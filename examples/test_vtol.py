"""VTOL2D transition-flight example (examples/test_vtol.py analog).

Usage:  python examples/test_vtol.py [--render] [--tf 100] [--rti]

``--rti`` selects the real-time-iteration MPC budget (MPCConfig.rti): the
real-time route to the reference's 50 ms control period for the N=30
horizon (quality gated in tests/test_vtol_e2e.py).

Full reference route (test_vtol.py:19-64): cruise the corridor at altitude
from (2,10) to (70,10), then descend between the two pillar columns
(x=67 upper pillars, x=73 full-height wall) to the landing point (70, 0.5).
VTOL is MPC-only in the reference (nominal_input returns zeros,
vtol2D.py:459-461) with horizon 30 (mpc_cbf.py:41).  Success iff
``run_all_steps`` ends with -1/0 — the reference predicate
(test_vtol.py:88-93) — with the ground/pitch terms of the collision oracle
active (tracking.py:488-495).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PILLAR_1_X, PILLAR_2_X = 67.0, 73.0
KNOWN_OBS = np.array(
    [[PILLAR_1_X, float(y), 0.5] for y in (6, 7, 8, 9)]
    + [[PILLAR_2_X, float(y), 0.5] for y in range(1, 16)]
    + [[60.0, 12.0, 1.5]]
)
WAYPOINTS = np.array([[2.0, 10.0], [70.0, 10.0], [70.0, 0.5]])


def main():
    parser = argparse.ArgumentParser(description="VTOL2D corridor + descent + landing.")
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--tf", type=float, default=100.0)
    parser.add_argument("--rti", action="store_true",
                        help="real-time-iteration MPC budget (50 ms period)")
    args = parser.parse_args()

    from safe_control_tpu.envs.env import Env
    from safe_control_tpu.sim import tracking
    from safe_control_tpu.sim.controller import LocalTrackingController

    robot_spec = {
        "model": "VTOL2D",
        "radius": 0.6,
        "v_max": 20.0,
        "reached_threshold": 1.0,
        "mpc_horizon": 30,
    }
    if args.rti:
        robot_spec["mpc_rti"] = True
    env = Env(width=75.0, height=20.0)
    v_init = robot_spec["v_max"]
    x_init = np.hstack([WAYPOINTS[0][:2], [0.0, v_init, 0.0, 0.0]])
    ctrl = LocalTrackingController(
        x_init, robot_spec, controller_type={"pos": "mpc_cbf"}, dt=0.05, env=env,
    )
    known7 = np.hstack([KNOWN_OBS, np.zeros((len(KNOWN_OBS), 4))])
    ctrl.obs = known7
    ctrl.set_waypoints(WAYPOINTS)

    xs, min_clear = [], np.inf
    ret = 0
    for _ in range(int(args.tf / 0.05)):
        ret = ctrl.control_step()
        x = ctrl.robot_state
        xs.append(x.copy())
        d = min(np.hypot(x[0] - p[0], x[1] - p[1]) - p[2] for p in KNOWN_OBS)
        min_clear = min(min_clear, d)
        if ret in (tracking.RET_DONE, tracking.RET_INFEASIBLE):
            break
    x = ctrl.robot_state
    ok = ret == tracking.RET_DONE and min_clear > 0.0
    print(
        f"final x={x[0]:.1f} m, altitude z={x[1]:.1f} m, ret={ret}, "
        f"min obstacle clearance {min_clear:.2f} m"
    )
    print("Success!" if ok else "Failed!")

    if args.render:
        from safe_control_tpu.viz.plotting import Plotting

        plot = Plotting(75.0, 20.0, known7)
        ax, fig = plot.plot_grid("VTOL2D corridor + landing")
        plot.plot_waypoints(ax, WAYPOINTS)
        plot.plot_trajectory(ax, np.asarray(xs))
        try:
            from safe_control_tpu.viz.bodies import draw_vtol

            for k in range(0, len(xs), 40):
                draw_vtol(ax, xs[k], robot_spec["radius"])
        except ImportError:
            pass
        fig.savefig("vtol.png", dpi=120)
        print("saved vtol.png")

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

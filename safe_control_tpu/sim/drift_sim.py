"""DriftingCarSimulator: reusable collision-checked drift-car sim loop.

JAX analog of the reference's robots/drifting_car.py:654-752
(``DriftingCarSimulator``) plus the shielded control pipeline that the
reference's drift examples re-assemble by hand (examples/drift_car/
test_drift.py:433-523): per step,

1. friction lookup at the car position (``env.get_friction_at_position``,
   test_drift.py:438-441) — the PLANT runs at the true local friction while
   the planner keeps its nominal assumption (the fault-injection mechanism),
2. MPCC solve on the nominal-friction model (:450),
3. shielding — gatekeeper backward search / MPS single-step / BackupCBF QP
   (:454-460) with time-synchronized moving-obstacle predictions,
4. plant step + env collision verdict (boundaries, obstacle cars at time t,
   drifting_car.py:700-752),
5. statistics: nominal-vs-backup step counts, h_min, collision step
   (test_drift.py:512-523) and MPC-prediction storage for visualization
   (drifting_car.py:585-651).

Everything inside :meth:`step` is one jitted XLA program; the class is a thin
host-side driver around it, so scenario scripts (examples/test_drift.py)
configure instead of re-implementing the loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from safe_control_tpu.core.spec import DRIFTING_CAR
from safe_control_tpu.dynamics import get_model
from safe_control_tpu.shielding import backup as bk
from safe_control_tpu.shielding import backup_cbf as bcbf
from safe_control_tpu.shielding import gatekeeper as gk
from safe_control_tpu.solvers import mpcc

ALGO_TYPES = ("gatekeeper", "mps", "backupcbf")
BACKUP_TYPES = ("lane_change", "stop")


@dataclasses.dataclass(frozen=True)
class DriftSimConfig:
    """Scenario knobs mirroring test_drift.py's SimulationConfig (:150-160)."""

    dt: float = 0.05
    algo: str = "gatekeeper"
    backup: str = "lane_change"
    nominal_steps: int = 40  # gatekeeper nominal horizon (steps)
    backup_steps: int = 60  # backup horizon (steps; ref 3 s / dt)
    event_offset_steps: int = 1  # ref event_offset 0.05 s = every step
    discount_steps: int = 5
    safety_margin: float = 0.01
    target_velocity: float = 10.0

    def __post_init__(self):
        if self.algo not in ALGO_TYPES:
            raise ValueError(f"unknown algo {self.algo!r}")
        if self.backup not in BACKUP_TYPES:
            raise ValueError(f"unknown backup {self.backup!r}")


class DriftingCarSimulator:
    """Collision-checked shielded drift-car simulation.

    Parameters
    ----------
    spec : RobotSpec for the DriftingCar (the PLANNER's friction ``spec.mu``).
    env : DriftingEnv with obstacles/puddles already added.
    path : mpcc.Path reference (usually the ego lane centerline).
    x0 : (8,) initial global state.
    mpcc_cfg : MPCCConfig for the nominal controller.
    cfg : DriftSimConfig selecting the shielding algorithm and backup.
    backup_target_y : lane-change target (ignored for the stopping backup).
    """

    def __init__(self, spec, env, path, x0, mpcc_cfg: mpcc.MPCCConfig,
                 cfg: DriftSimConfig, backup_target_y: float = 0.0):
        import jax
        import jax.numpy as jnp

        self._jnp = jnp
        self.spec = spec
        self.env = env
        self.cfg = cfg
        self.model = get_model(DRIFTING_CAR)
        dt = cfg.dt

        gains = bk.LaneChangeGains(
            target_velocity=cfg.target_velocity,
            delta_max=float(spec.delta_max),
            delta_dot_max=float(spec.delta_dot_max),
            tau_max=float(spec.tau_max),
            tau_dot_max=float(spec.tau_dot_max),
        )
        sgains = bk.StoppingGains(
            delta_max=float(spec.delta_max),
            delta_dot_max=float(spec.delta_dot_max),
            tau_max=float(spec.tau_max),
            tau_dot_max=float(spec.tau_dot_max),
        )

        def backup_policy_for(plant):
            if cfg.backup == "stop":
                return lambda xx: bk.stopping(xx, plant, sgains)
            return lambda xx: bk.lane_change(xx, backup_target_y, plant, gains)

        radius = float(spec.radius)
        margin = cfg.safety_margin

        def collision_fn(xx, t_idx, cars):
            # boundary + time-synchronized obstacle-car check
            # (gatekeeper.py:380-527 analog over DriftingEnv data).  The
            # obstacle-car array is a TRACED argument, not a baked-in
            # constant: moving/changing obstacles re-run the same compiled
            # program (and scenario suites share one compile per config).
            t = t_idx * dt
            cx = cars[:, 0] + cars[:, 3] * t
            cy = cars[:, 1] + cars[:, 4] * t
            d = jnp.sqrt((xx[0] - cx) ** 2 + (xx[1] - cy) ** 2)
            hit = jnp.any((d < radius + margin + cars[:, 5]) & (cars[:, 5] > 0))
            return env.check_collision(xx[:2], radius) | hit

        def h_safety(xx, t, cars):
            # Track halfspaces + obstacle cars at time t
            # (backup_cbf_qp.py:390-446, drift branch).
            half = env.track_width / 2.0
            h = jnp.minimum(half - xx[1] - radius, xx[1] + half - radius)
            cx = cars[:, 0] + cars[:, 3] * t
            cy = cars[:, 1] + cars[:, 4] * t
            d = jnp.sqrt((xx[0] - cx) ** 2 + (xx[1] - cy) ** 2)
            h_cars = jnp.where(
                cars[:, 5] > 0, d - radius - cars[:, 5] - margin, jnp.inf
            )
            return jnp.minimum(h, jnp.min(h_cars))

        def h_terminal(xx, cars):
            # Terminal invariance: safe AND (nearly stopped or in the backup
            # lane) — the backup set the policy converges to.
            base = h_safety(xx, cfg.backup_steps * dt, cars)
            if cfg.backup == "stop":
                return jnp.minimum(base, 1.0 - xx[5] / 5.0)
            return jnp.minimum(base, 1.0 - jnp.abs(xx[1] - backup_target_y))

        gcfg = gk.GatekeeperConfig(
            model_name=DRIFTING_CAR, dt=dt,
            nominal_steps=cfg.nominal_steps, backup_steps=cfg.backup_steps,
            event_offset_steps=cfg.event_offset_steps,
            discount_steps=cfg.discount_steps,
            mps_mode=(cfg.algo == "mps"),
        )
        bcfg = bcbf.BackupCBFConfig(
            model_name=DRIFTING_CAR, dt=dt, backup_steps=cfg.backup_steps
        )
        self._gcfg, self._bcfg, self._mpcc_cfg = gcfg, bcfg, mpcc_cfg

        assert mpcc_cfg.horizon >= cfg.nominal_steps, (
            "MPCC horizon must cover the gatekeeper nominal horizon "
            "(test_drift.py:151-153: nominal_horizon_time drives both)"
        )
        n_slice = cfg.nominal_steps

        def jit_step(mstate, gstate, x, u_prev, mu_plant, t_idx, cars):
            plant = spec.replace(mu=mu_plant)
            backup_policy = backup_policy_for(plant)
            mres = mpcc.solve(spec, x, path, mstate, u_prev, dt, mpcc_cfg)

            def coll_at(xx, k):
                return collision_fn(xx, t_idx + k, cars)

            if cfg.algo in ("gatekeeper", "mps"):
                out = gk.step(
                    gcfg, plant, gstate, x, backup_policy, coll_at,
                    nominal_traj=(
                        mres.xs[: n_slice + 1, :8], mres.us[:n_slice, :2]
                    ),
                )
                u, gstate_new = out.u, out.state
                using_backup = out.using_backup
                h_min = jnp.asarray(jnp.inf)
            else:
                t_now = t_idx * dt
                res = bcbf.solve(
                    bcfg, plant, x, mres.u, backup_policy,
                    lambda xx, tt: h_safety(xx, t_now + tt, cars),
                    lambda xx: h_terminal(xx, cars),
                )
                u, gstate_new = res.u, gstate
                using_backup = res.using_backup
                h_min = res.h_min

            x_next = self.model.step(x, u, plant, dt)
            collided = collision_fn(x_next, t_idx + 1, cars)
            return (
                mres.state, gstate_new, x_next, u, using_backup, collided,
                h_min, mres.xs[:, :2],
            )

        self._step_jit = jax.jit(jit_step)
        self.x = jnp.asarray(x0, jnp.float32)
        self.mstate = mpcc.init_state(mpcc_cfg)
        self.gstate = gk.init_state(gcfg)
        self.u_prev = jnp.zeros(2, jnp.float32)
        self.t_idx = 0
        self.stats = dict(
            nominal_steps=0, backup_steps=0, collision=False,
            collision_step=None, global_min_h=np.inf,
        )
        self.trajectory = []
        self.predictions = []  # per-step MPCC predicted (N+1, 2) positions

    # ------------------------------------------------------------------ API
    def reset(self, x0, env=None) -> None:
        """Re-arm the simulator for a fresh run (optionally with a new env
        sharing the same track geometry).  The compiled step program is
        kept: obstacle cars enter as runtime arguments and puddle friction
        is a host-side lookup, so only the track constants are baked in."""
        import jax.numpy as jnp

        if env is not None:
            assert env.track_width == self.env.track_width
            self.env = env
        self.x = jnp.asarray(x0, jnp.float32)
        self.mstate = mpcc.init_state(self._mpcc_cfg)
        self.gstate = gk.init_state(self._gcfg)
        self.u_prev = jnp.zeros(2, jnp.float32)
        self.t_idx = 0
        self.stats = dict(
            nominal_steps=0, backup_steps=0, collision=False,
            collision_step=None, global_min_h=np.inf,
        )
        self.trajectory = []
        self.predictions = []

    def step(self) -> bool:
        """Advance one control step; returns True if a collision occurred."""
        jnp = self._jnp
        mu = self.env.get_friction_at_position(
            self.x[:2], default_friction=float(self.spec.mu)
        )
        (self.mstate, self.gstate, self.x, self.u_prev, using_backup,
         collided, h_min, pred) = self._step_jit(
            self.mstate, self.gstate, self.x, self.u_prev,
            jnp.asarray(mu, jnp.float32), jnp.asarray(self.t_idx, jnp.int32),
            jnp.asarray(self.env.obstacle_cars, jnp.float32),
        )
        self.t_idx += 1
        self.trajectory.append(np.asarray(self.x))
        self.predictions.append(np.asarray(pred))
        if bool(using_backup):
            self.stats["backup_steps"] += 1
        else:
            self.stats["nominal_steps"] += 1
        hm = float(h_min)
        if np.isfinite(hm):
            self.stats["global_min_h"] = min(self.stats["global_min_h"], hm)
        if bool(collided):
            self.stats["collision"] = True
            if self.stats["collision_step"] is None:
                self.stats["collision_step"] = self.t_idx
        return bool(collided)

    def run(self, tf: float) -> dict:
        """Run until ``tf`` seconds or first collision (test_drift.py:433-523)."""
        n = int(round(tf / self.cfg.dt))
        for _ in range(n):
            if self.step():
                break
        out = dict(self.stats)
        out["x_final"] = np.asarray(self.x)
        out["trajectory"] = np.asarray(self.trajectory)
        return out

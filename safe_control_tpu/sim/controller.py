"""Host-side controller with the reference's imperative API.

A drop-in analog of /root/reference/tracking.py ``LocalTrackingController``
(:36-752) for users coming from the reference: same constructor shape
(``X0, robot_spec dict, controller_type dict, dt, env``), same methods
(``set_waypoints``, ``set_unknown_obs``, ``control_step``, ``run_all_steps``,
``get_control_input``), same return-code contract.  Internally it owns a
jitted functional tracker step (sim/tracking.py); visualization hooks are
optional host-side matplotlib (viz/plotting.py).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from safe_control_tpu.core import spec as spec_mod
from safe_control_tpu.core.types import pad_obstacles
from safe_control_tpu.dynamics import get_model
from safe_control_tpu.sim import tracking
from safe_control_tpu.solvers import mpc_cbf as mpc_mod

MAX_WAYPOINTS = 32
MAX_KNOWN_OBS = 32
MAX_UNKNOWN_OBS = 16


class InfeasibleError(Exception):
    """Raised when the QP is infeasible or the robot collides
    (tracking.py:25-33)."""


_SPEC_KEYS = {
    "v_max", "v_min", "w_max", "a_max", "ax_max", "ay_max", "radius",
    "wheel_base", "body_width", "front_ax_dist", "rear_ax_dist", "delta_max",
    "beta_max", "f_min", "f_max", "u_min", "u_max", "mass", "inertia",
    "throttle_min", "throttle_max", "elevator_min", "elevator_max",
    "descent_speed_max", "pitch_max", "nominal_k_v", "nominal_k_a",
    "nominal_k_omega", "cbf_alpha", "cbf_alpha1", "cbf_alpha2",
    "mpc_cbf_alpha", "mpc_cbf_alpha1", "mpc_cbf_alpha2", "reached_threshold",
    "cam_range",
}


def spec_from_dict(robot_spec: Dict) -> spec_mod.RobotSpec:
    """Translate a reference-style robot_spec dict to a RobotSpec pytree."""
    model = robot_spec["model"]
    overrides = {k: float(v) for k, v in robot_spec.items() if k in _SPEC_KEYS}
    if "fov_angle" in robot_spec:
        # The reference stores fov_angle in degrees (robots/robot.py:53-54).
        overrides["fov_angle"] = math.radians(float(robot_spec["fov_angle"]))
    if "Kp" in robot_spec:  # Manipulator gain key (manipulator2D.py:23)
        overrides["kp"] = float(robot_spec["Kp"])
    return spec_mod.make_spec(model, **overrides)


class LocalTrackingController:
    def __init__(
        self,
        X0,
        robot_spec: Dict,
        controller_type: Optional[Dict] = None,
        dt: float = 0.05,
        show_animation: bool = False,
        save_animation: bool = False,
        enable_rotation: bool = True,
        raise_error: bool = False,
        env=None,
        ax=None,
        fig=None,
        **_ignored,
    ):
        import jax
        import jax.numpy as jnp

        self._jax = jax
        self._jnp = jnp
        controller_type = controller_type or {}
        self.robot_spec = dict(robot_spec)
        self.model_name = robot_spec["model"]
        self.dt = dt
        self.raise_error = raise_error
        self.spec = spec_from_dict(robot_spec)
        model = get_model(self.model_name)

        X0 = np.asarray(X0, dtype=float).reshape(-1)
        X0, yaw0 = self._pad_x0(X0, model)
        self._x0 = X0
        self._yaw0 = yaw0

        # The reference auto-selects N=30 for VTOL2D and 10 otherwise
        # (position_control/mpc_cbf.py:15, 41); mirroring that here keeps
        # wrapper users from silently running VTOL at a third of the
        # reference's planning horizon.
        default_horizon = 30 if self.model_name == "VTOL2D" else 10
        horizon = int(robot_spec.get("mpc_horizon", default_horizon))
        # Manipulator2D defaults to 150 constraint slots (5 obs x 30 link
        # circles, tracking.py:131-136); everyone else to 10.
        default_constraints = 150 if self.model_name == "Manipulator2D" else 10
        num_constraints = int(robot_spec.get("num_constraints", default_constraints))
        if self.model_name == "Manipulator2D":
            # Our CBF-QP expands link-circle rows internally, so num_obs is
            # the obstacle count, not the row count.
            num_constraints = max(num_constraints // 30, 1)

        use_sensor = robot_spec.get("sensor") == "rgbd"
        pos_type = controller_type.get("pos", "cbf_qp")
        att_type = controller_type.get("att", "velocity_tracking_yaw")
        detection = str(robot_spec.get("unknown_obs_detection", "fov")).lower()

        # The sensing footprint grid stands in for the reference's shapely
        # polygon union (robots/robot.py:646-654); it is sized from the env
        # workspace so visibility violations (return code 1) are reachable
        # through this wrapper exactly like tracking.py:652-668.
        grid = None
        needs_grid = (
            use_sensor
            or detection == "ray"
            or att_type in ("visibility_raycast", "visibility_area", "gatekeeper")
        )
        if needs_grid:
            from safe_control_tpu.perception.grid import GridSpec

            if env is not None:
                grid = GridSpec(
                    width=float(getattr(env, "width", 20.0)),
                    height=float(getattr(env, "height", 20.0)),
                    resolution=float(getattr(env, "resolution", 0.1)),
                )
            else:
                grid = GridSpec(width=20.0, height=20.0)

        from safe_control_tpu.attitude.gatekeeper_att import GatekeeperAttConfig

        gk_att = GatekeeperAttConfig(
            dt=dt,
            nominal_horizon=float(robot_spec.get("gatekeeper_nominal_horizon", 1.0)),
            backup_horizon=float(robot_spec.get("gatekeeper_backup_horizon", 2.0)),
            event_offset=float(robot_spec.get("gatekeeper_event_offset", 0.5)),
            horizon_discount=float(
                robot_spec.get("gatekeeper_horizon_discount", max(5 * dt, dt))
            ),
            validation_slack=float(robot_spec.get("gatekeeper_validation_slack", 0.05)),
            tube_margin=float(
                robot_spec.get("gatekeeper_validation_tube_margin", 0.0)
            ),
            braking_distance_scale=float(
                robot_spec.get("gatekeeper_braking_distance_scale", 1.0)
            ),
            braking_distance_margin=float(
                robot_spec.get(
                    "gatekeeper_braking_distance_margin",
                    float(self.spec.radius) + 0.10,
                )
            ),
        )
        self.cfg = tracking.TrackerConfig(
            model_name=self.model_name,
            pos_controller=pos_type,
            att_controller=att_type,
            dt=dt,
            num_obs=num_constraints,
            enable_rotation=enable_rotation,
            use_sensor=use_sensor,
            detection_mode=detection,
            cbf_mode=str(robot_spec.get("cbf_mode", "cbf")),
            reached_threshold=float(
                robot_spec.get("reached_threshold", 0.3)
            ),
            mpc=self._build_mpc_cfg(robot_spec, horizon, pos_type),
            grid=grid,
            visibility_mode=str(
                robot_spec.get("visibility_violation_mode", "safety_area")
            ).lower(),
            strict_mpc_feasibility=bool(
                robot_spec.get("strict_mpc_feasibility", False)
            ),
            gk_att=gk_att,
        )

        env_obs = np.zeros((0, 7))
        if env is not None and getattr(env, "obs_circle", None) is not None:
            oc = np.asarray(env.obs_circle, dtype=float)
            if oc.size:
                env_obs = np.hstack([oc, np.zeros((oc.shape[0], 7 - oc.shape[1]))])
        self.obs = env_obs  # user-assignable, like the reference (:114)
        self.unknown_obs = np.zeros((0, 7))

        self.waypoints = np.zeros((0, 2))
        self.state = None
        self.u_pos = np.zeros(model.N_CONTROLS)
        self.last_safety_mask = None
        self._step_jit = None

    @staticmethod
    def _build_mpc_cfg(robot_spec, horizon, pos_type):
        """MPC configuration from reference-style robot_spec keys.

        - ``mpc_rti``: True selects the real-time-iteration budget
          (``MPCConfig.rti`` — the real-time route for VTOL N=30);
          explicit ``mpc_outer_iters`` /
          ``mpc_newton_iters`` override either preset.
        - ``mpc_scan_unroll``: rollout-scan unroll factor.  Default: full
          unroll on accelerator backends — the wrapper is the single-robot
          LATENCY path, where the serial N-step rollout chain is dispatch-
          latency-bound and XLA can fuse across unrolled steps (its effect
          on the GPU is open: ROADMAP S4); kept at 1 on CPU, where dispatch
          overhead is nil and unrolling only bloats compile (test-suite
          wall time).
        - ``mpc_loop_unroll``: unroll the Newton/AL ``fori_loop``s too
          (``MPCConfig.loop_unroll``).  Opt-in, default OFF: at the 8x3
          accuracy budget on N=30 the unrolled program takes many minutes
          to compile.
        """
        import jax as _jax

        kw = dict(
            horizon=horizon,
            num_obs=5,
            optimal_decay=(pos_type == "optimal_decay_mpc_cbf"),
        )
        if "mpc_scan_unroll" in robot_spec:
            kw["scan_unroll"] = int(robot_spec["mpc_scan_unroll"])
        elif _jax.default_backend() != "cpu":
            kw["scan_unroll"] = horizon
        base = (mpc_mod.MPCConfig.rti if robot_spec.get("mpc_rti")
                else mpc_mod.MPCConfig)
        if "mpc_outer_iters" in robot_spec:
            kw["outer_iters"] = int(robot_spec["mpc_outer_iters"])
        if "mpc_newton_iters" in robot_spec:
            kw["newton_iters"] = int(robot_spec["mpc_newton_iters"])
        if "mpc_loop_unroll" in robot_spec:
            kw["loop_unroll"] = bool(robot_spec["mpc_loop_unroll"])
        return base(**kw)

    @staticmethod
    def _pad_x0(X0, model):
        """Model-specific initial-state padding (tracking.py:60-99)."""
        n = model.N_STATES
        yaw0 = 0.0
        if X0.shape[0] == n:
            return X0, (X0[2] if n >= 3 else 0.0)
        if X0.shape[0] == 2:
            x = np.zeros(n)
            x[:2] = X0
            return x, 0.0
        if X0.shape[0] == 3:
            x = np.zeros(n)
            x[:2] = X0[:2]
            if n >= 3:
                x[2] = X0[2]
                yaw0 = X0[2]
            else:
                yaw0 = X0[2]
            return x, yaw0
        raise ValueError(f"Invalid initial state dim {X0.shape[0]} for {model}")

    # ------------------------------------------------------------------ API
    def set_waypoints(self, waypoints):
        wps = np.asarray(waypoints, dtype=float)
        self.waypoints = self._filter_waypoints(wps)
        first_goal = self.waypoints[0][:2] if len(self.waypoints) else None
        self.state = tracking.init_state(
            self.cfg, self.spec, self._x0, self._yaw0, first_goal=first_goal
        )

    def _filter_waypoints(self, waypoints):
        """Drop leading waypoints closer than reached_threshold
        (tracking.py:240-262)."""
        if len(waypoints) < 2:
            return waypoints
        model = get_model(self.model_name)
        robot_pos = np.asarray(self._x0[:2])
        aug = np.vstack([robot_pos, waypoints[:, :2]])
        dists = np.linalg.norm(np.diff(aug, axis=0), axis=1)
        mask = np.concatenate(([False], dists >= self.cfg.reached_threshold))
        out = aug[mask]
        return out if len(out) else waypoints[-1:, :2]

    def set_unknown_obs(self, unknown_obs):
        uo = np.asarray(unknown_obs, dtype=float)
        if uo.ndim == 1 and uo.size:
            uo = uo.reshape(1, -1)
        if uo.size == 0:
            uo = np.zeros((0, 7))
        elif uo.shape[1] < 7:
            uo = np.hstack([uo, np.zeros((uo.shape[0], 7 - uo.shape[1]))])
        self.unknown_obs = uo[:, :7]

    def _ensure_jit(self):
        if self._step_jit is not None:
            return
        jax, jnp = self._jax, self._jnp
        cfg, spec = self.cfg, self.spec

        def fn(state, wps, n_wps, known, unknown):
            return tracking.step(cfg, spec, state, wps, n_wps, known, unknown)

        self._step_jit = jax.jit(fn)

    def _device_inputs(self):
        """Device-resident obstacle/waypoint arrays, re-uploaded only when
        the host-side source arrays change.

        Latency matters here: every host->device put and device->host
        fetch is a synchronisation point, and the reference's per-step
        real-time budget is 50 ms.  Obstacles and waypoints rarely change
        between steps, so caching them device-side cuts the per-step
        transfer count from ~5 to ~1.

        Invalidation is BY CONTENT, not by object identity: ``obs`` is
        user-assignable like the reference's (tracking.py:114), and the
        reference's dynamic env mutates it IN PLACE every step
        (dynamic_env/main.py:54-58 ``obs[:,0:2] += obs[:,3:5]*dt``) —
        ``id()`` would serve stale obstacle positions both for in-place
        updates (id unchanged) and for reassignment (CPython readily reuses
        a freed same-shape array's address).  The arrays are tiny (<=32x7),
        so hashing their bytes each step costs microseconds.
        """
        jnp = self._jnp
        key = (self.obs.tobytes(), self.obs.shape,
               self.unknown_obs.tobytes(), self.unknown_obs.shape,
               self.waypoints.tobytes(), self.waypoints.shape)
        if getattr(self, "_dev_key", None) != key:
            known = pad_obstacles(jnp.asarray(self.obs), MAX_KNOWN_OBS)
            unknown = pad_obstacles(
                jnp.asarray(self.unknown_obs), MAX_UNKNOWN_OBS
            )
            wps = jnp.asarray(
                np.vstack([self.waypoints[:, :2],
                           np.zeros((MAX_WAYPOINTS - len(self.waypoints), 2))])
                if len(self.waypoints) < MAX_WAYPOINTS
                else self.waypoints[:MAX_WAYPOINTS, :2],
                dtype=jnp.float32,
            )
            n_wps = jnp.asarray(len(self.waypoints))
            self._dev_cache = (wps, n_wps, known, unknown)
            self._dev_key = key
        return self._dev_cache

    def control_step(self) -> int:
        """One control step; returns the reference's code contract
        (tracking.py:559-567)."""
        self._ensure_jit()
        wps, n_wps, known, unknown = self._device_inputs()
        out = self._step_jit(self.state, wps, n_wps, known, unknown)
        self.state = out.state
        # ONE device->host transfer for everything the host needs this step
        # (three separate np.asarray fetches = three synchronisations).
        u, ret, mask = self._jax.device_get(
            (out.u, out.ret, out.safety_mask)
        )
        self.u_pos = np.asarray(u)
        self.last_safety_mask = np.asarray(mask)
        ret = int(ret)
        if ret == tracking.RET_INFEASIBLE and self.raise_error:
            raise InfeasibleError("Infeasible or collision detected !!")
        return ret

    def get_control_input(self):
        return self.u_pos.reshape(-1, 1)

    @property
    def robot_state(self):
        return np.asarray(self.state.x)

    def has_reached_goal(self) -> bool:
        return int(self.state.goal_idx) >= len(self.waypoints)

    def run_all_steps(self, tf=30, write_csv: bool = False) -> int:
        """Mirror of tracking.py:711-752 (CSV logging included)."""
        unexpected_beh = 0
        writer = None
        csvfile = None
        if write_csv:
            import csv

            csvfile = open("output.csv", "w", newline="")
            writer = csv.writer(csvfile)
            writer.writerow(["states", "control_inputs", "alpha1", "alpha2"])
        try:
            for _ in range(int(tf / self.dt)):
                ret = self.control_step()
                unexpected_beh += ret
                if writer is not None:
                    writer.writerow(
                        np.concatenate(
                            [
                                self.robot_state,
                                self.u_pos,
                                [float(self.spec.cbf_alpha1), float(self.spec.cbf_alpha2)],
                            ]
                        )
                    )
                if ret in (tracking.RET_DONE, tracking.RET_INFEASIBLE):
                    break
        finally:
            if csvfile is not None:
                csvfile.close()
        return unexpected_beh

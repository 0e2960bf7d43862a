"""Waypoint-tracking orchestration: the reference's state machine, functional.

JAX re-implementation of the reference's tracking.py
``LocalTrackingController``: the idle/track/stop/rotate state machine
(:49, 559-668), waypoint advance (:497-535), nearest-unpassed obstacle
selection with per-model angular windows (:345-403), perception hookup
(:580-586), the per-step controller pipeline (:589-637), and the return-code
contract (-2 infeasible/collision, -1 all waypoints reached, 0 normal).

Everything is a pure function of a ``TrackerState`` pytree, so whole
simulations run under ``lax.scan`` and whole fleets under ``vmap`` — the
reference steps one robot per Python iteration.  A host-side wrapper class
with the reference's imperative API lives in ``sim/controller.py``.

Known behavioral deltas (documented per SURVEY.md §7 "hard parts"):
- the rotate-alignment test uses the *normalized* angle difference; the
  reference compares raw angles (tracking.py:516) which can spin forever
  across the ±pi seam.
- when some obstacles are "unpassed", the reference feeds only those to the
  controller; we mask passed obstacles to dummies after top-K selection,
  which is equivalent.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from safe_control_tpu.attitude import gatekeeper_att as gk_att_mod
from safe_control_tpu.attitude import visibility as vis_mod
from safe_control_tpu.attitude.simple import velocity_tracking_yaw
from safe_control_tpu.core import spec as spec_mod
from safe_control_tpu.core.types import (
    OBS_FLAG,
    OBS_R,
    angle_normalize,
    dummy_obstacle,
    is_dummy,
)
from safe_control_tpu.dynamics import get_model
from safe_control_tpu.perception import fov as fov_mod
from safe_control_tpu.perception import grid as grid_mod
from safe_control_tpu.solvers import cbf_qp as cbf_qp_mod
from safe_control_tpu.solvers import mpc_cbf as mpc_mod
from safe_control_tpu.solvers import optimal_decay_cbf_qp as od_qp_mod

# State-machine codes (tracking.py:49).
IDLE, TRACK, STOP, ROTATE = 0, 1, 2, 3

# Step return codes (tracking.py:559-567).
RET_INFEASIBLE = -2
RET_DONE = -1
RET_OK = 0
RET_VISIBILITY = 1

_INTEGRATORS = (spec_mod.SINGLE_INTEGRATOR_2D, spec_mod.DOUBLE_INTEGRATOR_2D)
# Models that skip the 'rotate' state entirely (tracking.py:512).
_SKIP_ROTATE = (spec_mod.QUAD_2D, spec_mod.VTOL_2D, spec_mod.MANIPULATOR_2D)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Static configuration (jit-specializing).

    ``pos_controller``/``att_controller`` accept the full reference factory
    surface (tracking.py:138-181): pos 'cbf_qp' | 'mpc_cbf' |
    'optimal_decay_cbf_qp' | 'optimal_decay_mpc_cbf'; att (integrators only)
    'none' | 'simple' | 'velocity_tracking_yaw' | 'visibility_raycast' |
    'visibility_area' | 'gatekeeper'.  ``detection_mode`` mirrors the
    ``unknown_detection`` axis (utils/detection.py:135-140): 'fov' | 'ray'.
    """

    model_name: str
    pos_controller: str = "cbf_qp"
    att_controller: str = "velocity_tracking_yaw"
    dt: float = 0.05
    num_obs: int = 10  # constraint slots fed to the controller
    mem_slots: int = 16  # persistent unknown-obstacle memory size
    reached_threshold: float = 0.3
    rotation_threshold: float = 0.1
    enable_rotation: bool = True
    use_sensor: bool = False  # 'sensor': 'rgbd' analog
    detection_mode: str = "fov"  # 'fov' | 'ray' (utils/detection.py:135-140)
    # CBF-QP constraint form (cbf_qp.py:120): 'cbf' = Lie-derivative rows
    # with the class-K alpha terms; 'hard' = the reference's h(x_next) >= 0
    # alternative (Taylor rows divided by dt / dt^2 — an "infinite alpha"
    # one-step invariance constraint, cbf_qp.py:137-177).
    cbf_mode: str = "cbf"
    mpc: mpc_mod.MPCConfig = mpc_mod.MPCConfig()
    qp_iters: int = 1600
    # Occupancy-footprint visibility checking (tracking.py:652-668): when a
    # GridSpec is given (and use_sensor), the footprint is updated every step
    # and a visibility violation returns RET_VISIBILITY.
    grid: object = None  # Optional[grid_mod.GridSpec]
    visibility_mode: str = "safety_area"  # or 'point_mass'
    # Braking decelerations for the safety area (robots/robot.py:62-63).
    max_decel: float = 3.0
    max_ang_decel: float = 3.0
    # VTOL pitch term of the collision oracle: 'reference' compares the pitch
    # against the RAW spec value like tracking.py:493 (vacuous at the 15.0-
    # degree default); 'strict' converts degrees->radians first.
    vtol_pitch_oracle: str = "reference"
    # MPC feasibility verdict.  The reference hardcodes status='optimal'
    # (mpc_cbf.py:10 TODO) so MPC stress can never fail a run; False
    # reproduces that.  True feeds MPCResult.feasible into the step verdict,
    # so genuine MPC infeasibility returns RET_INFEASIBLE like a failed QP.
    strict_mpc_feasibility: bool = False
    # Yaw-gatekeeper attitude shielding (attitude/gatekeeper_att.py).
    gk_att: gk_att_mod.GatekeeperAttConfig = gk_att_mod.GatekeeperAttConfig()

    def __post_init__(self):
        if self.pos_controller not in (
            "cbf_qp", "mpc_cbf", "optimal_decay_cbf_qp", "optimal_decay_mpc_cbf",
        ):
            raise ValueError(f"Unknown controller type: {self.pos_controller}")
        if self.att_controller not in (
            "none", "simple", "velocity_tracking_yaw", "visibility_raycast",
            "visibility_area", "gatekeeper",
        ):
            raise ValueError(
                f"Unknown attitude controller type: {self.att_controller}"
            )
        if self.pos_controller == "optimal_decay_mpc_cbf" and not self.mpc.optimal_decay:
            # The optimal-decay MPC is the same engine with the omega inputs
            # enabled (optimal_decay_mpc_cbf.py:125-126); coerce the flag so
            # the two config axes can't disagree.
            object.__setattr__(self, "mpc", self.mpc._replace(optimal_decay=True))
        if self.detection_mode not in ("fov", "ray"):
            raise ValueError(
                f"Unsupported unknown_obs_detection mode: {self.detection_mode}"
            )
        if self.cbf_mode not in ("cbf", "hard"):
            raise ValueError(f"Unsupported cbf_mode: {self.cbf_mode}")
        needs_grid = self.att_controller in (
            "visibility_raycast", "visibility_area", "gatekeeper",
        ) or self.detection_mode == "ray"
        if needs_grid and self.grid is None:
            raise ValueError(
                f"att_controller={self.att_controller!r} / detection_mode="
                f"{self.detection_mode!r} require a GridSpec (cfg.grid): the "
                "reference's equivalents operate on the sensing footprint "
                "(robots/robot.py:646-654)"
            )

    @property
    def uses_mpc(self) -> bool:
        return self.pos_controller in ("mpc_cbf", "optimal_decay_mpc_cbf")


class TrackerState(NamedTuple):
    x: jnp.ndarray  # (n,) dynamics state
    yaw: jnp.ndarray  # scalar yaw side-channel (integrators)
    mode: jnp.ndarray  # int32 state machine
    goal_idx: jnp.ndarray  # int32 waypoint index
    u_prev: jnp.ndarray  # (m,) last applied control
    mpc: mpc_mod.MPCState
    mem: fov_mod.ObsMemory
    ret: jnp.ndarray  # int32 last step return code
    footprint: jnp.ndarray  # occupancy grid (1,1) placeholder when unused
    att_gk: gk_att_mod.GatekeeperAttState  # yaw-gatekeeper commitment


class StepOutput(NamedTuple):
    state: TrackerState
    u: jnp.ndarray
    ret: jnp.ndarray  # int32 return code for this step
    feasible: jnp.ndarray
    goal: jnp.ndarray  # (2,) active goal (or last waypoint)
    # The braking-distance safety-area mask actually checked this step
    # ((nx, ny) grid when cfg.grid + safety_area visibility mode, else a
    # (1, 1) placeholder) — exposed so replays/animations can draw exactly
    # what the tracker evaluated (robots/robot.py:656-741 live artists).
    safety_mask: jnp.ndarray = jnp.zeros((1, 1), dtype=bool)


def orientation_of(cfg: TrackerConfig, x, yaw):
    """Robot heading: theta state for heading models, the side-channel yaw
    for integrators (robots/robot.py:441-453)."""
    if cfg.model_name in _INTEGRATORS:
        return yaw
    return x[2]


def angle_window(model_name: str):
    """Per-model 'unpassed' angular window (tracking.py:352-357)."""
    if model_name in (
        spec_mod.UNICYCLE_2D,
        spec_mod.DYNAMIC_UNICYCLE_2D,
        spec_mod.VTOL_2D,
    ):
        return jnp.pi * 1.2
    return jnp.pi * 2.0


def init_state(
    cfg: TrackerConfig, spec, x0, yaw0=0.0, first_goal=None, dtype=jnp.float32
) -> TrackerState:
    """Initial state; the mode mirrors ``set_waypoints`` (tracking.py:222-236):
    'track' if the first goal is inside the FoV cone, else 'stop' (which then
    converges through stop->rotate->track).  Quad2D/VTOL always 'track'
    (robots/robot.py:860-862)."""
    model = get_model(cfg.model_name)
    x0 = jnp.asarray(x0, dtype=dtype)
    yaw0 = jnp.asarray(yaw0, dtype=dtype)
    if cfg.model_name in _SKIP_ROTATE or first_goal is None:
        mode0 = jnp.asarray(TRACK, dtype=jnp.int32)
    else:
        heading0 = orientation_of(cfg, x0, yaw0)
        in_fov = fov_mod.is_in_fov(
            model.barrier_pos(x0), heading0, jnp.asarray(first_goal, dtype=dtype), spec
        )
        mode0 = jnp.where(in_fov, TRACK, STOP).astype(jnp.int32)
    if cfg.grid is not None:
        fp = grid_mod.init_footprint(cfg.grid, model.barrier_pos(x0), spec)
    else:
        fp = jnp.zeros((1, 1), dtype=bool)
    return TrackerState(
        x=x0,
        yaw=yaw0,
        mode=mode0,
        goal_idx=jnp.asarray(0, dtype=jnp.int32),
        u_prev=jnp.zeros((get_model(cfg.model_name).N_CONTROLS,), dtype=dtype),
        mpc=mpc_mod.init_state(cfg.model_name, cfg.mpc, dtype=dtype),
        mem=fov_mod.init_memory(cfg.mem_slots, dtype=dtype),
        ret=jnp.asarray(RET_OK, dtype=jnp.int32),
        footprint=fp,
        att_gk=gk_att_mod.init_state(cfg.gk_att),
    )


def select_obstacles(cfg: TrackerConfig, spec, pos, heading, all_obs, speed=0.0):
    """Nearest-K unpassed obstacle selection (tracking.py:345-403).

    ``all_obs`` is (Ka, 7) padded.  Returns (num_obs, 7) padded selection.

    Safety fix over the reference: its angular window assumes forward motion;
    a reversing robot (v < 0, legal for DU/KB) would drop exactly the
    obstacles it is driving toward.  When ``speed`` is negative we also keep
    obstacles unpassed w.r.t. the motion direction (heading + pi).
    """
    win = angle_window(cfg.model_name)
    valid = ~is_dummy(all_obs)
    to_obs = all_obs[:, :2] - pos[None, :]
    dist = jnp.linalg.norm(to_obs, axis=1)
    ang = jnp.arctan2(to_obs[:, 1], to_obs[:, 0])
    unpassed = jnp.abs(angle_normalize(ang - heading)) <= win / 2.0
    unpassed_rev = jnp.abs(angle_normalize(ang - heading - jnp.pi)) <= win / 2.0
    reversing = jnp.asarray(speed) < -1e-3
    unpassed = unpassed | (reversing & unpassed_rev)
    any_unpassed = jnp.any(unpassed & valid)

    BIG = 1e6
    # Prefer valid, then unpassed, then near.
    score = dist + BIG * (~valid) + 0.5 * BIG * (unpassed ^ True) * any_unpassed
    k = min(cfg.num_obs, all_obs.shape[0])
    _, idx = jax.lax.top_k(-score, k)
    sel = all_obs[idx]
    sel_valid = valid[idx] & ~(
        any_unpassed & ~unpassed[idx]
    )  # drop passed rows when unpassed ones exist (reference behavior)
    sel = jnp.where(sel_valid[:, None], sel, dummy_obstacle(sel.dtype)[None, :])
    if k < cfg.num_obs:
        pad = jnp.tile(dummy_obstacle(sel.dtype), (cfg.num_obs - k, 1))
        sel = jnp.concatenate([sel, pad], axis=0)
    return sel


def _collides(spec, pos, obs):
    """Circle / superellipsoid collision oracle (tracking.py:445-488)."""
    r = spec.radius
    circle_hit = jnp.linalg.norm(pos - obs[:2]) < obs[OBS_R] + r

    # superellipsoid inside-test (tracking.py:473-487)
    a = jnp.maximum(jnp.abs(obs[2]), 1e-3)
    b = jnp.maximum(jnp.abs(obs[3]), 1e-3)
    e = jnp.maximum(jnp.abs(obs[4]), 2.0)
    th = obs[5]
    ct, st = jnp.cos(th), jnp.sin(th)
    px = ct * (pos[0] - obs[0]) + st * (pos[1] - obs[1])
    py = -st * (pos[0] - obs[0]) + ct * (pos[1] - obs[1])
    h = (
        jnp.power(jnp.abs(px) / (a + r), e)
        + jnp.power(jnp.abs(py) / (b + r), e)
        - 1.0
    )
    se_hit = h <= 0.0

    is_se = (obs[OBS_FLAG] >= 0.5) & (obs[4] >= 2.0)
    return jnp.where(is_dummy(obs), False, jnp.where(is_se, se_hit, circle_hit))


def collision_any(spec, pos, obs_sets):
    hits = jax.vmap(lambda o: _collides(spec, pos, o))(obs_sets)
    return jnp.any(hits)


def step(
    cfg: TrackerConfig,
    spec,
    state: TrackerState,
    waypoints: jnp.ndarray,  # (W, >=2) padded waypoint array
    n_waypoints,  # int32 scalar, actual count
    known_obs: jnp.ndarray,  # (Kk, 7) padded
    unknown_obs: Optional[jnp.ndarray] = None,  # (Ku, 7) padded or None
) -> StepOutput:
    """One control step (tracking.py:559-668)."""
    model = get_model(cfg.model_name)
    dtype = state.x.dtype
    x, yaw, mode, goal_idx = state.x, state.yaw, state.mode, state.goal_idx
    pos = model.barrier_pos(x)
    heading = orientation_of(cfg, x, yaw)
    W = waypoints.shape[0]

    # ---- state machine + goal update (tracking.py:569-577, 497-535) -------
    stopped = model.has_stopped(x, spec)
    mode = jnp.where(
        (mode == STOP) & stopped,
        jnp.where(cfg.enable_rotation, ROTATE, TRACK),
        mode,
    )

    # waypoint advance
    wp = waypoints[jnp.clip(goal_idx, 0, W - 1), :2].astype(dtype)
    reached = (
        (jnp.linalg.norm(pos - wp) < cfg.reached_threshold)
        & (goal_idx < n_waypoints)
        & (mode != STOP)
    )
    goal_idx = jnp.where(reached, goal_idx + 1, goal_idx)
    all_done = goal_idx >= n_waypoints
    mode = jnp.where(all_done & (mode != STOP), IDLE, mode)
    wp = waypoints[jnp.clip(goal_idx, 0, W - 1), :2].astype(dtype)

    # rotate-alignment check (tracking.py:506-519, normalized delta)
    goal_angle = jnp.arctan2(wp[1] - pos[1], wp[0] - pos[0])
    aligned = jnp.abs(angle_normalize(heading - goal_angle)) <= cfg.rotation_threshold
    skip_rotate = cfg.model_name in _SKIP_ROTATE or not cfg.enable_rotation
    mode = jnp.where(
        (mode == ROTATE) & (aligned | skip_rotate) & ~all_done, TRACK, mode
    )

    # ---- perception (tracking.py:580-586) ---------------------------------
    mem = state.mem
    if cfg.use_sensor and unknown_obs is not None:
        if cfg.detection_mode == "ray":
            # Legacy 'ray' mode (utils/detection.py:90-132): obstacles are
            # detected through the accumulated sensing footprint, and the
            # controller sees only the CURRENT detections — persistent
            # memory is fov-mode-only in the reference (robot.py:811-834).
            det, det_mask = fov_mod.detect_unknown_obs_ray(
                pos, unknown_obs, state.footprint, cfg.grid
            )
            detected_slots = jnp.where(
                det_mask[:, None], det, dummy_obstacle(dtype)[None, :]
            )
        else:
            det, det_mask = fov_mod.detect_unknown_obs_fov(
                pos, heading, unknown_obs, spec
            )
            mem = fov_mod.merge_memory(mem, det, det_mask)
            detected_slots = jnp.where(
                mem.valid[:, None], mem.slots, dummy_obstacle(dtype)[None, :]
            )
        all_obs = jnp.concatenate([known_obs, detected_slots], axis=0)
    else:
        all_obs = known_obs
    # Signed speed for the motion-aware window (x[3] on v-state models).
    model_n = get_model(cfg.model_name).N_STATES
    speed = x[3] if (cfg.model_name not in _INTEGRATORS and model_n >= 4) else 0.0
    obs_sel = select_obstacles(cfg, spec, pos, heading, all_obs, speed)

    # ---- nominal input (tracking.py:589-604) ------------------------------
    if cfg.pos_controller == "optimal_decay_cbf_qp":
        # The reference feeds softer nominal gains to the optimal-decay QP
        # (tracking.py:600-601: k_omega=3.0, k_a=0.5, k_v=0.5).
        spec_nom = spec.replace(
            nominal_k_omega=3.0, nominal_k_a=0.5, nominal_k_v=0.5
        )
    else:
        spec_nom = spec
    u_track = model.nominal_input(x, wp, spec_nom)
    u_stop = model.stop(x, spec)
    if cfg.model_name in _INTEGRATORS:
        u_rotate = u_stop
    else:
        u_rotate = model.rotate_to(x, goal_angle, spec)
    u_ref = jnp.where(
        mode == TRACK, u_track, jnp.where(mode == ROTATE, u_rotate, u_stop)
    )

    # ---- position controller (tracking.py:606-616) ------------------------
    mpc_xs = None  # (N+1, n) prediction, published for the yaw gatekeeper
    if cfg.pos_controller == "cbf_qp":
        qp = cbf_qp_mod.solve(
            cfg.model_name, spec, x, u_ref, obs_sel, cfg.dt,
            mode=cfg.cbf_mode, iters=cfg.qp_iters,
        )
        u, feasible = qp.u, qp.feasible
        mpc_state = state.mpc
    elif cfg.pos_controller == "optimal_decay_cbf_qp":
        # Nearest obstacle only, like the reference (:135-155).
        od = od_qp_mod.solve(
            cfg.model_name, spec, x, u_ref, obs_sel[0], cfg.dt, iters=cfg.qp_iters
        )
        u, feasible = od.u, od.feasible
        mpc_state = state.mpc
    elif cfg.uses_mpc:
        goal_full = jnp.zeros((model.N_STATES,), dtype=dtype).at[:2].set(wp)
        res = mpc_mod.solve(
            cfg.model_name,
            spec,
            x,
            goal_full,
            obs_sel[: cfg.mpc.num_obs],
            state.u_prev,
            state.mpc,
            cfg.dt,
            cfg.mpc,
        )
        # MPC only acts in 'track'; otherwise pass the reference through
        # (mpc_cbf.py:379-381).
        u = jnp.where(mode == TRACK, res.u, u_ref)
        # Reference parity: MPC status is hardcoded 'optimal' (mpc_cbf.py:10),
        # so by default solver stress NEVER fails a run — the best-effort
        # control is applied and only an actual collision triggers -2.  The
        # strict mode (cfg.strict_mpc_feasibility) instead lets genuine
        # infeasibility fail the step like a failed QP would.
        if cfg.strict_mpc_feasibility:
            feasible = res.feasible | (mode != TRACK)
        else:
            feasible = jnp.asarray(True)
        mpc_state = res.state
        mpc_xs = res.xs
    else:
        raise ValueError(f"unknown pos controller {cfg.pos_controller}")

    # ---- attitude controller (tracking.py:621-624, factory :156-181) ------
    gk_state = state.att_gk
    if cfg.model_name in _INTEGRATORS and cfg.att_controller != "none":
        if cfg.att_controller == "velocity_tracking_yaw":
            u_att_track = velocity_tracking_yaw(cfg.model_name, spec, x, yaw, u)
        elif cfg.att_controller == "simple":
            # Constant yaw rate (simple_attitude.py:21).
            u_att_track = jnp.asarray(spec.w_max, dtype)
        elif cfg.att_controller == "visibility_area":
            u_att_track = vis_mod.visibility_area_yaw(
                state.footprint, cfg.grid, pos, yaw, spec
            )
        elif cfg.att_controller == "visibility_raycast":
            u_att_track = vis_mod.visibility_raycast_yaw(
                state.footprint, cfg.grid, pos, yaw, spec
            )
        elif cfg.att_controller == "gatekeeper":
            # Positional prediction: the MPC trajectory when available, else a
            # zero-control rollout from the current state — exactly the
            # reference's opt_x_num pull + constant-velocity fallback
            # (gatekeeper_attitude.py:159-241).
            T = cfg.gk_att.total_steps
            x_pred = mpc_xs if mpc_xs is not None else x[None, :]
            x_pred = gk_att_mod.extend_prediction(model, spec, x_pred, cfg.dt, T)
            pos_traj = x_pred[:, :2]
            if model.N_STATES >= 4:
                vel_traj = x_pred[:, 2:4]
            else:  # SingleIntegrator2D: velocity from position differences
                dp = jnp.diff(pos_traj, axis=0) / cfg.dt
                vel_traj = jnp.concatenate([dp, dp[-1:]], axis=0)
            u_att_track, gk_new, _ = gk_att_mod.step(
                cfg.gk_att, spec, cfg.model_name, state.att_gk,
                state.footprint, cfg.grid, pos_traj, vel_traj, yaw,
            )
            # The reference invokes the attitude controller only in 'track'
            # (tracking.py:621); freeze its commitment state otherwise.
            gk_state = jax.tree_util.tree_map(
                lambda new, old: jnp.where(mode == TRACK, new, old),
                gk_new, state.att_gk,
            )
        else:
            raise ValueError(f"unknown att controller {cfg.att_controller}")
        u_att_rotate = model.yaw_rate_to(yaw, goal_angle, spec)
        u_att = jnp.where(
            mode == TRACK, u_att_track, jnp.where(mode == ROTATE, u_att_rotate, 0.0)
        )
        yaw_next = angle_normalize(yaw + u_att * cfg.dt)
    else:
        u_att = jnp.asarray(0.0, dtype)
        yaw_next = yaw

    # ---- verdicts + integration (tracking.py:626-646) ---------------------
    # The oracle checks GROUND-TRUTH obstacles (known + raw unknown,
    # tracking.py:456-470), not the detections the controller sees — in 'ray'
    # mode fitted circles can differ from the real geometry.
    if cfg.use_sensor and unknown_obs is not None:
        oracle_obs = jnp.concatenate([known_obs, unknown_obs], axis=0)
    else:
        oracle_obs = all_obs
    collide_pre = collision_any(spec, pos, oracle_obs)
    x_next = model.step(x, u, spec, cfg.dt)
    pos_next = model.barrier_pos(x_next)
    collide_post = collision_any(spec, pos_next, oracle_obs)
    if cfg.model_name == spec_mod.VTOL_2D:
        # VTOL ground-strike / pitch-limit terms of the collision oracle
        # (tracking.py:488-495).  The reference compares the pitch state
        # (radians) against robot_spec['pitch_max'] whose default is 15.0
        # *degrees* (vtol2D.py:110) — at defaults that check can never fire
        # (15 rad), while the MPC separately enforces the converted bound
        # (mpc_cbf.py:231-232).  'reference' mode reproduces that literally;
        # 'strict' applies the clearly intended degrees->radians conversion
        # (transient AL-softened bound overshoot then terminates the run).
        if cfg.vtol_pitch_oracle == "strict":
            pitch_lim = jnp.deg2rad(spec.pitch_max)
        else:
            pitch_lim = jnp.asarray(spec.pitch_max, dtype)
        collide_pre = collide_pre | (x[1] < 0.0) | (jnp.abs(x[2]) > pitch_lim)
        collide_post = (
            collide_post | (x_next[1] < 0.0) | (jnp.abs(x_next[2]) > pitch_lim)
        )
    bad = (~feasible) | collide_pre | collide_post

    # Yaw of heading models tracks theta (robots/robot.py:441-453).
    if cfg.model_name not in _INTEGRATORS:
        yaw_next = x_next[2]

    # ---- sensing footprint + visibility violation (tracking.py:652-668) ---
    footprint = state.footprint
    beyond = jnp.asarray(False)
    safety_mask = jnp.zeros((1, 1), dtype=bool)
    if cfg.grid is not None and cfg.use_sensor:
        footprint = grid_mod.update_footprint(
            footprint, cfg.grid, pos_next, yaw_next, spec
        )
        if cfg.visibility_mode == "safety_area":
            is_integrator = cfg.model_name in _INTEGRATORS
            # Speed + yaw rate per model (robots/robot.py:656-676, 367-381):
            # the decelerating-arc branch runs whenever the live yaw rate is
            # non-zero, exactly like update_safety_area.
            if cfg.model_name == spec_mod.SINGLE_INTEGRATOR_2D:
                vel, v_mag = u[:2], jnp.linalg.norm(u[:2])
                yaw_rate = u_att
            elif cfg.model_name == spec_mod.DOUBLE_INTEGRATOR_2D:
                vel, v_mag = x_next[2:4], jnp.linalg.norm(x_next[2:4])
                yaw_rate = u_att
            elif cfg.model_name == spec_mod.UNICYCLE_2D:
                vel, v_mag, yaw_rate = None, u[0], u[1]
            elif cfg.model_name in (spec_mod.QUAD_2D, spec_mod.VTOL_2D):
                vel, v_mag = None, jnp.linalg.norm(x_next[3:5])
                yaw_rate = x_next[5]
            elif cfg.model_name == spec_mod.QUAD_3D:
                vel, v_mag = None, jnp.linalg.norm(x_next[6:9])
                yaw_rate = x_next[11]
            else:  # DynamicUnicycle2D / KinematicBicycle2D family
                vel, v_mag = None, x_next[3] if model.N_STATES >= 4 else 0.0
                yaw_rate = u[1]
            tube = grid_mod.safety_area_mask(
                cfg.grid, pos_next, yaw_next, v_mag, yaw_rate, spec, cfg.dt,
                max_decel=cfg.max_decel, max_ang_decel=cfg.max_ang_decel,
                integrator=is_integrator, vel=vel,
            )
            safety_mask = tube
            beyond = grid_mod.is_beyond_footprint(
                footprint, cfg.grid, pos_next, safety_mask=tube
            )
        else:
            beyond = grid_mod.is_beyond_footprint(footprint, cfg.grid, pos_next)

    ret = jnp.where(
        bad,
        RET_INFEASIBLE,
        jnp.where(
            all_done & (mode != STOP),
            RET_DONE,
            jnp.where(beyond, RET_VISIBILITY, RET_OK),
        ),
    ).astype(jnp.int32)

    # Freeze the robot on terminal codes so scanned batches stay put.
    # Terminal codes are -1/-2; a visibility violation (+1) does NOT stop the
    # run (the reference merely accumulates it, tracking.py:723-741).
    frozen = state.ret < 0
    x_out = jnp.where(frozen, state.x, x_next)
    new_state = TrackerState(
        x=x_out,
        yaw=jnp.where(frozen, state.yaw, yaw_next),
        mode=jnp.where(frozen, state.mode, mode).astype(jnp.int32),
        goal_idx=jnp.where(frozen, state.goal_idx, goal_idx).astype(jnp.int32),
        u_prev=jnp.where(frozen, state.u_prev, u),
        mpc=jax.tree_util.tree_map(
            lambda a, b: jnp.where(frozen, a, b), state.mpc, mpc_state
        ),
        mem=jax.tree_util.tree_map(
            lambda a, b: jnp.where(frozen, a, b), state.mem, mem
        ),
        ret=jnp.where(frozen, state.ret, ret).astype(jnp.int32),
        footprint=jnp.where(frozen, state.footprint, footprint),
        att_gk=jax.tree_util.tree_map(
            lambda a, b: jnp.where(frozen, a, b), state.att_gk, gk_state
        ),
    )
    return StepOutput(
        state=new_state, u=u, ret=new_state.ret, feasible=feasible, goal=wp,
        safety_mask=safety_mask,
    )


def run(
    cfg: TrackerConfig,
    spec,
    state: TrackerState,
    waypoints,
    n_waypoints,
    known_obs,
    n_steps: int,
    unknown_obs=None,
):
    """``run_all_steps`` analog (tracking.py:711-752) as one ``lax.scan``.

    Returns (final_state, trajectory dict of stacked per-step outputs).
    """

    def body(st, _):
        out = step(cfg, spec, st, waypoints, n_waypoints, known_obs, unknown_obs)
        return out.state, dict(x=out.state.x, u=out.u, ret=out.ret)

    final, traj = jax.lax.scan(body, state, None, length=n_steps)
    return final, traj


def step_dynamic_obstacles(obs, dt, x_range=None, y_range=None):
    """Advance constant-velocity dynamic obstacles one step.

    Mirrors dynamic_env/main.py:54-58 (``obs[:, 0:2] += obs[:, 3:5] * dt``),
    plus the demo's wall-bounce behavior (dynamic_env/main.py:238-366) when
    ``x_range``/``y_range`` are given: velocity components flip when the
    obstacle center leaves the workspace.
    """
    obs = obs.at[:, 0:2].add(obs[:, 3:5] * dt)
    if x_range is not None:
        flip_x = (obs[:, 0] < x_range[0]) | (obs[:, 0] > x_range[1])
        obs = obs.at[:, 3].multiply(jnp.where(flip_x, -1.0, 1.0))
    if y_range is not None:
        flip_y = (obs[:, 1] < y_range[0]) | (obs[:, 1] > y_range[1])
        obs = obs.at[:, 4].multiply(jnp.where(flip_y, -1.0, 1.0))
    return obs


def run_dynamic(
    cfg: TrackerConfig,
    spec,
    state: TrackerState,
    waypoints,
    n_waypoints,
    moving_obs,
    n_steps: int,
    x_range=None,
    y_range=None,
):
    """Dynamic-environment run loop (dynamic_env/main.py LocalTrackingControllerDyn):
    obstacles advance by their velocities every step (with optional bouncing)
    and are fed to the controller as the known set."""

    def body(carry, _):
        st, obs = carry
        out = step(cfg, spec, st, waypoints, n_waypoints, obs)
        obs = step_dynamic_obstacles(obs, cfg.dt, x_range, y_range)
        return (out.state, obs), dict(x=out.state.x, u=out.u, ret=out.ret)

    (final, obs_final), traj = jax.lax.scan(
        body, (state, moving_obs), None, length=n_steps
    )
    return final, obs_final, traj

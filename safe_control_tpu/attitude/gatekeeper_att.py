"""Gatekeeper applied to the yaw channel (exploration-safety shielding).

JAX re-implementation of
/root/reference/attitude_control/gatekeeper_attitude.py: the positional MPC
prediction is shielded in the *yaw* channel so the camera keeps the part of
the path that matters visible before the robot commits to it.

Faithful semantics (gatekeeper_attitude.py:504-609):

1. the positional prediction (MPC ``opt_x_num`` analog, or a zero-control
   rollout fallback, :159-241) is extended to cover nominal+backup horizon;
2. critical point = first predicted position that exits the known map
   (:314-353; here: first path cell outside the occupancy footprint — grid
   resolution instead of shapely bisection, documented delta);
3. reactive fallback: critical point within camera range but outside the
   current FoV -> immediate backup yaw, committed trajectory dropped
   (:520-546);
4. the crossing step CAPS the nominal horizon: ``max_nominal = min(max_
   nominal, crossing_step - backup_steps)`` so the backup always completes
   inside the known region (:568-574);
5. candidate = nominal (visibility-area yaw scored over the predicted path
   against the current footprint, :243-293 + visibility_area.py:106-167)
   prefix + velocity-tracking backup suffix; candidates are the backward
   search ``nominal_steps = max_nominal - i*discount_steps`` (:576-585);
6. validity (:387-453): (a) the critical point must enter the FoV cone
   (with camera range) before the braking-distance deadline; (b) at every
   step the braking-lookahead tube ALONG THE PATH (arc length, :434-479)
   must be covered by that step's instantaneous FoV sector;
7. commit the longest valid nominal prefix; if none is valid keep the
   previous commitment and retry after ``event_offset`` (:586-598); past
   the end of the committed segment, fall back to the live backup yaw
   (:600-606).

All of it is fixed-shape: the backward search is a ``vmap`` over candidate
prefixes + an argmax, the shapely sector/covers tests become cone-membership
reductions over sampled tube points and an occupancy-grid unexplored count.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from safe_control_tpu.core.types import angle_normalize
from safe_control_tpu.perception import grid as grid_mod


@dataclasses.dataclass(frozen=True)
class GatekeeperAttConfig:
    """Mirrors the reference's constructor/robot_spec knobs
    (gatekeeper_attitude.py:24-96)."""

    dt: float = 0.05
    nominal_horizon: float = 1.0  # [s] (:28)
    backup_horizon: float = 2.0  # [s] (:29)
    event_offset: float = 0.5  # [s] (:30)
    horizon_discount: float = 0.25  # [s] (= max(5 dt, dt), :46-48)
    validation_slack: float = 0.05  # (:70-72)
    tube_margin: float = 0.0  # (:73-75)
    braking_distance_scale: float = 1.0  # (:76-78)
    braking_distance_margin: float = 0.35  # radius + 0.10 default (:79-84)
    kp_vis: float = 1.5  # visibility_area_kp default (:135-140)
    kp_backup: float = 1.5  # velocity_tracking_yaw gain
    n_yaw_samples: int = 36  # visibility_area_n_yaw_samples (:141-145)
    n_tube_samples: int = 8

    @property
    def nominal_steps(self) -> int:
        import math

        return max(int(math.ceil(self.nominal_horizon / self.dt)), 0)

    @property
    def backup_steps(self) -> int:
        import math

        return max(int(math.ceil(self.backup_horizon / self.dt)), 1)

    @property
    def total_steps(self) -> int:
        return self.nominal_steps + self.backup_steps

    @property
    def discount_steps(self) -> int:
        import math

        return max(int(math.ceil(self.horizon_discount / self.dt)), 1)

    @property
    def event_offset_steps(self) -> int:
        import math

        return max(int(math.ceil(self.event_offset / self.dt)), 1)

    @property
    def num_candidates(self) -> int:
        return self.nominal_steps // self.discount_steps + 2


class GatekeeperAttState(NamedTuple):
    committed_u: jnp.ndarray  # (total_steps,) committed yaw rates
    committed_len: jnp.ndarray  # int32, valid length of committed_u
    time_idx: jnp.ndarray  # int32
    next_event_idx: jnp.ndarray  # int32
    initialized: jnp.ndarray  # bool
    # Replan statistics (gatekeeper_attitude.py:489-502).
    total_replans: jnp.ndarray
    accepted_replans: jnp.ndarray
    rejected_replans: jnp.ndarray
    nominal_steps_total: jnp.ndarray


def init_state(cfg: GatekeeperAttConfig) -> GatekeeperAttState:
    z = jnp.asarray(0, jnp.int32)
    return GatekeeperAttState(
        committed_u=jnp.zeros((cfg.total_steps,), jnp.float32),
        committed_len=z,
        time_idx=z,
        next_event_idx=z,
        initialized=jnp.asarray(False),
        total_replans=z,
        accepted_replans=z,
        rejected_replans=z,
        nominal_steps_total=z,
    )


def _in_fov(pos, yaw, point, spec, slack=0.0, check_range=True):
    """Cone membership (gatekeeper_attitude.py:377-386) with angular+range
    slack standing in for the reference's sector.buffer(slack)."""
    to_p = point - pos
    ang = jnp.abs(angle_normalize(jnp.arctan2(to_p[1], to_p[0]) - yaw))
    ok = ang <= spec.fov_angle / 2.0 + slack
    if check_range:
        ok = ok & (jnp.linalg.norm(to_p) <= spec.cam_range + slack)
    return ok


def max_braking_distance(cfg: GatekeeperAttConfig, spec, model_name: str):
    """_max_braking_distance (gatekeeper_attitude.py:355-375)."""
    if model_name == "DoubleIntegrator2D":
        base = spec.v_max**2 / (2.0 * jnp.maximum(spec.a_max, 1e-6))
    elif model_name == "SingleIntegrator2D":
        base = spec.v_max * cfg.dt
    else:
        base = spec.cam_range * 0.25
    return cfg.braking_distance_scale * base + cfg.braking_distance_margin


def visibility_targets(footprint, gs: grid_mod.GridSpec, positions, spec, n_yaw: int):
    """Per-step visibility-area target yaw along a predicted path.

    The reference's nominal controller is VisibilityAreaAtt evaluated at each
    predicted position against the CURRENT footprint (gatekeeper_attitude.py:
    243-270 rolls ``self.nominal_controller(pos_x, yaw, pos_u)`` which scores
    ``sector.difference(footprints).area`` over 36 yaws, visibility_area.py:
    106-167).  The argmax target is independent of the rolling yaw, so it is
    precomputed once per event: (T, n_yaw) unexplored-cell counts -> (T,)
    target yaws.
    """
    yaws = jnp.linspace(-jnp.pi, jnp.pi, n_yaw, endpoint=False)

    def score_at(p):
        def one(yw):
            sector = grid_mod.fov_mask(gs, p, yw, spec)
            return jnp.sum(sector & ~footprint)

        return jax.vmap(one)(yaws)

    scores = jax.vmap(score_at)(positions)  # (T, n_yaw)
    return yaws[jnp.argmax(scores, axis=1)]  # (T,)


def _arc_lookahead_points(path, brake_dist, n_pts: int):
    """For each start index i, the point at arc length ``brake_dist`` along
    the path polyline (``_critical_point_along_path``, gatekeeper_attitude.py:
    455-479), plus ``n_pts`` samples of the segment start->lookahead point."""
    T = path.shape[0]
    seg = jnp.linalg.norm(jnp.diff(path, axis=0), axis=1)  # (T-1,)
    cum = jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(seg)])  # (T,)

    def lookahead(i):
        target = cum[i] + brake_dist
        # first index j with cum[j] >= target (or last point)
        past = cum >= target - 1e-9
        j = jnp.where(jnp.any(past), jnp.argmax(past), T - 1)
        j = jnp.maximum(j, i)
        j0 = jnp.maximum(j - 1, 0)
        seg_len = jnp.maximum(cum[j] - cum[j0], 1e-9)
        alpha = jnp.clip((target - cum[j0]) / seg_len, 0.0, 1.0)
        cp = path[j0] + alpha * (path[j] - path[j0])
        return jnp.where(jnp.any(past), cp, path[T - 1])

    cps = jax.vmap(lookahead)(jnp.arange(T))  # (T, 2)
    ts = jnp.linspace(0.0, 1.0, n_pts)
    tube_pts = path[:, None, :] + ts[None, :, None] * (cps[:, None, :] - path[:, None, :])
    return cps, tube_pts  # (T,2), (T,n_pts,2)


def step(
    cfg: GatekeeperAttConfig,
    spec,
    model_name: str,
    state: GatekeeperAttState,
    footprint,
    gs: grid_mod.GridSpec,
    pos_traj,  # (T+1, 2) predicted positions (MPC prediction or fallback)
    vel_traj,  # (T+1, 2) predicted velocities (for the backup yaw)
    yaw,
):
    """One yaw-gatekeeper step (gatekeeper_attitude.py:503-609).

    Returns (u_att, new_state, info).
    """
    T = cfg.total_steps
    dt = cfg.dt
    nominal_steps = cfg.nominal_steps
    backup_steps = cfg.backup_steps

    # ---- critical point (:314-353, grid version) --------------------------
    def cell_known(p):
        ix = jnp.clip((p[0] / gs.resolution).astype(jnp.int32), 0, gs.nx - 1)
        iy = jnp.clip((p[1] / gs.resolution).astype(jnp.int32), 0, gs.ny - 1)
        return footprint[ix, iy]

    known = jax.vmap(cell_known)(pos_traj)
    has_crossing = jnp.any(~known)
    crossing_step = jnp.argmax(~known).astype(jnp.int32)
    critical_point = pos_traj[crossing_step]

    brake_dist = max_braking_distance(cfg, spec, model_name)

    # ---- backup yaw-rate law (velocity_tracking_yaw.py:35-64) -------------
    def backup_rate(vel, yw):
        des = jnp.arctan2(vel[1], vel[0])
        moving = jnp.linalg.norm(vel) > 1e-2
        return jnp.where(
            moving,
            jnp.clip(cfg.kp_backup * angle_normalize(des - yw), -spec.w_max, spec.w_max),
            0.0,
        )

    live_backup = backup_rate(vel_traj[0], yaw)

    # ---- reactive fallback (:520-546) --------------------------------------
    cp_dist = jnp.linalg.norm(critical_point - pos_traj[0])
    cp_in_range = cp_dist <= spec.cam_range + cfg.validation_slack
    cp_visible = _in_fov(pos_traj[0], yaw, critical_point, spec, 0.0, check_range=True)
    reactive = has_crossing & cp_in_range & ~cp_visible

    # ---- event: backward search over nominal prefixes (:558-598) ----------
    event = (state.time_idx >= state.next_event_idx) | ~state.initialized

    # Cap the nominal horizon so the backup completes inside the known region
    # (:568-574): latest_nominal = max(crossing_step - backup_steps, 0).
    latest_nominal = jnp.maximum(crossing_step - backup_steps, 0)
    max_nominal = jnp.where(
        has_crossing, jnp.minimum(nominal_steps, latest_nominal), nominal_steps
    ).astype(jnp.int32)

    # Nominal yaw rollout, shared by every candidate prefix (:243-270).
    vis_targets = visibility_targets(
        footprint, gs, pos_traj[:T], spec, cfg.n_yaw_samples
    )

    def nominal_rate(k, yw):
        return jnp.clip(
            cfg.kp_vis * angle_normalize(vis_targets[k] - yw), -spec.w_max, spec.w_max
        )

    def roll_candidate(nom_len):
        def body(yw, k):
            rate = jnp.where(
                k < nom_len, nominal_rate(k, yw), backup_rate(vel_traj[k], yw)
            )
            return angle_normalize(yw + rate * dt), (yw, rate)

        _, (yaws_k, rates) = jax.lax.scan(body, yaw, jnp.arange(T))
        return yaws_k, rates  # yaw at the START of each step, rate applied

    cand_lens = jnp.maximum(
        max_nominal - jnp.arange(cfg.num_candidates, dtype=jnp.int32) * cfg.discount_steps,
        0,
    )
    cand_yaws, cand_rates = jax.vmap(roll_candidate)(cand_lens)
    cand_total = jnp.minimum(cand_lens + backup_steps, T)  # committed length

    # ---- validity (:387-453) ----------------------------------------------
    path = pos_traj[:T]
    d_to_cp = jnp.linalg.norm(path - critical_point[None, :], axis=1)
    within_brake = d_to_cp <= brake_dist + cfg.validation_slack
    deadline = jnp.minimum(
        crossing_step,
        jnp.where(jnp.any(within_brake), jnp.argmax(within_brake), T - 1),
    )
    deadline = jnp.clip(deadline, 0, T - 1)

    _, tube_pts = _arc_lookahead_points(path, brake_dist, cfg.n_tube_samples)

    def candidate_valid(yaws_k, n_states):
        in_cand = jnp.arange(T) < n_states
        # (a) critical point seen (cone + camera range) before the deadline
        sees = jax.vmap(
            lambda k: _in_fov(
                path[k], yaws_k[k], critical_point, spec, cfg.validation_slack
            )
        )(jnp.arange(T))
        seen_cum = jnp.cumsum((sees & in_cand).astype(jnp.int32)) > 0
        global_ok = seen_cum[jnp.minimum(deadline, n_states - 1)]

        # (b) stepwise braking tube inside the instantaneous FoV sector
        def tube_ok(k):
            ok = jax.vmap(
                lambda p: _in_fov(
                    path[k], yaws_k[k], p, spec,
                    cfg.validation_slack + cfg.tube_margin,
                )
            )(tube_pts[k])
            return jnp.all(ok)

        tubes = jax.vmap(tube_ok)(jnp.arange(T))
        tubes_ok = jnp.all(tubes | ~in_cand)
        return jnp.where(has_crossing, global_ok & tubes_ok, True)

    cand_valid = jax.vmap(candidate_valid)(cand_yaws, cand_total)
    found = jnp.any(cand_valid)
    best = jnp.argmax(cand_valid)  # first valid = longest nominal prefix

    commit = event & found
    committed_u = jnp.where(commit, cand_rates[best], state.committed_u)
    committed_len = jnp.where(commit, cand_total[best], state.committed_len).astype(
        jnp.int32
    )
    time_idx = jnp.where(commit, 0, state.time_idx).astype(jnp.int32)
    next_event = jnp.where(
        commit,
        cfg.event_offset_steps,
        jnp.where(event, state.time_idx + cfg.event_offset_steps, state.next_event_idx),
    ).astype(jnp.int32)

    # ---- emit (:600-606): committed rate, or live backup past the end -----
    in_committed = time_idx < committed_len
    u_att = jnp.where(
        in_committed, committed_u[jnp.clip(time_idx, 0, T - 1)], live_backup
    )

    # Reactive fallback overrides everything and drops the commitment (:533-546).
    u_att = jnp.where(reactive, live_backup, u_att)
    committed_len = jnp.where(reactive, 0, committed_len).astype(jnp.int32)
    time_idx = jnp.where(reactive, 0, time_idx).astype(jnp.int32)
    next_event = jnp.where(reactive, 0, next_event).astype(jnp.int32)

    u_att = jnp.clip(u_att, -spec.w_max, spec.w_max)

    nominal_committed = jnp.where(commit & ~reactive, cand_lens[best], 0)
    new_state = GatekeeperAttState(
        committed_u=committed_u,
        committed_len=committed_len,
        time_idx=(time_idx + 1).astype(jnp.int32),
        next_event_idx=next_event,
        initialized=jnp.asarray(True),
        total_replans=state.total_replans + jnp.where(event & ~reactive, 1, 0),
        accepted_replans=state.accepted_replans + jnp.where(commit & ~reactive, 1, 0),
        rejected_replans=state.rejected_replans
        + jnp.where((event & ~found) | reactive, 1, 0),
        nominal_steps_total=state.nominal_steps_total + nominal_committed,
    )
    info = dict(
        event=event,
        found=found,
        reactive=reactive,
        nominal_len=cand_lens[best],
        crossing=has_crossing,
        crossing_step=crossing_step,
        critical_point=critical_point,
    )
    return u_att, new_state, info


def extend_prediction(model, spec, x_pred, dt: float, total_steps: int):
    """Extend a positional prediction to ``total_steps + 1`` states with a
    zero-control rollout (gatekeeper_attitude.py:222-241 extends the MPC
    prediction by stepping the dynamics with zero input).

    ``x_pred`` is (P, n) predicted states (P >= 1).  Returns (total_steps+1, n).
    """
    P = x_pred.shape[0]
    need = total_steps + 1 - P
    if need <= 0:
        return x_pred[: total_steps + 1]
    u0 = jnp.zeros((model.N_CONTROLS,), dtype=x_pred.dtype)

    def body(xk, _):
        x1 = model.step(xk, u0, spec, dt)
        return x1, x1

    _, tail = jax.lax.scan(body, x_pred[-1], None, length=need)
    return jnp.concatenate([x_pred, tail], axis=0)

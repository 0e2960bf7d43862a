"""Heterogeneous fleets: multiple model families in one compiled program.

BASELINE.json anchor config 5: a heterogeneous multi-robot fleet
(unicycle + bicycle + quad + ...) with shielding, thousands of agents
batched across devices.  Model dispatch is static (jit specializes per
model), so a heterogeneous fleet is a *struct of homogeneous groups*: one
vmapped scan per model family, all inside one jit — XLA schedules the
groups' programs back-to-back on the chip, and a shared obstacle set
couples them.

Fleet-shared obstacles: each group can treat the OTHER robots' positions as
dynamic obstacles (fleet coupling); positions are gathered across groups
between chunks (and across devices via the scenario mesh when sharded).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from safe_control_tpu.core import spec as spec_mod
from safe_control_tpu.core.types import dummy_obstacle
from safe_control_tpu.dynamics import get_model
from safe_control_tpu.shielding import gatekeeper as gk_mod
from safe_control_tpu.sim import tracking


@dataclasses.dataclass(frozen=True)
class FleetGroup:
    """Static description of one homogeneous sub-fleet."""

    cfg: tracking.TrackerConfig
    count: int
    robot_radius: float = 0.25  # radius other groups see as an obstacle


class FleetState(NamedTuple):
    trackers: Tuple[tracking.TrackerState, ...]  # one batched state per group


def init_fleet(
    groups: List[FleetGroup], specs, x0s: List[jnp.ndarray], waypoints_list
) -> FleetState:
    """``x0s[i]``: (count_i, n_i) initial states per group."""
    states = []
    for g, spec, x0, wps in zip(groups, specs, x0s, waypoints_list):
        st = jax.vmap(
            lambda x: tracking.init_state(g.cfg, spec, x, 0.0, first_goal=wps[0])
        )(x0)
        states.append(st)
    return FleetState(trackers=tuple(states))


def fleet_positions(groups: List[FleetGroup], state: FleetState) -> jnp.ndarray:
    """(total, 3) rows [x, y, radius] of every robot in the fleet."""
    rows = []
    for g, st in zip(groups, state.trackers):
        model = get_model(g.cfg.model_name)
        pos = jax.vmap(model.barrier_pos)(st.x)
        rows.append(
            jnp.concatenate(
                [pos, jnp.full((g.count, 1), g.robot_radius)], axis=1
            )
        )
    return jnp.concatenate(rows, axis=0)


def step_fleet(
    groups: List[FleetGroup],
    specs,
    state: FleetState,
    waypoints_list,
    n_waypoints_list,
    known_obs,
    inter_robot: bool = True,
    n_steps: int = 1,
    coupling_margin: float = 0.3,
):
    """Advance every group ``n_steps``; optionally feed other robots'
    positions (held fixed within the chunk) as obstacles.

    NOTE: the reference's multi-robot example has NO robot-robot coupling
    at all (examples/test_multi_robot.py:77-84 — robots pass through each
    other); this coupling is additional capability.  Because the circle
    HOCBF models other robots as static, ``coupling_margin`` inflates their
    published radii to absorb mutual motion within a control period."""
    offs = np.cumsum([0] + [g.count for g in groups])
    if inter_robot:
        allpos = fleet_positions(groups, state)  # (total, 3)
        # Margin goes into the CONSTRAINT rows only; the collision oracle in
        # tracking.step would otherwise flag margin contact as collision.
        # (Callers can alternatively raise spec.cbf_beta.)

    new_states = []
    for gi, (g, spec, st) in enumerate(zip(groups, specs, state.trackers)):
        if inter_robot:
            others = jnp.concatenate(
                [allpos[: offs[gi]], allpos[offs[gi] + g.count :]], axis=0
            )
            # Keep the nearest few as 7-vector obstacles, per robot.
            def obs_for(x_row):
                model = get_model(g.cfg.model_name)
                p = model.barrier_pos(x_row)
                d = jnp.linalg.norm(others[:, :2] - p[None, :], axis=1)
                k = min(4, others.shape[0])
                _, idx = jax.lax.top_k(-d, k)
                sel = others[idx]
                rows = jnp.concatenate(
                    [sel[:, :2], sel[:, 2:3] + coupling_margin, jnp.zeros((k, 4))],
                    axis=1,
                )
                return jnp.concatenate([known_obs, rows], axis=0)

            obs_batch = jax.vmap(obs_for)(st.x)
        else:
            obs_batch = jnp.tile(known_obs[None], (g.count, 1, 1))

        wps = waypoints_list[gi]
        n_wps = n_waypoints_list[gi]

        def one(tr, obs, wps_r):
            def body(t, _):
                out = tracking.step(g.cfg, spec, t, wps_r, n_wps, obs)
                return out.state, None

            tr, _ = jax.lax.scan(body, tr, None, length=n_steps)
            return tr

        if wps.ndim == 3:  # per-robot waypoints (count, W, 2)
            new_states.append(jax.vmap(one)(st, obs_batch, wps))
        else:
            new_states.append(
                jax.vmap(one, in_axes=(0, 0, None))(st, obs_batch, wps)
            )
    return FleetState(trackers=tuple(new_states))


# ===================== gatekeeper-shielded fleets ==========================
# BASELINE anchor config 5 is "heterogeneous 4k-agent fleet WITH GATEKEEPER
# SHIELDING".  Architecture mirrors the reference's shielded examples
# (drift/evade): the gatekeeper OWNS the applied control — nominal = the
# PD waypoint-tracking policy, backup = a deadbeat brake policy (the
# discrete-time version of the reference's StoppingController,
# /root/reference/position_control/backup_controller.py:261-417), and the
# per-robot commitment machinery is shielding/gatekeeper.py:553-665 made
# batched: the per-robot ``GatekeeperState`` vmaps.  The moving-obstacle
# check defaults to COMMITMENT SHARING — each robot validates against the
# other robots' committed trajectories (see ``step_fleet_shielded``) —
# with the reference's constant-velocity prediction model
# (envs/drifting_env.py:486-673) available as a comparison mode.


@dataclasses.dataclass(frozen=True)
class ShieldedGroup:
    """One homogeneous sub-fleet under gatekeeper shielding."""

    model_name: str
    count: int
    gk: gk_mod.GatekeeperConfig
    robot_radius: float = 0.25
    reached_threshold: float = 0.3
    safety_margin: float = 0.1  # inter-robot margin on top of radii sum


class ShieldedFleetState(NamedTuple):
    x: Tuple[jnp.ndarray, ...]  # per group (count, n)
    goal_idx: Tuple[jnp.ndarray, ...]  # per group (count,) int32
    gk: Tuple[gk_mod.GatekeeperState, ...]  # per group, vmapped
    backup_steps: Tuple[jnp.ndarray, ...]  # per group (count,) int32 cumulative
    commits: Tuple[jnp.ndarray, ...]  # per group (count,) int32 cumulative


# --- shielded-fleet model-family registries --------------------------------
# Shielding soundness rests on BOTH of these being correct for every family
# in the fleet: the brake policy must actually PARK the robot inside the
# validated backup window (an exponential ``model.stop`` never reaches
# zero and keeps creeping past the validated horizon), and the planar
# velocity feeds the constant-velocity neighbor prediction every OTHER
# robot validates its commitments against (zeros would silently validate
# against static ghosts of a moving robot).  Unsupported families therefore
# RAISE at fleet-construction time instead of silently degrading — register
# model-specific implementations via the two ``register_*`` functions.


def _di_brake(spec, dt):
    def brake(x):
        a = -x[2:4] / dt
        mag = jnp.linalg.norm(a)
        return a * jnp.where(
            mag > spec.a_max, spec.a_max / jnp.maximum(mag, 1e-9), 1.0
        )
    return brake


def _heading_speed_brake(spec, dt):
    try:
        if float(spec.v_min) > 0.0:
            raise ValueError(
                f"{spec.model}: spec.v_min={float(spec.v_min)} > 0 — the "
                "model's step clamp keeps it moving forever, so a brake "
                "backup can never park it and shielded-fleet commitments "
                "would be unsound.  Configure the group's spec with "
                "v_min=0 (the reference's KinematicBicycle2D default of "
                "0.2 models a minimum-speed vehicle, which cannot join a "
                "brake-backup fleet)."
            )
    except TypeError:  # traced spec: checked at concrete build sites
        pass

    def brake(x):
        a = jnp.clip(-x[3] / dt, -spec.a_max, spec.a_max)
        return jnp.array([a, 0.0], dtype=x.dtype)
    return brake


def _di_planar_velocity(x):
    return x[2:4]


def _heading_speed_planar_velocity(x):
    return x[3] * jnp.array([jnp.cos(x[2]), jnp.sin(x[2])])


# builders: (spec, dt) -> (x -> u) deadbeat full-brake policy that parks
# within ceil(v0 / (a_max dt)) steps and HOLDS (the discrete-time version
# of the reference's StoppingController, backup_controller.py:261-417)
BRAKE_REGISTRY = {
    spec_mod.DOUBLE_INTEGRATOR_2D: _di_brake,
    spec_mod.DYNAMIC_UNICYCLE_2D: _heading_speed_brake,
    spec_mod.KINEMATIC_BICYCLE_2D: _heading_speed_brake,
    spec_mod.KINEMATIC_BICYCLE_2D_C3BF: _heading_speed_brake,
    spec_mod.KINEMATIC_BICYCLE_2D_DPCBF: _heading_speed_brake,
}

# x -> (2,) ground-plane velocity for constant-velocity neighbor prediction
PLANAR_VELOCITY_REGISTRY = {
    spec_mod.DOUBLE_INTEGRATOR_2D: _di_planar_velocity,
    spec_mod.DYNAMIC_UNICYCLE_2D: _heading_speed_planar_velocity,
    spec_mod.KINEMATIC_BICYCLE_2D: _heading_speed_planar_velocity,
    spec_mod.KINEMATIC_BICYCLE_2D_C3BF: _heading_speed_planar_velocity,
    spec_mod.KINEMATIC_BICYCLE_2D_DPCBF: _heading_speed_planar_velocity,
}


def register_brake_policy(model_name: str, builder) -> None:
    """Register a deadbeat brake-policy builder ``(spec, dt) -> (x -> u)``
    for a model family; required before that family can join a shielded
    fleet.  The policy must reach zero velocity within the validated backup
    window and hold."""
    BRAKE_REGISTRY[model_name] = builder


def register_planar_velocity(model_name: str, fn) -> None:
    """Register ``x -> (2,) planar velocity`` for a model family (feeds the
    constant-velocity neighbor prediction other robots validate against)."""
    PLANAR_VELOCITY_REGISTRY[model_name] = fn


def _brake_policy(model_name: str, spec, dt: float):
    try:
        return BRAKE_REGISTRY[model_name](spec, dt)
    except KeyError:
        raise KeyError(
            f"no registered shielded-fleet brake policy for {model_name!r}; "
            "register one with parallel.fleet.register_brake_policy (a "
            "silent model.stop fallback would creep past the validated "
            "backup window)"
        ) from None


def _planar_velocity(model_name: str, x):
    try:
        return PLANAR_VELOCITY_REGISTRY[model_name](x)
    except KeyError:
        raise KeyError(
            f"no registered planar-velocity extractor for {model_name!r}; "
            "register one with parallel.fleet.register_planar_velocity (a "
            "silent zeros fallback would validate commitments against "
            "static ghosts of a moving robot)"
        ) from None


def init_shielded_fleet(
    groups: List[ShieldedGroup], x0s: List[jnp.ndarray]
) -> ShieldedFleetState:
    for g in groups:  # fail at construction, not mid-trace
        if g.model_name not in BRAKE_REGISTRY:
            _brake_policy(g.model_name, None, 0.0)
        if g.model_name not in PLANAR_VELOCITY_REGISTRY:
            _planar_velocity(g.model_name, None)
    xs, gidx, gks, bsteps, commits = [], [], [], [], []
    for g, x0 in zip(groups, x0s):
        xs.append(jnp.asarray(x0))
        gidx.append(jnp.zeros((g.count,), jnp.int32))
        gks.append(
            jax.vmap(lambda _: gk_mod.init_state(g.gk))(jnp.arange(g.count))
        )
        bsteps.append(jnp.zeros((g.count,), jnp.int32))
        commits.append(jnp.zeros((g.count,), jnp.int32))
    return ShieldedFleetState(
        x=tuple(xs), goal_idx=tuple(gidx), gk=tuple(gks),
        backup_steps=tuple(bsteps), commits=tuple(commits),
    )


def _committed_pos_table(g, model, dt, Ltab, st_x, gk_st):
    """(count, Ltab, 2) future positions robot-by-robot: the robot's OWN
    committed trajectory read from its current time index (what it will
    actually do if it keeps following its commitment — including the parked
    backup terminus), with a constant-velocity fallback for robots whose
    gatekeeper has not initialized yet (first chunk).
    """
    L = g.gk.committed_len

    def one(xrow, cx, tidx, init):
        idx = jnp.clip(tidx + jnp.arange(Ltab), 0, L - 1)
        pts = jax.vmap(model.barrier_pos)(cx[idx])  # (Ltab, 2)
        vel = _planar_velocity(g.model_name, xrow)
        p0 = model.barrier_pos(xrow)
        steps = jnp.arange(Ltab, dtype=p0.dtype)[:, None] * dt
        cv = p0[None, :] + vel[None, :] * steps
        return jnp.where(init, pts, cv)

    return jax.vmap(one)(
        st_x, gk_st.committed_x, gk_st.time_idx, gk_st.initialized
    )


def step_fleet_shielded(
    groups: List[ShieldedGroup],
    specs,
    state: ShieldedFleetState,
    waypoints_list,  # per group (count, W, 2)
    n_waypoints_list,
    known_obs,  # (Kk, 7) padded static obstacles
    n_steps: int = 1,
    k_neighbors: int = 4,
    prediction: str = "commitments",
) -> ShieldedFleetState:
    """Advance every group ``n_steps`` under per-robot gatekeeper shielding.

    Neighbor prediction modes (what each robot's commitment validation
    assumes the other robots will do):

    - ``"commitments"`` (default): neighbors follow their own COMMITTED
      trajectories — shared once per chunk as a (total, Ltab, 2) position
      table.  This is the compositional gatekeeper argument: every
      commitment was validated against the others' commitments, and a
      brake-backup commitment ends PARKED, so a neighbor that stops is
      predicted stopped.  Constant-velocity extrapolation fails exactly
      there: it predicts a braking neighbor sails on through, and a stale
      "it will have passed" commitment then walks into a parked robot
      (observed in the 3-family anchor test before this mode existed).
      Known caveat (documented, absorbed by ``safety_margin`` + short
      chunks): commitments adopted MID-chunk are validated against the
      chunk-start table, so there is a <= chunk-length inconsistency
      window, as with any snapshot-based decentralized scheme.
    - ``"constant_velocity"``: the reference's ``moving_obstacles(t)``
      model (shielding/gatekeeper.py:380-527) — correct for scripted
      obstacle cars, unsound for mutually-shielding robots; kept for
      comparison studies.
    """
    if prediction not in ("commitments", "constant_velocity"):
        raise ValueError(f"unknown prediction mode {prediction!r}")
    Lmax = max(g.gk.committed_len for g in groups)
    Ltab = n_steps + Lmax  # covers substep + validation offsets in-chunk

    # ---- fleet-wide snapshot ---------------------------------------------
    # rows: [x, y, radius, flat future-position table (Ltab * 2)]
    rows = []
    for g, st_x, gk_st in zip(groups, state.x, state.gk):
        model = get_model(g.model_name)
        pos = jax.vmap(model.barrier_pos)(st_x)
        if prediction == "commitments":
            tab = _committed_pos_table(g, model, g.gk.dt, Ltab, st_x, gk_st)
        else:
            vel = jax.vmap(
                lambda xr: _planar_velocity(g.model_name, xr)
            )(st_x)
            steps = jnp.arange(Ltab, dtype=pos.dtype)[None, :, None] * g.gk.dt
            tab = pos[:, None, :] + vel[:, None, :] * steps
        rows.append(
            jnp.concatenate(
                [pos, jnp.full((g.count, 1), g.robot_radius),
                 tab.reshape(g.count, Ltab * 2)], axis=1,
            )
        )
    allrows = jnp.concatenate(rows, axis=0)
    total = allrows.shape[0]
    offs = np.cumsum([0] + [g.count for g in groups])

    new_x, new_gidx, new_gk, new_bk, new_cm = [], [], [], [], []
    for gi, (g, spec) in enumerate(zip(groups, specs)):
        model = get_model(g.model_name)
        dt = g.gk.dt
        wps = waypoints_list[gi]
        n_wps = n_waypoints_list[gi]
        W = wps.shape[1]

        # nearest-K neighbors (self excluded by global index)
        self_idx = offs[gi] + jnp.arange(g.count)
        pos_g = jax.vmap(model.barrier_pos)(state.x[gi])
        d = jnp.linalg.norm(
            allrows[None, :, :2] - pos_g[:, None, :], axis=-1
        )  # (count, total)
        d = d.at[jnp.arange(g.count), self_idx].set(jnp.inf)
        k = min(k_neighbors, total - 1)
        _, nbr_idx = jax.lax.top_k(-d, k)
        nbrs = allrows[nbr_idx]  # (count, k, 3 + Ltab*2)

        def one(x, gk_st, goal_idx, bk, cm, nbr, wps_r):
            nbr_r = nbr[:, 2]
            nbr_tab = nbr[:, 3:].reshape(k, Ltab, 2)

            def body(carry, s):
                x, gk_st, goal_idx, bk, cm = carry
                wp = wps_r[jnp.clip(goal_idx, 0, W - 1)]

                def nominal_policy(xx):
                    return model.nominal_input(xx, wp, spec)

                backup_policy = _brake_policy(g.model_name, spec, dt)

                def collision_fn(xx, t_idx):
                    p = model.barrier_pos(xx)
                    static_hit = tracking.collision_any(
                        spec.replace(radius=g.robot_radius), p, known_obs
                    )
                    j = jnp.clip(s + t_idx, 0, Ltab - 1)
                    np_t = nbr_tab[:, j, :]
                    dist = jnp.linalg.norm(np_t - p, axis=1)
                    robot_hit = jnp.any(
                        dist < nbr_r + g.robot_radius + g.safety_margin
                    )
                    return static_hit | robot_hit

                out = gk_mod.step(
                    g.gk, spec, gk_st, x, backup_policy, collision_fn,
                    nominal_policy=nominal_policy,
                )
                x1 = model.step(x, out.u, spec, dt)
                reached = (
                    jnp.linalg.norm(model.barrier_pos(x1) - wp)
                    < g.reached_threshold
                ) & (goal_idx < n_wps)
                goal_idx = jnp.where(reached, goal_idx + 1, goal_idx)
                bk = bk + out.using_backup.astype(jnp.int32)
                cm = cm + out.candidate_found.astype(jnp.int32)
                return (x1, out.state, goal_idx, bk, cm), None

            carry, _ = jax.lax.scan(
                body, (x, gk_st, goal_idx, bk, cm), jnp.arange(n_steps)
            )
            return carry

        x1, gk1, gidx1, bk1, cm1 = jax.vmap(one)(
            state.x[gi], state.gk[gi], state.goal_idx[gi],
            state.backup_steps[gi], state.commits[gi], nbrs, wps,
        )
        new_x.append(x1)
        new_gk.append(gk1)
        new_gidx.append(gidx1)
        new_bk.append(bk1)
        new_cm.append(cm1)
    return ShieldedFleetState(
        x=tuple(new_x), goal_idx=tuple(new_gidx), gk=tuple(new_gk),
        backup_steps=tuple(new_bk), commits=tuple(new_cm),
    )


def step_fleet_shielded_sharded(
    groups: List[ShieldedGroup],
    specs,
    state: ShieldedFleetState,
    waypoints_list,  # per group (count, W, 2)
    n_waypoints_list,
    known_obs,
    mesh,
    n_steps: int = 1,
    k_neighbors: int = 4,
    prediction: str = "commitments",
) -> ShieldedFleetState:
    """Multi-chip ``step_fleet_shielded``: robots sharded over the scenario
    mesh, with the fleet-wide neighbor snapshot assembled by an
    ``all_gather`` over the mesh.

    This is BASELINE anchor config 5 across devices: every group's robot axis
    is block-sharded (counts must divide the mesh size); each device
    computes its local robots' snapshot rows ([x, y, radius] + the shared
    committed-position table, see ``step_fleet_shielded``), one tiled
    all_gather per group rebuilds the (total, rows) snapshot everywhere,
    and the per-robot gatekeeper commitment step then proceeds exactly as
    in the single-device path — the collective is the ONLY cross-device
    communication per chunk.
    """
    from jax.sharding import PartitionSpec as P

    from safe_control_tpu.parallel.mesh import SCENARIO_AXIS

    if prediction not in ("commitments", "constant_velocity"):
        raise ValueError(f"unknown prediction mode {prediction!r}")
    n_dev = mesh.devices.size
    for g in groups:
        if g.count % n_dev:
            raise ValueError(
                f"group count {g.count} must divide the mesh size {n_dev}"
            )
    offs = np.cumsum([0] + [g.count for g in groups])
    Lmax = max(g.gk.committed_len for g in groups)
    Ltab = n_steps + Lmax

    def body(state, wps_tuple, known):
        new_x, new_gidx, new_gk, new_bk, new_cm = [], [], [], [], []
        rows_local = []
        for g, st_x, gk_st in zip(groups, state.x, state.gk):
            model = get_model(g.model_name)
            pos = jax.vmap(model.barrier_pos)(st_x)
            if prediction == "commitments":
                tab = _committed_pos_table(
                    g, model, g.gk.dt, Ltab, st_x, gk_st
                )
            else:
                vel = jax.vmap(
                    lambda xr: _planar_velocity(g.model_name, xr)
                )(st_x)
                steps = jnp.arange(
                    Ltab, dtype=pos.dtype
                )[None, :, None] * g.gk.dt
                tab = pos[:, None, :] + vel[:, None, :] * steps
            rows_local.append(
                jnp.concatenate(
                    [pos, jnp.full((st_x.shape[0], 1), g.robot_radius),
                     tab.reshape(st_x.shape[0], Ltab * 2)], axis=1,
                )
            )
        allrows = jnp.concatenate(
            [jax.lax.all_gather(r, SCENARIO_AXIS, axis=0, tiled=True)
             for r in rows_local],
            axis=0,
        )
        total = allrows.shape[0]
        shard = jax.lax.axis_index(SCENARIO_AXIS)

        for gi, (g, spec) in enumerate(zip(groups, specs)):
            model = get_model(g.model_name)
            dt = g.gk.dt
            wps = wps_tuple[gi]
            n_wps = n_waypoints_list[gi]
            W = wps.shape[1]
            local = g.count // n_dev
            self_idx = offs[gi] + shard * local + jnp.arange(local)
            pos_g = jax.vmap(model.barrier_pos)(state.x[gi])
            d = jnp.linalg.norm(
                allrows[None, :, :2] - pos_g[:, None, :], axis=-1
            )
            d = d.at[jnp.arange(local), self_idx].set(jnp.inf)
            k = min(k_neighbors, total - 1)
            _, nbr_idx = jax.lax.top_k(-d, k)
            nbrs = allrows[nbr_idx]

            def one(x, gk_st, goal_idx, bk, cm, nbr, wps_r):
                nbr_r = nbr[:, 2]
                nbr_tab = nbr[:, 3:].reshape(k, Ltab, 2)

                def step_body(carry, s):
                    x, gk_st, goal_idx, bk, cm = carry
                    wp = wps_r[jnp.clip(goal_idx, 0, W - 1)]

                    def nominal_policy(xx):
                        return model.nominal_input(xx, wp, spec)

                    backup_policy = _brake_policy(g.model_name, spec, dt)

                    def collision_fn(xx, t_idx):
                        p = model.barrier_pos(xx)
                        static_hit = tracking.collision_any(
                            spec.replace(radius=g.robot_radius), p, known
                        )
                        j = jnp.clip(s + t_idx, 0, Ltab - 1)
                        np_t = nbr_tab[:, j, :]
                        dist = jnp.linalg.norm(np_t - p, axis=1)
                        robot_hit = jnp.any(
                            dist < nbr_r + g.robot_radius + g.safety_margin
                        )
                        return static_hit | robot_hit

                    out = gk_mod.step(
                        g.gk, spec, gk_st, x, backup_policy, collision_fn,
                        nominal_policy=nominal_policy,
                    )
                    x1 = model.step(x, out.u, spec, dt)
                    reached = (
                        jnp.linalg.norm(model.barrier_pos(x1) - wp)
                        < g.reached_threshold
                    ) & (goal_idx < n_wps)
                    goal_idx = jnp.where(reached, goal_idx + 1, goal_idx)
                    bk = bk + out.using_backup.astype(jnp.int32)
                    cm = cm + out.candidate_found.astype(jnp.int32)
                    return (x1, out.state, goal_idx, bk, cm), None

                carry, _ = jax.lax.scan(
                    step_body, (x, gk_st, goal_idx, bk, cm),
                    jnp.arange(n_steps),
                )
                return carry

            x1, gk1, gidx1, bk1, cm1 = jax.vmap(one)(
                state.x[gi], state.gk[gi], state.goal_idx[gi],
                state.backup_steps[gi], state.commits[gi], nbrs, wps,
            )
            new_x.append(x1)
            new_gk.append(gk1)
            new_gidx.append(gidx1)
            new_bk.append(bk1)
            new_cm.append(cm1)
        return ShieldedFleetState(
            x=tuple(new_x), goal_idx=tuple(new_gidx), gk=tuple(new_gk),
            backup_steps=tuple(new_bk), commits=tuple(new_cm),
        )

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SCENARIO_AXIS), P(SCENARIO_AXIS), P()),
        out_specs=P(SCENARIO_AXIS),
        check_vma=False,
    )(state, tuple(waypoints_list), known_obs)


def shielded_fleet_stats(
    groups: List[ShieldedGroup], state: ShieldedFleetState
) -> Dict[str, float]:
    out: Dict[str, float] = dict(total=0, backup_steps=0, commits=0,
                                 mean_goal_idx=0.0)
    for g, gidx, bk, cm in zip(
        groups, state.goal_idx, state.backup_steps, state.commits
    ):
        out["total"] += g.count
        out["backup_steps"] += int(np.sum(np.asarray(bk)))
        out["commits"] += int(np.sum(np.asarray(cm)))
        out["mean_goal_idx"] += float(np.sum(np.asarray(gidx)))
    out["mean_goal_idx"] /= max(out["total"], 1)
    return out


def min_pairwise_clearance(
    groups: List[ShieldedGroup], state: ShieldedFleetState
) -> float:
    """min over robot pairs of (distance - radii sum); > 0 means no
    robot-robot collision in the current configuration."""
    rows = []
    for g, st_x in zip(groups, state.x):
        model = get_model(g.model_name)
        pos = jax.vmap(model.barrier_pos)(st_x)
        rows.append(
            jnp.concatenate(
                [pos, jnp.full((g.count, 1), g.robot_radius)], axis=1
            )
        )
    allp = jnp.concatenate(rows, axis=0)
    d = jnp.linalg.norm(allp[None, :, :2] - allp[:, None, :2], axis=-1)
    rsum = allp[None, :, 2] + allp[:, None, 2]
    clear = d - rsum + jnp.diag(jnp.full(allp.shape[0], jnp.inf))
    return float(jnp.min(clear))


def fleet_stats(groups: List[FleetGroup], state: FleetState) -> Dict[str, float]:
    done = bad = total = 0
    for g, st in zip(groups, state.trackers):
        ret = np.asarray(st.ret)
        done += int((ret == tracking.RET_DONE).sum())
        bad += int((ret == tracking.RET_INFEASIBLE).sum())
        total += g.count
    return dict(total=total, reached=done, infeasible_or_collision=bad)

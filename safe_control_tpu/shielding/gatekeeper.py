"""Gatekeeper / MPS shielding: infinite-time safety via committed trajectories.

JAX re-implementation of the reference's shielding/gatekeeper.py and
shielding/mps.py.  The committed trajectory = a nominal prefix + a backup
suffix; at events, the reference runs a sequential backward search over
nominal horizons, rolling out and validating one candidate at a time
(:589-652).  Here ALL candidate switch points are evaluated at once:

- one ``lax.scan`` nominal rollout (or an external MPC trajectory slice),
- ``vmap`` of backup rollouts from every candidate switch state,
- per-step collision flags -> prefix-AND masks -> the longest valid
  candidate by a single argmax (the "keep previous commit on failure"
  rule, :649-652, is a ``where``).

The environment couples in through a user-supplied pure function
``collision_fn(state, t_idx) -> bool`` evaluated at absolute step offsets
from 'now' — this is the reference's boundary + static + time-synchronized
moving-obstacle check (:380-527) folded into one callable.

MPS (shielding/mps.py:59-166) is the same machinery with a single 1-step
nominal candidate re-evaluated every step (``mps_mode``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from safe_control_tpu.dynamics import get_model


@dataclasses.dataclass(frozen=True)
class GatekeeperConfig:
    model_name: str
    dt: float = 0.05
    nominal_steps: int = 40  # max nominal horizon (steps)
    backup_steps: int = 40  # backup horizon (steps)
    event_offset_steps: int = 10
    discount_steps: int = 5  # backward-search granularity (:68 default 5*dt)
    mps_mode: bool = False  # MPS: single 1-step candidate, event every step
    # Stale-commitment re-validation (fleet extension, NOT reference
    # semantics).  The reference keeps the previous commitment whenever no
    # new candidate validates (:649-652) — sound when obstacle predictions
    # are exact (its env-scripted obstacle cars), but in a fleet of
    # mutually-shielding robots a NEIGHBOR can change ITS commitment (e.g.
    # brake to a stop), silently invalidating the assumptions this robot's
    # active commitment was validated under; replaying it then drives into
    # the parked neighbor (observed in the 3-family anchor scenario).  With
    # ``revalidate=True``, events where no new candidate validates ALSO
    # re-check the remaining committed suffix; if it now fails, the robot
    # falls to an immediate brake-backup commitment — the least-unsafe
    # action available (it minimizes kinetic energy along the only
    # trajectory class guaranteed to terminate).
    revalidate: bool = False

    @property
    def num_candidates(self) -> int:
        if self.mps_mode:
            return 1
        return self.nominal_steps // self.discount_steps + 2

    @property
    def committed_len(self) -> int:
        # states: nominal_steps + backup_steps + 1
        return self.nominal_steps + self.backup_steps + 1


class GatekeeperState(NamedTuple):
    committed_x: jnp.ndarray  # (L, n)
    committed_u: jnp.ndarray  # (L-1, m)
    committed_valid: jnp.ndarray  # (L-1,) bool: u rows that exist
    time_idx: jnp.ndarray  # int32, index into committed arrays
    next_event_idx: jnp.ndarray  # int32, absolute step count for next event
    nominal_steps_committed: jnp.ndarray  # int32 (diagnostics, :542)
    initialized: jnp.ndarray  # bool


class GatekeeperOutput(NamedTuple):
    u: jnp.ndarray
    state: GatekeeperState
    using_backup: jnp.ndarray  # bool: past the committed nominal prefix
    event_fired: jnp.ndarray
    candidate_found: jnp.ndarray


def init_state(cfg: GatekeeperConfig, dtype=jnp.float32) -> GatekeeperState:
    model = get_model(cfg.model_name)
    L = cfg.committed_len
    return GatekeeperState(
        committed_x=jnp.zeros((L, model.N_STATES), dtype=dtype),
        committed_u=jnp.zeros((L - 1, model.N_CONTROLS), dtype=dtype),
        committed_valid=jnp.zeros((L - 1,), dtype=bool),
        time_idx=jnp.asarray(0, jnp.int32),
        next_event_idx=jnp.asarray(0, jnp.int32),
        nominal_steps_committed=jnp.asarray(0, jnp.int32),
        initialized=jnp.asarray(False),
    )


def _rollout(model, spec, dt, policy, x0, n_steps):
    """Closed-loop rollout: returns xs (n_steps+1, n), us (n_steps, m)."""

    def body(x, _):
        u = policy(x)
        x1 = model.step(x, u, spec, dt)
        return x1, (x1, u)

    _, (xs, us) = jax.lax.scan(body, x0, None, length=n_steps)
    return jnp.concatenate([x0[None], xs], axis=0), us


def step(
    cfg: GatekeeperConfig,
    spec,
    state: GatekeeperState,
    x,
    backup_policy: Callable,
    collision_fn: Callable,
    nominal_policy: Optional[Callable] = None,
    nominal_traj: Optional[tuple] = None,
    terminal_fn: Optional[Callable] = None,
) -> GatekeeperOutput:
    """One gatekeeper step (solve_control_problem, :553-665).

    Exactly one of ``nominal_policy`` (closed-loop law ``x -> u``) or
    ``nominal_traj`` ((N+1, n) states, (N, m) controls from an external MPC)
    must be provided.  ``collision_fn(state_vec, t_idx)`` must be pure.

    ``terminal_fn(state_vec) -> bool`` (optional) is the invariant-set test
    on the backup rollout's END state (the reference's terminal check,
    gatekeeper.py:380-527 / backup_cbf_qp.py:659-671): a candidate is valid
    only if its backup suffix actually REACHES the invariant set within the
    backup horizon.  Without it, a commitment can run out mid-transit and
    drop the robot into the unvalidated live-backup fallback — observed as
    fleet/warehouse robots exhausting their committed suffix inside a moving
    obstacle's lane.
    """
    model = get_model(cfg.model_name)
    dt = cfg.dt
    N_N, N_B, L = cfg.nominal_steps, cfg.backup_steps, cfg.committed_len
    dtype = x.dtype

    # ---- nominal source -----------------------------------------------
    if nominal_traj is not None:
        nom_x, nom_u = nominal_traj
        assert nom_x.shape[0] == N_N + 1, "external nominal must match cfg"
    elif nominal_policy is not None:
        nom_x, nom_u = _rollout(model, spec, dt, nominal_policy, x, N_N)
    else:
        raise ValueError("need nominal_policy or nominal_traj")

    # ---- initialization: commit pure backup (:571-583) ----------------
    init_bx, init_bu = _rollout(model, spec, dt, backup_policy, x, N_B)
    pad_x = jnp.tile(init_bx[-1][None], (L - (N_B + 1), 1))
    pad_u = jnp.zeros((L - 1 - N_B, model.N_CONTROLS), dtype=dtype)
    init_cx = jnp.concatenate([init_bx, pad_x], axis=0)
    init_cu = jnp.concatenate([init_bu, pad_u], axis=0)
    init_cv = (jnp.arange(L - 1) < N_B)

    def use_init(s):
        return GatekeeperState(
            committed_x=init_cx,
            committed_u=init_cu,
            committed_valid=init_cv,
            time_idx=jnp.asarray(0, jnp.int32),
            next_event_idx=jnp.asarray(0, jnp.int32),
            nominal_steps_committed=jnp.asarray(0, jnp.int32),
            initialized=jnp.asarray(True),
        )

    state = jax.lax.cond(state.initialized, lambda s: s, use_init, state)

    # ---- event: parallel candidate evaluation (:589-652) ---------------
    event = state.time_idx >= state.next_event_idx

    # candidate nominal lengths: N_N, N_N - d, ..., 0 (or just [1] for MPS)
    if cfg.mps_mode:
        cand_lens = jnp.asarray([min(1, N_N)], jnp.int32)
    else:
        cand_lens = jnp.maximum(
            N_N - jnp.arange(cfg.num_candidates, dtype=jnp.int32) * cfg.discount_steps,
            0,
        )

    # nominal per-step collision flags at absolute offsets 0..N_N
    nom_coll = jax.vmap(lambda k: collision_fn(nom_x[k], k))(jnp.arange(N_N + 1))
    nom_safe_prefix = jnp.cumprod(~nom_coll) > 0  # safe through step k

    # backup rollout + validity per candidate (batched)
    def cand_backup(length):
        x_switch = nom_x[length]
        bx, bu = _rollout(model, spec, dt, backup_policy, x_switch, N_B)
        coll = jax.vmap(lambda j: collision_fn(bx[j], length + j))(
            jnp.arange(N_B + 1)
        )
        ok = ~jnp.any(coll)
        if terminal_fn is not None:
            ok = ok & terminal_fn(bx[-1])
        return bx, bu, ok

    cand_bx, cand_bu, cand_backup_ok = jax.vmap(cand_backup)(cand_lens)
    cand_valid = nom_safe_prefix[cand_lens] & cand_backup_ok

    found = jnp.any(cand_valid)
    best = jnp.argmax(cand_valid)  # first (longest) valid candidate
    best_len = cand_lens[best]

    # ---- build the new committed trajectory (fixed shape L) ------------
    idx = jnp.arange(L)
    take_nom = idx[:, None] <= best_len  # rows from nominal prefix
    nom_part = nom_x[jnp.clip(idx, 0, N_N)]
    bk_part = cand_bx[best][jnp.clip(idx - best_len, 0, N_B)]
    new_cx = jnp.where(take_nom, nom_part, bk_part)
    idx_u = jnp.arange(L - 1)
    nom_u_part = nom_u[jnp.clip(idx_u, 0, N_N - 1)] if N_N > 0 else jnp.zeros(
        (L - 1, model.N_CONTROLS), dtype=dtype
    )
    bk_u_part = cand_bu[best][jnp.clip(idx_u - best_len, 0, N_B - 1)]
    new_cu = jnp.where((idx_u < best_len)[:, None], nom_u_part, bk_u_part)
    new_cv = idx_u < best_len + N_B

    commit = event & found

    # ---- stale-commitment re-validation (see GatekeeperConfig.revalidate)
    if cfg.revalidate:
        rem_idx = jnp.clip(state.time_idx + jnp.arange(L), 0, L - 1)
        rem_coll = jax.vmap(
            lambda j: collision_fn(state.committed_x[rem_idx[j]], j)
        )(jnp.arange(L))
        # Only the rows the commitment actually CONTAINS count: state row
        # k is reached iff k <= valid u-row count, and rows beyond that are
        # padded copies of the terminal state — a far-future predicted
        # conflict with the parked terminus must not spuriously trigger
        # stale (it would install an unvalidated brake commitment for a
        # conflict the robot never drives into).
        valid_count = jnp.sum(state.committed_valid.astype(jnp.int32))
        in_commit = state.time_idx + jnp.arange(L) <= valid_count
        stale = event & ~found & jnp.any(rem_coll & in_commit)
    else:
        stale = jnp.asarray(False)

    committed_x = jnp.where(
        commit, new_cx, jnp.where(stale, init_cx, state.committed_x)
    )
    committed_u = jnp.where(
        commit, new_cu, jnp.where(stale, init_cu, state.committed_u)
    )
    committed_valid = jnp.where(
        commit, new_cv, jnp.where(stale, init_cv, state.committed_valid)
    )
    time_idx = jnp.where(commit | stale, 0, state.time_idx)
    next_event_idx = jnp.where(
        commit | stale,
        cfg.event_offset_steps,
        jnp.where(event, state.time_idx + cfg.event_offset_steps, state.next_event_idx),
    ).astype(jnp.int32)
    nominal_steps_committed = jnp.where(
        commit, best_len,
        jnp.where(stale, 0, state.nominal_steps_committed),
    ).astype(jnp.int32)

    # ---- emit control (:654-665) ---------------------------------------
    u_idx = jnp.clip(time_idx, 0, L - 2)
    in_range = (time_idx < L - 1) & committed_valid[u_idx]
    u_committed = committed_u[u_idx]
    u_fallback = backup_policy(x)
    u = jnp.where(in_range, u_committed, u_fallback)
    using_backup = time_idx >= nominal_steps_committed

    new_state = GatekeeperState(
        committed_x=committed_x,
        committed_u=committed_u,
        committed_valid=committed_valid,
        time_idx=(time_idx + 1).astype(jnp.int32),
        next_event_idx=next_event_idx,
        nominal_steps_committed=nominal_steps_committed,
        initialized=jnp.asarray(True),
    )
    return GatekeeperOutput(
        u=u,
        state=new_state,
        using_backup=using_backup,
        event_fired=event,
        candidate_found=event & found,
    )

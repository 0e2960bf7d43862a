"""Monte-Carlo sweep harness: thousands of scenarios across a device mesh.

The reference runs Monte-Carlo by re-executing a script per scenario
(SURVEY.md §2.5); here a sweep is ONE program: scenarios are a batch axis
(``vmap``), devices are a mesh axis (``shard_map`` over 'scenario'), and the
success statistics ride a ``psum`` over the mesh (BASELINE.json anchor configs:
1k-scenario DPCBF dynamic-obstacle sweep; 4k-agent fleets).

Checkpoint/resume: the sweep state (tracker states, obstacle arrays,
completed-step counter, metrics) is one pytree — pass it to
utils/checkpoint.save every K outer steps and restore to resume.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from safe_control_tpu.core.types import pad_obstacles
from safe_control_tpu.dynamics import get_model
from safe_control_tpu.parallel.mesh import SCENARIO_AXIS
from safe_control_tpu.sim import tracking


class SweepState(NamedTuple):
    tracker: tracking.TrackerState  # batched pytree (B, ...)
    obs: jnp.ndarray  # (B, K, 7) per-scenario dynamic obstacles
    steps_done: jnp.ndarray  # int32 scalar


class SweepResult(NamedTuple):
    ret: jnp.ndarray  # (B,) final return codes
    x: jnp.ndarray  # (B, n) final states
    success_rate: jnp.ndarray  # scalar, reduced across the mesh
    collision_rate: jnp.ndarray  # scalar


def dpcbf_sweep_init(
    cfg: tracking.TrackerConfig,
    spec,
    key,
    batch: int,
    waypoints,
    n_obstacles: int = 8,
    speed_range=(0.3, 0.8),
    workspace=(22.0, 15.0),
):
    """Randomized dynamic-obstacle scenarios (dynamic_env/main.py demo
    randomized): obstacle positions across the workspace, random headings."""
    kpos, kang, kspd = jax.random.split(key, 3)
    pos = jax.random.uniform(
        kpos, (batch, n_obstacles, 2),
        minval=jnp.array([6.0, 1.0]), maxval=jnp.array([workspace[0], workspace[1] - 1.0]),
    )
    ang = jax.random.uniform(kang, (batch, n_obstacles), minval=-jnp.pi, maxval=jnp.pi)
    spd = jax.random.uniform(
        kspd, (batch, n_obstacles), minval=speed_range[0], maxval=speed_range[1]
    )
    vel = spd[..., None] * jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)
    r = jnp.full((batch, n_obstacles, 1), 0.5)
    zeros = jnp.zeros((batch, n_obstacles, 2))
    obs = jnp.concatenate([pos, r, vel, zeros], axis=-1)

    x0 = jnp.tile(jnp.array([1.0, 7.5, 0.0, 1.0]), (batch, 1))
    st = jax.vmap(
        lambda x: tracking.init_state(cfg, spec, x, 0.0, first_goal=waypoints[0][:2])
    )(x0)
    return SweepState(tracker=st, obs=obs, steps_done=jnp.asarray(0, jnp.int32))


def run_sweep_chunk(
    cfg: tracking.TrackerConfig,
    spec,
    state: SweepState,
    waypoints,
    n_waypoints,
    n_steps: int,
    y_range=(0.0, 15.0),
):
    """Advance every scenario by ``n_steps`` (jit/shard_map-able chunk)."""

    def one(tr, obs):
        def body(carry, _):
            tr, obs = carry
            out = tracking.step(cfg, spec, tr, waypoints, n_waypoints, obs)
            obs = tracking.step_dynamic_obstacles(obs, cfg.dt, y_range=y_range)
            return (out.state, obs), None

        (tr, obs), _ = jax.lax.scan(body, (tr, obs), None, length=n_steps)
        return tr, obs

    tracker, obs = jax.vmap(one)(state.tracker, state.obs)
    return SweepState(
        tracker=tracker, obs=obs, steps_done=state.steps_done + n_steps
    )


def sweep_stats(state: SweepState, axis_name: Optional[str] = None):
    """Success/collision statistics; psum-reduced when inside shard_map."""
    ret = state.tracker.ret
    succ = (ret == tracking.RET_DONE).astype(jnp.float32)
    coll = (ret == tracking.RET_INFEASIBLE).astype(jnp.float32)
    n = jnp.asarray(ret.shape[0], jnp.float32)
    s, c = jnp.sum(succ), jnp.sum(coll)
    if axis_name is not None:
        s = jax.lax.psum(s, axis_name)
        c = jax.lax.psum(c, axis_name)
        n = jax.lax.psum(n, axis_name)
    return s / n, c / n


def run_sharded_sweep(
    mesh: Mesh,
    cfg: tracking.TrackerConfig,
    spec,
    state: SweepState,
    waypoints,
    n_waypoints,
    n_steps: int,
    chunk: int = 50,
):
    """Full sweep over a device mesh: scenario-sharded batch, psum stats.

    Returns (final SweepState, SweepResult).  The batch must divide the mesh
    size.  The per-chunk structure keeps the program small and gives natural
    checkpoint boundaries.
    """

    data = NamedSharding(mesh, P(SCENARIO_AXIS))

    def chunk_fn(tracker, obs):
        st = SweepState(tracker=tracker, obs=obs, steps_done=jnp.asarray(0, jnp.int32))
        st = run_sweep_chunk(cfg, spec, st, waypoints, n_waypoints, chunk)
        s, c = sweep_stats(st, SCENARIO_AXIS)
        return st.tracker, st.obs, s, c

    sharded = jax.shard_map(
        chunk_fn,
        mesh=mesh,
        in_specs=(P(SCENARIO_AXIS), P(SCENARIO_AXIS)),
        out_specs=(P(SCENARIO_AXIS), P(SCENARIO_AXIS), P(), P()),
        check_vma=False,
    )
    sharded = jax.jit(sharded)

    tracker = jax.device_put(state.tracker, data)
    obs = jax.device_put(state.obs, data)
    s = c = jnp.asarray(0.0)
    done = int(state.steps_done)
    for _ in range(int(np.ceil(n_steps / chunk))):
        tracker, obs, s, c = sharded(tracker, obs)
        done += chunk
    final = SweepState(tracker=tracker, obs=obs, steps_done=jnp.asarray(done, jnp.int32))
    res = SweepResult(
        ret=final.tracker.ret,
        x=final.tracker.x,
        success_rate=s,
        collision_rate=c,
    )
    return final, res

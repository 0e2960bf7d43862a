"""Gatekeeper-shielded heterogeneous fleet e2e (BASELINE anchor config 5).

Two opposing walls of robots (DynamicUnicycle2D vs DoubleIntegrator2D) drive
through each other's lanes around static obstacles.  Without shielding this
geometry produces head-on conflicts; with per-robot gatekeeper commitment
(nominal PD tracking + stop backup, neighbors under constant-velocity
prediction) the shields must measurably engage (backup steps > 0) while the
fleet stays collision-free throughout.

Scale note: the >=1k-agent version of exactly this scenario runs in
bench.py (bench_fleet_shielded) and chip_smoke.py on the GPU; the CPU-mesh test keeps the
same structure at a size a small host can verify in seconds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safe_control_tpu.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DYNAMIC_UNICYCLE_2D,
    make_spec,
)
from safe_control_tpu.core.types import pad_obstacles
from safe_control_tpu.parallel import fleet as fleet_mod
from safe_control_tpu.shielding import gatekeeper as gk_mod

DT = 0.05

GK = gk_mod.GatekeeperConfig(
    model_name=DYNAMIC_UNICYCLE_2D, dt=DT, nominal_steps=16, backup_steps=16,
    event_offset_steps=4, discount_steps=4,
    revalidate=True,  # fleet: neighbors change commitments (see gk docs)
)


def build_fleet(n_per_group=32):
    """Two opposing walls on crossing lanes, two static obstacles between."""
    groups = [
        fleet_mod.ShieldedGroup(
            model_name=DYNAMIC_UNICYCLE_2D, count=n_per_group,
            gk=dataclasses.replace(GK, model_name=DYNAMIC_UNICYCLE_2D),
            robot_radius=0.25,
        ),
        fleet_mod.ShieldedGroup(
            model_name=DOUBLE_INTEGRATOR_2D, count=n_per_group,
            gk=dataclasses.replace(GK, model_name=DOUBLE_INTEGRATOR_2D),
            robot_radius=0.25,
        ),
    ]
    specs = [
        make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.8, v_max=0.6,
                  radius=0.25),
        make_spec(DOUBLE_INTEGRATOR_2D, v_max=0.6, a_max=1.5, radius=0.25),
    ]
    # group 0: wall at x=0 heading +x; group 1: wall at x=8 heading -x on the
    # same lanes (offset half a lane so conflicts are head-on but resolvable).
    lane = 1.6
    y = lane * np.arange(n_per_group)
    x0_du = np.zeros((n_per_group, 4), np.float32)
    x0_du[:, 1] = y
    x0_du[:, 3] = 0.3
    x0_di = np.zeros((n_per_group, 4), np.float32)
    x0_di[:, 0] = 8.0
    x0_di[:, 1] = y + 0.4 * lane
    x0_di[:, 2] = -0.3
    wps_du = np.zeros((n_per_group, 1, 2), np.float32)
    wps_du[:, 0, 0] = 8.0
    wps_du[:, 0, 1] = y
    wps_di = np.zeros((n_per_group, 1, 2), np.float32)
    wps_di[:, 0, 0] = 0.0
    wps_di[:, 0, 1] = y + 0.4 * lane
    known = pad_obstacles(
        jnp.asarray(
            np.array(
                [[4.0, 0.8, 0.4, 0, 0, 0, 0],
                 [4.0, float(lane * n_per_group - 1.6), 0.4, 0, 0, 0, 0]],
                np.float32,
            )
        ),
        4,
    )
    x0s = [jnp.asarray(x0_du), jnp.asarray(x0_di)]
    wps = [jnp.asarray(wps_du), jnp.asarray(wps_di)]
    n_wps = [jnp.asarray(1), jnp.asarray(1)]
    return groups, specs, x0s, wps, n_wps, known


@pytest.mark.slow
def test_shielded_fleet_no_collisions_and_shields_engage():
    groups, specs, x0s, wps, n_wps, known = build_fleet(n_per_group=32)
    state = fleet_mod.init_shielded_fleet(groups, x0s)
    step = jax.jit(
        lambda s: fleet_mod.step_fleet_shielded(
            groups, specs, s, wps, n_wps, known, n_steps=5, k_neighbors=4
        )
    )
    min_clear = np.inf
    for _ in range(24):  # 120 control steps = 6 s sim time
        state = step(state)
        min_clear = min(min_clear,
                        fleet_mod.min_pairwise_clearance(groups, state))
    stats = fleet_mod.shielded_fleet_stats(groups, state)
    assert min_clear > 0.0, f"robot-robot collision: clearance {min_clear}"
    assert stats["backup_steps"] > 0, f"shields never engaged: {stats}"
    assert stats["commits"] > 0, f"no candidate ever committed: {stats}"
    # the fleet must still make progress (not a full deadlock): some robots
    # should have advanced well into the arena
    adv_du = float(jnp.max(state.x[0][:, 0]))
    adv_di = float(jnp.min(state.x[1][:, 0]))
    assert adv_du > 1.0 and adv_di < 7.0, (adv_du, adv_di, stats)


@pytest.mark.slow
def test_shielded_headon_pair_stops_safely():
    """Two robots aimed straight at each other must both yield to backup."""
    groups, specs, _, _, _, _ = build_fleet(n_per_group=1)
    x0s = [
        jnp.asarray(np.array([[0.0, 0.0, 0.0, 0.5]], np.float32)),
        jnp.asarray(np.array([[6.0, 0.0, -0.5, 0.0]], np.float32)),
    ]
    wps = [
        jnp.asarray(np.array([[[6.0, 0.0]]], np.float32)),
        jnp.asarray(np.array([[[0.0, 0.0]]], np.float32)),
    ]
    n_wps = [jnp.asarray(1), jnp.asarray(1)]
    known = pad_obstacles(jnp.zeros((0, 7), jnp.float32), 4)
    state = fleet_mod.init_shielded_fleet(groups, x0s)
    step = jax.jit(
        lambda s: fleet_mod.step_fleet_shielded(
            groups, specs, s, wps, n_wps, known, n_steps=5, k_neighbors=1
        )
    )
    min_clear = np.inf
    for _ in range(30):
        state = step(state)
        min_clear = min(min_clear,
                        fleet_mod.min_pairwise_clearance(groups, state))
    stats = fleet_mod.shielded_fleet_stats(groups, state)
    assert min_clear > 0.0, f"head-on pair collided: clearance {min_clear}"
    assert stats["backup_steps"] > 0, stats


def test_unsupported_family_raises():
    """Silent-unsoundness guard (round-3 ADVICE): families without a
    registered deadbeat brake policy / planar-velocity extractor must be
    REJECTED at fleet construction — a model.stop fallback never parks
    inside the validated window and a zeros-velocity fallback validates
    against static ghosts of moving robots."""
    from safe_control_tpu.core.spec import QUAD_2D

    groups = [
        fleet_mod.ShieldedGroup(
            model_name=QUAD_2D, count=2,
            gk=dataclasses.replace(GK, model_name=QUAD_2D)),
    ]
    with pytest.raises(KeyError, match="brake policy"):
        fleet_mod.init_shielded_fleet(
            groups, [jnp.zeros((2, 6), jnp.float32)])
    assert QUAD_2D not in fleet_mod.BRAKE_REGISTRY
    assert QUAD_2D not in fleet_mod.PLANAR_VELOCITY_REGISTRY


@pytest.mark.slow
def test_three_family_anchor_structure_collision_free():
    """The 4,096-agent BASELINE anchor structure (DU + KB + DI head-on
    lanes, bench.build_shielded_fleet_3fam) at a size the 2-core host can
    verify: collision-free with shields engaging across all THREE
    families."""
    from bench import build_shielded_fleet_3fam

    groups, specs, x0s, wps, n_wps, known = build_shielded_fleet_3fam(rows=8)
    assert len(groups) == 3
    state = fleet_mod.init_shielded_fleet(groups, x0s)
    # same chunk/neighbor parameters as the GPU bench (event-aligned
    # chunks, wide neighbor set — see bench.bench_fleet_shielded)
    step = jax.jit(
        lambda s: fleet_mod.step_fleet_shielded(
            groups, specs, s, wps, n_wps, known, n_steps=4, k_neighbors=8
        )
    )
    min_clear = np.inf
    for _ in range(30):  # 120 control steps = 6 s sim
        state = step(state)
        min_clear = min(min_clear,
                        fleet_mod.min_pairwise_clearance(groups, state))
    stats = fleet_mod.shielded_fleet_stats(groups, state)
    assert min_clear > 0.0, f"collision in 3-family fleet: {min_clear}"
    assert stats["backup_steps"] > 0, stats
    assert stats["commits"] > 0, stats


@pytest.mark.slow
def test_sharded_shielded_fleet_matches_single_device():
    """Robots sharded over the 8-device mesh with an all_gather neighbor
    snapshot must produce the same trajectories as the single-device path
    (pure data sharding + one collective; no algorithmic difference)."""
    from safe_control_tpu.parallel.mesh import scenario_mesh, shard_leading_axis

    groups, specs, x0s, wps, n_wps, known = build_fleet(n_per_group=16)
    mesh = scenario_mesh(8)

    s_ref = fleet_mod.init_shielded_fleet(groups, x0s)
    s_shard = jax.device_put(s_ref)
    step_ref = jax.jit(
        lambda s: fleet_mod.step_fleet_shielded(
            groups, specs, s, wps, n_wps, known, n_steps=3, k_neighbors=4
        )
    )
    step_shard = jax.jit(
        lambda s, w: fleet_mod.step_fleet_shielded_sharded(
            groups, specs, s, w, n_wps, known, mesh, n_steps=3, k_neighbors=4
        )
    )
    wps_sharded = [shard_leading_axis(mesh, w) for w in wps]
    s_shard = shard_leading_axis(mesh, s_shard)
    for _ in range(4):
        s_ref = step_ref(s_ref)
        s_shard = step_shard(s_shard, wps_sharded)
    for a, b in zip(s_ref.x, s_shard.x):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)
    for a, b in zip(s_ref.backup_steps, s_shard.backup_steps):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_revalidate_ignores_padded_terminal_rows():
    """The stale re-check must scan only rows the commitment CONTAINS:
    a predicted conflict with the PADDED terminal state (beyond
    committed_valid) must not trigger the brake fallback, while a conflict
    within the valid rows must (advisor r4 finding on gatekeeper.py:230)."""
    import jax.numpy as jnp

    from safe_control_tpu.core.spec import DOUBLE_INTEGRATOR_2D, make_spec
    from safe_control_tpu.shielding import gatekeeper as gk

    spec = make_spec(DOUBLE_INTEGRATOR_2D, v_max=1.0, a_max=1.0)
    cfg = gk.GatekeeperConfig(
        model_name=DOUBLE_INTEGRATOR_2D, dt=0.1, nominal_steps=4,
        backup_steps=4, event_offset_steps=2, discount_steps=2,
        revalidate=True,
    )
    L = cfg.committed_len
    x = jnp.array([0.0, 0.0, 1.0, 0.0], jnp.float32)  # moving +x

    def nominal_policy(xx):
        return jnp.array([1.0, 0.0])  # accelerate into the flagged band

    def backup_policy(xx):
        a = -xx[2:4] / 0.1
        m = jnp.linalg.norm(a)
        return a * jnp.where(m > 1.0, 1.0 / jnp.maximum(m, 1e-9), 1.0)

    def make_state(valid_rows, terminus):
        cx = jnp.zeros((L, 4), jnp.float32).at[:, 0].set(-1.0)
        # valid rows sit at x=-1 (safe); padded rows at the crafted terminus
        cx = cx.at[valid_rows + 1:, :2].set(jnp.asarray(terminus))
        return gk.GatekeeperState(
            committed_x=cx,
            committed_u=jnp.zeros((L - 1, 2), jnp.float32),
            committed_valid=jnp.arange(L - 1) < valid_rows,
            time_idx=jnp.asarray(0, jnp.int32),
            next_event_idx=jnp.asarray(0, jnp.int32),  # event fires now
            nominal_steps_committed=jnp.asarray(2, jnp.int32),
            initialized=jnp.asarray(True),
        )

    def coll_band(xx, t_idx):
        # every candidate's rollout (x in (0.05, 8)) collides -> ~found;
        # the crafted terminus at (9, 9) is also flagged
        in_band = (xx[0] > 0.05) & (xx[0] < 8.0)
        at_term = jnp.linalg.norm(xx[:2] - jnp.array([9.0, 9.0])) < 0.5
        return in_band | at_term

    # (a) conflict ONLY at the padded terminus -> not stale: the previous
    # committed controls must survive the event
    st = make_state(valid_rows=4, terminus=(9.0, 9.0))
    out = gk.step(cfg, spec, st, x, backup_policy, coll_band,
                  nominal_policy=nominal_policy)
    assert not bool(out.candidate_found)
    assert int(out.state.nominal_steps_committed) == 2  # untouched
    np.testing.assert_array_equal(
        np.asarray(out.state.committed_u), np.asarray(st.committed_u)
    )

    # (b) conflict within the VALID rows -> stale: fall to the brake
    # commitment (nominal_steps_committed resets, time restarts)
    st_bad = make_state(valid_rows=4, terminus=(9.0, 9.0))
    st_bad = st_bad._replace(
        committed_x=st_bad.committed_x.at[2, :2].set(jnp.array([1.0, 0.0]))
    )
    out_b = gk.step(cfg, spec, st_bad, x, backup_policy, coll_band,
                    nominal_policy=nominal_policy)
    assert not bool(out_b.candidate_found)
    assert int(out_b.state.nominal_steps_committed) == 0  # brake fallback
    assert int(out_b.state.time_idx) == 1  # reset to 0, then advanced

"""Benchmark: batched MPC-CBF solves/s on one GPU (DynamicUnicycle2D, N=8).

The BASELINE.json north-star metric.  The reference solves ONE horizon-10
IPOPT NLP per control period (0.05 s budget, i.e. ~20 solves/s per CPU,
single robot); BASELINE.json's north-star figure is 10,000 batched MPC-CBF
solves/s, and vs_baseline is value / 10,000.

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {...}, "extra_metrics": {...}}

``device`` names the card (JAX's platform, device kind and count, and
nvidia-smi's name and power limit).  ``extra_metrics`` carries the
secondary BASELINE rows:
- vtol_mpc_n30_solves_per_sec / mpcc_n30_solves_per_sec: the large-horizon
  solver path (120 / 90 decision vars -> the blocked trace-time Cholesky,
  solvers/chol.py) at the horizons the reference actually runs
  (position_control/mpc_cbf.py:41, mpcc.py:47).
- per_step_latency_ms: ONE robot's control_step() wall time through the
  public LocalTrackingController wrapper vs the reference's real-time
  budget (dt = 0.05 s -> 50 ms; BASELINE.md real-time parity row).
- fleet_shielded_4096: agent-steps/s of the 4,096-agent 3-family
  gatekeeper-shielded fleet (BASELINE anchor config 5 at spec) with
  shields engaging and the minimum pairwise clearance reported.

Runs on the GPU only (``python bench.py`` on a machine with one card); any
other device, and any failed row, ends the run with an error.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

TARGET_SOLVES_PER_SEC = 10_000.0


def device_info():
    """The device this run measures; refuses anything but a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX's device is "
                         f"{dev.platform!r}")
    name, power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].split(", ")
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()), card=name, power_limit=power)


def bench_main_metric():
    import jax

    from __graft_entry__ import _build_step

    batch = 4096
    step, args = _build_step(batch=batch)
    fn = jax.jit(step)

    jax.block_until_ready(fn(*args))

    xs, goals, obs, u_prevs, Us = args
    reps = 5
    best = 0.0
    for _round in range(2):
        t0 = time.perf_counter()
        for _ in range(reps):
            xs, u, Us = fn(xs, goals, obs, u_prevs, Us)
            u_prevs = u
        jax.block_until_ready(xs)
        elapsed = time.perf_counter() - t0
        best = max(best, batch * reps / elapsed)
    return best


def bench_vtol_n30(batch=256, reps=3):
    import jax
    import jax.numpy as jnp

    from safe_control_tpu.core.spec import VTOL_2D, make_spec
    from safe_control_tpu.core.types import pad_obstacles
    from safe_control_tpu.solvers import mpc_cbf

    spec = make_spec(VTOL_2D)
    cfg = mpc_cbf.MPCConfig(horizon=30, num_obs=5)
    dt = 0.05
    goal = jnp.array([80.0, 40.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
    obs = pad_obstacles(
        jnp.asarray([[40.0, 35.0, 3.0, 0, 0, 0, 0]], jnp.float32), 5
    )
    st0 = mpc_cbf.init_state(VTOL_2D, cfg)

    def one(x, U):
        res = mpc_cbf.solve(
            VTOL_2D, spec, x, goal, obs, jnp.zeros(4),
            mpc_cbf.MPCState(U=U, lam=jnp.zeros_like(st0.lam)), dt, cfg,
        )
        return res.u, res.state.U

    fn = jax.jit(jax.vmap(one))
    rng = np.random.default_rng(0)
    xs = jnp.asarray(
        np.concatenate(
            [rng.uniform(0, 20, (batch, 1)), rng.uniform(30, 50, (batch, 1)),
             rng.uniform(-0.1, 0.1, (batch, 1)), rng.uniform(5, 15, (batch, 1)),
             rng.uniform(-1, 1, (batch, 1)), np.zeros((batch, 1))], axis=1,
        ), jnp.float32)
    Us = jnp.tile(st0.U[None], (batch, 1, 1))
    u, Us_w = jax.block_until_ready(fn(xs, Us))
    t0 = time.perf_counter()
    for _ in range(reps):
        u, Us_w = fn(xs, Us_w)
    jax.block_until_ready(u)
    return batch * reps / (time.perf_counter() - t0)


def bench_mpcc_n30(batch=256, reps=3):
    import jax
    import jax.numpy as jnp

    from safe_control_tpu.core.spec import DRIFTING_CAR, make_spec
    from safe_control_tpu.solvers import mpcc

    spec = make_spec(DRIFTING_CAR)
    sx = np.linspace(0.0, 200.0, 601)
    path = mpcc.make_path(sx, np.full_like(sx, 2.0))
    cfg = mpcc.MPCCConfig(horizon=30, v_ref=10.0)

    def one(x8, st):
        res = mpcc.solve(spec, x8, path, st, jnp.zeros(2), 0.05, cfg)
        return res.u, res.state

    fn = jax.jit(jax.vmap(one))
    rng = np.random.default_rng(0)
    xs = np.zeros((batch, 8), np.float32)
    xs[:, 0] = rng.uniform(1.0, 50.0, batch)
    xs[:, 1] = 2.0
    xs[:, 5] = 10.0
    xs = jnp.asarray(xs)
    st = jax.vmap(lambda _: mpcc.init_state(cfg))(jnp.arange(batch))
    u, st_w = jax.block_until_ready(fn(xs, st))
    t0 = time.perf_counter()
    for _ in range(reps):
        u, st_w = fn(xs, st_w)
    jax.block_until_ready(u)
    return batch * reps / (time.perf_counter() - t0)


def bench_per_step_latency():
    """Single-robot control_step() wall time through the public wrapper.

    ``vtol_mpc_n30`` keeps the default accuracy budget (historically the
    one red BASELINE row); ``vtol_mpc_n30_rti`` is the shipped real-time
    configuration for that row (see the case comment below).
    """
    from safe_control_tpu.sim.controller import LocalTrackingController

    out = {}
    cases = {
        "du_cbf_qp": (dict(model="DynamicUnicycle2D", a_max=1.0, w_max=0.5,
                           radius=0.25), {"pos": "cbf_qp"}, 0.05),
        "du_mpc_cbf": (dict(model="DynamicUnicycle2D", a_max=1.0, w_max=0.5,
                            radius=0.25), {"pos": "mpc_cbf"}, 0.05),
        "vtol_mpc_n30": (dict(model="VTOL2D"), {"pos": "mpc_cbf"}, 0.05),
        # the real-time route for the VTOL row: warm-started RTI budget
        # (MPCConfig.rti, 2x2 = 4 Newtons; closed-loop quality validated in
        # tests/test_vtol_e2e.py)
        "vtol_mpc_n30_rti": (dict(model="VTOL2D", mpc_rti=True),
                             {"pos": "mpc_cbf"}, 0.05),
    }
    for name, (rspec, ctype, dt) in cases.items():
        ctrl = LocalTrackingController(
            np.zeros(3) if rspec["model"] != "VTOL2D" else
            np.array([5.0, 40.0, 0.0]),
            rspec, controller_type=ctype, dt=dt,
        )
        wp = [[8.0, 4.0]] if rspec["model"] != "VTOL2D" else [[120.0, 40.0]]
        ctrl.set_waypoints(wp)
        ctrl.obs = np.array([[4.0, 2.0, 0.4, 0, 0, 0, 0]], float) \
            if rspec["model"] != "VTOL2D" else np.zeros((0, 7))
        for _ in range(3):  # compile + warm
            ctrl.control_step()
        ts = []
        for _ in range(30):
            t0 = time.perf_counter()
            ctrl.control_step()
            ts.append(time.perf_counter() - t0)
        out[name] = dict(
            median_ms=round(float(np.median(ts)) * 1e3, 3),
            p95_ms=round(float(np.percentile(ts, 95)) * 1e3, 3),
            budget_ms=dt * 1e3,
            within_budget=bool(np.median(ts) < dt),
        )
    return out


def build_shielded_fleet_3fam(rows, dt=0.05, nominal_steps=16,
                              backup_steps=16):
    """BASELINE anchor-5 geometry at spec: >=3 model families, head-on
    conflicts in every lane so shields must engage.

    ``rows`` lanes at 1.6 m spacing: even rows DynamicUnicycle2D and odd
    rows KinematicBicycle2D drive +x from x=0; one DoubleIntegrator2D per
    row drives -x from x=4 at a 0.32 m lateral offset (< the conflict
    threshold).  Total agents = 2*rows (rows/2 DU + rows/2 KB + rows DI).
    Returns (groups, specs, x0s, waypoints, n_wps, known_obs).
    """
    import dataclasses

    import jax.numpy as jnp

    from safe_control_tpu.core.spec import (
        DOUBLE_INTEGRATOR_2D, DYNAMIC_UNICYCLE_2D, KINEMATIC_BICYCLE_2D,
        make_spec,
    )
    from safe_control_tpu.core.types import pad_obstacles
    from safe_control_tpu.parallel import fleet as fleet_mod
    from safe_control_tpu.shielding import gatekeeper as gk_mod

    assert rows % 2 == 0
    GK = gk_mod.GatekeeperConfig(
        model_name=DYNAMIC_UNICYCLE_2D, dt=dt, nominal_steps=nominal_steps,
        backup_steps=backup_steps, event_offset_steps=4, discount_steps=4,
        revalidate=True,  # fleet: neighbors change commitments (see gk docs)
    )
    n_du = n_kb = rows // 2
    n_di = rows
    # safety_margin 0.25: commitments adopted mid-chunk are validated
    # against the chunk-start snapshot of the other robots' commitments;
    # the margin must absorb that re-commit divergence window (measured:
    # 0.1 m let a 4 cm overlap through at 4,096 agents; 0.25 m with
    # event-aligned chunks is clean)
    margin = 0.25
    groups = [
        fleet_mod.ShieldedGroup(
            model_name=DYNAMIC_UNICYCLE_2D, count=n_du,
            gk=dataclasses.replace(GK, model_name=DYNAMIC_UNICYCLE_2D),
            safety_margin=margin),
        fleet_mod.ShieldedGroup(
            model_name=KINEMATIC_BICYCLE_2D, count=n_kb,
            gk=dataclasses.replace(GK, model_name=KINEMATIC_BICYCLE_2D),
            safety_margin=margin),
        fleet_mod.ShieldedGroup(
            model_name=DOUBLE_INTEGRATOR_2D, count=n_di,
            gk=dataclasses.replace(GK, model_name=DOUBLE_INTEGRATOR_2D),
            safety_margin=margin),
    ]
    specs = [
        make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.8, v_max=0.6,
                  radius=0.25),
        # v_min=0: the reference KB default (0.2) is a minimum-speed vehicle
        # that cannot park — the brake-backup registry rejects it (see
        # parallel.fleet._heading_speed_brake)
        make_spec(KINEMATIC_BICYCLE_2D, a_max=1.0, v_max=0.6, radius=0.25,
                  v_min=0.0),
        make_spec(DOUBLE_INTEGRATOR_2D, v_max=0.6, a_max=1.5, radius=0.25),
    ]
    lane = 1.6
    y_du = lane * (2.0 * np.arange(n_du))  # even rows
    y_kb = lane * (2.0 * np.arange(n_kb) + 1.0)  # odd rows
    y_di = lane * np.arange(n_di) + 0.2 * lane
    x0_du = np.zeros((n_du, 4), np.float32)
    x0_du[:, 1] = y_du
    x0_du[:, 3] = 0.3
    x0_kb = np.zeros((n_kb, 4), np.float32)
    x0_kb[:, 1] = y_kb
    x0_kb[:, 3] = 0.3
    x0_di = np.zeros((n_di, 4), np.float32)
    x0_di[:, 0] = 4.0
    x0_di[:, 1] = y_di
    x0_di[:, 2] = -0.3
    def wp(ys, xg):
        w = np.zeros((len(ys), 1, 2), np.float32)
        w[:, 0, 0] = xg
        w[:, 0, 1] = ys
        return jnp.asarray(w)
    wps = [wp(y_du, 8.0), wp(y_kb, 8.0), wp(y_di, 0.0)]
    n_wps = [jnp.asarray(1)] * 3
    known = pad_obstacles(jnp.zeros((0, 7), jnp.float32), 4)
    x0s = [jnp.asarray(x0_du), jnp.asarray(x0_kb), jnp.asarray(x0_di)]
    return groups, specs, x0s, wps, n_wps, known


def bench_fleet_shielded(total=4096, chunks=17, n_steps=4):
    """BASELINE anchor 5 at spec: 4,096 agents, 3 model families
    (DU + KB + DI), gatekeeper-shielded, head-on conflicts in every lane.

    n_steps = 4 aligns chunks with the gatekeeper event period so at most
    one commitment event happens per snapshot window, and k_neighbors = 8
    covers the clusters that form when lanes jam (4 missed the colliding
    neighbor at 4,096 agents)."""
    import jax

    from safe_control_tpu.parallel import fleet as fleet_mod

    rows = total // 2
    groups, specs, x0s, wps, n_wps, known = build_shielded_fleet_3fam(rows)
    state = fleet_mod.init_shielded_fleet(groups, x0s)
    step = jax.jit(
        lambda s: fleet_mod.step_fleet_shielded(
            groups, specs, s, wps, n_wps, known, n_steps=n_steps,
            k_neighbors=8,
        )
    )
    state = jax.block_until_ready(step(state))
    t0 = time.perf_counter()
    for _ in range(chunks):
        state = step(state)
    jax.block_until_ready(state.x)
    elapsed = time.perf_counter() - t0
    stats = fleet_mod.shielded_fleet_stats(groups, state)
    total_agents = sum(g.count for g in groups)
    clearance = fleet_mod.min_pairwise_clearance(groups, state)
    return dict(
        agent_steps_per_sec=round(total_agents * chunks * n_steps / elapsed, 1),
        agents=total_agents,
        families=len(groups),
        backup_steps=stats["backup_steps"],
        commits=stats["commits"],
        min_pairwise_clearance=round(float(clearance), 4),
    )


_BENCH_TABLE = {
    "vtol_mpc_n30_solves_per_sec": bench_vtol_n30,
    "mpcc_n30_solves_per_sec": bench_mpcc_n30,
    "per_step_latency_ms": bench_per_step_latency,
    "fleet_shielded_4096": bench_fleet_shielded,
}


def main() -> None:
    device = device_info()
    solves_per_sec = bench_main_metric()
    extra = {}
    for name, fn in _BENCH_TABLE.items():
        v = fn()
        extra[name] = round(float(v), 1) if isinstance(v, float) else v
    print(
        json.dumps(
            {
                "metric": "mpc_cbf_solves_per_sec_per_chip_du_N8",
                "value": round(float(solves_per_sec), 1),
                "unit": "solves/s",
                "vs_baseline": round(float(solves_per_sec / TARGET_SOLVES_PER_SEC), 3),
                "device": device,
                "extra_metrics": extra,
            }
        )
    )


if __name__ == "__main__":
    main()

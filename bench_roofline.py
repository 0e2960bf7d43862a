"""Roofline measurement for the MPC-CBF solve (BASELINE north-star op).

For each configuration, lowers + compiles the batched solve, reads XLA's own
cost analysis (FLOPs + HBM bytes accessed), times steady-state execution,
and reports achieved FLOP/s, achieved bandwidth, and arithmetic intensity.
This is the "prove" side of the large-horizon item: it shows WHERE each
configuration sits on the roofline against the card's published peaks.

Prints one JSON line per config, with the device it ran on.  Runs on the
GPU only (``python bench_roofline.py`` on a machine with one card).
"""

from __future__ import annotations

import json
import time

import numpy as np

# Published peaks by JAX device kind: f32 FLOP/s outside the tensor cores
# (what HIGHEST-precision f32 products and elementwise work run on) and
# device-memory bytes/s.  Source: NVIDIA H100 data sheet, SXM part, at the
# full 700 W power limit; a card set below it cannot hold its top clock.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(f32_flops=67e12, hbm_bps=3.35e12),
}


def peaks_for(device_kind: str) -> dict:
    """Peaks of a device kind; a kind missing from the table is an error."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"add them to bench_roofline.PEAKS with their source")
    return PEAKS[device_kind]


def measure(model_name, horizon, batch, spec_kwargs, n_ctrl, reps=5):
    import jax
    import jax.numpy as jnp

    from safe_control_tpu.core.spec import make_spec
    from safe_control_tpu.core.types import pad_obstacles
    from safe_control_tpu.dynamics import get_model
    from safe_control_tpu.solvers import mpc_cbf

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_roofline.py measures the GPU; JAX's device is "
                         f"{dev.platform!r}")
    peaks = peaks_for(dev.device_kind)
    spec = make_spec(model_name, **spec_kwargs)
    model = get_model(model_name)
    cfg = mpc_cbf.MPCConfig(horizon=horizon, num_obs=5)
    dt = 0.05
    n = model.N_STATES
    goal = jnp.zeros((n,), jnp.float32).at[0].set(5.0)
    obs = pad_obstacles(
        jnp.asarray([[3.0, 0.5, 0.4, 0, 0, 0, 0]], jnp.float32), 5
    )
    st0 = mpc_cbf.init_state(model_name, cfg)

    def one(x, U):
        res = mpc_cbf.solve(
            model_name, spec, x, goal, obs, jnp.zeros(n_ctrl),
            mpc_cbf.MPCState(U=U, lam=jnp.zeros_like(st0.lam)), dt, cfg,
        )
        return res.u, res.state.U

    fn = jax.jit(jax.vmap(one))
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.uniform(-0.3, 0.8, (batch, n)), jnp.float32)
    Us = jnp.tile(st0.U[None], (batch, 1, 1))

    lowered = fn.lower(xs, Us)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))

    u, Us_w = jax.block_until_ready(fn(xs, Us))
    t0 = time.perf_counter()
    for _ in range(reps):
        u, Us_w = fn(xs, Us_w)
    jax.block_until_ready(u)
    dt_wall = (time.perf_counter() - t0) / reps

    achieved_flops = flops / dt_wall
    achieved_bw = bytes_acc / dt_wall
    return {
        "metric": "mpc_cbf_roofline",
        "device_kind": dev.device_kind,
        "model": model_name,
        "horizon": horizon,
        "batch": batch,
        "decision_vars": horizon * n_ctrl,
        "solves_per_sec": round(batch / dt_wall, 1),
        "xla_flops_per_solve": round(flops / batch, 1),
        "xla_bytes_per_solve": round(bytes_acc / batch, 1),
        "achieved_tflops": round(achieved_flops / 1e12, 4),
        "pct_of_f32_peak": round(100 * achieved_flops / peaks["f32_flops"], 2),
        "achieved_gbps": round(achieved_bw / 1e9, 2),
        "pct_of_hbm_peak": round(100 * achieved_bw / peaks["hbm_bps"], 2),
        "arithmetic_intensity": round(flops / max(bytes_acc, 1.0), 3),
    }


def main():
    from safe_control_tpu.core.spec import DYNAMIC_UNICYCLE_2D, VTOL_2D

    cases = [
        (DYNAMIC_UNICYCLE_2D, 8, 4096, dict(a_max=1.0, w_max=0.5), 2),
        (DYNAMIC_UNICYCLE_2D, 25, 1024, dict(a_max=1.0, w_max=0.5), 2),
        (VTOL_2D, 30, 256, dict(), 4),
    ]
    for model_name, horizon, batch, kw, n_ctrl in cases:
        print(json.dumps(measure(model_name, horizon, batch, kw, n_ctrl)))


if __name__ == "__main__":
    main()

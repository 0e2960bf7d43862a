"""Continuous-time CBF-QP safety filter (batched).

Behavioral equivalent of /root/reference/position_control/cbf_qp.py:

    min ||u - u_ref||^2
    s.t. A1 u + b1 >= 0   (one HOCBF row per obstacle, :155-183)
         u in [u_lb, u_ub] (:54-104)

Differences from the reference: constraint rows come from ``jax.grad`` of one
h(x) (barriers/hocbf.py) instead of hand-derived expressions; all ``num_obs``
rows always exist, with padded/dummy obstacles masked to inert rows (the
reference zeroes stale rows, :109-111); and the solve is our fixed-iteration
ADMM+polish QP (solvers/qp.py) instead of Gurobi, so thousands of robots
solve in one ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from safe_control_tpu.barriers.hocbf import ct_cbf_row
from safe_control_tpu.core.types import is_dummy
from safe_control_tpu.dynamics import get_model
from safe_control_tpu.solvers.precision import highest
from safe_control_tpu.solvers.qp import solve_qp


class CBFQPResult(NamedTuple):
    u: jnp.ndarray  # (m,) filtered control
    feasible: jnp.ndarray  # bool scalar (status == 'optimal' analog)
    h_min: jnp.ndarray  # min barrier margin over active rows (diagnostics)


def _assemble(model, model_name, spec, x, u_ref, obs, dt, mode):
    """Build the QP data (P, q, A, l, u) plus the CBF rows for diagnostics."""
    m = model.N_CONTROLS

    if hasattr(model, "ct_multi_h"):
        # Multi-row models (Manipulator2D link circles): C rows per obstacle,
        # mirroring cbf_qp.py:131-149's expansion.
        from safe_control_tpu.barriers.hocbf import ct_cbf_rows_multi

        a_blocks, b_blocks = jax.vmap(
            lambda o: ct_cbf_rows_multi(model, x, o, spec, dt, mode)
        )(obs)  # (K, C, m), (K, C)
        dummy = jnp.repeat(is_dummy(obs), a_blocks.shape[1])
        a_rows = a_blocks.reshape(-1, m)
        b_vals = b_blocks.reshape(-1)
    else:
        a_rows, b_vals = jax.vmap(
            lambda o: ct_cbf_row(model, model_name, x, o, spec, dt, mode)
        )(obs)
        dummy = is_dummy(obs)
    # Inert rows for padded dummy obstacles: 0·u + 1 >= 0.
    a_rows = jnp.where(dummy[:, None], 0.0, a_rows)
    b_vals = jnp.where(dummy, 1.0, b_vals)

    P = 2.0 * jnp.eye(m, dtype=x.dtype)
    q = -2.0 * u_ref
    A = jnp.concatenate([a_rows, jnp.eye(m, dtype=x.dtype)], axis=0)
    l = jnp.concatenate([-b_vals, model.u_lb(spec)])
    u_up = jnp.concatenate([jnp.full((a_rows.shape[0],), jnp.inf, dtype=x.dtype),
                            model.u_ub(spec)])
    return P, q, A, l, u_up, a_rows, b_vals, dummy


def _result(sol, a_rows, b_vals, dummy) -> CBFQPResult:
    feasible = sol.prim_res < 1e-3
    margin = a_rows @ sol.x + b_vals
    h_min = jnp.min(jnp.where(dummy, jnp.inf, margin))
    return CBFQPResult(u=sol.x, feasible=feasible, h_min=h_min)


@highest
def solve(
    model_name: str,
    spec,
    x,
    u_ref,
    obs,
    dt: float,
    mode: str = "cbf",
    iters: int = 1600,
) -> CBFQPResult:
    """Solve one CBF-QP. ``obs`` is a fixed-shape (K, 7) padded array."""
    model = get_model(model_name)
    P, q, A, l, u_up, a_rows, b_vals, dummy = _assemble(
        model, model_name, spec, x, u_ref, obs, dt, mode
    )
    sol = solve_qp(P, q, A, l, u_up, iters=iters)
    return _result(sol, a_rows, b_vals, dummy)


# The region where the Pallas ADMM kernel was measured faster than the
# vmapped XLA loop on the card (PERF.md; chip_smoke.py phase d measures its
# corners): batches from 128 problems, up to 16 constraint rows.  Larger
# row counts (the manipulator's ~150) were not measured: one problem's data
# no longer fits a thread's registers.
KERNEL_MIN_BATCH = 128
KERNEL_MAX_ROWS = 16


def pick_backend(n_batch: int, n_rows: int) -> str:
    """``backend="auto"``: the kernel only on the GPU, only where measured
    faster than XLA."""
    if (
        jax.default_backend() == "gpu"
        and n_batch >= KERNEL_MIN_BATCH
        and n_rows <= KERNEL_MAX_ROWS
    ):
        return "pallas"
    return "xla"


@highest
def solve_batch(
    model_name: str,
    spec,
    xs,
    u_refs,
    obs_batch,
    dt: float,
    backend: str = "auto",
    interpret: bool = False,
    **kw,
):
    """vmap over robots; ``spec`` may itself be batched for heterogeneity.

    ``backend``: 'xla' vmaps the fori-loop ADMM (solvers/qp.py); 'pallas'
    assembles all QPs then runs the Pallas ADMM kernel on the GPU
    (solvers/qp_kernel.py; elsewhere it raises, unless ``interpret`` — for
    tests — runs it in the interpreter); 'auto' follows ``pick_backend``.
    """
    model = get_model(model_name)
    mode = kw.pop("mode", "cbf")
    in_axes = (None, 0, 0, 0) if not _is_batched(spec) else (0, 0, 0, 0)
    assemble = jax.vmap(
        lambda s, x, ur, ob: _assemble(model, model_name, s, x, ur, ob, dt, mode),
        in_axes=in_axes,
    )
    if backend == "auto":
        n_rows = jax.eval_shape(assemble, spec, xs, u_refs, obs_batch)[2].shape[1]
        backend = pick_backend(xs.shape[0], n_rows)
    if backend == "pallas":
        from safe_control_tpu.solvers.qp_kernel import solve_qp_batch_pallas

        P, q, A, l, u_up, a_rows, b_vals, dummy = assemble(
            spec, xs, u_refs, obs_batch
        )
        sols = solve_qp_batch_pallas(
            P, q, A, l, u_up, iters=kw.pop("iters", 1600), interpret=interpret
        )
        return jax.vmap(_result)(sols, a_rows, b_vals, dummy)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    fn = lambda s, x, ur, ob: solve(model_name, s, x, ur, ob, dt, mode=mode, **kw)
    return jax.vmap(fn, in_axes=in_axes)(spec, xs, u_refs, obs_batch)


def _is_batched(spec) -> bool:
    return hasattr(spec.radius, "ndim") and getattr(spec.radius, "ndim", 0) > 0

"""Pallas kernel (Triton route): batched dense QP ADMM, one problem per thread.

This is the hot op behind every CBF-QP control step (SURVEY.md §2.4: the
Gurobi/OSQP role).  The XLA path (solvers/qp.py under ``vmap``) runs the
ADMM sweeps as a 1,600-trip ``fori_loop``: a While loop whose small fused
body is launched once per trip.  Here ONE kernel launch runs the whole
staged-ADMM iteration loop, with

- one problem per GPU thread: every scalar of a problem is one element of a
  ``(tile,)`` vector, so the iteration state (x, z, y, rho) and the problem
  data stay in registers for the whole solve (a warp holds 32 problems);
- the n x n KKT factorization unrolled at trace time (closed-form Cholesky
  on per-thread scalars).

Equilibration and the one-shot active-set polish stay in plain JAX around the
kernel (they run once, not ``iters`` times).  Math is identical to
solvers/qp.py: OSQP-convention ADMM with over-relaxation and per-stage
adaptive rho.  ``interpret=True`` runs the same kernel on the CPU for tests.

Problems are laid out lane-major: one ``(rows, batch)`` array whose batch
axis is padded to a multiple of the tile, which Triton needs as a power of
two.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from safe_control_tpu.solvers.precision import highest
from safe_control_tpu.solvers.qp import QPSolution, _polish

N_STAGES = 8  # adaptive-rho refactorization points (matches qp.py)
# One warp per program, one problem per thread: the launch measured on the
# card (batches 128 and 4,096).  Registers, not shared memory, bound what a
# thread holds, so the tile never shrinks below a warp.
TILE = 32
NUM_WARPS = 1


def require_gpu() -> None:
    """Raise unless JAX's default backend is the GPU the kernel compiles for."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            "solve_qp_batch_pallas is a Pallas kernel for the GPU (Triton "
            f"route); the JAX backend is {backend!r}.  Use the XLA path "
            "(solvers/qp.py) on this backend."
        )


def lane_major(parts, tile: int):
    """Pack ``(B, ...)`` arrays into one ``(sum of row widths, Bp)`` array.

    The batch is zero-padded to ``Bp``, a multiple of ``tile``; the kernel
    keeps zero problems finite (their outputs are dropped).
    """
    x = jnp.concatenate([p.reshape(p.shape[0], -1) for p in parts], axis=1)
    pad = (-x.shape[0]) % tile
    return jnp.pad(x, ((0, pad), (0, 0))).T


def _chol(K, n):
    """Unrolled Cholesky of an n x n SPD matrix of per-thread scalars.

    ``K`` is a list-of-lists of (tile,) vectors; returns lower-triangular L
    in the same representation.
    """
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = K[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve(L, b, n):
    """Solve L L' x = b with unrolled forward/back substitution."""
    w = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * w[k]
        w[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = w[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _matvec(A, x, rows, cols):
    out = []
    for j in range(rows):
        s = A[j][0] * x[0]
        for i in range(1, cols):
            s = s + A[j][i] * x[i]
        out.append(s)
    return out


def _admm_kernel(in_ref, x_out, y_out, *, n, m, iters, rho0, sigma, alpha):
    """Staged ADMM for one tile of problems.

    ``in_ref`` rows: P (n*n, row-major), q (n), A (m*n, row-major), l (m),
    u (m).  Outputs: x (n rows), y (m rows), still in scaled variables.
    """
    o_p, o_q, o_a = 0, n * n, n * n + n
    o_l = o_a + m * n
    o_u = o_l + m
    P = [[in_ref[o_p + i * n + j] for j in range(n)] for i in range(n)]
    q = [in_ref[o_q + i] for i in range(n)]
    A = [[in_ref[o_a + j * n + i] for i in range(n)] for j in range(m)]
    lo = [in_ref[o_l + j] for j in range(m)]
    hi = [in_ref[o_u + j] for j in range(m)]

    # A'A once (symmetric): n^2 m FMAs.
    AtA = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[0][i] * A[0][j]
            for k in range(1, m):
                s = s + A[k][i] * A[k][j]
            AtA[i][j] = s
            AtA[j][i] = s

    zero = jnp.zeros_like(q[0])
    x = [zero] * n
    z = [zero] * m
    y = [zero] * m
    rho = jnp.full_like(q[0], rho0)
    per_stage = max(iters // N_STAGES, 1)

    def stage(_, carry):
        x, z, y, rho = carry
        # Refactor K = P + sigma I + rho A'A at the current (per-problem) rho.
        K = [
            [
                P[i][j] + rho * AtA[i][j] + (sigma if i == j else 0.0)
                for j in range(n)
            ]
            for i in range(n)
        ]
        L = _chol(K, n)

        def body(_, carry):
            x, z, y = carry
            # rhs = sigma x - q + A'(rho z - y)
            w = [rho * z[j] - y[j] for j in range(m)]
            rhs = []
            for i in range(n):
                s = sigma * x[i] - q[i]
                for j in range(m):
                    s = s + A[j][i] * w[j]
                rhs.append(s)
            xt = _chol_solve(L, rhs, n)
            x_new = [alpha * xt[i] + (1.0 - alpha) * x[i] for i in range(n)]
            # z update with over-relaxation + projection
            zt = _matvec(A, xt, m, n)
            z_new, y_new = [], []
            for j in range(m):
                z_hat = alpha * zt[j] + (1.0 - alpha) * z[j]
                zj = jnp.minimum(jnp.maximum(z_hat + y[j] / rho, lo[j]), hi[j])
                z_new.append(zj)
                y_new.append(y[j] + rho * (z_hat - zj))
            return (x_new, z_new, y_new)

        x, z, y = jax.lax.fori_loop(0, per_stage, body, (x, z, y))

        # Adaptive rho from the residual ratio (same rule as qp.py).
        ax = _matvec(A, x, m, n)
        r_prim = jnp.abs(ax[0] - z[0])
        for j in range(1, m):
            r_prim = jnp.maximum(r_prim, jnp.abs(ax[j] - z[j]))
        r_dual = None
        for i in range(n):
            s = q[i]
            for j in range(n):
                s = s + P[i][j] * x[j]
            for j in range(m):
                s = s + A[j][i] * y[j]
            r_dual = jnp.abs(s) if r_dual is None else jnp.maximum(r_dual, jnp.abs(s))
        ratio = jnp.sqrt(
            jnp.maximum(r_prim, 1e-12) / jnp.maximum(r_dual, 1e-12)
        )
        rho = jnp.clip(rho * jnp.clip(ratio, 0.1, 10.0), 1e-4, 1e5)
        return (x, z, y, rho)

    x, z, y, _ = jax.lax.fori_loop(0, N_STAGES, stage, (x, z, y, rho))

    for i in range(n):
        x_out[i] = x[i]
    for j in range(m):
        y_out[j] = y[j]


@functools.partial(
    jax.jit,
    static_argnames=("iters", "rho", "sigma", "alpha", "polish", "interpret"),
)
@highest
def solve_qp_batch_pallas(
    P,
    q,
    A,
    l,
    u,
    iters: int = 1600,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    polish: bool = True,
    interpret: bool = False,
) -> QPSolution:
    """Batched QP solve via the Pallas ADMM kernel.

    Arguments carry a leading batch axis: P (B,n,n), q (B,n), A (B,m,n),
    l/u (B,m).  Returns a batched ``QPSolution`` numerically matching
    ``vmap(solve_qp)`` (same equilibration, staged rho and polish).
    Compiles for the GPU; ``interpret=True`` runs it on any backend.
    """
    if not interpret:
        require_gpu()
    Bt, m, n = A.shape
    dtype = q.dtype

    # --- batched row+column equilibration (mirrors qp.py) -----------------
    row_norm = jnp.linalg.norm(A, axis=2)
    d = 1.0 / jnp.maximum(row_norm, 1e-6)  # (B, m)
    As = A * d[:, :, None]
    ls = jnp.where(jnp.isfinite(l), l * d, l)
    us = jnp.where(jnp.isfinite(u), u * d, u)
    col_norm = jnp.linalg.norm(As, axis=1)
    e = 1.0 / jnp.sqrt(jnp.maximum(col_norm, 1e-6))  # (B, n)
    As = As * e[:, None, :]
    Ps = e[:, :, None] * P * e[:, None, :]
    qs = q * e

    # --- lane-major layout; zero-padded problems stay finite (K = sigma I,
    # bounds [0, 0]) ---------------------------------------------------------
    packed = lane_major([Ps, qs, As, ls, us], TILE)
    Bp = packed.shape[1]

    kern = functools.partial(
        _admm_kernel, n=n, m=m, iters=iters, rho0=rho, sigma=sigma, alpha=alpha
    )
    spec = lambda rows: pl.BlockSpec((rows, TILE), lambda i: (0, i))
    x_t, y_t = pl.pallas_call(
        kern,
        grid=(Bp // TILE,),
        in_specs=[spec(packed.shape[0])],
        out_specs=(spec(n), spec(m)),
        out_shape=(
            jax.ShapeDtypeStruct((n, Bp), dtype),
            jax.ShapeDtypeStruct((m, Bp), dtype),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="qp_admm",
    )(packed)
    x_s = x_t.T[:Bt]  # (B, n), still in scaled variables
    y_s = y_t.T[:Bt]

    # --- one-shot polish + unscale + residuals (plain JAX, batched) --------
    if polish:
        x_s, y_s = jax.vmap(
            lambda Pb, qb, Ab, lb, ub, xb, yb: _polish(
                Pb, qb, Ab, lb, ub, xb, yb, 1e-8, 1e-4
            )
        )(Ps, qs, As, ls, us, x_s, y_s)

    x = e * x_s
    y = y_s * d
    Ax = jnp.einsum("bmn,bn->bm", A, x)
    prim = jnp.maximum(
        jnp.max(jnp.where(jnp.isfinite(l), (l - Ax) * d, -jnp.inf), axis=1),
        jnp.max(jnp.where(jnp.isfinite(u), (Ax - u) * d, -jnp.inf), axis=1),
    )
    prim = jnp.maximum(prim, 0.0)
    dual = jnp.max(
        jnp.abs(
            jnp.einsum("bij,bj->bi", P, x) + q + jnp.einsum("bmn,bm->bn", A, y)
        ),
        axis=1,
    )
    return QPSolution(x=x, y=y, prim_res=prim, dual_res=dual)

"""Tiered SPD solves for the AL-Gauss-Newton engines.

Batched ``cho_factor``/``cho_solve`` under ``vmap`` is a library call with
a serial chain per problem; these tiers unroll the factorization at trace
time instead, so it fuses with the rest of the solve.  The tier bounds are
open for re-measurement on the GPU (ROADMAP S4).  Three regimes:

- D <= _UNROLL_CHOL_MAX: fully-scalar trace-time unroll (~D^3/6 fused ops,
  each a (batch,)-wide elementwise op under ``vmap`` — the Pallas QP
  kernel's ``_chol``, solvers/qp_kernel.py).
- D <= _BLOCKED_CHOL_MAX: blocked unroll (8x8 blocks): D/8 tiny diagonal
  factorizations chained with triangular solves and rank-k updates that are
  (8, 8) matmuls — batched matmuls under ``vmap``, O((D/8)^3) trace ops.
- above: fall back to ``cho_factor`` (nothing in the repo needs it).

``chol_factor``/``chol_sub`` split factorization from substitution for
many-RHS uses (the KKT polish: 1 factor, n_con + 2 solves).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from safe_control_tpu.solvers.precision import highest


_UNROLL_CHOL_MAX = 40  # fully-scalar unroll of the Newton solve up to here
_BLOCKED_CHOL_MAX = 192  # blocked unroll above that (VTOL N=30 -> 120 vars)
_CHOL_BLOCK = 8  # block edge for the blocked factorization


def _chol_solve_unrolled(H, g):
    """Solve H x = g (SPD) with a trace-time-unrolled Cholesky.

    Unrolling at trace time turns the factorization into ~D^3/6 fused
    scalar ops, each of which is a (batch,)-wide elementwise op under
    ``vmap`` — the same trick as the Pallas QP kernel's ``_chol``
    (solvers/qp_kernel.py).
    """
    D = H.shape[0]
    L = [[None] * D for _ in range(D)]
    for i in range(D):
        for j in range(i + 1):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    w = [None] * D
    for i in range(D):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * w[k]
        w[i] = s / L[i][i]
    x = [None] * D
    for i in reversed(range(D)):
        s = w[i]
        for k in range(i + 1, D):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def _dense_chol_unrolled(A):
    """Unrolled Cholesky of a small (b, b) SPD jnp matrix -> lower L."""
    b = A.shape[0]
    L = [[None] * b for _ in range(b)]
    for i in range(b):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    zero = jnp.zeros((), A.dtype)
    return jnp.stack(
        [jnp.stack([L[i][j] if j <= i else zero for j in range(b)]) for i in range(b)]
    )


@highest
def _chol_solve_blocked(H, g, block=_CHOL_BLOCK):
    """Solve H x = g (SPD) via a trace-time-unrolled *blocked* Cholesky.

    The fully-scalar unroll (``_chol_solve_unrolled``) emits ~D^3/6 jaxpr ops
    — fine at D<=40, minutes of tracing at the VTOL/MPCC sizes (N=30, m=4 ->
    D=120).  The batched ``cho_factor`` library call is the other extreme.
    Blocking at ``block`` is the middle ground: D/block diagonal
    factorizations (tiny scalar unrolls) chained with triangular solves and
    symmetric-rank-k updates that are (block, block) matmuls — each a
    *batched* matmul under ``vmap`` instead of a scalar dependency
    chain.  Trace cost is O((D/block)^3) block ops (~600 matmuls
    at D=120), not O(D^3) scalar ops.
    """
    D = H.shape[0]
    b = block
    nb = -(-D // b)
    Dp = nb * b
    if Dp != D:
        pad = Dp - D
        H = jnp.pad(H, ((0, pad), (0, pad)))
        # identity on the padding diagonal keeps the factorization SPD
        H = H + jnp.diag(jnp.concatenate([jnp.zeros(D, H.dtype), jnp.ones(pad, H.dtype)]))
        g = jnp.pad(g, (0, pad))

    def blk(i, j):
        return H[i * b:(i + 1) * b, j * b:(j + 1) * b]

    L = [[None] * nb for _ in range(nb)]
    for k in range(nb):
        Akk = blk(k, k)
        for j in range(k):
            Akk = Akk - L[k][j] @ L[k][j].T
        Lkk = _dense_chol_unrolled(Akk)
        L[k][k] = Lkk
        for i in range(k + 1, nb):
            Aik = blk(i, k)
            for j in range(k):
                Aik = Aik - L[i][j] @ L[k][j].T
            # X Lkk' = Aik: forward substitution over Lkk columns
            cols = []
            for c in range(b):
                s = Aik[:, c]
                for d in range(c):
                    s = s - cols[d] * Lkk[c, d]
                cols.append(s / Lkk[c, c])
            L[i][k] = jnp.stack(cols, axis=1)

    # forward block solve  L w = g
    w = [None] * nb
    for i in range(nb):
        s = g[i * b:(i + 1) * b]
        for k in range(i):
            s = s - L[i][k] @ w[k]
        Lii = L[i][i]
        wi = []
        for c in range(b):
            t = s[c]
            for d in range(c):
                t = t - Lii[c, d] * wi[d]
            wi.append(t / Lii[c, c])
        w[i] = jnp.stack(wi)
    # backward block solve  L' x = w
    x = [None] * nb
    for i in reversed(range(nb)):
        s = w[i]
        for k in range(i + 1, nb):
            s = s - L[k][i].T @ x[k]
        Lii = L[i][i]
        xi = [None] * b
        for c in reversed(range(b)):
            t = s[c]
            for d in range(c + 1, b):
                t = t - Lii[d, c] * xi[d]
            xi[c] = t / Lii[c, c]
        x[i] = jnp.stack(xi)
    return jnp.concatenate(x)[:D]


@highest
def _chol_factor(H):
    """Lower-Cholesky factor as a dense matrix, trace-time unrolled.

    Scalar unroll up to ``_UNROLL_CHOL_MAX`` (O(D^3/6) trace ops), blocked
    unroll above it (O((D/8)^3) block ops, assembled dense afterwards).
    Pair with ``_chol_sub`` when one factorization serves many right-hand
    sides (the KKT polish: 1 factor, n_con + 2 solves).
    """
    D = H.shape[0]
    if D <= _UNROLL_CHOL_MAX:
        return _dense_chol_unrolled(H)
    b = _CHOL_BLOCK
    nb = -(-D // b)
    Dp = nb * b
    if Dp != D:
        pad = Dp - D
        H = jnp.pad(H, ((0, pad), (0, pad)))
        H = H + jnp.diag(
            jnp.concatenate([jnp.zeros(D, H.dtype), jnp.ones(pad, H.dtype)])
        )
    L = [[None] * nb for _ in range(nb)]
    for k in range(nb):
        Akk = H[k * b:(k + 1) * b, k * b:(k + 1) * b]
        for j in range(k):
            Akk = Akk - L[k][j] @ L[k][j].T
        Lkk = _dense_chol_unrolled(Akk)
        L[k][k] = Lkk
        for i in range(k + 1, nb):
            Aik = H[i * b:(i + 1) * b, k * b:(k + 1) * b]
            for j in range(k):
                Aik = Aik - L[i][j] @ L[k][j].T
            cols = []
            for c in range(b):
                s = Aik[:, c]
                for d in range(c):
                    s = s - cols[d] * Lkk[c, d]
                cols.append(s / Lkk[c, c])
            L[i][k] = jnp.stack(cols, axis=1)
    zero = jnp.zeros((b, b), H.dtype)
    full = jnp.block([[L[i][j] if j <= i else zero for j in range(nb)]
                      for i in range(nb)])
    return full[:D, :D]


def _chol_sub(L, g):
    """Solve L L' x = g by unrolled forward/back substitution (O(D^2) ops)."""
    D = L.shape[0]
    w = [None] * D
    for i in range(D):
        s = g[i]
        for k in range(i):
            s = s - L[i, k] * w[k]
        w[i] = s / L[i, i]
    x = [None] * D
    for i in reversed(range(D)):
        s = w[i]
        for k in range(i + 1, D):
            s = s - L[k, i] * x[k]
        x[i] = s / L[i, i]
    return jnp.stack(x)

"""Batched dense QP solver (OSQP-style ADMM + active-set polish).

The reference ships every control-step QP to Gurobi/OSQP via cvxpy
(cbf_qp.py:190, backup_cbf_qp.py:737-744) — one 2-4 variable, <=150 row dense
QP at a time on the host.  Here the solver is a fixed-iteration, branch-free
ADMM written in pure JAX so that thousands of independent QPs run batched on
one device via ``vmap`` (the reference's "native dependency" this replaces,
SURVEY.md §2.4).

Problem form (OSQP convention):

    minimize    0.5 x' P x + q' x
    subject to  l <= A x <= u

Notes on accuracy: after ``iters`` ADMM sweeps a single masked-KKT "polish"
solve is performed on the detected active set, which takes the solution to
near machine precision whenever the active set has been identified — this is
what makes <1e-3 parity with interior-point references achievable at fixed
iteration count.  All shapes are static; infeasibility is reported via the
returned residuals, never via control flow.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from safe_control_tpu.solvers.precision import highest


class QPSolution(NamedTuple):
    x: jnp.ndarray  # (n,) primal solution
    y: jnp.ndarray  # (m,) dual solution
    prim_res: jnp.ndarray  # scalar, max constraint violation
    dual_res: jnp.ndarray  # scalar, ||Px + q + A'y||_inf


@highest
def solve_qp(
    P,
    q,
    A,
    l,
    u,
    iters: int = 400,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    polish: bool = True,
    polish_reg: float = 1e-8,
    act_tol: float = 1e-4,
) -> QPSolution:
    """Solve one dense QP; wrap in ``vmap`` for batches.

    Row scaling: constraint rows are normalized to unit norm internally
    (Ruiz-style, one pass) which makes a fixed ``rho`` robust across the
    heterogeneous CBF/bound rows.
    """
    n = q.shape[0]
    m = A.shape[0]
    dtype = q.dtype

    # --- row + column equilibration ---------------------------------------
    # Row scaling alone is not enough: CBF rows can be 100:1 anisotropic in
    # the variables (e.g. slip-angle vs accel columns of the C3BF rows),
    # which stalls ADMM.  One Ruiz-like pass on both sides fixes it.
    A_orig, P_orig, q_orig = A, P, q
    row_norm = jnp.linalg.norm(A, axis=1)
    d = 1.0 / jnp.maximum(row_norm, 1e-6)
    # Rows that are entirely zero (padded constraints) get d=1 and +/-inf-safe
    # bounds; keep them inert.
    As = A * d[:, None]
    ls = jnp.where(jnp.isfinite(l), l * d, l)
    us = jnp.where(jnp.isfinite(u), u * d, u)
    col_norm = jnp.linalg.norm(As, axis=0)
    e = 1.0 / jnp.sqrt(jnp.maximum(col_norm, 1e-6))
    As = As * e[None, :]
    P = e[:, None] * P * e[None, :]
    q = q * e
    # From here the primal variable is x' with x = e * x'.

    # --- staged ADMM with adaptive rho ------------------------------------
    # OSQP-style: between stages, rho is rescaled by sqrt(prim/dual residual
    # ratio) and the small KKT matrix is refactorized.  A fixed rho stalls on
    # problems whose active geometry is ill-matched to it (observed: a
    # feasible 8-row CBF-QP needing 1000 iters at rho=1 vs 400 at rho=10).
    n_stages = 8
    per_stage = max(iters // n_stages, 1)
    AtA = As.T @ As
    eyeN = jnp.eye(n, dtype=dtype)

    def stage(carry, _):
        x, z, y, rho_c = carry
        K = P + sigma * eyeN + rho_c * AtA
        chol = jax.scipy.linalg.cho_factor(K, lower=True)

        def body(_, inner):
            x, z, y = inner
            rhs = sigma * x - q + As.T @ (rho_c * z - y)
            x_t = jax.scipy.linalg.cho_solve(chol, rhs)
            z_t = As @ x_t
            x_new = alpha * x_t + (1.0 - alpha) * x
            z_hat = alpha * z_t + (1.0 - alpha) * z
            z_new = jnp.clip(z_hat + y / rho_c, ls, us)
            y_new = y + rho_c * (z_hat - z_new)
            return (x_new, z_new, y_new)

        x, z, y = jax.lax.fori_loop(0, per_stage, body, (x, z, y))
        r_prim = jnp.max(jnp.abs(As @ x - z))
        r_dual = jnp.max(jnp.abs(P @ x + q + As.T @ y))
        scale_num = jnp.maximum(r_prim, 1e-12)
        scale_den = jnp.maximum(r_dual, 1e-12)
        rho_new = jnp.clip(
            rho_c * jnp.sqrt(scale_num / scale_den), rho_c * 0.1, rho_c * 10.0
        )
        rho_new = jnp.clip(rho_new, 1e-4, 1e5)
        return (x, z, y, rho_new), None

    x0 = jnp.zeros(n, dtype=dtype)
    z0 = jnp.zeros(m, dtype=dtype)
    y0 = jnp.zeros(m, dtype=dtype)
    (x, z, y, _), _ = jax.lax.scan(
        stage, (x0, z0, y0, jnp.asarray(rho, dtype)), None, length=n_stages
    )

    if polish:
        x, y = _polish(P, q, As, ls, us, x, y, polish_reg, act_tol)

    # Unscale primal (x = e x') and duals (y_orig = d_i * y_s).
    x = e * x
    y_orig = y * d

    # Residuals are reported in ROW-SCALED units: a row with norm 1e6 (e.g. a
    # far superellipsoid CBF row) solved to f32 precision has raw residual
    # ~1e-1 while being numerically exact — raw-unit feasibility tests would
    # spuriously fail on it.
    Ax = A_orig @ x
    prim_res = jnp.maximum(
        jnp.max(jnp.where(jnp.isfinite(l), (l - Ax) * d, -jnp.inf)),
        jnp.max(jnp.where(jnp.isfinite(u), (Ax - u) * d, -jnp.inf)),
    )
    prim_res = jnp.maximum(prim_res, 0.0)
    dual_res = jnp.max(jnp.abs(P_orig @ x + q_orig + A_orig.T @ y_orig))
    return QPSolution(x=x, y=y_orig, prim_res=prim_res, dual_res=dual_res)


def _polish(P, q, A, l, u, x, y, reg, act_tol):
    """Masked-KKT refinement on the detected active set.

    Builds the full (n+m) square KKT system where inactive constraint rows are
    replaced by the identity equation y_i = 0 — static shapes, no gather.
    Falls back to the ADMM iterate if the polished point is less feasible.
    """
    n = q.shape[0]
    m = A.shape[0]
    dtype = q.dtype
    Ax = A @ x
    lower_act = jnp.isfinite(l) & ((Ax - l < act_tol) | (y < -act_tol))
    upper_act = jnp.isfinite(u) & ((u - Ax < act_tol) | (y > act_tol))
    act = lower_act | upper_act
    bound = jnp.where(upper_act, jnp.where(jnp.isfinite(u), u, 0.0),
                      jnp.where(jnp.isfinite(l), l, 0.0))
    mask = act.astype(dtype)

    top = jnp.concatenate([P + reg * jnp.eye(n, dtype=dtype), (mask[:, None] * A).T], axis=1)
    bot = jnp.concatenate(
        [mask[:, None] * A, -reg * jnp.eye(m, dtype=dtype) + jnp.diag(mask - 1.0)],
        axis=1,
    )
    M = jnp.concatenate([top, bot], axis=0)
    rhs = jnp.concatenate([-q, mask * bound], axis=0)
    sol = jnp.linalg.solve(M, rhs)
    x_p, nu = sol[:n], sol[n:]
    # Dual signs: nu>0 at upper bound, nu<0 at lower bound per our convention
    # y' in P x + q + A' y = 0.
    y_p = nu * mask

    def viol(xx):
        axx = A @ xx
        v = jnp.maximum(
            jnp.max(jnp.where(jnp.isfinite(l), l - axx, -jnp.inf)),
            jnp.max(jnp.where(jnp.isfinite(u), axx - u, -jnp.inf)),
        )
        return jnp.maximum(v, 0.0)

    ok = jnp.isfinite(x_p).all() & (viol(x_p) <= viol(x) + 1e-7)
    x_out = jnp.where(ok, x_p, x)
    y_out = jnp.where(ok, y_p, y)
    return x_out, y_out


def solve_box_qp_batch(P, q, A, l, u, **kwargs):
    """vmapped convenience wrapper: leading batch axis on every argument."""
    fn = lambda P_, q_, A_, l_, u_: solve_qp(P_, q_, A_, l_, u_, **kwargs)
    return jax.vmap(fn)(P, q, A, l, u)

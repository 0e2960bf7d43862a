"""Shared augmented-Lagrangian Gauss-Newton trajectory optimizer core.

The engine behind MPC-CBF (solvers/mpc_cbf.py) and MPCC (solvers/mpcc.py):
minimize ||residual(U)||^2 subject to constraints(U) >= 0 and box bounds on
the flat decision vector, with

- forward-mode-only derivatives (reverse AD through a rollout scan is a
  multi-minute XLA compile; closed forms: grad = 2 Jr'r - Jc'act,
  H = 2 Jr'Jr + rho Jc_a'Jc_a),
- constraint rows normalized by their warm-start gradient norms,
- projected Newton with free-set masking at active box bounds,
- a cancellation-free merit-difference line search
  (L(a)-L(0) = (r_a-r_0)·(r_a+r_0) + [(act_a-act_0)·(act_a+act_0)]/(2rho)),
- capped-rho AL outer loop (feasibility from multipliers, not from
  f32-destroying penalties).

Everything is fixed-shape / fixed-iteration: one jit, vmap for fleets.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from safe_control_tpu.solvers.chol import (
    _BLOCKED_CHOL_MAX,
    _UNROLL_CHOL_MAX,
    _chol_solve_blocked,
    _chol_solve_unrolled,
)
from safe_control_tpu.solvers.precision import highest


class ALGNConfig(NamedTuple):
    outer_iters: int = 12
    newton_iters: int = 4
    rho0: float = 50.0
    rho_growth: float = 1.6
    rho_max: float = 2000.0
    reg: float = 1e-6


@highest
def solve(
    residual: Callable,
    constraints: Callable,
    U0_flat,
    lb_flat,
    ub_flat,
    cfg: ALGNConfig = ALGNConfig(),
):
    """Returns (U_flat, scaled constraint values at the solution)."""
    dtype = U0_flat.dtype
    nz = U0_flat.shape[0]

    Jc0 = jax.jacfwd(constraints)(U0_flat)
    c_scale = 1.0 / jnp.maximum(jnp.linalg.norm(Jc0, axis=1), 1e-2)

    def al_terms(Uf, lam, rho):
        r = residual(Uf)
        c = constraints(Uf) * c_scale
        act = jnp.maximum(0.0, lam - rho * c)
        return r, act

    def al_grad_hess(Uf, lam, rho):
        r, act = al_terms(Uf, lam, rho)
        Jr = jax.jacfwd(residual)(Uf)
        Jc = jax.jacfwd(lambda u: constraints(u) * c_scale)(Uf)
        grad = 2.0 * (Jr.T @ r) - Jc.T @ act
        active = (act > 0.0).astype(dtype)
        Jca = Jc * active[:, None]
        H = 2.0 * (Jr.T @ Jr) + rho * (Jca.T @ Jca)
        return grad, H

    alphas = jnp.array([1.0, 0.5, 0.25, 0.1, 0.03, 0.0], dtype=dtype)

    def newton_step(Uf, lam, rho):
        grad, H = al_grad_hess(Uf, lam, rho)
        H = H + cfg.reg * jnp.eye(nz, dtype=dtype) * (1.0 + jnp.trace(H) / nz)
        eps_b = 1e-7
        at_lb = (Uf <= lb_flat + eps_b) & (grad > 0.0)
        at_ub = (Uf >= ub_flat - eps_b) & (grad < 0.0)
        free = jnp.logical_not(at_lb | at_ub).astype(dtype)
        Hf = free[:, None] * H * free[None, :] + jnp.diag(1.0 - free)
        gf = free * grad
        if nz <= _UNROLL_CHOL_MAX:
            step = -_chol_solve_unrolled(Hf, gf)
        elif nz <= _BLOCKED_CHOL_MAX:
            # MPCC N=30 x 3 controls = 90 decision vars: the blocked unroll
            # instead of XLA's sequential cho_factor lowering (see chol.py).
            step = -_chol_solve_blocked(Hf, gf)
        else:
            step = -jax.scipy.linalg.cho_solve(
                jax.scipy.linalg.cho_factor(Hf, lower=True), gf
            )
        r0, act0 = al_terms(Uf, lam, rho)

        def merit_delta(a):
            cand = jnp.clip(Uf + a * step, lb_flat, ub_flat)
            r_a, act_a = al_terms(cand, lam, rho)
            return (r_a - r0) @ (r_a + r0) + ((act_a - act0) @ (act_a + act0)) / (
                2.0 * rho
            )

        vals = jax.vmap(merit_delta)(alphas)
        vals = jnp.where(jnp.isfinite(vals), vals, jnp.inf)
        # Noise-phase acceptance (see mpc_cbf.py newton_step): when even the
        # model's own predicted decrease is below the f32 merit resolution,
        # the argmin over measured deltas (which includes alpha=0 at exactly
        # 0) is a stall; take the damped Newton step instead.
        noise_floor = jnp.asarray(4.0 * jnp.finfo(dtype).eps, dtype) * (
            r0 @ r0 + (act0 @ act0) / (2.0 * rho)
        )
        pred = gf @ step + 0.5 * (step @ (Hf @ step))
        best = jnp.where(pred >= -noise_floor, 0, jnp.argmin(vals))
        return jnp.clip(Uf + alphas[best] * step, lb_flat, ub_flat)

    n_con = Jc0.shape[0]

    def outer_body(i, carry):
        Uf, lam, rho = carry
        Uf = jax.lax.fori_loop(
            0, cfg.newton_iters, lambda _, u: newton_step(u, lam, rho), Uf
        )
        c = constraints(Uf) * c_scale
        lam = jnp.maximum(0.0, lam - rho * c)
        rho = jnp.minimum(rho * cfg.rho_growth, cfg.rho_max)
        return (Uf, lam, rho)

    Uf, lam, _ = jax.lax.fori_loop(
        0,
        cfg.outer_iters,
        outer_body,
        (
            jnp.clip(U0_flat, lb_flat, ub_flat),
            jnp.zeros((n_con,), dtype=dtype),
            jnp.asarray(cfg.rho0, dtype),
        ),
    )
    c = constraints(Uf) * c_scale
    return Uf, c

"""Optimal-decay CBF-QP: decay-rate relaxation for pointwise feasibility.

JAX re-implementation of
/root/reference/position_control/optimal_decay_cbf_qp.py: the CBF row's
class-K gains are multiplied by decision variables omega1, omega2 that are
softly pinned to 1 with penalty p_sb = 1e4 (:56-130), which guarantees the
QP is always feasible (the filter "decays slower" instead of failing).

    min ||u - u_ref||^2 + p_sb1 (w1-1)^2 [+ p_sb2 (w2-1)^2]
    s.t. r=2:  A u + b_f + (a1+a2) hdot w1 + a1 a2 h w2 >= 0
         r=1:  A u + b_f + alpha h w1 >= 0
         input box

Decision vector z = [u; w1; w2] — still a tiny dense QP solved by the same
batched ADMM engine (solvers/qp.py).  One obstacle row, like the reference
(it filters only the nearest obstacle, :135-155).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from safe_control_tpu.barriers import hocbf
from safe_control_tpu.core.types import is_dummy
from safe_control_tpu.dynamics import get_model
from safe_control_tpu.solvers.qp import solve_qp
from safe_control_tpu.solvers.precision import highest

# Reference gains (:14-52): alpha = 0.5, omega ref 1.0, p_sb 1e4.
ALPHA1 = 0.5
ALPHA2 = 0.5
ALPHA_R1 = 0.5
OMEGA_REF = 1.0
P_SB = 1.0e4


class ODCBFResult(NamedTuple):
    u: jnp.ndarray
    omega1: jnp.ndarray
    omega2: jnp.ndarray
    feasible: jnp.ndarray


@highest
def solve(model_name: str, spec, x, u_ref, nearest_obs, dt, iters: int = 1600):
    """One optimal-decay CBF-QP solve for the nearest obstacle (7-vector)."""
    model = get_model(model_name)
    m = model.N_CONTROLS
    dtype = x.dtype
    r2 = model.REL_DEG == 2

    h_fn = lambda xx: hocbf.ct_h(model, model_name, xx, nearest_obs, spec)
    f_x, g_x = model.f(x, spec), model.g(x, spec)

    if r2:
        hdot_fn = lambda xx: jax.grad(h_fn)(xx) @ model.f(xx, spec)
        h = h_fn(x)
        hdot, dhd = jax.value_and_grad(hdot_fn)(x)
        a_u = dhd @ g_x
        b_f = dhd @ f_x
        # row over z = [u, w1, w2]
        row = jnp.concatenate(
            [a_u, jnp.array([(ALPHA1 + ALPHA2) * hdot, ALPHA1 * ALPHA2 * h])]
        )
        n_z = m + 2
    else:
        h, dh = jax.value_and_grad(h_fn)(x)
        a_u = dh @ g_x
        b_f = dh @ f_x
        row = jnp.concatenate([a_u, jnp.array([ALPHA_R1 * h, 0.0])])
        n_z = m + 2  # w2 unused but kept for fixed shape (pinned to 1)

    # Inert row for a dummy/absent obstacle.
    dummy = is_dummy(nearest_obs)
    row = jnp.where(dummy, jnp.zeros_like(row), row)
    b_f = jnp.where(dummy, 1.0, b_f)

    P = jnp.zeros((n_z, n_z), dtype=dtype)
    P = P.at[:m, :m].set(2.0 * jnp.eye(m, dtype=dtype))
    P = P.at[m, m].set(2.0 * P_SB)
    P = P.at[m + 1, m + 1].set(2.0 * P_SB)
    q = jnp.concatenate(
        [-2.0 * u_ref, jnp.array([-2.0 * P_SB * OMEGA_REF, -2.0 * P_SB * OMEGA_REF])]
    )

    A = jnp.concatenate([row[None, :], jnp.eye(n_z, dtype=dtype)], axis=0)
    inf = jnp.inf
    l = jnp.concatenate(
        [jnp.array([-b_f]), model.u_lb(spec), jnp.array([-inf, -inf])]
    )
    u_up = jnp.concatenate(
        [jnp.array([inf]), model.u_ub(spec), jnp.array([inf, inf])]
    )
    sol = solve_qp(P, q, A, l, u_up, iters=iters)
    return ODCBFResult(
        u=sol.x[:m],
        omega1=sol.x[m],
        omega2=sol.x[m + 1],
        feasible=sol.prim_res < 1e-3,
    )

"""BackupCBF: backup-policy CBF-QP with exact sensitivity propagation.

JAX re-implementation of
/root/reference/position_control/backup_cbf_qp.py.  The reference rolls out
the backup policy and propagates sensitivity matrices S_k by an
n-dimensional finite-difference loop per step (:283-316 — ~N*n dynamics
evaluations per control step, the single hottest Python loop in the repo);
here the closed-loop step Jacobian comes from one ``jax.jacfwd`` inside a
``lax.scan``, exact and ~n times cheaper.

QP rows (:623-671): for each backup step i,

    grad_h(phi_i)' S_i g(x0) u >= -grad_h' S_i f(x0) + grad_h' f_pi_i
                                   - dh/dt - alpha h(phi_i)

(moving-obstacle dh/dt by the reference's one-dt finite difference in t,
backup-drift f_pi by trajectory differencing), plus the terminal
invariant-set row without the drift term (:659-671).  Inputs are scaled to
O(1) by actuator limits with weights Q_u (:678-727).  The multi-level
fallback ladder is preserved (:767-784): QP fail + safe -> nominal,
QP fail + unsafe -> raw backup.

``h_safety(x, t)`` and ``h_terminal(x)`` are caller-supplied pure functions
(the reference hardcodes env-specific min-of-halfspace/dist forms,
:341-553; see envs/* for building blocks); gradients come from ``jax.grad``
instead of finite differences.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from safe_control_tpu.dynamics import get_model
from safe_control_tpu.solvers.qp import solve_qp
from safe_control_tpu.solvers.precision import highest


@dataclasses.dataclass(frozen=True)
class BackupCBFConfig:
    model_name: str
    dt: float = 0.05
    backup_steps: int = 40  # N = backup_horizon / dt (:56)
    alpha: float = 1.0  # (:50)
    alpha_terminal: float = 2.0  # (:51)
    intervention_tol: float = 0.1  # (:766)
    qp_iters: int = 800


class BackupCBFResult(NamedTuple):
    u: jnp.ndarray
    using_backup: jnp.ndarray
    h_min: jnp.ndarray  # min safety/terminal h along the backup rollout
    qp_ok: jnp.ndarray
    phi: jnp.ndarray  # (N, n) backup rollout (for visualization)


def _q_u(model_name: str, m: int):
    # (:100-108): DriftingCar [1, 10]; others ones.
    if model_name == "DriftingCar":
        return jnp.array([1.0, 10.0])
    return jnp.ones((m,))


@highest
def solve(
    cfg: BackupCBFConfig,
    spec,
    x0,
    u_ref,
    backup_policy: Callable,
    h_safety: Callable,  # (x, t) -> scalar
    h_terminal: Callable,  # (x,) -> scalar
    has_moving_obstacles: bool = True,
) -> BackupCBFResult:
    model = get_model(cfg.model_name)
    n, m = model.N_STATES, model.N_CONTROLS
    dt = cfg.dt
    N = cfg.backup_steps
    dtype = x0.dtype

    # ---- backup rollout + exact sensitivities (scan + jacfwd) ----------
    def closed_loop(x):
        return model.step(x, backup_policy(x), spec, dt)

    def body(carry, _):
        x, S = carry
        A = jax.jacfwd(closed_loop)(x)
        x1 = closed_loop(x)
        S1 = A @ S
        return (x1, S1), (x1, S1)

    S0 = jnp.eye(n, dtype=dtype)
    (_, _), (phi_tail, S_tail) = jax.lax.scan(
        body, (x0, S0), None, length=N - 1
    )
    phi = jnp.concatenate([x0[None], phi_tail], axis=0)  # (N, n)
    S = jnp.concatenate([S0[None], S_tail], axis=0)  # (N, n, n)

    ts = jnp.arange(N, dtype=dtype) * dt
    h_vals = jax.vmap(h_safety)(phi, ts)
    h_term = h_terminal(phi[-1])
    h_min = jnp.minimum(jnp.min(h_vals), h_term)

    f0 = model.f(x0, spec)
    g0 = model.g(x0, spec)

    # ---- safety rows i = 1..N-1 (:623-657) ------------------------------
    # f_pi drift by trajectory differencing; forward difference, backward at
    # the end (:641-646).
    f_pi = jnp.concatenate(
        [(phi[2:] - phi[1:-1]) / dt, ((phi[-1] - phi[-2]) / dt)[None]], axis=0
    )  # (N-1, n) for i = 1..N-1

    def safety_row(i):
        x_i, S_i, t_i = phi[i], S[i], ts[i]
        h_val = h_safety(x_i, t_i)
        grad_h = jax.grad(lambda xx: h_safety(xx, t_i))(x_i)
        if has_moving_obstacles:
            dh_dt = (h_safety(x_i, t_i + dt) - h_val) / dt
        else:
            dh_dt = jnp.asarray(0.0, dtype)
        lhs = grad_h @ S_i @ g0
        rhs = (
            -(grad_h @ S_i @ f0)
            + grad_h @ f_pi[i - 1]
            - dh_dt
            - cfg.alpha * h_val
        )
        return lhs, rhs

    idxs = jnp.arange(1, N)
    G_s, h_s = jax.vmap(safety_row)(idxs)

    # ---- terminal row (:659-671) ----------------------------------------
    grad_ht = jax.grad(h_terminal)(phi[-1])
    lhs_t = grad_ht @ S[-1] @ g0
    rhs_t = -(grad_ht @ S[-1] @ f0 + cfg.alpha_terminal * h_term)

    G = jnp.concatenate([G_s, lhs_t[None]], axis=0)  # (N, m)
    h_b = jnp.concatenate([h_s, rhs_t[None]], axis=0)

    # Inert rows where ||lhs|| ~ 0 (:648-649).
    tiny = jnp.linalg.norm(G, axis=1) <= 1e-6
    G = jnp.where(tiny[:, None], 0.0, G)
    h_b = jnp.where(tiny, -1.0, h_b)  # 0 u >= -1, always true

    # ---- scaled QP (:678-744) -------------------------------------------
    u_scale = model.u_ub(spec)  # symmetric limits assumed (:685-699)
    u_ref_c = jnp.clip(u_ref, -u_scale, u_scale)
    Qu = _q_u(cfg.model_name, m).astype(dtype)
    w = Qu / u_scale
    P = 2.0 * jnp.diag(w**2)
    q = -2.0 * (w**2) * u_ref_c
    A = jnp.concatenate([G, jnp.eye(m, dtype=dtype)], axis=0)
    inf = jnp.inf
    l = jnp.concatenate([h_b, -u_scale])
    u_up = jnp.concatenate([jnp.full((N,), inf, dtype=dtype), u_scale])
    sol = solve_qp(P, q, A, l, u_up, iters=cfg.qp_iters)
    qp_ok = sol.prim_res < 1e-3

    # intervention metric in scaled units (:756-766)
    diff_scaled = Qu * (sol.x - u_ref_c) / u_scale
    intervened = jnp.linalg.norm(diff_scaled) > cfg.intervention_tol

    # ---- fallback ladder (:767-784) -------------------------------------
    u_backup = backup_policy(x0)
    safe_now = h_min > 0.01
    u_out = jnp.where(
        qp_ok,
        sol.x,
        jnp.where(safe_now, u_ref_c, u_backup),
    )
    using_backup = jnp.where(qp_ok, intervened, ~safe_now)
    return BackupCBFResult(
        u=u_out, using_backup=using_backup, h_min=h_min, qp_ok=qp_ok, phi=phi
    )

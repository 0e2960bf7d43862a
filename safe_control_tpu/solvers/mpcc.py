"""MPCC — model-predictive contouring control for the drift car.

JAX re-implementation of the reference's position_control/mpcc.py:
augmented 9-state [x, y, theta, r, beta, V, delta, tau, psi] with
path-progress input v_psi (:50-53, :150-159); contouring / lag / heading /
velocity / yaw-rate stage costs against path references sampled at
psi_k = psi_now + k v_psi_ref dt (:163-190, :263-280); state bounds as
constraints (:235-245); arc-length path representation with linear interp
(:295-345) and a windowed closest-point search that cannot jump across
track folds (:347-413).  Instead of a do-mpc/IPOPT NLP per step, the solve
is the shared AL-Gauss-Newton engine (solvers/al_gn.py) — fixed-iteration,
jit-able, vmap-able.  Full predictions are stored for the gatekeeper
handoff (:454-491).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from safe_control_tpu.core.types import angle_normalize
from safe_control_tpu.dynamics import dynamic_bicycle2d as dyn
from safe_control_tpu.solvers import al_gn
from safe_control_tpu.solvers.precision import highest

N_CONTROLS = 3  # [delta_dot, tau_dot, v_psi]


@dataclasses.dataclass(frozen=True)
class MPCCConfig:
    horizon: int = 30
    # Cost weights (:56-64)
    q_c: float = 100.0
    q_l: float = 5.0
    q_theta: float = 30.0
    q_v: float = 20.0
    q_r: float = 10.0
    v_ref: float = 5.0
    r_delta_dot: float = 50.0
    r_tau_dot: float = 0.01
    r_v_psi: float = 0.1
    v_psi_ref: float = 2.0
    v_psi_min: float = 0.1  # (:252)
    v_psi_max: float = 15.0
    search_window: float = 40.0  # closest-point window (:78)
    search_back: float = 10.0
    al: al_gn.ALGNConfig = al_gn.ALGNConfig()
    # Rollout-scan unroll factor — same dispatch-latency knob as
    # MPCConfig.scan_unroll (the N-step rollout is a serial chain of small
    # kernels; at batch=1 XLA can fuse across unrolled steps).  Keep 1 for
    # batched/throughput use.
    scan_unroll: int = 1


class Path(NamedTuple):
    """Arc-length parametrized polyline (mpcc.py:295-345)."""

    s: jnp.ndarray  # (P,) cumulative arc length
    x: jnp.ndarray  # (P,)
    y: jnp.ndarray  # (P,)
    theta: jnp.ndarray  # (P,)


def make_path(path_x, path_y, path_theta=None) -> Path:
    path_x = jnp.asarray(path_x, dtype=jnp.float32)
    path_y = jnp.asarray(path_y, dtype=jnp.float32)
    ds = jnp.sqrt(jnp.diff(path_x) ** 2 + jnp.diff(path_y) ** 2)
    s = jnp.concatenate([jnp.zeros(1), jnp.cumsum(ds)])
    if path_theta is None:
        th = jnp.arctan2(jnp.diff(path_y), jnp.diff(path_x))
        path_theta = jnp.concatenate([th, th[-1:]])
    return Path(s=s, x=path_x, y=path_y, theta=jnp.asarray(path_theta, jnp.float32))


def path_reference(path: Path, psi):
    """Interpolated (x_ref, y_ref, theta_ref) at arc length psi (:326-345)."""
    psi = jnp.clip(psi, path.s[0], path.s[-1])
    xr = jnp.interp(psi, path.s, path.x)
    yr = jnp.interp(psi, path.s, path.y)
    # Angle interp via sin/cos to avoid wrap artifacts.
    cr = jnp.interp(psi, path.s, jnp.cos(path.theta))
    sr = jnp.interp(psi, path.s, jnp.sin(path.theta))
    return xr, yr, jnp.arctan2(sr, cr)


def closest_path_psi(path: Path, pos, psi_now, cfg: MPCCConfig, global_search=False):
    """Windowed closest-point search (:347-413): only points with
    s in [psi - back, psi + window] compete, preventing track-fold jumps."""
    d2 = (path.x - pos[0]) ** 2 + (path.y - pos[1]) ** 2
    in_win = (path.s >= psi_now - cfg.search_back) & (
        path.s <= psi_now + cfg.search_window
    )
    use_global = global_search | (~jnp.any(in_win))
    score = jnp.where(use_global | in_win, d2, jnp.inf)
    return path.s[jnp.argmin(score)]


class MPCCState(NamedTuple):
    U: jnp.ndarray  # (N, 3) warm start
    psi: jnp.ndarray  # scalar path progress
    initialized: jnp.ndarray  # bool


class MPCCResult(NamedTuple):
    u: jnp.ndarray  # (2,) [delta_dot, tau_dot] applied to the car
    state: MPCCState
    xs: jnp.ndarray  # (N+1, 9) predicted augmented states
    us: jnp.ndarray  # (N, 3) predicted inputs
    viol: jnp.ndarray


def init_state(cfg: MPCCConfig, dtype=jnp.float32) -> MPCCState:
    U = jnp.zeros((cfg.horizon, 3), dtype=dtype).at[:, 2].set(cfg.v_psi_ref)
    return MPCCState(
        U=U, psi=jnp.asarray(0.0, dtype), initialized=jnp.asarray(False)
    )


def _aug_step(x9, u3, spec, dt):
    """Unclamped augmented dynamics (mpcc.py:126-161): raw f/g Euler for the
    body states (bounds are constraints, not clamps), kinematic coupling for
    the pose, psi' = v_psi."""
    X_dyn = x9[3:8]
    f_d = dyn.f(X_dyn, spec)
    g_d = dyn.g(X_dyn, spec)
    X_dyn_next = X_dyn + (f_d + g_d @ u3[:2]) * dt
    theta, r, beta, V = x9[2], x9[3], x9[4], x9[5]
    x_next = x9[0] + V * jnp.cos(theta + beta) * dt
    y_next = x9[1] + V * jnp.sin(theta + beta) * dt
    th_next = theta + r * dt
    psi_next = x9[8] + u3[2] * dt
    return jnp.concatenate(
        [jnp.array([x_next, y_next, th_next]), X_dyn_next, jnp.array([psi_next])]
    )


@highest
def solve(
    spec,
    x8,  # (8,) DriftingCar global state
    path: Path,
    mpcc_state: MPCCState,
    u_prev,  # (2,) last applied [delta_dot, tau_dot]
    dt: float,
    cfg: MPCCConfig = MPCCConfig(),
) -> MPCCResult:
    N = cfg.horizon
    dtype = x8.dtype

    # Path progress: global search on first call, windowed after (:70-76).
    psi0 = closest_path_psi(
        path, x8[:2], mpcc_state.psi, cfg, global_search=~mpcc_state.initialized
    )

    # Per-stage path references (TVP analog, :263-280).
    psis = psi0 + jnp.arange(N + 1, dtype=dtype) * cfg.v_psi_ref * dt
    xr, yr, thr = jax.vmap(lambda p: path_reference(path, p))(psis)

    x0 = jnp.concatenate([x8, psi0[None]])

    def rollout(U):
        def body(x, u):
            x1 = _aug_step(x, u, spec, dt)
            return x1, x1

        _, xs = jax.lax.scan(body, x0, U, unroll=cfg.scan_unroll)
        return xs  # (N, 9): x_1..x_N

    sq = jnp.sqrt
    Rw = jnp.array([cfg.r_delta_dot, cfg.r_tau_dot, cfg.r_v_psi], dtype=dtype)
    uprev3 = jnp.concatenate([u_prev, jnp.array([cfg.v_psi_ref], dtype=dtype)])

    def residual(Uf):
        U = Uf.reshape(N, 3)
        xs = rollout(U)
        dx = xs[:, 0] - xr[1:]
        dy = xs[:, 1] - yr[1:]
        e_c = jnp.sin(thr[1:]) * dx - jnp.cos(thr[1:]) * dy
        e_l = -jnp.cos(thr[1:]) * dx - jnp.sin(thr[1:]) * dy
        e_th = angle_normalize(xs[:, 2] - thr[1:])
        e_v = xs[:, 5] - cfg.v_ref
        du = jnp.diff(jnp.concatenate([uprev3[None], U], axis=0), axis=0)
        return jnp.concatenate(
            [
                sq(cfg.q_c) * e_c,
                sq(cfg.q_l) * e_l,
                sq(cfg.q_theta) * e_th,
                sq(cfg.q_v) * e_v,
                sq(cfg.q_r) * xs[:, 3],
                (du * sq(Rw)[None, :]).ravel(),
            ]
        )

    # State bounds on r, beta, V, delta, tau as constraints (:235-245).
    lbs = jnp.array(
        [-spec.r_max, -spec.beta_max, spec.v_min, -spec.delta_max, -spec.tau_max]
    )
    ubs = jnp.array(
        [spec.r_max, spec.beta_max, spec.v_max, spec.delta_max, spec.tau_max]
    )

    def constraints(Uf):
        xs = rollout(Uf.reshape(N, 3))
        body = xs[:, 3:8]
        return jnp.concatenate(
            [(ubs[None, :] - body).ravel(), (body - lbs[None, :]).ravel()]
        )

    lb_u = jnp.array([-spec.delta_dot_max, -spec.tau_dot_max, cfg.v_psi_min])
    ub_u = jnp.array([spec.delta_dot_max, spec.tau_dot_max, cfg.v_psi_max])

    U0 = jnp.concatenate([mpcc_state.U[1:], mpcc_state.U[-1:]], axis=0)
    Uf, c = al_gn.solve(
        residual,
        constraints,
        U0.ravel(),
        jnp.tile(lb_u, N),
        jnp.tile(ub_u, N),
        cfg.al,
    )
    U = Uf.reshape(N, 3)
    xs = jnp.concatenate([x0[None], rollout(U)], axis=0)
    viol = jnp.maximum(0.0, -jnp.min(c))
    return MPCCResult(
        u=U[0, :2],
        state=MPCCState(U=U, psi=psi0, initialized=jnp.asarray(True)),
        xs=xs,
        us=U,
        viol=viol,
    )

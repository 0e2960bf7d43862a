"""DriftingCar: global 8-state wrapper over DynamicBicycle2D.

JAX re-implementation of the reference's robots/drifting_car.py:
X = [x, y, theta, r, beta, V, delta, tau], U = [delta_dot, tau_dot].
Kinematic coupling x_dot = V cos(theta+beta), y_dot = V sin(theta+beta),
theta_dot = r (:474-530 step; note the reference advances position with the
NEXT dynamics state and the CURRENT heading — mirrored here exactly).
``f``/``g`` give the full 8-dim affine dynamics for BackupCBF (:405-464);
``nominal_input`` is the cascaded P steering/torque law (:540-575).
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.dynamics import dynamic_bicycle2d as dyn
from safe_control_tpu.dynamics.base import angle_normalize

N_STATES = 8
N_CONTROLS = 2
REL_DEG = 1


def f(x, spec):
    """Full-state drift dynamics (f_full, :405-439)."""
    f_dyn = dyn.f(x[3:8], spec)
    theta, r, beta, V = x[2], x[3], x[4], x[5]
    return jnp.concatenate(
        [
            jnp.array([V * jnp.cos(theta + beta), V * jnp.sin(theta + beta), r]),
            f_dyn,
        ]
    )


def g(x, spec):
    """Full-state control matrix (g_full, :441-464)."""
    G = jnp.zeros((8, 2), dtype=x.dtype)
    return G.at[6, 0].set(1.0).at[7, 1].set(1.0)


def step(x, u, spec, dt):
    """Global step mirroring drifting_car.py:474-530: dynamics first, then
    position integration with next (V, beta, r) and current theta."""
    x_dyn_next = dyn.step(x[3:8], u, spec, dt)
    theta = x[2]
    r, beta, V = x_dyn_next[0], x_dyn_next[1], x_dyn_next[2]
    xg = x[0] + V * jnp.cos(theta + beta) * dt
    yg = x[1] + V * jnp.sin(theta + beta) * dt
    th = angle_normalize(theta + r * dt)
    return jnp.concatenate([jnp.array([xg, yg, th]), x_dyn_next])


def nominal_input(x, goal, spec, d_min=0.5):
    """Cascaded P steering + torque-rate law (:540-575)."""
    dx_, dy_ = goal[0] - x[0], goal[1] - x[1]
    distance = jnp.sqrt(dx_**2 + dy_**2)
    heading_err = angle_normalize(jnp.arctan2(dy_, dx_) - x[2])
    delta_des = jnp.clip(2.0 * heading_err, -spec.delta_max, spec.delta_max)
    delta_dot = jnp.clip(
        3.0 * (delta_des - x[6]), -spec.delta_dot_max, spec.delta_dot_max
    )
    V_des = jnp.minimum(distance, spec.v_max)
    tau_des = jnp.clip(500.0 * (V_des - x[5]), -spec.tau_max, spec.tau_max)
    tau_dot = jnp.clip(
        2000.0 * (tau_des - x[7]), -spec.tau_dot_max, spec.tau_dot_max
    )
    return jnp.array([delta_dot, tau_dot])


def stop(x, spec):
    return dyn.stop(x[3:8], spec)


def has_stopped(x, spec, tol=0.5):
    return dyn.has_stopped(x[3:8], spec, tol)


def rotate_to(x, theta_des, spec):
    return jnp.zeros(2, dtype=x.dtype)


def u_lb(spec):
    return dyn.u_lb(spec)


def u_ub(spec):
    return dyn.u_ub(spec)


def state_bounds(spec):
    inf = jnp.inf
    lb_d, ub_d = dyn.state_bounds(spec)
    return (
        jnp.concatenate([jnp.array([-inf, -inf, -inf]), lb_d]),
        jnp.concatenate([jnp.array([inf, inf, inf]), ub_d]),
    )


def barrier_pos(x):
    return x[:2]

"""KinematicBicycle2D: X=[x, y, theta, v], U=[a, beta_slip], relative degree 2.

JAX re-implementation of the behavior of
/root/reference/robots/kinematic_bicycle2D.py (slip-angle maps :55-65,
f/g :75-110, step with v clip :112-123, nominal_input :125-147, stop :149-150,
rotate_to :155-158).
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.dynamics.base import angle_normalize, masked_apply

N_STATES = 4
N_CONTROLS = 2
REL_DEG = 2


def beta_from_delta(delta, spec):
    """Slip angle from steering angle (:55-59)."""
    return jnp.arctan((spec.rear_ax_dist / spec.wheel_base) * jnp.tan(delta))


def delta_from_beta(beta, spec):
    """Steering angle from slip angle (:61-65)."""
    return jnp.arctan((spec.wheel_base / spec.rear_ax_dist) * jnp.tan(beta))


def f(x, spec):
    return jnp.array(
        [x[3] * jnp.cos(x[2]), x[3] * jnp.sin(x[2]), 0.0, 0.0], dtype=x.dtype
    )


def g(x, spec):
    theta, v = x[2], x[3]
    z = jnp.zeros((), dtype=x.dtype)
    return jnp.array(
        [
            [z, -v * jnp.sin(theta)],
            [z, v * jnp.cos(theta)],
            [z, v / spec.rear_ax_dist],
            [jnp.ones((), dtype=x.dtype), z],
        ]
    )


def step(x, u, spec, dt):
    x = x + (f(x, spec) + g(x, spec) @ u) * dt
    x = masked_apply(x, angle_normalize, 2, 3)
    return masked_apply(x, lambda v: jnp.clip(v, spec.v_min, spec.v_max), 3, 4)


def nominal_input(x, goal, spec, d_min=0.05, k_theta=0.5, k_a=1.5, k_v=0.5):
    distance = jnp.maximum(jnp.linalg.norm(x[:2] - goal[:2]) - d_min, 0.05)
    theta_d = jnp.arctan2(goal[1] - x[1], goal[0] - x[0])
    err = angle_normalize(theta_d - x[2])
    delta = jnp.clip(k_theta * err, -spec.delta_max, spec.delta_max)
    beta = beta_from_delta(delta, spec)
    heading_scale = jnp.maximum(0.0, jnp.cos(err))
    v_cmd = k_v * distance * heading_scale
    v = jnp.clip(v_cmd, spec.v_min, spec.v_max)
    a = k_a * (v - x[3])
    return jnp.array([a, beta])


def stop(x, spec):
    return jnp.zeros(2, dtype=x.dtype)


def has_stopped(x, spec, tol=0.05):
    return jnp.abs(x[3]) < tol


def rotate_to(x, theta_des, spec, k_theta=2.0):
    err = angle_normalize(theta_des - x[2])
    return jnp.array([0.0, k_theta * err])


def u_lb(spec):
    return jnp.array([-spec.a_max, -spec.beta_max])


def u_ub(spec):
    return jnp.array([spec.a_max, spec.beta_max])


def state_bounds(spec):
    inf = jnp.inf
    return (
        jnp.array([-inf, -inf, -inf, -spec.v_max]),
        jnp.array([inf, inf, inf, spec.v_max]),
    )


def barrier_pos(x):
    return x[:2]

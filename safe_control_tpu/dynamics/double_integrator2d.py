"""DoubleIntegrator2D: X=[x, y, vx, vy], U=[ax, ay], relative degree 2.

JAX re-implementation of the behavior of
/root/reference/robots/double_integrator2D.py (f/g :46-77, step with
velocity-norm clamp :79-107, nominal_input :113-140, stop :150-156,
has_stopped :158-159, rotate_to :161-165).
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.dynamics.base import angle_normalize, masked_apply

N_STATES = 4
N_CONTROLS = 2
REL_DEG = 2


def f(x, spec):
    return jnp.array([x[2], x[3], 0.0, 0.0], dtype=x.dtype)


def g(x, spec):
    return jnp.array(
        [[0.0, 0.0], [0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], dtype=x.dtype
    )


def step(x, u, spec, dt):
    x = x + (f(x, spec) + g(x, spec) @ u) * dt
    # Velocity-magnitude clamp (:82-106); branch-free.
    v_mag = jnp.sqrt(x[2] ** 2 + x[3] ** 2)
    scale = jnp.where(v_mag > spec.v_max, spec.v_max / jnp.maximum(v_mag, 1e-9), 1.0)
    return masked_apply(x, lambda v: v * scale, 2, 4)


def nominal_input(x, goal, spec, d_min=0.05):
    k_v = spec.nominal_k_v
    k_a = spec.nominal_k_a
    pos_err = goal[:2] - x[:2]
    pos_err = jnp.sign(pos_err) * jnp.maximum(jnp.abs(pos_err) - d_min, 0.0)
    v_des = k_v * pos_err
    v_mag = jnp.linalg.norm(v_des)
    v_des = v_des * jnp.where(
        v_mag > spec.v_max, spec.v_max / jnp.maximum(v_mag, 1e-9), 1.0
    )
    a = k_a * (v_des - x[2:4])
    a_mag = jnp.linalg.norm(a)
    a = a * jnp.where(a_mag > spec.a_max, spec.a_max / jnp.maximum(a_mag, 1e-9), 1.0)
    return a


def stop(x, spec):
    return spec.nominal_k_a * (0.0 - x[2:4])


def has_stopped(x, spec, tol=0.05):
    return jnp.linalg.norm(x[2:4]) < tol


def rotate_to(x, theta_des, spec, k_omega=2.0):
    # Positional input is zero while rotating in place (yaw side-channel).
    return jnp.zeros(2, dtype=x.dtype)


def yaw_rate_to(yaw, theta_des, spec, k_omega=2.0):
    err = angle_normalize(theta_des - yaw)
    return jnp.clip(k_omega * err, -spec.w_max, spec.w_max)


def u_lb(spec):
    return jnp.array([-spec.ax_max, -spec.ay_max])


def u_ub(spec):
    return jnp.array([spec.ax_max, spec.ay_max])


def state_bounds(spec):
    inf = jnp.inf
    return jnp.array([-inf, -inf, -inf, -inf]), jnp.array([inf, inf, inf, inf])


def barrier_pos(x):
    return x[:2]

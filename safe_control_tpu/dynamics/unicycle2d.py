"""Unicycle2D: X=[x, y, theta], U=[v, omega], relative degree 1.

JAX re-implementation of the behavior of
/root/reference/robots/unicycle2D.py (f/g :43-63, step :65-68,
nominal_input :70-86, rotate_to :95-98, sigma heading shaping :100-105).
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.dynamics.base import angle_normalize, masked_apply

N_STATES = 3
N_CONTROLS = 2
REL_DEG = 1

# Sigmoid heading-shaping constants (unicycle2D.py:37-38).
SIGMA_K1 = 0.5
SIGMA_K2 = 1.8


def f(x, spec):
    return jnp.zeros(3, dtype=x.dtype)


def g(x, spec):
    c, s = jnp.cos(x[2]), jnp.sin(x[2])
    z = jnp.zeros((), dtype=x.dtype)
    one = jnp.ones((), dtype=x.dtype)
    return jnp.array([[c, z], [s, z], [z, one]])


def step(x, u, spec, dt):
    x = x + (f(x, spec) + g(x, spec) @ u) * dt
    return masked_apply(x, angle_normalize, 2, 3)


def nominal_input(x, goal, spec, d_min=0.05, k_omega=2.0, k_v=1.0):
    distance = jnp.maximum(jnp.linalg.norm(x[:2] - goal[:2]) - d_min, 0.05)
    theta_d = jnp.arctan2(goal[1] - x[1], goal[0] - x[0])
    err = angle_normalize(theta_d - x[2])
    omega = k_omega * err
    v = jnp.where(jnp.abs(err) > jnp.deg2rad(90.0), 0.0, k_v * distance * jnp.cos(err))
    return jnp.array([v, omega])


def stop(x, spec):
    return jnp.zeros(2, dtype=x.dtype)


def has_stopped(x, spec, tol=0.05):
    return jnp.array(True)


def rotate_to(x, theta_des, spec, k_omega=2.0):
    err = angle_normalize(theta_des - x[2])
    return jnp.array([0.0, k_omega * err])


def sigma(s):
    """Heading-shaping sigmoid (unicycle2D.py:100-102)."""
    e = jnp.exp(SIGMA_K1 - s)
    return SIGMA_K2 * (e - 1.0) / (e + 1.0)


def u_lb(spec):
    return jnp.array([-spec.v_max, -spec.w_max])


def u_ub(spec):
    return jnp.array([spec.v_max, spec.w_max])


def state_bounds(spec):
    inf = jnp.inf
    return jnp.array([-inf, -inf, -inf]), jnp.array([inf, inf, inf])


def barrier_pos(x):
    return x[:2]

"""DynamicUnicycle2D: X=[x, y, theta, v], U=[a, omega], relative degree 2.

JAX re-implementation of the behavior of
/root/reference/robots/dynamic_unicycle2D.py (f/g :42-73, step :75-78,
nominal_input :80-104, stop :106-111, has_stopped :113-114, rotate_to
:116-119).  This is the BASELINE benchmark model.
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.dynamics.base import angle_normalize, masked_apply

N_STATES = 4
N_CONTROLS = 2
REL_DEG = 2


def f(x, spec):
    return jnp.array(
        [x[3] * jnp.cos(x[2]), x[3] * jnp.sin(x[2]), 0.0, 0.0], dtype=x.dtype
    )


def g(x, spec):
    return jnp.array(
        [[0.0, 0.0], [0.0, 0.0], [0.0, 1.0], [1.0, 0.0]], dtype=x.dtype
    )


def step(x, u, spec, dt):
    x = x + (f(x, spec) + g(x, spec) @ u) * dt
    return masked_apply(x, angle_normalize, 2, 3)


def nominal_input(x, goal, spec, d_min=0.05):
    k_omega = spec.nominal_k_omega
    k_a = spec.nominal_k_a
    k_v = spec.nominal_k_v
    distance = jnp.maximum(jnp.linalg.norm(x[:2] - goal[:2]) - d_min, 0.0)
    theta_d = jnp.arctan2(goal[1] - x[1], goal[0] - x[0])
    err = angle_normalize(theta_d - x[2])
    omega = k_omega * err
    v = jnp.where(
        jnp.abs(err) > jnp.deg2rad(90.0),
        0.0,
        jnp.minimum(k_v * distance * jnp.cos(err), spec.v_max),
    )
    accel = k_a * (v - x[3])
    return jnp.array([accel, omega])


def stop(x, spec):
    return jnp.array([spec.nominal_k_a * (0.0 - x[3]), 0.0])


def has_stopped(x, spec, tol=0.05):
    return jnp.abs(x[3]) < tol


def rotate_to(x, theta_des, spec, k_omega=2.0):
    err = angle_normalize(theta_des - x[2])
    return jnp.array([0.0, k_omega * err])


def u_lb(spec):
    return jnp.array([-spec.a_max, -spec.w_max])


def u_ub(spec):
    return jnp.array([spec.a_max, spec.w_max])


def state_bounds(spec):
    inf = jnp.inf
    # v bounded in the MPC (mpc_cbf.py:193-195).
    return (
        jnp.array([-inf, -inf, -inf, -spec.v_max]),
        jnp.array([inf, inf, inf, spec.v_max]),
    )


def barrier_pos(x):
    return x[:2]

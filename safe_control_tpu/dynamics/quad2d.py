"""Quad2D planar quadrotor: X=[x, z, theta, vx, vz, w], U=[F_r, F_l], r=2.

JAX re-implementation of the reference's robots/quad2D.py
(f/g :46-81, Euler step :83-86, cascaded-PD nominal input :88-143,
stop-by-hover :145-154, HOCBF r=2 circle barrier :166-206).
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.dynamics.base import angle_normalize, masked_apply

N_STATES = 6
N_CONTROLS = 2
REL_DEG = 2

GRAVITY = 9.81


def f(x, spec):
    return jnp.array([x[3], x[4], x[5], 0.0, -GRAVITY, 0.0], dtype=x.dtype)


def g(x, spec):
    m, inertia, r = spec.mass, spec.inertia, spec.radius
    theta = x[2]
    s, c = jnp.sin(theta), jnp.cos(theta)
    z = jnp.zeros((), dtype=x.dtype)
    return jnp.array(
        [
            [z, z],
            [z, z],
            [z, z],
            [-s / m, -s / m],
            [c / m, c / m],
            [r / inertia, -r / inertia],
        ]
    )


def step(x, u, spec, dt):
    x = x + (f(x, spec) + g(x, spec) @ u) * dt
    return masked_apply(x, angle_normalize, 2, 3)


def nominal_input(
    x,
    goal,
    spec,
    k_px=3.0,
    k_dx=0.5,
    k_pz=0.1,
    k_dz=0.5,
    k_p_theta=0.05,
    k_d_theta=0.05,
):
    """Cascaded PD: outer position loop -> thrust/attitude -> rotor forces
    (quad2D.py:88-143)."""
    m = spec.mass
    r = spec.radius
    e_x = goal[0] - x[0]
    e_z = goal[1] - x[1]
    x_ddot_d = k_px * e_x + k_dx * (-x[3])
    z_ddot_d = k_pz * e_z + k_dz * (-x[4])
    a_d_x = x_ddot_d
    a_d_z = z_ddot_d + GRAVITY
    T = m * jnp.sqrt(a_d_x**2 + a_d_z**2)
    theta_d = -jnp.arctan2(a_d_x, a_d_z)
    e_theta = jnp.arctan2(jnp.sin(theta_d - x[2]), jnp.cos(theta_d - x[2]))
    tau = jnp.clip(k_p_theta * e_theta + k_d_theta * (-x[5]), -1.0, 1.0)
    F_r = jnp.clip((T + tau / r) / 2.0, spec.f_min, spec.f_max)
    F_l = jnp.clip((T - tau / r) / 2.0, spec.f_min, spec.f_max)
    return jnp.array([F_r, F_l])


def stop(x, spec):
    """Hover at the current position (quad2D.py:145-154)."""
    return nominal_input(x, x[:2], spec)


def has_stopped(x, spec, tol=0.05):
    return jnp.linalg.norm(x[3:5]) < tol


def rotate_to(x, theta_des, spec, k_omega=2.0):
    err = angle_normalize(theta_des - x[2])
    return jnp.array([0.0, k_omega * err])


def u_lb(spec):
    return jnp.array([spec.f_min, spec.f_min])


def u_ub(spec):
    return jnp.array([spec.f_max, spec.f_max])


def state_bounds(spec):
    inf = jnp.inf
    return jnp.full((6,), -inf), jnp.full((6,), inf)


def barrier_pos(x):
    return x[:2]

"""SingleIntegrator2D: X=[x, y], U=[vx, vy], relative degree 1.

JAX re-implementation of the behavior of
/root/reference/robots/single_integrator2D.py (f/g :44-62, step :64-66,
nominal_input :72-89, stop :99-102, rotate_to :108-112).  The yaw
side-channel (``step_rotate`` :68-70) lives in the sim layer, not here.
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.dynamics.base import angle_normalize

N_STATES = 2
N_CONTROLS = 2
REL_DEG = 1


def f(x, spec):
    return jnp.zeros(2, dtype=x.dtype)


def g(x, spec):
    return jnp.eye(2, dtype=x.dtype)


def step(x, u, spec, dt):
    return x + u * dt


def nominal_input(x, goal, spec, d_min=0.05, k_v=1.0):
    pos_err = goal[:2] - x[:2]
    pos_err = jnp.sign(pos_err) * jnp.maximum(jnp.abs(pos_err) - d_min, 0.0)
    v_des = k_v * pos_err
    v_mag = jnp.linalg.norm(v_des)
    scale = jnp.where(v_mag > spec.v_max, spec.v_max / jnp.maximum(v_mag, 1e-9), 1.0)
    return v_des * scale


def stop(x, spec):
    return jnp.zeros(2, dtype=x.dtype)


def has_stopped(x, spec, tol=0.05):
    # A single integrator can always stop instantly (:104-106).
    return jnp.array(True)


def rotate_to(x, theta_des, spec, k_omega=2.0):
    # Yaw is a side-channel; positional input is zero during rotation.
    return jnp.zeros(2, dtype=x.dtype)


def yaw_rate_to(yaw, theta_des, spec, k_omega=2.0):
    """Rotation-in-place yaw-rate command (:108-112)."""
    err = angle_normalize(theta_des - yaw)
    return jnp.clip(k_omega * err, -spec.w_max, spec.w_max)


def u_lb(spec):
    return jnp.array([-spec.v_max, -spec.v_max])


def u_ub(spec):
    return jnp.array([spec.v_max, spec.v_max])


def state_bounds(spec):
    inf = jnp.inf
    return jnp.array([-inf, -inf]), jnp.array([inf, inf])


def barrier_pos(x):
    return x[:2]

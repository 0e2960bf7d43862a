"""Manipulator2D: 3-link planar arm, X=[q1, q2, q3], U = joint velocities.

JAX re-implementation of the reference's robots/manipulator2D.py:
kinematic dynamics q_dot = u (:27-42), forward kinematics (:44-61),
IK P-control nominal input via the geometric Jacobian transpose (:107-124),
and the per-link sampled-circle barrier: each link is discretized into
circles (fixed counts 9/8/6 = 23 total, :126-153) and every circle
contributes one CBF row per obstacle (:186-224).  All Jacobians come from
``jax.jacfwd`` of the FK instead of the reference's hand-built point
Jacobians (:155-183).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from safe_control_tpu.barriers.geometry import h_circle

N_STATES = 3
N_CONTROLS = 3
REL_DEG = 1
NUM_LINKS = 3

# Link discretization (manipulator2D.py:134-149): step 10/60 m.
_STEP_LEN = 10.0 / 60.0
# ceil(L_i / step) per link with lengths 80/70/50 px / 60: 8, 7, 5 steps
# => 9 + 8 + 6 = 23 circles, a static count.
_NUM_STEPS = (8, 7, 5)
NUM_CIRCLES = sum(n + 1 for n in _NUM_STEPS)


def _link_lengths(spec):
    return jnp.array([spec.link_len_1, spec.link_len_2, spec.link_len_3])


def f(x, spec):
    return jnp.zeros(3, dtype=x.dtype)


def g(x, spec):
    return jnp.eye(3, dtype=x.dtype)


def step(x, u, spec, dt):
    return x + u * dt


def joint_positions(x, spec):
    """Base + 3 joint/EE positions, (4, 2) (:53-61)."""
    L = _link_lengths(spec)
    base = jnp.array([spec.base_x, spec.base_y])
    angles = jnp.cumsum(x)
    deltas = L[:, None] * jnp.stack([jnp.cos(angles), jnp.sin(angles)], axis=1)
    pts = jnp.concatenate([base[None, :], base[None, :] + jnp.cumsum(deltas, 0)], 0)
    return pts


def end_effector(x, spec):
    return joint_positions(x, spec)[-1]


def link_circle_centers(x, spec):
    """Centers of the NUM_CIRCLES sampled circles along the links (:126-153)."""
    pts = joint_positions(x, spec)
    centers = []
    for i, n in enumerate(_NUM_STEPS):
        t = jnp.linspace(0.0, 1.0, n + 1)[:, None]
        centers.append(pts[i][None, :] + t * (pts[i + 1] - pts[i])[None, :])
    return jnp.concatenate(centers, axis=0)  # (NUM_CIRCLES, 2)


def nominal_input(x, goal, spec, d_min=0.05):
    """IK P-control: omega = J^T (Kp * (goal - ee)), clipped (:107-124)."""
    ee_fn = lambda q: end_effector(q, spec)
    ee = ee_fn(x)
    J = jax.jacfwd(ee_fn)(x)  # (2, 3) geometric Jacobian
    v_des = spec.kp * (goal[:2] - ee)
    omega = J.T @ v_des
    return jnp.clip(omega, -spec.w_max, spec.w_max)


def stop(x, spec):
    return jnp.zeros(3, dtype=x.dtype)


def has_stopped(x, spec, tol=0.05):
    return jnp.array(True)


def rotate_to(x, theta_des, spec, k_omega=2.0):
    return jnp.zeros(3, dtype=x.dtype)


def ct_multi_h(x, obs, spec):
    """All NUM_CIRCLES barrier values for one obstacle (:186-224).

    h_j = ||c_j(q) - o||^2 - beta (r + r_obs)^2; gradients via autodiff of
    the circle centers.  Returns (NUM_CIRCLES,).
    """
    centers = link_circle_centers(x, spec)
    return jax.vmap(lambda c: h_circle(c, obs, spec.radius, spec.manip_beta))(centers)


def u_lb(spec):
    return jnp.full((3,), -spec.w_max)


def u_ub(spec):
    return jnp.full((3,), spec.w_max)


def state_bounds(spec):
    inf = jnp.inf
    return jnp.full((3,), -inf), jnp.full((3,), inf)


def barrier_pos(x):
    # The base is fixed; barrier logic goes through ct_multi_h instead.
    return x[:2] * 0.0

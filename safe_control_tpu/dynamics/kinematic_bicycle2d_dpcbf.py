"""KinematicBicycle2D with Dynamic Parabolic CBF (DPCBF) for dynamic obstacles.

JAX re-implementation of
/root/reference/dynamic_env/kinematic_bicycle2D_dpcbf.py (the flagship
ICRA'26 novelty, dynamic_env/README.md): inherits the kinematic bicycle
dynamics and overrides only the barrier.  In the line-of-sight frame
(x' toward the obstacle):

    h = v_rel_x' + lambda(x) * v_rel_y'^2 + mu(x)
    lambda = k_lambda * sqrt(d_safe) / ||v_rel|| * sqrt(s^2-1) / R
    mu     = k_mu     * sqrt(d_safe)             * sqrt(s^2-1) / R
    d_safe = max(||p_rel||^2 - R^2, eps),  R = (r_obs + r_rob) * s   (:56-75)

k_lambda=0.1, k_mu=0.5, s=1.05 (:11-14).  Relative degree 1; gradients via
``jax.grad`` of this exact h (reference hand-derives them at :78-82).
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.core.types import OBS_R, OBS_VX, OBS_VY
from safe_control_tpu.dynamics.kinematic_bicycle2d import *  # noqa: F401,F403
from safe_control_tpu.dynamics.kinematic_bicycle2d import (
    N_CONTROLS,
    N_STATES,
    barrier_pos,
    f,
    g,
    step,
)

REL_DEG = 1

K_LAMBDA = 0.1
K_MU = 0.5
S_MARGIN = 1.05
EPS = 1e-6


def _dpcbf_h(x, obs, spec, s=S_MARGIN):
    theta, v = x[2], x[3]
    ego_dim = (obs[OBS_R] + spec.radius) * s
    p_rel = jnp.array([obs[0] - x[0], obs[1] - x[1]])
    v_rel = jnp.array(
        [obs[OBS_VX] - v * jnp.cos(theta), obs[OBS_VY] - v * jnp.sin(theta)]
    )
    p_mag = jnp.linalg.norm(p_rel)
    v_mag = jnp.linalg.norm(v_rel)
    rot = jnp.arctan2(p_rel[1], p_rel[0])
    c, sn = jnp.cos(rot), jnp.sin(rot)
    v_rel_x = c * v_rel[0] + sn * v_rel[1]
    v_rel_y = -sn * v_rel[0] + c * v_rel[1]
    d_safe = jnp.maximum(p_mag**2 - ego_dim**2, EPS)
    scale = jnp.sqrt(s**2 - 1.0) / ego_dim
    lam = K_LAMBDA * jnp.sqrt(d_safe) / jnp.maximum(v_mag, EPS) * scale
    mu = K_MU * jnp.sqrt(d_safe) * scale
    return v_rel_x + lam * v_rel_y**2 + mu


def ct_h(x, obs, spec):
    return _dpcbf_h(x, obs, spec)


def dt_h(x, obs, spec):
    return _dpcbf_h(x, obs, spec)

"""KinematicBicycle2D with Collision-Cone CBF (C3BF) for dynamic obstacles.

JAX re-implementation of
/root/reference/dynamic_env/kinematic_bicycle2D_c3bf.py: inherits the
kinematic bicycle dynamics and overrides only the barrier with

    h = <p_rel, v_rel> + ||p_rel|| ||v_rel|| cos(phi),
    cos(phi) = sqrt(max(||p_rel||^2 - R^2, eps)) / ||p_rel||        (:59-66)

where p_rel/v_rel are relative position/velocity vs a constant-velocity
obstacle (vx, vy in obs cols 3:5) and R = (r_obs + r_robot)*beta.  Relative
degree 1.  The gradient comes from ``jax.grad`` of this exact h (the
reference hand-derives an approximation of it, :69-73).
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

# The reference uses beta=1.0 for the continuous barrier (:15) and 1.01 for
# the discrete one (:77) — both via default args through the BaseRobot facade.
CT_BETA = 1.0
DT_BETA = 1.01
EPS = 1e-6


def _c3bf_h(x, obs, spec, beta):
    theta, v = x[2], x[3]
    ego_dim = (obs[OBS_R] + spec.radius) * beta
    p_rel = jnp.array([obs[0] - x[0], obs[1] - x[1]])
    v_rel = jnp.array(
        [obs[OBS_VX] - v * jnp.cos(theta), obs[OBS_VY] - v * jnp.sin(theta)]
    )
    p_mag = jnp.linalg.norm(p_rel)
    v_mag = jnp.linalg.norm(v_rel)
    sqrt_term = jnp.sqrt(jnp.maximum(p_mag**2 - ego_dim**2, EPS))
    cos_phi = sqrt_term / (p_mag + EPS)
    return p_rel @ v_rel + p_mag * v_mag * cos_phi


def ct_h(x, obs, spec):
    return _c3bf_h(x, obs, spec, CT_BETA)


def dt_h(x, obs, spec):
    return _c3bf_h(x, obs, spec, DT_BETA)

"""Simple attitude (yaw side-channel) controllers.

JAX equivalents of attitude_control/simple_attitude.py (constant yaw
rate, :21) and attitude_control/velocity_tracking_yaw.py (P-control of yaw
toward the velocity vector with optional acceleration preview, :35-64).
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.core import spec as spec_mod
from safe_control_tpu.core.types import angle_normalize


def simple_att(spec, yaw):
    """Constant yaw rate (simple_attitude.py:21)."""
    return spec.w_max


def velocity_tracking_yaw(
    model_name: str,
    spec,
    x,
    yaw,
    u,
    kp: float = 1.5,
    preview_time: float = 0.0,
):
    """Yaw-rate command aligning heading with velocity
    (velocity_tracking_yaw.py:35-64)."""
    if model_name == spec_mod.SINGLE_INTEGRATOR_2D:
        vx, vy = u[0], u[1]
    else:  # DoubleIntegrator2D (and other velocity-state models)
        vx, vy = x[2], x[3]
        if preview_time > 0.0:
            vx = vx + preview_time * u[0]
            vy = vy + preview_time * u[1]
    speed = jnp.hypot(vx, vy)
    desired = jnp.arctan2(vy, vx)
    err = angle_normalize(desired - yaw)
    u_att = jnp.clip(kp * err, -spec.w_max, spec.w_max)
    return jnp.where(speed < 1e-2, 0.0, u_att)

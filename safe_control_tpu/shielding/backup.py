"""Backup policies: simple closed-loop controllers that can be rolled out.

JAX re-implementation of
/root/reference/position_control/backup_controller.py — each policy is a
pure function ``u = policy(x, spec)`` so candidate trajectories roll out
under ``lax.scan`` and batch under ``vmap`` (the reference forward-simulates
them in Python loops, :198-258, :360-417, :577-620).

- ``lane_change``: cascaded PD to a target lane y (DriftingCar, :77-194)
- ``stopping``: PD braking to rest with holding torque (DriftingCar, :261-352)
- ``evade``: phased PD into a safe pocket with wall-avoidance logic
  (DoubleIntegrator2D, :420-570) — the reference's if/elif phases become
  nested ``jnp.where`` on the same conditions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from safe_control_tpu.core.types import angle_normalize


# --------------------------------------------------------------------- lane
class LaneChangeGains(NamedTuple):
    kp_y: float = 0.25
    kd_y: float = 0.3
    kp_theta: float = 1.2
    kd_theta: float = 1.0
    kp_delta: float = 2.5
    kp_v: float = 500.0
    kp_tau_dot: float = 2.0
    target_velocity: float = 8.0
    theta_des_max: float = math.radians(20.0)
    delta_max: float = math.radians(20.0)
    delta_dot_max: float = math.radians(25.0)
    tau_max: float = 4000.0
    tau_dot_max: float = 8000.0


def lane_change(x, target_y, spec, gains: LaneChangeGains = LaneChangeGains()):
    """Cascaded PD lane change for DriftingCar (:129-194)."""
    _, y, theta, r, beta, V, delta, tau = (x[i] for i in range(8))
    V = jnp.maximum(V, 0.1)
    vy = V * jnp.sin(angle_normalize(theta + beta))
    theta_des = jnp.arctan(gains.kp_y * (target_y - y) - gains.kd_y * vy)
    theta_des = jnp.clip(theta_des, -gains.theta_des_max, gains.theta_des_max)
    course = angle_normalize(theta + beta)
    theta_err = angle_normalize(theta_des - course)
    delta_des = jnp.clip(
        gains.kp_theta * theta_err - gains.kd_theta * r,
        -gains.delta_max,
        gains.delta_max,
    )
    delta_dot = jnp.clip(
        gains.kp_delta * (delta_des - delta), -gains.delta_dot_max, gains.delta_dot_max
    )
    tau_des = jnp.clip(
        gains.kp_v * (gains.target_velocity - V), -gains.tau_max, gains.tau_max
    )
    tau_dot = jnp.clip(
        gains.kp_tau_dot * (tau_des - tau), -gains.tau_dot_max, gains.tau_dot_max
    )
    return jnp.array([delta_dot, tau_dot])


# ------------------------------------------------------------------ stopping
class StoppingGains(NamedTuple):
    kp_v: float = 1000.0
    kd_theta: float = 1.0
    kp_delta: float = 3.0
    stop_velocity_threshold: float = 0.05
    min_braking_torque: float = -500.0
    holding_torque: float = -100.0
    delta_max: float = math.radians(20.0)
    delta_dot_max: float = math.radians(25.0)
    tau_max: float = 4000.0
    tau_dot_max: float = 8000.0


def stopping(x, spec, gains: StoppingGains = StoppingGains()):
    """PD braking-to-stop with holding torque for DriftingCar (:305-352)."""
    r, V, delta, tau = x[3], x[5], x[6], x[7]
    tau_des_moving = jnp.minimum(-gains.kp_v * V, gains.min_braking_torque)
    tau_des = jnp.where(
        V > gains.stop_velocity_threshold, tau_des_moving, gains.holding_torque
    )
    tau_des = jnp.clip(tau_des, -gains.tau_max, gains.tau_max)
    tau_err = tau_des - tau
    tau_dot = 5000.0 * jnp.sign(tau_err) * jnp.minimum(jnp.abs(tau_err) / 50.0, 1.0)
    tau_dot = jnp.clip(tau_dot, -gains.tau_dot_max, gains.tau_dot_max)
    delta_des = jnp.clip(-gains.kd_theta * r, -gains.delta_max, gains.delta_max)
    delta_dot = jnp.clip(
        gains.kp_delta * (delta_des - delta), -gains.delta_dot_max, gains.delta_dot_max
    )
    return jnp.array([delta_dot, tau_dot])


# --------------------------------------------------------------------- evade
class EvadeConfig(NamedTuple):
    pocket_center: tuple  # (x, y)
    pocket_x_min: float
    pocket_x_max: float
    pocket_y_min: float
    pocket_y_max: float
    goal_x_min: float = 0.0
    goal_x_max: float = 0.0
    goal_y_min: float = 0.0
    goal_y_max: float = 0.0
    has_goal: bool = False
    kp: float = 2.0
    kd: float = 2.0


def evade(x, cfg: EvadeConfig, spec):
    """Phased PD evade-to-pocket for DoubleIntegrator2D (:456-570)."""
    px, py, vx, vy = x[0], x[1], x[2], x[3]
    margin = spec.radius + 0.1
    cx, cy = cfg.pocket_center

    # Phase contributions (all computed; selected by nested wheres).
    # Goal zone: brake.
    in_goal = (
        cfg.has_goal
        & (px >= cfg.goal_x_min)
        & (px <= cfg.goal_x_max)
        & (py >= cfg.goal_y_min)
        & (py <= cfg.goal_y_max)
    )
    a_goal = jnp.array([-cfg.kd * vx, -cfg.kd * vy])

    # Deep inside pocket: brake.
    dist_c = jnp.sqrt((px - cx) ** 2 + (py - cy) ** 2)
    inside = (
        (px >= cfg.pocket_x_min + margin)
        & (px <= cfg.pocket_x_max - margin)
        & (py >= cfg.pocket_y_min + margin)
        & (py <= cfg.pocket_y_max - margin)
        & (dist_c < 1.0)
    )
    a_inside = jnp.array([-cfg.kd * vx, -cfg.kd * vy])

    # Near pocket x-range (:516-546).
    near_x = (px >= cfg.pocket_x_min - 2.0) & (px <= cfg.pocket_x_max + 2.0)
    safe_x_entry = (px >= cfg.pocket_x_min + margin) & (px <= cfg.pocket_x_max - margin)
    # aligned branch
    a_near_aligned = jnp.array(
        [cfg.kp * (cx - px) - cfg.kd * vx, cfg.kp * (cy - py) - cfg.kd * vy]
    )
    # not aligned: stay high if above the wall
    ty_near = jnp.where(py > cfg.pocket_y_min, jnp.maximum(py, 3.0), 0.0)
    a_near_unaligned = jnp.array(
        [cfg.kp * (cx - px) - cfg.kd * vx, cfg.kp * (ty_near - py) - cfg.kd * vy]
    )
    a_near = jnp.where(safe_x_entry, a_near_aligned, a_near_unaligned)

    # Far: run along the hallway toward the pocket x (:550-565).
    ty_far = jnp.where(
        (py > cfg.pocket_y_min) & (px > cfg.pocket_x_max),
        jnp.maximum(py, 3.0),
        0.0,
    )
    ex = cx - px
    a_far = jnp.array(
        [
            cfg.kp * jnp.sign(ex) * jnp.minimum(jnp.abs(ex), 3.0) - cfg.kd * vx,
            cfg.kp * (ty_far - py) - cfg.kd * vy,
        ]
    )

    a = jnp.where(
        in_goal, a_goal, jnp.where(inside, a_inside, jnp.where(near_x, a_near, a_far))
    )
    a_mag = jnp.linalg.norm(a)
    scale = jnp.where(a_mag > spec.a_max, spec.a_max / jnp.maximum(a_mag, 1e-9), 1.0)
    return a * scale

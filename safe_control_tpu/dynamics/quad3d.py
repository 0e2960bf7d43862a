"""Quad3D: linearized 6-DOF quadrotor, 12 states, 4 motor forces.

JAX re-implementation of the reference's robots/quad3D.py:
X = [x, y, z, th, ph, ps, vx, vy, vz, q, p, r], A/B1·B2 structure (:73-97),
RK4 integration (:121-158), pinv(B2) control allocation in
nominal/stop/rotate (:160-267).  The continuous barrier is not defined
(:269-273 raises); safety uses the RK4 sampled-data discrete CBF, relative
degree 1 in discrete time (:275-297, IEEE CDC'22 sampled-data CBF).
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.barriers.geometry import h_circle
from safe_control_tpu.dynamics.base import angle_normalize, masked_apply

N_STATES = 12
N_CONTROLS = 4
REL_DEG = 1  # discrete-time relative degree (RK4 sampled-data CBF)

GRAVITY = 9.8


def _A(spec, dtype):
    A = jnp.zeros((12, 12), dtype=dtype)
    for i in range(6):
        A = A.at[i, i + 6].set(1.0)
    A = A.at[6, 3].set(GRAVITY)
    A = A.at[7, 4].set(-GRAVITY)
    return A


def _B2(spec, dtype):
    L, nu = spec.arm_length, spec.nu_torque
    one = jnp.asarray(1.0, dtype)
    return jnp.array(
        [
            [one, one, one, one],
            [0.0 * one, L * one, 0.0 * one, -L * one],
            [L * one, 0.0 * one, -L * one, 0.0 * one],
            [nu * one, -nu * one, nu * one, -nu * one],
        ]
    )


def _B(spec, dtype):
    B1 = jnp.zeros((12, 4), dtype=dtype)
    B1 = B1.at[8, 0].set(1.0 / spec.mass)
    B1 = B1.at[9, 1].set(1.0 / spec.iy)
    B1 = B1.at[10, 2].set(1.0 / spec.ix)
    B1 = B1.at[11, 3].set(1.0 / spec.iz)
    return B1 @ _B2(spec, dtype)


def f(x, spec):
    return _A(spec, x.dtype) @ x


def g(x, spec):
    return _B(spec, x.dtype)


def step(x, u, spec, dt):
    """RK4 with angle normalization on th/ph/ps (:121-158)."""
    A, B = _A(spec, x.dtype), _B(spec, x.dtype)
    Bu = B @ u
    k1 = A @ x + Bu
    k2 = A @ (x + dt / 2 * k1) + Bu
    k3 = A @ (x + dt / 2 * k2) + Bu
    k4 = A @ (x + dt * k3) + Bu
    xn = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return masked_apply(xn, angle_normalize, 3, 6)


def _allocate(spec, dtype, F, tau_y, tau_x, tau_z):
    """pinv(B2) wrench -> motor forces, clipped (:199-206)."""
    wrench = jnp.array([F, tau_y, tau_x, tau_z])
    u = jnp.linalg.pinv(_B2(spec, dtype)) @ wrench
    return jnp.clip(u, spec.u_min, spec.u_max)


def nominal_input(x, goal, spec, k_p=1.0, k_d=2.0, k_ang=5.0):
    """PD position loop -> linearized attitude targets -> allocation
    (:160-206).  ``goal`` may be (2,) or (3,); missing z target is 0."""
    gz = goal[2] if goal.shape[0] >= 3 else jnp.asarray(0.0, x.dtype)
    pos_err = jnp.array([goal[0] - x[0], goal[1] - x[1], gz - x[2]])
    ax = k_p * pos_err[0] + k_d * (-x[6])
    ay = k_p * pos_err[1] + k_d * (-x[7])
    az = k_p * pos_err[2] + k_d * (-x[8])
    theta_des = ax / GRAVITY
    phi_des = -ay / GRAVITY
    F_des = spec.mass * az
    tau_y = spec.iy * (k_ang * (theta_des - x[3]) + k_d * (-x[9]))
    tau_x = spec.ix * (k_ang * (phi_des - x[4]) + k_d * (-x[10]))
    tau_z = spec.iz * (k_ang * (0.0 - x[5]) + k_d * (-x[11]))
    return _allocate(spec, x.dtype, F_des, tau_y, tau_x, tau_z)


def stop(x, spec, k_stop=1.0):
    """Velocity-damping stop (:208-237)."""
    ax, ay, az = -k_stop * x[6], -k_stop * x[7], -k_stop * x[8]
    theta_des = ax / GRAVITY
    phi_des = -ay / GRAVITY
    F_des = spec.mass * az
    tau_y = spec.iy * k_stop * (theta_des - x[3] - x[9] / k_stop)
    tau_x = spec.ix * k_stop * (phi_des - x[4] - x[10] / k_stop)
    tau_z = spec.iz * k_stop * (0.0 - x[5] - x[11] / k_stop)
    return _allocate(spec, x.dtype, F_des, tau_y, tau_x, tau_z)


def has_stopped(x, spec, tol=0.05):
    return (jnp.linalg.norm(x[6:9]) < tol) & (jnp.linalg.norm(x[9:12]) < tol)


def rotate_to(x, ang_des, spec, k_omega=2.0):
    """Yaw to ang_des at hover (:245-267)."""
    F_hover = spec.mass * GRAVITY
    tau_y = spec.iy * k_omega * (0.0 - x[3] - x[9] / k_omega)
    tau_x = spec.ix * k_omega * (0.0 - x[4] - x[10] / k_omega)
    tau_z = spec.iz * k_omega * (ang_des - x[5] - x[11] / k_omega)
    return _allocate(spec, x.dtype, F_hover, tau_y, tau_x, tau_z)


def dt_h(x, obs, spec):
    """Cylinder-obstacle circle barrier in (x, y) (:283-291)."""
    return h_circle(x[:2], obs, spec.radius, spec.cbf_beta)


def u_lb(spec):
    return jnp.full((4,), spec.u_min)


def u_ub(spec):
    return jnp.full((4,), spec.u_max)


def state_bounds(spec):
    inf = jnp.inf
    return jnp.full((12,), -inf), jnp.full((12,), inf)


def barrier_pos(x):
    return x[:2]

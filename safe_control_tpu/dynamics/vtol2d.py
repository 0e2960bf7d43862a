"""VTOL2D: X=[x, z, theta, vx, vz, w], U=[d_front, d_rear, d_pusher, d_elev].

JAX re-implementation of the reference's robots/vtol2D.py — full 2-D
aero: body-frame velocity/angle of attack (:333-342), blended linear /
flat-plate lift with sigmoid stall transition (:347-371), lift/drag/moment
(:373-402), wind->inertial rotation by theta+alpha (:411-420), three linear
rotors (:425-457).  The system is control-affine by construction: f is the
unforced (delta_e = 0) aero + gravity (:118-193); g columns are the rotor
partials plus the elevator's delta_e = 1 aero increment (:198-309).

VTOL is MPC-only: nominal_input/stop return zeros (:459-465), the continuous
barrier is not implemented (:471-473), and the discrete barrier is the r=2
circle HOCBF (:475-498).
"""

from __future__ import annotations

import jax.numpy as jnp

from safe_control_tpu.barriers.geometry import h_circle
from safe_control_tpu.dynamics.base import angle_normalize, masked_apply

N_STATES = 6
N_CONTROLS = 4
REL_DEG = 2

GRAVITY = 9.81


def _body_velocity(xdot, zdot, theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    return c * xdot + s * zdot, -s * xdot + c * zdot


def _lift_blending(alpha, spec):
    """Sigmoid-blended linear/flat-plate lift coefficient (:347-371).

    Exponents are clamped to +/-40: the reference's raw exp overflows to
    inf (and then inf/inf = NaN) once |alpha| approaches pi/2, which happens
    at near-zero airspeed (hover) — a latent bug its fast-flight demos never
    hit.  The clamp leaves the blend bit-identical in the +/-0.8 rad range.
    """
    cl_lin = spec.c_l0 + spec.c_lalpha * alpha
    cl_nl = 2.0 * jnp.sin(alpha) * jnp.cos(alpha)
    t1 = jnp.exp(jnp.clip(-spec.m_blend * (alpha - spec.alpha_0), -40.0, 40.0))
    t2 = jnp.exp(jnp.clip(spec.m_blend * (alpha + spec.alpha_0), -40.0, 40.0))
    sigma = (1.0 + t1 + t2) / ((1.0 + t1) * (1.0 + t2))
    return (1.0 - sigma) * cl_lin + sigma * cl_nl


def _lift_drag_moment(V, alpha, delta_e, spec):
    cl = _lift_blending(alpha, spec) + spec.c_ldelta_e * delta_e
    cd = spec.c_d0 + spec.c_dalpha * alpha**2 + spec.c_ddelta_e * delta_e
    cm = spec.c_m0 + spec.c_malpha * alpha + spec.c_mdelta_e * delta_e
    qbar = 0.5 * spec.rho_air * V**2
    return (
        qbar * spec.s_wing * cl,
        qbar * spec.s_wing * cd,
        qbar * spec.s_wing * cm * spec.chord,
    )


def _wind_to_inertial(theta, alpha, fx_w, fz_w):
    h = theta + alpha
    c, s = jnp.cos(h), jnp.sin(h)
    return c * fx_w - s * fz_w, s * fx_w + c * fz_w


def f(x, spec):
    theta, xdot, zdot, thetadot = x[2], x[3], x[4], x[5]
    u_b, w_b = _body_velocity(xdot, zdot, theta)
    V = jnp.sqrt(u_b**2 + w_b**2)
    alpha = jnp.arctan2(-w_b, u_b)
    L0, D0, M0 = _lift_drag_moment(V, alpha, 0.0, spec)
    fx_a, fz_a = _wind_to_inertial(theta, alpha, -D0, L0)
    return jnp.array(
        [
            xdot,
            zdot,
            thetadot,
            fx_a / spec.mass,
            (fz_a - spec.mass * GRAVITY) / spec.mass,
            M0 / spec.inertia,
        ]
    )


def g(x, spec):
    theta, xdot, zdot = x[2], x[3], x[4]
    u_b, w_b = _body_velocity(xdot, zdot, theta)
    V = jnp.sqrt(u_b**2 + w_b**2)
    alpha = jnp.arctan2(-w_b, u_b)
    c, s = jnp.cos(theta), jnp.sin(theta)
    m, inertia = spec.mass, spec.inertia

    # Rotors (:425-457): front/rear along +body_z, pusher along +body_x.
    fx_f, fz_f, M_f = -s * spec.k_front, c * spec.k_front, spec.ell_f * spec.k_front
    fx_r, fz_r, M_r = -s * spec.k_rear, c * spec.k_rear, -spec.ell_r * spec.k_rear
    fx_p, fz_p, M_p = c * spec.k_pusher, s * spec.k_pusher, 0.0

    # Elevator partial: the delta_e = 1 aero increment (:222-223).
    L_de, D_de, M_de = _lift_drag_moment(V, alpha, 1.0, spec)
    fx_e, fz_e = _wind_to_inertial(theta, alpha, -D_de, L_de)

    z = jnp.zeros((), dtype=x.dtype)
    return jnp.array(
        [
            [z, z, z, z],
            [z, z, z, z],
            [z, z, z, z],
            [fx_f / m, fx_r / m, fx_p / m, fx_e / m],
            [fz_f / m, fz_r / m, fz_p / m, fz_e / m],
            [M_f / inertia, M_r / inertia, M_p / inertia, M_de / inertia],
        ]
    )


def step(x, u, spec, dt):
    x = x + (f(x, spec) + g(x, spec) @ u) * dt
    return masked_apply(x, angle_normalize, 2, 3)


def nominal_input(x, goal, spec):
    # VTOL is MPC-only; the reference returns zeros (:459-461).
    return jnp.zeros(4, dtype=x.dtype)


def stop(x, spec):
    return jnp.zeros(4, dtype=x.dtype)


def has_stopped(x, spec, tol=0.05):
    return jnp.linalg.norm(x[3:5]) < tol


def rotate_to(x, theta_des, spec, k_omega=2.0):
    return jnp.zeros(4, dtype=x.dtype)


def dt_h(x, obs, spec):
    return h_circle(x[:2], obs, spec.radius, spec.cbf_beta)


def u_lb(spec):
    return jnp.array(
        [spec.throttle_min, spec.throttle_min, spec.throttle_min, spec.elevator_min]
    )


def u_ub(spec):
    return jnp.array(
        [spec.throttle_max, spec.throttle_max, spec.throttle_max, spec.elevator_max]
    )


def state_bounds(spec):
    """MPC state bounds (mpc_cbf.py:222-232): vx, vz, pitch."""
    inf = jnp.inf
    pitch = spec.pitch_max * jnp.pi / 180.0
    return (
        jnp.array([-inf, -inf, -pitch, -spec.v_max, -spec.descent_speed_max, -inf]),
        jnp.array([inf, inf, pitch, spec.v_max, inf, inf]),
    )


def barrier_pos(x):
    return x[:2]

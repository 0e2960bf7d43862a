"""DynamicBicycle2D: Fiala brush-tire model for high-slip (drifting) maneuvers.

JAX re-implementation of the reference's robots/dynamic_bicycle2D.py:
X = [r, beta, V, delta, tau] (body-fixed), U = [delta_dot, tau_dot].

- slip angles with V-safe guard (:103-139)
- Fiala lateral force with friction circle and branch-free saturation
  switch (:141-197) — the reference's ca.if_else becomes jnp.where
- longitudinal tanh soft saturation (:199-234)
- Euler step with the 5-way state clamp (:347-388)

The friction coefficient mu is a RobotSpec leaf, so the reference's
runtime-mutable ``set_friction`` (drifting_car.py:335) is just a spec
replace — no recompilation, and it batches across a fleet.
"""

from __future__ import annotations

import jax.numpy as jnp

N_STATES = 5
N_CONTROLS = 2
REL_DEG = 2  # not used: the model runs under shielding, not CBF-QP

GRAVITY = 9.81


def normal_forces(spec):
    """Static axle normal forces (:93-101)."""
    L = spec.a_cg + spec.b_cg
    Fz_f = spec.mass * GRAVITY * spec.b_cg / L
    Fz_r = spec.mass * GRAVITY * spec.a_cg / L
    return Fz_f, Fz_r


def slip_angles(r, beta, V, delta, spec):
    """Front/rear slip angles with the V >= 0.1 guard (:103-139)."""
    V_safe = jnp.maximum(V, 0.1)
    alpha_f = jnp.arctan2(V * jnp.sin(beta) + spec.a_cg * r, V_safe * jnp.cos(beta)) - delta
    alpha_r = jnp.arctan2(V * jnp.sin(beta) - spec.b_cg * r, V_safe * jnp.cos(beta))
    return alpha_f, alpha_r


def lateral_force(alpha, Cc, Fz, Fx, spec):
    """Fiala brush model with friction circle (:141-197), branch-free."""
    Fy_max = jnp.sqrt(jnp.maximum((spec.mu * Fz) ** 2 - spec.gamma_stab * Fx**2, 1.0))
    alpha_sl = jnp.arctan(3.0 * Fy_max / Cc)
    tan_a = jnp.tan(alpha)
    Fy_linear = (
        -Cc * tan_a
        + (Cc**2 / (3.0 * Fy_max)) * jnp.abs(tan_a) * tan_a
        - (Cc**3 / (27.0 * Fy_max**2)) * tan_a**3
    )
    Fy_sat = -Fy_max * jnp.sign(alpha)
    return jnp.where(jnp.abs(alpha) < alpha_sl, Fy_linear, Fy_sat)


def longitudinal_force(tau, Fz, spec):
    """tanh soft saturation at the friction limit (:199-234)."""
    F_lim = spec.mu * Fz
    F_lim_safe = jnp.maximum(F_lim, 1.0)
    return F_lim * jnp.tanh(tau / (spec.r_w * F_lim_safe))


def tire_forces(r, beta, V, delta, tau, spec):
    """(Fx_f, Fy_f, Fx_r, Fy_r) — rear-wheel drive (:236-262)."""
    alpha_f, alpha_r = slip_angles(r, beta, V, delta, spec)
    Fz_f, Fz_r = normal_forces(spec)
    Fx_f = jnp.zeros_like(tau)
    Fx_r = longitudinal_force(tau, Fz_r, spec)
    Fy_f = lateral_force(alpha_f, spec.cc_f, Fz_f, Fx_f, spec)
    Fy_r = lateral_force(alpha_r, spec.cc_r, Fz_r, Fx_r, spec)
    return Fx_f, Fy_f, Fx_r, Fy_r


def f(x, spec):
    r, beta, V, delta, tau = x[0], x[1], x[2], x[3], x[4]
    Fx_f, Fy_f, Fx_r, Fy_r = tire_forces(r, beta, V, delta, tau, spec)
    V_safe = jnp.maximum(V, 0.1)
    r_dot = (
        spec.a_cg * (Fx_f * jnp.sin(delta) + Fy_f * jnp.cos(delta))
        - spec.b_cg * Fy_r
    ) / spec.izz
    beta_dot = (
        Fx_f * jnp.sin(delta - beta)
        + Fy_f * jnp.cos(delta - beta)
        - Fx_r * jnp.sin(beta)
        + Fy_r * jnp.cos(beta)
    ) / (spec.mass * V_safe) - r
    V_dot = (
        Fx_f * jnp.cos(delta - beta)
        - Fy_f * jnp.sin(delta - beta)
        + Fx_r * jnp.cos(beta)
        + Fy_r * jnp.sin(beta)
    ) / spec.mass
    return jnp.array([r_dot, beta_dot, V_dot, 0.0, 0.0])


def g(x, spec):
    G = jnp.zeros((5, 2), dtype=x.dtype)
    return G.at[3, 0].set(1.0).at[4, 1].set(1.0)


def _clamp(x, spec):
    """5-way state clamp (:375-387)."""
    return jnp.stack(
        [
            jnp.clip(x[0], -spec.r_max, spec.r_max),
            jnp.clip(x[1], -spec.beta_max, spec.beta_max),
            jnp.clip(x[2], spec.v_min, spec.v_max),
            jnp.clip(x[3], -spec.delta_max, spec.delta_max),
            jnp.clip(x[4], -spec.tau_max, spec.tau_max),
        ]
    )


def step(x, u, spec, dt):
    return _clamp(x + (f(x, spec) + g(x, spec) @ u) * dt, spec)


def nominal_input(x, goal, spec):
    # Requires global position; handled by the DriftingCar wrapper (:390-405).
    return jnp.zeros(2, dtype=x.dtype)


def stop(x, spec):
    """Brake + center steering (:407-418)."""
    return jnp.array(
        [
            -jnp.sign(x[3]) * spec.delta_dot_max * 0.5,
            -jnp.sign(x[4]) * spec.tau_dot_max * 0.5,
        ]
    )


def has_stopped(x, spec, tol=0.5):
    return jnp.abs(x[2]) < tol


def rotate_to(x, theta_des, spec):
    return jnp.zeros(2, dtype=x.dtype)


def global_velocity(x):
    """Body-frame (vx, vy) from V, beta (:423-439)."""
    return x[2] * jnp.cos(x[1]), x[2] * jnp.sin(x[1])


def u_lb(spec):
    return jnp.array([-spec.delta_dot_max, -spec.tau_dot_max])


def u_ub(spec):
    return jnp.array([spec.delta_dot_max, spec.tau_dot_max])


def state_bounds(spec):
    return (
        jnp.array([-spec.r_max, -spec.beta_max, spec.v_min, -spec.delta_max, -spec.tau_max]),
        jnp.array([spec.r_max, spec.beta_max, spec.v_max, spec.delta_max, spec.tau_max]),
    )


def barrier_pos(x):
    # Body-fixed state has no global position; use the DriftingCar wrapper.
    return x[:2] * 0.0

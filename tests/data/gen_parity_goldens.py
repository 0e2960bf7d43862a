"""Generate golden parity-anchor control sequences for the 5 BASELINE configs.

BASELINE.json's acceptance criterion is max |u - u_ref| < 1e-3 vs the
reference's CasADi/CVXPY solution under identical horizon/dt.  casadi/cvxpy
are not installed in this environment, so the goldens are produced by a
HIGH-PRECISION float64 scipy reference (SLSQP, ftol 1e-14) solving the SAME
optimization problems, with all barrier rows built from INDEPENDENT NumPy
implementations of the reference's hand-derived formulas (not from this
repo's jax code):

  config 1  DoubleIntegrator2D CBF-QP tracking    (double_integrator2D.py:167-183)
  config 2  DynamicUnicycle2D MPC-CBF N=8, circle + superellipsoid
            (dynamic_unicycle2D.py:188-238, mpc_cbf.py:308-325)
  config 3  DU MPC-CBF unknown-env (FOV-detected, circularized obstacles)
  config 4  KinematicBicycle2D C3BF + DPCBF QPs   (kinematic_bicycle2D_{c3bf,
            dpcbf}.py:15-84) with moving obstacles
  config 5  heterogeneous-fleet per-family CBF-QPs (DU r=2 + KB-DPCBF r=1)

Anchor states are produced by closed-loop runs of THIS repo's stack (so the
anchors sit on realistic trajectories), then frozen into the .npz together
with the QP/NLP data and the float64 golden control.  Both solvers are run
COLD at each anchor (no warm start) so the comparison is reproducible.

Identifiability policy for the nonconvex MPC configs (2, 3): the golden
solver itself is run from TWO starts — zeros, and this repo's cold f32
solution.  If the two f64 optima disagree on the first control by more than
the test tolerance, the anchor's answer is solver-start-dependent (a flat
valley or multiple local basins — IPOPT runs differ here too) and it is
dropped and counted.  What remains are anchors where the f64 problem has a
well-identified first control, which the f32 solver must then match.

Run (CPU):  env JAX_PLATFORMS=cpu python tests/data/gen_parity_goldens.py
Output:     tests/data/parity_goldens.npz  (committed)
"""

from __future__ import annotations

import os
import sys

import numpy as np
from scipy.optimize import minimize

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

DT = 0.05
BETA = 1.01


# ============================================================ NumPy formulas
def fd_grad(f, x, eps=1e-6):
    x = np.asarray(x, dtype=float)
    g = np.zeros_like(x)
    for i in range(x.size):
        d = np.zeros_like(x)
        d[i] = eps
        g[i] = (f(x + d) - f(x - d)) / (2 * eps)
    return g


def h_circle_np(p, obs, rr, beta=BETA):
    d_min = obs[2] + rr
    diff = p[:2] - obs[:2]
    return float(diff @ diff - beta * d_min**2)


def h_superellipsoid_np(p, obs, rr):
    a, b, e, th = max(abs(obs[2]), 1e-3), max(abs(obs[3]), 1e-3), max(abs(obs[4]), 2.0), obs[5]
    ct, st = np.cos(th), np.sin(th)
    dx, dy = p[0] - obs[0], p[1] - obs[1]
    px, py = ct * dx + st * dy, -st * dx + ct * dy
    return float(abs(px / (a + rr)) ** e + abs(py / (b + rr)) ** e - 1.0)


def h_point_np(p, obs, rr, beta=BETA):
    return h_circle_np(p, obs, rr, beta) if obs[6] < 0.5 else h_superellipsoid_np(p, obs, rr)


# --- DoubleIntegrator2D r=2 rows (double_integrator2D.py:167-183) -----------
def di_row(x, obs, rr, a1, a2):
    diff = x[:2] - obs[:2]
    h = h_circle_np(x, obs, rr)
    h_dot = 2 * diff @ x[2:4]
    dh_dot_dx = np.concatenate([2 * x[2:4], 2 * diff])
    g = np.array([[0, 0], [0, 0], [1, 0], [0, 1]], dtype=float)
    f = np.array([x[2], x[3], 0, 0], dtype=float)
    A = dh_dot_dx @ g
    b = dh_dot_dx @ f + (a1 + a2) * h_dot + a1 * a2 * h
    return A, b


# --- DynamicUnicycle2D r=2 rows (dynamic_unicycle2D.py:121-186) -------------
def du_f(x):
    return np.array([x[3] * np.cos(x[2]), x[3] * np.sin(x[2]), 0.0, 0.0])


def du_row(x, obs, rr, a1, a2):
    def h_fn(q):
        return h_point_np(q, obs, rr)

    def hdot_fn(q):
        return fd_grad(h_fn, q) @ du_f(q)

    h = h_fn(x)
    h_dot = hdot_fn(x)
    dh_dot = fd_grad(hdot_fn, x, eps=1e-5)
    g = np.array([[0, 0], [0, 0], [0, 1], [1, 0]], dtype=float)
    A = dh_dot @ g
    b = dh_dot @ du_f(x) + (a1 + a2) * h_dot + a1 * a2 * h
    return A, b


# --- KB2D C3BF / DPCBF r=1 rows (dynamic_env/*.py) ---------------------------
def kb_f(x):
    return np.array([x[3] * np.cos(x[2]), x[3] * np.sin(x[2]), 0.0, 0.0])


def kb_g(x, wheel_base=0.4):
    # kinematic_bicycle2D.py:67-78: columns [a, beta_slip]
    return np.array(
        [
            [0.0, -x[3] * np.sin(x[2])],
            [0.0, x[3] * np.cos(x[2])],
            [0.0, x[3] / (0.5 * wheel_base)],
            [1.0, 0.0],
        ]
    )


def c3bf_h_np(x, obs, rr=0.3, beta=1.0):
    theta, v = x[2], x[3]
    ego = (obs[2] + rr) * beta
    p_rel = obs[:2] - x[:2]
    v_rel = np.array([obs[3] - v * np.cos(theta), obs[4] - v * np.sin(theta)])
    p_mag, v_mag = np.linalg.norm(p_rel), np.linalg.norm(v_rel)
    eps = 1e-6
    sqrt_term = np.sqrt(max(p_mag**2 - ego**2, eps))
    return float(p_rel @ v_rel + p_mag * v_mag * sqrt_term / (p_mag + eps))


def dpcbf_h_np(x, obs, rr=0.3, s=1.05, k_lam=0.1, k_mu=0.5):
    theta, v = x[2], x[3]
    ego = (obs[2] + rr) * s
    p_rel = obs[:2] - x[:2]
    v_rel = np.array([obs[3] - v * np.cos(theta), obs[4] - v * np.sin(theta)])
    p_mag, v_mag = np.linalg.norm(p_rel), max(np.linalg.norm(v_rel), 1e-6)
    rot = np.arctan2(p_rel[1], p_rel[0])
    R = np.array([[np.cos(rot), np.sin(rot)], [-np.sin(rot), np.cos(rot)]])
    vx_p, vy_p = R @ v_rel
    d_safe = max(p_mag**2 - ego**2, 1e-6)
    lam = k_lam * np.sqrt(d_safe) / v_mag * np.sqrt(s**2 - 1) / ego
    mu = k_mu * np.sqrt(d_safe) * np.sqrt(s**2 - 1) / ego
    return float(vx_p + lam * vy_p**2 + mu)


def r1_row(h_fn, x, f, g, alpha):
    grad = fd_grad(h_fn, x, eps=1e-5)
    return grad @ g, grad @ f + alpha * h_fn(x)


# ============================================================== QP golden
def qp_golden(u_ref, rows, lb, ub):
    """min ||u-u_ref||^2 s.t. A u + b >= 0, box — EXACT f64 active-set
    enumeration.

    Every CBF-QP in the anchor configs has 2 decision variables, so the
    optimal active set has at most 2 constraints; enumerating all subsets of
    size <= 2 and checking primal feasibility + dual nonnegativity yields
    the exact optimum of the convex QP (unlike SLSQP, which occasionally
    reports spurious failure on degenerate near-goal steps).
    """
    from itertools import combinations

    u_ref = np.asarray(u_ref, dtype=float)
    n = u_ref.size
    assert n == 2, "exact enumeration written for 2-var QPs"
    G_rows, h_rows = [], []
    for a_i, b_i in rows:
        G_rows.append(np.asarray(a_i, float))
        h_rows.append(-float(b_i))  # A u + b >= 0  ->  A u >= -b
    for i in range(n):
        e = np.zeros(n)
        e[i] = 1.0
        G_rows.append(e.copy())
        h_rows.append(float(lb[i]))
        G_rows.append(-e)
        h_rows.append(-float(ub[i]))
    G = np.stack(G_rows)
    h = np.asarray(h_rows)
    m = G.shape[0]

    def feasible(u):
        return np.all(G @ u - h >= -1e-10)

    best = None
    if feasible(u_ref):
        best = u_ref.copy()
    for k in (1, 2):
        for S in combinations(range(m), k):
            Gs = G[list(S)]
            M = Gs @ Gs.T
            if abs(np.linalg.det(M)) < 1e-12:
                continue
            lam = np.linalg.solve(M, 2.0 * (h[list(S)] - Gs @ u_ref))
            if np.any(lam < -1e-10):
                continue
            u = u_ref + Gs.T @ lam / 2.0
            if not feasible(u):
                continue
            if best is None or (u - u_ref) @ (u - u_ref) < (best - u_ref) @ (
                best - u_ref
            ) - 1e-15:
                best = u
    return best


# ============================================================== MPC golden
N_MPC = 8
Q_DU = np.array([50.0, 50.0, 0.01, 30.0])
R_DU = np.array([0.5, 0.5])


def du_step_np(x, u):
    x = x + (du_f(x) + np.array([[0, 0], [0, 0], [0, 1], [1, 0]]) @ u) * DT
    x[2] = (x[2] + np.pi) % (2 * np.pi) - np.pi
    return x


def du_rollout_np(x0, U):
    xs = [np.asarray(x0, float)]
    for k in range(N_MPC):
        xs.append(du_step_np(xs[-1], U[k]))
    return np.stack(xs)


def mpc_golden(x0, goal, u_prev, obs_rows, rr, a1, a2, v_max, U0=None,
               ftol=1e-14):
    def cost(U_flat):
        U = U_flat.reshape(N_MPC, 2)
        xs = du_rollout_np(x0, U)
        c = float(np.sum(Q_DU * (xs[1:] - goal) ** 2))
        du = np.diff(np.vstack([u_prev[None], U]), axis=0)
        return c + float(np.sum(R_DU * du**2))

    def cbf(U_flat):
        U = U_flat.reshape(N_MPC, 2)
        xs = du_rollout_np(x0, U)
        vals = []
        for k in range(N_MPC):
            x1 = du_step_np(xs[k], U[k])
            x2 = du_step_np(x1, U[k])
            for obs in obs_rows:
                h0 = h_point_np(xs[k], obs, rr)
                h1 = h_point_np(x1, obs, rr)
                h2 = h_point_np(x2, obs, rr)
                vals.append((h2 - 2 * h1 + h0) + (a1 + a2) * (h1 - h0) + a1 * a2 * h0)
        return np.array(vals) if vals else np.array([1.0])

    def vbounds(U_flat):
        U = U_flat.reshape(N_MPC, 2)
        xs = du_rollout_np(x0, U)
        return np.concatenate([v_max - xs[1:, 3], xs[1:, 3] + v_max])

    res = minimize(
        cost, np.zeros(N_MPC * 2) if U0 is None else np.asarray(U0, float).ravel(),
        method="SLSQP",
        bounds=[(-1.0, 1.0), (-0.5, 0.5)] * N_MPC,
        constraints=[dict(type="ineq", fun=cbf), dict(type="ineq", fun=vbounds)],
        options=dict(maxiter=500, ftol=ftol),
    )
    if not res.success:
        return None, None
    return res.x.reshape(N_MPC, 2), res.fun


# ================================== closed-loop golden helpers (f64 NumPy)
def di_nominal_np(x, goal, k_v=1.0, k_a=1.0, v_max=1.0, a_max=1.0, d_min=0.05):
    """DoubleIntegrator2D nominal PD law (double_integrator2D.py:113-140)."""
    pos_err = goal - x[:2]
    pos_err = np.sign(pos_err) * np.maximum(np.abs(pos_err) - d_min, 0.0)
    v_des = k_v * pos_err
    vm = np.linalg.norm(v_des)
    if vm > v_max:
        v_des = v_des * (v_max / vm)
    a = k_a * (v_des - x[2:4])
    am = np.linalg.norm(a)
    if am > a_max:
        a = a * (a_max / am)
    return a


def di_step_np(x, u, dt=DT, v_max=1.0):
    """DI Euler step + velocity-norm clamp (double_integrator2D.py:79-107)."""
    x = x + np.array([x[2], x[3], u[0], u[1]]) * dt
    vm = np.linalg.norm(x[2:4])
    if vm > v_max:
        x = x.copy()
        x[2:4] *= v_max / vm
    return x


# ================================================================= main
def main():
    import jax
    import jax.numpy as jnp

    from safe_control_tpu.core.spec import (
        DOUBLE_INTEGRATOR_2D, DYNAMIC_UNICYCLE_2D, KINEMATIC_BICYCLE_2D_C3BF,
        KINEMATIC_BICYCLE_2D_DPCBF, make_spec,
    )
    from safe_control_tpu.core.types import pad_obstacles
    from safe_control_tpu.dynamics import get_model
    from safe_control_tpu.perception import fov as fov_mod
    from safe_control_tpu.solvers import cbf_qp

    out = {}

    # ---------------- config 1: DI CBF-QP, 2 static circles ----------------
    spec = make_spec(DOUBLE_INTEGRATOR_2D)
    model = get_model(DOUBLE_INTEGRATOR_2D)
    obs_np = np.array([[3.0, 2.2, 0.5, 0, 0, 0, 0], [5.5, 3.3, 0.4, 0, 0, 0, 0]])
    obs = pad_obstacles(jnp.asarray(obs_np, jnp.float32), 5)
    x = jnp.array([0.5, 1.0, 0.0, 0.0], jnp.float32)
    goal = jnp.array([8.0, 4.0], jnp.float32)
    solve = jax.jit(lambda x, u: cbf_qp.solve(DOUBLE_INTEGRATOR_2D, spec, x, u, obs, DT))
    nom1 = jax.jit(lambda x: model.nominal_input(x, goal, spec))
    step1 = jax.jit(lambda x, u: model.step(x, u, spec, DT))
    anchors = dict(x=[], uref=[], gold=[])
    for k in range(300):
        u_ref = nom1(x)
        r = solve(x, u_ref)
        if k % 10 == 0:
            xs64, ur64 = np.asarray(x, float), np.asarray(u_ref, float)
            rows = [di_row(xs64, o, float(spec.radius), 1.5, 1.5) for o in obs_np]
            g = qp_golden(ur64, rows, [-1.0, -1.0], [1.0, 1.0])
            if g is not None:
                anchors["x"].append(xs64)
                anchors["uref"].append(ur64)
                anchors["gold"].append(g)
        x = step1(x, r.u)
    out["c1_x"] = np.stack(anchors["x"])
    out["c1_uref"] = np.stack(anchors["uref"])
    out["c1_gold"] = np.stack(anchors["gold"])
    out["c1_obs"] = obs_np
    print(f"config1: {len(anchors['x'])} anchors")

    # -- config 1 CLOSED-LOOP golden: full f64 NumPy loop, SLSQP QP each
    # step, independent nominal/step formulas.  The parity test drives this
    # repo's f32 closed loop from the same x0 and bounds the trajectory
    # deviation (BASELINE closed-loop criterion).
    xg = np.array([0.5, 1.0, 0.0, 0.0])
    goal_np = np.array([8.0, 4.0])
    cl1 = [xg.copy()]
    for k in range(300):
        ur = di_nominal_np(xg, goal_np)
        rows = [di_row(xg, o, 0.25, 1.5, 1.5) for o in obs_np]
        gsol = qp_golden(ur, rows, [-1.0, -1.0], [1.0, 1.0])
        assert gsol is not None, f"cl1 QP infeasible at k={k}"
        xg = di_step_np(xg, gsol)
        cl1.append(xg.copy())
    out["cl1_x0"] = np.array([0.5, 1.0, 0.0, 0.0])
    out["cl1_goal"] = goal_np
    out["cl1_traj"] = np.stack(cl1)
    print(f"config1 closed-loop golden: {len(cl1)} states, "
          f"final pos {cl1[-1][:2].round(3)}")

    # ------- config 2: DU MPC-CBF N=8, circle + superellipsoid -------------
    from safe_control_tpu.solvers import mpc_cbf

    spec2 = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    m2 = get_model(DYNAMIC_UNICYCLE_2D)
    cfg2 = mpc_cbf.MPCConfig(horizon=N_MPC, num_obs=5)
    # accuracy-mode budget used by the parity test (test_parity_anchors.py):
    # same horizon/dt, more AL iterations than the closed-loop default
    cfg2a = mpc_cbf.MPCConfig(horizon=N_MPC, num_obs=5,
                              outer_iters=12, newton_iters=4, polish_iters=2)
    obs2_np = np.array(
        [[2.0, 0.3, 0.35, 0, 0, 0, 0],  # circle
         [4.0, -0.4, 0.8, 0.4, 4.0, 0.4, 1.0]]  # superellipsoid
    )
    obs2 = pad_obstacles(jnp.asarray(obs2_np, jnp.float32), 5)
    goal2 = np.array([6.0, 0.5, 0.0, 0.0])
    x = jnp.array([0.0, 0.0, 0.0, 0.4], jnp.float32)
    st = mpc_cbf.init_state(DYNAMIC_UNICYCLE_2D, cfg2)
    u_prev = jnp.zeros(2, jnp.float32)
    sol2 = jax.jit(lambda x, up, st: mpc_cbf.solve(
        DYNAMIC_UNICYCLE_2D, spec2, x, jnp.asarray(goal2, jnp.float32), obs2,
        up, st, DT, cfg2))
    sol2_cold = jax.jit(lambda x, up: mpc_cbf.solve(
        DYNAMIC_UNICYCLE_2D, spec2, x, jnp.asarray(goal2, jnp.float32),
        obs2, up, mpc_cbf.init_state(DYNAMIC_UNICYCLE_2D, cfg2a), DT, cfg2a))
    step2 = jax.jit(lambda x, u: m2.step(x, u, spec2, DT))
    c2 = dict(x=[], uprev=[], gold=[])
    dropped = 0
    for k in range(240):
        r = sol2(x, u_prev, st)
        if k % 20 == 0:
            x64, up64 = np.asarray(x, float), np.asarray(u_prev, float)
            U_a, f_a = mpc_golden(x64, goal2, up64, obs2_np, float(spec2.radius),
                                  0.15, 0.15, 1.0)
            if U_a is not None:
                r_cold = sol2_cold(
                    jnp.asarray(x64, jnp.float32), jnp.asarray(up64, jnp.float32))
                U_b, _ = mpc_golden(x64, goal2, up64, obs2_np, float(spec2.radius),
                                    0.15, 0.15, 1.0,
                                    U0=np.asarray(r_cold.state.U, float))
                if U_b is not None and np.max(np.abs(U_a[0] - U_b[0])) < 1e-3:
                    c2["x"].append(x64)
                    c2["uprev"].append(up64)
                    c2["gold"].append(U_a[0])
                else:
                    dropped += 1
        st, u_prev = r.state, r.u
        x = step2(x, r.u)
    out["c2_x"] = np.stack(c2["x"])
    out["c2_uprev"] = np.stack(c2["uprev"])
    out["c2_gold"] = np.stack(c2["gold"])
    out["c2_obs"] = obs2_np
    out["c2_goal"] = goal2
    # Identifiability-filter accounting (BASELINE criterion row): the number
    # of anchors dropped because the two-start f64 optima disagreed is part
    # of the committed record, not just a generator printout.
    out["c2_dropped"] = np.asarray(dropped)
    print(f"config2: {len(c2['x'])} anchors ({dropped} dropped: different basin)")

    # -- config 2 CLOSED-LOOP golden: f64 NumPy loop, warm-started SLSQP MPC
    # each step (the same problem the reference's IPOPT solves per period).
    xg = np.array([0.0, 0.0, 0.0, 0.4])
    ug_prev = np.zeros(2)
    U_warm = None
    cl2 = [xg.copy()]
    for k in range(150):
        U_sol, _ = mpc_golden(xg, goal2, ug_prev, obs2_np, 0.25, 0.15, 0.15,
                              1.0, U0=U_warm)
        if U_sol is None:  # cold retry on the rare warm-start SLSQP failure
            U_sol, _ = mpc_golden(xg, goal2, ug_prev, obs2_np, 0.25, 0.15,
                                  0.15, 1.0)
        assert U_sol is not None, f"closed-loop golden infeasible at k={k}"
        ug_prev = U_sol[0]
        U_warm = np.vstack([U_sol[1:], U_sol[-1:]])
        xg = du_step_np(xg, U_sol[0])
        cl2.append(xg.copy())
    out["cl2_x0"] = np.array([0.0, 0.0, 0.0, 0.4])
    out["cl2_traj"] = np.stack(cl2)
    print(f"config2 closed-loop golden: {len(cl2)} states, "
          f"final pos {cl2[-1][:2].round(3)}")

    # ------- config 3: DU MPC-CBF unknown env (FOV-detected circles) -------
    unknown_np = np.array([[3.0, 0.4, 0.4, 0, 0, 0, 0], [4.5, -0.3, 0.35, 0, 0, 0, 0]])
    unknown = pad_obstacles(jnp.asarray(unknown_np, jnp.float32), 8)
    mem = fov_mod.init_memory(8)
    x = jnp.array([0.0, 0.0, 0.0, 0.4], jnp.float32)
    st = mpc_cbf.init_state(DYNAMIC_UNICYCLE_2D, cfg2)
    u_prev = jnp.zeros(2, jnp.float32)
    goal3 = np.array([7.0, 0.0, 0.0, 0.0])
    c3 = dict(x=[], uprev=[], obs=[], gold=[])
    dropped3 = 0
    # jit everything in the hot loop: eager dispatch compiles thousands of
    # tiny LLVM programs on CPU and exhausts JIT code memory ("LLVM
    # compilation error: Cannot allocate memory") partway through.
    detect3 = jax.jit(
        lambda p, th: fov_mod.detect_unknown_obs_fov(p, th, unknown, spec2))
    merge3 = jax.jit(fov_mod.merge_memory)
    sol3 = jax.jit(lambda x, obs_k, up, st: mpc_cbf.solve(
        DYNAMIC_UNICYCLE_2D, spec2, x, jnp.asarray(goal3, jnp.float32),
        obs_k, up, st, DT, cfg2))
    sol3_cold = jax.jit(lambda x, obs_k, up: mpc_cbf.solve(
        DYNAMIC_UNICYCLE_2D, spec2, x, jnp.asarray(goal3, jnp.float32),
        obs_k, up, mpc_cbf.init_state(DYNAMIC_UNICYCLE_2D, cfg2a), DT, cfg2a))
    step3 = jax.jit(lambda x, u: m2.step(x, u, spec2, DT))
    for k in range(240):
        det, mask = detect3(x[:2], x[2])
        mem = merge3(mem, det, mask)
        slots = np.asarray(mem.slots)
        valid = np.asarray(mem.valid)
        obs_rows = slots[valid][:5]
        obs_k = pad_obstacles(jnp.asarray(obs_rows.reshape(-1, 7), jnp.float32), 5)
        r = sol3(x, obs_k, u_prev, st)
        if k % 20 == 10 and valid.any():
            x64, up64 = np.asarray(x, float), np.asarray(u_prev, float)
            U_a, _ = mpc_golden(x64, goal3, up64, list(obs_rows.astype(float)),
                                float(spec2.radius), 0.15, 0.15, 1.0)
            if U_a is not None:
                r_cold = sol3_cold(
                    jnp.asarray(x64, jnp.float32), obs_k,
                    jnp.asarray(up64, jnp.float32))
                U_b, _ = mpc_golden(x64, goal3, up64, list(obs_rows.astype(float)),
                                    float(spec2.radius), 0.15, 0.15, 1.0,
                                    U0=np.asarray(r_cold.state.U, float))
                if U_b is not None and np.max(np.abs(U_a[0] - U_b[0])) < 1e-3:
                    padded = np.zeros((5, 7))
                    padded[: len(obs_rows)] = obs_rows
                    padded[len(obs_rows):, :2] = 1000.0  # dummy convention
                    c3["x"].append(x64)
                    c3["uprev"].append(up64)
                    c3["obs"].append(padded)
                    c3["gold"].append(U_a[0])
                else:
                    dropped3 += 1
        st, u_prev = r.state, r.u
        x = step3(x, r.u)
    out["c3_x"] = np.stack(c3["x"])
    out["c3_uprev"] = np.stack(c3["uprev"])
    out["c3_obs"] = np.stack(c3["obs"])
    out["c3_gold"] = np.stack(c3["gold"])
    out["c3_goal"] = goal3
    out["c3_dropped"] = np.asarray(dropped3)
    print(f"config3: {len(c3['x'])} anchors ({dropped3} dropped)")

    # ------- config 4: KB C3BF / DPCBF QPs with moving obstacles ------------
    for tag, model_name, h_np in (
        ("c4c", KINEMATIC_BICYCLE_2D_C3BF, c3bf_h_np),
        ("c4d", KINEMATIC_BICYCLE_2D_DPCBF, dpcbf_h_np),
    ):
        spec4 = make_spec(model_name)
        m4 = get_model(model_name)
        obs_m = np.array([8.0, 0.3, 0.4, -1.0, 0.2, 0.0, 0.0])
        x = jnp.array([0.0, 0.0, 0.0, 1.2], jnp.float32)
        rows_x, rows_o, rows_ur, rows_g = [], [], [], []
        obs_cur = obs_m.copy()
        nom4 = jax.jit(
            lambda x: m4.nominal_input(x, jnp.array([12.0, 0.0]), spec4))
        sol4 = jax.jit(lambda x, ur, ob: cbf_qp.solve(
            model_name, spec4, x, ur, ob, DT))
        step4 = jax.jit(lambda x, u: m4.step(x, u, spec4, DT))
        for k in range(200):
            u_ref = nom4(x)
            obs_j = pad_obstacles(jnp.asarray(obs_cur[None], jnp.float32), 5)
            r = sol4(x, u_ref, obs_j)
            if k % 10 == 0:
                x64, ur64 = np.asarray(x, float), np.asarray(u_ref, float)
                if tag == "c4c":
                    # continuous-time C3BF uses beta=1.0 (the reference's
                    # agent_barrier default, kinematic_bicycle2D_c3bf.py:15),
                    # NOT the discrete-time cbf_beta=1.1
                    h_fn = lambda q: c3bf_h_np(q, obs_cur, rr=float(spec4.radius),
                                               beta=1.0)
                else:
                    h_fn = lambda q: dpcbf_h_np(q, obs_cur, rr=float(spec4.radius),
                                                s=1.05)
                row = r1_row(h_fn, x64, kb_f(x64), kb_g(x64), float(spec4.cbf_alpha))
                lb = [-float(spec4.a_max), -float(spec4.beta_max)]
                ub = [float(spec4.a_max), float(spec4.beta_max)]
                g = qp_golden(ur64, [row], lb, ub)
                if g is not None:
                    rows_x.append(x64)
                    rows_o.append(obs_cur.copy())
                    rows_ur.append(ur64)
                    rows_g.append(g)
            x = step4(x, r.u)
            obs_cur[:2] += obs_cur[3:5] * DT
        out[f"{tag}_x"] = np.stack(rows_x)
        out[f"{tag}_obs"] = np.stack(rows_o)
        out[f"{tag}_uref"] = np.stack(rows_ur)
        out[f"{tag}_gold"] = np.stack(rows_g)
        print(f"config4 {tag}: {len(rows_x)} anchors")

    # ------- config 5: fleet per-family CBF-QP anchors (DU r=2) ------------
    spec5 = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.8, v_max=0.7)
    m5 = get_model(DYNAMIC_UNICYCLE_2D)
    obs5_np = np.array([[2.5, 1.8, 0.4, 0, 0, 0, 0], [4.0, 2.6, 0.5, 0, 0, 0, 0]])
    obs5 = pad_obstacles(jnp.asarray(obs5_np, jnp.float32), 8)
    x = jnp.array([0.5, 1.5, 0.2, 0.4], jnp.float32)
    rows_x, rows_ur, rows_g = [], [], []
    nom5 = jax.jit(lambda x: m5.nominal_input(x, jnp.array([7.0, 3.0]), spec5))
    sol5 = jax.jit(
        lambda x, ur: cbf_qp.solve(DYNAMIC_UNICYCLE_2D, spec5, x, ur, obs5, DT))
    step5 = jax.jit(lambda x, u: m5.step(x, u, spec5, DT))
    for k in range(200):
        u_ref = nom5(x)
        r = sol5(x, u_ref)
        if k % 10 == 0:
            x64, ur64 = np.asarray(x, float), np.asarray(u_ref, float)
            rows = [du_row(x64, o, float(spec5.radius), 1.5, 1.5) for o in obs5_np]
            g = qp_golden(ur64, rows, [-1.0, -0.8], [1.0, 0.8])
            if g is not None:
                rows_x.append(x64)
                rows_ur.append(ur64)
                rows_g.append(g)
        x = step5(x, r.u)
    out["c5_x"] = np.stack(rows_x)
    out["c5_uref"] = np.stack(rows_ur)
    out["c5_gold"] = np.stack(rows_g)
    out["c5_obs"] = obs5_np
    print(f"config5: {len(rows_x)} anchors")

    path = os.path.join(os.path.dirname(__file__), "parity_goldens.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()

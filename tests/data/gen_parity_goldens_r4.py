"""Round-4 parity goldens: MPCC contouring anchors + closed-loop configs 3-4.

Extends tests/data/gen_parity_goldens.py (same policy: float64 scipy
reference solving the SAME optimization problems, formulas re-implemented
independently in NumPy, constants shared with the reference; two-start
identifiability filter for nonconvex problems with drop counts recorded):

  mpcc   f64 SLSQP KKT-point certifications of the MPCC contouring NLP on
         an oval track (the reference's mpcc.py:415-443 problem:
         contouring/lag/heading/velocity/yaw-rate costs, Fiala-tire
         rollout, body-state bound constraints, per-stage path references
         at psi0 + k*v_psi_ref*dt) at anchor states frozen from a
         closed-loop drive.  POLICY NOTE (differs from the MPC-CBF
         anchors): cold-started f64 SLSQP does not converge on this
         90-variable strongly-nonconvex NLP (measured; perturbed starts
         also diverge) — the reference itself only ever solves it
         warm-started with relaxed tolerances (mpcc.py:213-220) — so the
         golden is the f64 SLSQP optimum POLISHED from this repo's
         solution (ftol 1e-12 against an INDEPENDENT NumPy implementation
         of the dynamics/cost/constraints).  This certifies the repo
         solver sits next to a true f64 KKT point of the exact NLP — it
         catches wrong dynamics/cost/constraint implementations and solver
         non-convergence; it cannot certify global-basin choice (neither
         can IPOPT).  ``mpcc_polish_move`` records how far the f64 polish
         moved from the f32 repo solution (the solver's true per-anchor
         optimality gap) as part of the committed record.
  cl3    closed-loop golden for BASELINE config 3 (DU MPC-CBF unknown env):
         full f64 NumPy loop — FoV detection + persistent memory merge +
         warm-started SLSQP MPC every step (utils/detection.py:28-87,
         robots/robot.py:773-797 semantics re-implemented in NumPy).
  cl4c/d closed-loop goldens for config 4 (KB C3BF / DPCBF with a moving
         obstacle): f64 NumPy loop with the exact active-set QP each step.

Run (CPU):  env JAX_PLATFORMS=cpu python tests/data/gen_parity_goldens_r4.py
Output:     tests/data/parity_goldens_r4.npz  (committed)
"""

from __future__ import annotations

import os
import sys

import numpy as np
from scipy.optimize import minimize

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gen_parity_goldens as g1  # NumPy formula library (independent impls)

DT = 0.05


def norm_angle(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


# ===================== MPCC: NumPy problem implementation ===================
# Fiala brush-tire dynamics (dynamic_bicycle2D.py:103-262) re-derived in
# NumPy; spec constants read from the shared RobotSpec at generation time.


def fiala_params():
    from safe_control_tpu.core.spec import DRIFTING_CAR, make_spec

    s = make_spec(DRIFTING_CAR)
    keys = ["mass", "izz", "a_cg", "b_cg", "cc_f", "cc_r", "mu", "r_w",
            "gamma_stab", "r_max", "beta_max", "v_min", "v_max", "delta_max",
            "tau_max", "delta_dot_max", "tau_dot_max"]
    return {k: float(getattr(s, k)) for k in keys}


def fiala_f_np(x5, P):
    r, beta, V, delta, tau = x5
    G = 9.81
    L = P["a_cg"] + P["b_cg"]
    Fz_f = P["mass"] * G * P["b_cg"] / L
    Fz_r = P["mass"] * G * P["a_cg"] / L
    V_safe = max(V, 0.1)
    alpha_f = np.arctan2(V * np.sin(beta) + P["a_cg"] * r,
                         V_safe * np.cos(beta)) - delta
    alpha_r = np.arctan2(V * np.sin(beta) - P["b_cg"] * r,
                         V_safe * np.cos(beta))
    Fx_f = 0.0
    F_lim = P["mu"] * Fz_r
    Fx_r = F_lim * np.tanh(tau / (P["r_w"] * max(F_lim, 1.0)))

    def fy(alpha, Cc, Fz, Fx):
        Fy_max = np.sqrt(max((P["mu"] * Fz) ** 2 - P["gamma_stab"] * Fx**2,
                             1.0))
        alpha_sl = np.arctan(3.0 * Fy_max / Cc)
        t = np.tan(alpha)
        lin = (-Cc * t + (Cc**2 / (3.0 * Fy_max)) * abs(t) * t
               - (Cc**3 / (27.0 * Fy_max**2)) * t**3)
        return lin if abs(alpha) < alpha_sl else -Fy_max * np.sign(alpha)

    Fy_f = fy(alpha_f, P["cc_f"], Fz_f, Fx_f)
    Fy_r = fy(alpha_r, P["cc_r"], Fz_r, Fx_r)
    r_dot = (P["a_cg"] * (Fx_f * np.sin(delta) + Fy_f * np.cos(delta))
             - P["b_cg"] * Fy_r) / P["izz"]
    beta_dot = (Fx_f * np.sin(delta - beta) + Fy_f * np.cos(delta - beta)
                - Fx_r * np.sin(beta) + Fy_r * np.cos(beta)) / (
        P["mass"] * V_safe) - r
    V_dot = (Fx_f * np.cos(delta - beta) - Fy_f * np.sin(delta - beta)
             + Fx_r * np.cos(beta) + Fy_r * np.sin(beta)) / P["mass"]
    return np.array([r_dot, beta_dot, V_dot, 0.0, 0.0])


def aug_step_np(x9, u3, P):
    """mpcc.py's augmented step: raw (unclamped) body dynamics + kinematic
    pose coupling + psi' = v_psi."""
    Xd = x9[3:8].copy()
    fd = fiala_f_np(Xd, P)
    Xd = Xd + (fd + np.array([[0, 0], [0, 0], [0, 0], [1, 0], [0, 1.0]])
               @ u3[:2]) * DT
    theta, r, beta, V = x9[2], x9[3], x9[4], x9[5]
    out = np.empty(9)
    out[0] = x9[0] + V * np.cos(theta + beta) * DT
    out[1] = x9[1] + V * np.sin(theta + beta) * DT
    out[2] = theta + r * DT
    out[3:8] = Xd
    out[8] = x9[8] + u3[2] * DT
    return out


class NpPath:
    def __init__(self, xs, ys):
        xs = np.asarray(xs, float)
        ys = np.asarray(ys, float)
        ds = np.hypot(np.diff(xs), np.diff(ys))
        self.s = np.concatenate([[0.0], np.cumsum(ds)])
        self.x, self.y = xs, ys
        th = np.arctan2(np.diff(ys), np.diff(xs))
        self.theta = np.concatenate([th, th[-1:]])

    def ref(self, psi):
        psi = np.clip(psi, self.s[0], self.s[-1])
        xr = np.interp(psi, self.s, self.x)
        yr = np.interp(psi, self.s, self.y)
        cr = np.interp(psi, self.s, np.cos(self.theta))
        sr = np.interp(psi, self.s, np.sin(self.theta))
        return xr, yr, np.arctan2(sr, cr)

    def closest_psi(self, pos, psi_now, back, window, global_search):
        d2 = (self.x - pos[0]) ** 2 + (self.y - pos[1]) ** 2
        in_win = (self.s >= psi_now - back) & (self.s <= psi_now + window)
        use_global = global_search or not in_win.any()
        score = np.where(use_global | in_win, d2, np.inf)
        return self.s[int(np.argmin(score))]


MPCC_N = 30
MPCC_W = dict(q_c=100.0, q_l=5.0, q_theta=30.0, q_v=20.0, q_r=10.0,
              v_ref=10.0, r_delta_dot=50.0, r_tau_dot=0.01, r_v_psi=0.1,
              v_psi_ref=2.0, v_psi_min=0.1, v_psi_max=15.0,
              search_window=40.0, search_back=10.0)


def mpcc_nlp(x8, psi_prev, initialized, u_prev2, path: NpPath, P):
    """Independent f64 model of the MPCC NLP at one anchor.

    Returns ``(cost, cons, bounds, psi0)`` — the objective, inequality
    constraint vector (feasible iff all >= 0), SLSQP box bounds, and the
    windowed-search path parameter.  Shared by ``mpcc_golden`` (golden
    generation) and the f32 cost-gap certificate in
    tests/test_parity_anchors_r4.py, so the certificate is evaluated on
    the SAME independent NumPy model the goldens come from (structurally
    disjoint from the repo's jax implementation; reference NLP:
    /root/reference/position_control/mpcc.py:196-290).
    """
    W = MPCC_W
    psi0 = path.closest_psi(x8[:2], psi_prev, W["search_back"],
                            W["search_window"], not initialized)
    psis = psi0 + np.arange(MPCC_N + 1) * W["v_psi_ref"] * DT
    refs = [path.ref(p) for p in psis]
    xr = np.array([r[0] for r in refs])
    yr = np.array([r[1] for r in refs])
    thr = np.array([r[2] for r in refs])
    x0 = np.concatenate([x8, [psi0]])
    uprev3 = np.concatenate([u_prev2, [W["v_psi_ref"]]])
    Rw = np.array([W["r_delta_dot"], W["r_tau_dot"], W["r_v_psi"]])

    def rollout(U):
        xs = [x0]
        for k in range(MPCC_N):
            xs.append(aug_step_np(xs[-1], U[k], P))
        return np.stack(xs[1:])

    def cost(Uf):
        U = Uf.reshape(MPCC_N, 3)
        xs = rollout(U)
        dx = xs[:, 0] - xr[1:]
        dy = xs[:, 1] - yr[1:]
        e_c = np.sin(thr[1:]) * dx - np.cos(thr[1:]) * dy
        e_l = -np.cos(thr[1:]) * dx - np.sin(thr[1:]) * dy
        e_th = norm_angle(xs[:, 2] - thr[1:])
        e_v = xs[:, 5] - W["v_ref"]
        du = np.diff(np.vstack([uprev3[None], U]), axis=0)
        return float(
            W["q_c"] * e_c @ e_c + W["q_l"] * e_l @ e_l
            + W["q_theta"] * e_th @ e_th + W["q_v"] * e_v @ e_v
            + W["q_r"] * xs[:, 3] @ xs[:, 3]
            + np.sum(Rw[None, :] * du * du)
        )

    lbs = np.array([-P["r_max"], -P["beta_max"], P["v_min"],
                    -P["delta_max"], -P["tau_max"]])
    ubs = np.array([P["r_max"], P["beta_max"], P["v_max"],
                    P["delta_max"], P["tau_max"]])

    def cons(Uf):
        xs = rollout(Uf.reshape(MPCC_N, 3))
        body = xs[:, 3:8]
        return np.concatenate([(ubs[None] - body).ravel(),
                               (body - lbs[None]).ravel()])

    bounds = [(-P["delta_dot_max"], P["delta_dot_max"]),
              (-P["tau_dot_max"], P["tau_dot_max"]),
              (W["v_psi_min"], W["v_psi_max"])] * MPCC_N
    return cost, cons, bounds, psi0


def mpcc_golden(x8, psi_prev, initialized, u_prev2, path: NpPath, P,
                U0=None):
    """f64 SLSQP solve of the SAME MPCC NLP; returns (U (N,3), psi0)."""
    W = MPCC_W
    cost, cons, bounds, psi0 = mpcc_nlp(
        x8, psi_prev, initialized, u_prev2, path, P)
    if U0 is None:
        U0 = np.zeros((MPCC_N, 3))
        U0[:, 2] = W["v_psi_ref"]
    res = minimize(cost, np.asarray(U0, float).ravel(), method="SLSQP",
                   bounds=bounds,
                   constraints=[dict(type="ineq", fun=cons)],
                   options=dict(maxiter=400, ftol=1e-12))
    if not res.success:
        return None, psi0
    return res.x.reshape(MPCC_N, 3), psi0


def gen_mpcc(out):
    import jax
    import jax.numpy as jnp

    from safe_control_tpu.core.spec import DRIFTING_CAR, make_spec
    from safe_control_tpu.dynamics import drifting_car as car
    from safe_control_tpu.solvers import mpcc

    P = fiala_params()
    spec = make_spec(DRIFTING_CAR)
    # oval: two 60 m straights + semicircles of radius 15, 0.25 m sampling
    R, straight = 15.0, 60.0
    pts = []
    for t in np.arange(0.0, straight, 0.25):
        pts.append((t, 0.0))
    for a in np.arange(-np.pi / 2, np.pi / 2, 0.25 / R):
        pts.append((straight + R * np.cos(a), R + R * np.sin(a)))
    for t in np.arange(0.0, straight, 0.25):
        pts.append((straight - t, 2 * R))
    for a in np.arange(np.pi / 2, 3 * np.pi / 2, 0.25 / R):
        pts.append((R * np.cos(a), R + R * np.sin(a)))
    pts.append((0.0, 0.0))
    xs_p = np.array([p[0] for p in pts])
    ys_p = np.array([p[1] for p in pts])
    np_path = NpPath(xs_p, ys_p)
    jpath = mpcc.make_path(xs_p, ys_p)
    cfg = mpcc.MPCCConfig(horizon=MPCC_N, v_ref=MPCC_W["v_ref"])

    x8 = jnp.asarray([2.0, 0.2, 0.0, 0.0, 0.0, 10.0, 0.0, 0.0], jnp.float32)
    st = mpcc.init_state(cfg)
    u_prev = jnp.zeros(2, jnp.float32)
    sol = jax.jit(lambda x, s, up: mpcc.solve(spec, x, jpath, s, up, DT, cfg))
    stepc = jax.jit(lambda x, u: car.step(x, u, spec, DT))

    anchors = dict(x8=[], psi=[], init=[], uprev=[], gold=[], move=[])
    dropped = 0
    for k in range(120):
        if k % 15 == 5:
            x64 = np.asarray(x8, float)
            psi_prev = float(st.psi)
            init = bool(st.initialized)
            up64 = np.asarray(u_prev, float)
            r_now = sol(x8, st, u_prev)
            U_repo = np.asarray(r_now.us, float)
            # f64 KKT polish from the repo solution (see module docstring)
            U_a, _ = mpcc_golden(x64, psi_prev, init, up64, np_path, P,
                                 U0=U_repo)
            if U_a is not None:
                anchors["x8"].append(x64)
                anchors["psi"].append(psi_prev)
                anchors["init"].append(init)
                anchors["uprev"].append(up64)
                anchors["gold"].append(U_a[0, :2])
                anchors["move"].append(
                    np.max(np.abs(U_a[0, :2] - U_repo[0, :2]))
                )
            else:
                dropped += 1
        r = sol(x8, st, u_prev)
        st, u_prev = r.state, r.u
        x8 = stepc(x8, r.u)
    out["mpcc_x8"] = np.stack(anchors["x8"])
    out["mpcc_psi"] = np.asarray(anchors["psi"])
    out["mpcc_init"] = np.asarray(anchors["init"])
    out["mpcc_uprev"] = np.stack(anchors["uprev"])
    out["mpcc_gold"] = np.stack(anchors["gold"])
    out["mpcc_polish_move"] = np.asarray(anchors["move"])
    out["mpcc_dropped"] = np.asarray(dropped)
    out["mpcc_path_xy"] = np.stack([xs_p, ys_p], axis=1)
    print(f"mpcc: {len(anchors['x8'])} anchors ({dropped} dropped)")


# ================= closed-loop config 4: KB C3BF / DPCBF ====================
def kb_params():
    from safe_control_tpu.core.spec import KINEMATIC_BICYCLE_2D_C3BF, make_spec

    s = make_spec(KINEMATIC_BICYCLE_2D_C3BF)
    return {k: float(getattr(s, k)) for k in
            ["radius", "a_max", "beta_max", "v_min", "v_max", "wheel_base",
             "rear_ax_dist", "delta_max", "cbf_alpha"]}


def kb_nominal_np(x, goal, P, d_min=0.05, k_theta=0.5, k_a=1.5, k_v=0.5):
    """kinematic_bicycle2D.py:125-147 re-implementation."""
    distance = max(np.hypot(*(x[:2] - goal[:2])) - d_min, 0.05)
    theta_d = np.arctan2(goal[1] - x[1], goal[0] - x[0])
    err = norm_angle(theta_d - x[2])
    delta = np.clip(k_theta * err, -P["delta_max"], P["delta_max"])
    beta = np.arctan((P["rear_ax_dist"] / P["wheel_base"]) * np.tan(delta))
    heading_scale = max(0.0, np.cos(err))
    v = np.clip(k_v * distance * heading_scale, P["v_min"], P["v_max"])
    return np.array([k_a * (v - x[3]), beta])


def kb_step_np(x, u, P):
    """kinematic_bicycle2D.py:112-123: Euler + angle norm + v clip."""
    fx = np.array([x[3] * np.cos(x[2]), x[3] * np.sin(x[2]), 0.0, 0.0])
    gx = np.array([
        [0.0, -x[3] * np.sin(x[2])],
        [0.0, x[3] * np.cos(x[2])],
        [0.0, x[3] / P["rear_ax_dist"]],
        [1.0, 0.0],
    ])
    x = x + (fx + gx @ u) * DT
    x[2] = norm_angle(x[2])
    x[3] = np.clip(x[3], P["v_min"], P["v_max"])
    return x


def gen_cl4(out):
    P = kb_params()
    for tag, h_np in (("cl4c", g1.c3bf_h_np), ("cl4d", g1.dpcbf_h_np)):
        x = np.array([0.0, 0.0, 0.0, 1.2])
        obs = np.array([8.0, 0.3, 0.4, -1.0, 0.2, 0.0, 0.0])
        goal = np.array([12.0, 0.0])
        traj = [x.copy()]
        for k in range(200):
            u_ref = kb_nominal_np(x, goal, P)
            if tag == "cl4c":
                h_fn = lambda q: g1.c3bf_h_np(q, obs, rr=P["radius"],
                                              beta=1.0)
            else:
                h_fn = lambda q: g1.dpcbf_h_np(q, obs, rr=P["radius"], s=1.05)
            row = g1.r1_row(h_fn, x, g1.kb_f(x),
                            g1.kb_g(x, wheel_base=P["wheel_base"]),
                            P["cbf_alpha"])
            gsol = g1.qp_golden(u_ref, [row],
                                [-P["a_max"], -P["beta_max"]],
                                [P["a_max"], P["beta_max"]])
            assert gsol is not None, (tag, k)
            x = kb_step_np(x, gsol, P)
            obs[:2] += obs[3:5] * DT
            traj.append(x.copy())
        out[f"{tag}_x0"] = np.array([0.0, 0.0, 0.0, 1.2])
        out[f"{tag}_obs0"] = np.array([8.0, 0.3, 0.4, -1.0, 0.2, 0.0, 0.0])
        out[f"{tag}_goal"] = goal
        out[f"{tag}_traj"] = np.stack(traj)
        print(f"{tag} closed-loop golden: final pos "
              f"{traj[-1][:2].round(3)}")


# ================= closed-loop config 3: FoV unknown env ====================
def fov_params():
    from safe_control_tpu.core.spec import DYNAMIC_UNICYCLE_2D, make_spec

    s = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    return float(s.fov_angle), float(s.cam_range), float(s.radius)


def detect_np(p, yaw, obs_rows, fov_angle, cam_range):
    """utils/detection.py:28-87 'fov' mode, circles (NumPy)."""
    hits = []
    for o in obs_rows:
        toc = o[:2] - p
        dist = np.hypot(*toc)
        inside = dist <= o[2]
        too_far = dist - o[2] > cam_range
        diff = abs(norm_angle(np.arctan2(toc[1], toc[0]) - yaw))
        in_cone = diff <= fov_angle / 2
        ang_rad = np.arcsin(np.clip(o[2] / max(dist, 1e-9), 0.0, 1.0))
        in_wide = diff <= fov_angle / 2 + ang_rad
        hits.append(bool(inside or (not too_far and (in_cone or in_wide))))
    return hits


def gen_cl3(out):
    fov_angle, cam_range, rr = fov_params()
    unknown = [np.array([3.0, 0.4, 0.4, 0, 0, 0, 0.0]),
               np.array([4.5, -0.3, 0.35, 0, 0, 0, 0.0])]
    goal = np.array([7.0, 0.0, 0.0, 0.0])
    x = np.array([0.0, 0.0, 0.0, 0.4])
    memory = []  # persistent slots, insertion order (robot.py:773-797)
    u_prev = np.zeros(2)
    U_warm = None
    traj = [x.copy()]
    for k in range(150):
        hits = detect_np(x[:2], x[2], unknown, fov_angle, cam_range)
        for o, h in zip(unknown, hits):
            if not h:
                continue
            for m in memory:  # tolerance dedup
                if (np.hypot(*(m[:2] - o[:2])) <= 1e-3
                        and abs(m[2] - o[2]) <= 1e-2):
                    m[:] = o
                    break
            else:
                if len(memory) < 8:
                    memory.append(o.copy())
        obs_rows = [m.copy() for m in memory[:5]]
        # SLSQP retry ladder: with v pinned at the v_max state bound the
        # 1e-14 ftol is below achievable line-search precision and SLSQP
        # reports spurious failure; 1e-12/1e-10 are still orders below the
        # trajectory-gate tolerance.
        U_sol = None
        for U0_try, ftol in ((U_warm, 1e-14), (None, 1e-14),
                             (U_warm, 1e-12), (None, 1e-12),
                             (U_warm, 1e-10), (None, 1e-10)):
            U_sol, _ = g1.mpc_golden(x, goal, u_prev, obs_rows, rr,
                                     0.15, 0.15, 1.0, U0=U0_try, ftol=ftol)
            if U_sol is not None:
                break
        assert U_sol is not None, f"cl3 infeasible at k={k}"
        u_prev = U_sol[0]
        U_warm = np.vstack([U_sol[1:], U_sol[-1:]])
        x = g1.du_step_np(x, U_sol[0])
        traj.append(x.copy())
    out["cl3_x0"] = np.array([0.0, 0.0, 0.0, 0.4])
    out["cl3_goal"] = goal
    out["cl3_unknown"] = np.stack(unknown)
    out["cl3_traj"] = np.stack(traj)
    print(f"cl3 closed-loop golden: final pos {traj[-1][:2].round(3)}")


def main():
    out = {}
    gen_cl4(out)
    gen_cl3(out)
    gen_mpcc(out)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "parity_goldens_r4.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()

"""MPC-CBF solver tests.

Parity is checked against scipy SLSQP solving the *identical* NLP (same
rollout, cost, constraints) — the stand-in for the reference's IPOPT since
casadi/do-mpc are not installed here.  BASELINE.md's acceptance criterion is
max |u - u_ref| < 1e-3 under identical horizon/dt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import minimize

from safe_control_tpu.core.spec import DYNAMIC_UNICYCLE_2D, make_spec
from safe_control_tpu.core.types import pad_obstacles
from safe_control_tpu.dynamics import get_model
from safe_control_tpu.solvers import mpc_cbf

DT = 0.05
N = 8
K = 5

SPEC = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
MODEL = get_model(DYNAMIC_UNICYCLE_2D)
CFG = mpc_cbf.MPCConfig(horizon=N, num_obs=K)


def _np_step(x, u):
    """NumPy replica of DynamicUnicycle2D Euler step (reference :75-78)."""
    f = np.array([x[3] * np.cos(x[2]), x[3] * np.sin(x[2]), 0.0, 0.0])
    g = np.array([[0, 0], [0, 0], [0, 1], [1, 0]], dtype=float)
    x = x + (f + g @ u) * DT
    x[2] = (x[2] + np.pi) % (2 * np.pi) - np.pi
    return x


def _np_rollout(x0, U):
    xs = [np.asarray(x0, dtype=float)]
    for k in range(N):
        xs.append(_np_step(xs[-1], U[k]))
    return np.stack(xs)


def _np_cost(U_flat, x0, goal, u_prev):
    U = U_flat.reshape(N, 2)
    xs = _np_rollout(x0, U)
    Q = np.array([50.0, 50.0, 0.01, 30.0])
    R = np.array([0.5, 0.5])
    c = float(np.sum(Q * (xs[1:] - goal) ** 2))
    du = np.diff(np.vstack([u_prev[None], U]), axis=0)
    c += float(np.sum(R * du**2))
    return c


def _np_h(x, obs):
    d_min = obs[2] + float(SPEC.radius)
    return (x[0] - obs[0]) ** 2 + (x[1] - obs[1]) ** 2 - 1.01 * d_min**2


def _np_cbf(U_flat, x0, goal, u_prev, obs_list):
    """All dt-HOCBF constraint values (must be >= 0), mirroring our solver."""
    U = U_flat.reshape(N, 2)
    xs = _np_rollout(x0, U)
    a1 = a2 = 0.15
    vals = []
    for k in range(N):
        xk, uk = xs[k], U[k]
        x1 = _np_step(xk, uk)
        x2 = _np_step(x1, uk)
        for obs in obs_list:
            h0, h1, h2 = _np_h(xk, obs), _np_h(x1, obs), _np_h(x2, obs)
            vals.append((h2 - 2 * h1 + h0) + (a1 + a2) * (h1 - h0) + a1 * a2 * h0)
    return np.array(vals)


def _np_vbounds(U_flat, x0):
    U = U_flat.reshape(N, 2)
    xs = _np_rollout(x0, U)
    return np.concatenate([1.0 - xs[1:, 3], xs[1:, 3] + 1.0])  # v_max = 1


def _scipy_solution(x0, goal, u_prev, obs_list, U0):
    cons = [
        dict(type="ineq", fun=lambda U: _np_cbf(U, x0, goal, u_prev, obs_list)),
        dict(type="ineq", fun=lambda U: _np_vbounds(U, x0)),
    ]
    bounds = [(-1.0, 1.0), (-0.5, 0.5)] * N
    res = minimize(
        _np_cost,
        U0.ravel(),
        args=(x0, goal, u_prev),
        method="SLSQP",
        bounds=bounds,
        constraints=cons,
        options=dict(maxiter=400, ftol=1e-12),
    )
    assert res.success, res.message
    return res.x.reshape(N, 2)


def _our_solution(x0, goal, u_prev, obs):
    st = mpc_cbf.init_state(DYNAMIC_UNICYCLE_2D, CFG)
    res = mpc_cbf.solve(
        DYNAMIC_UNICYCLE_2D,
        SPEC,
        jnp.asarray(x0, dtype=jnp.float32),
        jnp.asarray(goal, dtype=jnp.float32),
        obs,
        jnp.asarray(u_prev, dtype=jnp.float32),
        st,
        DT,
        CFG,
    )
    return res


@pytest.mark.parametrize(
    "x0,goal_xy,obs_rows",
    [
        # free flight toward goal
        (np.array([0.0, 0.0, 0.0, 0.3]), (3.0, 0.5), []),
        # single obstacle near the path
        (np.array([0.0, 0.0, 0.2, 0.6]), (3.0, 0.0), [[1.4, 0.15, 0.3]]),
        # two obstacles
        (
            np.array([0.5, -0.2, 0.4, 0.8]),
            (3.5, 1.0),
            [[1.8, 0.3, 0.35], [2.6, 0.9, 0.3]],
        ),
    ],
)
@pytest.mark.slow
def test_first_control_matches_scipy(x0, goal_xy, obs_rows):
    goal = np.array([goal_xy[0], goal_xy[1], 0.0, 0.0])
    u_prev = np.zeros(2)
    obs_list = [np.array(r, dtype=float) for r in obs_rows]
    obs = pad_obstacles(
        jnp.asarray(np.array([r + [0, 0, 0, 0] for r in obs_rows]).reshape(-1, 7))
        if obs_rows
        else jnp.zeros((0, 7)),
        K,
    )
    ours = _our_solution(x0, goal, u_prev, obs)
    assert bool(ours.feasible)
    U0 = np.asarray(ours.state.U)  # warm-start scipy from our answer: both
    # should then sit at the same local optimum
    ref = _scipy_solution(x0, goal, u_prev, obs_list, np.zeros((N, 2)))
    dev = np.abs(np.asarray(ours.u) - ref[0])
    assert dev.max() < 1e-3, f"deviation {dev} vs scipy {ref[0]} ours {np.asarray(ours.u)}"


def test_closed_loop_obstacle_avoidance():
    """DU robot must reach the goal without collision under MPC-CBF."""
    obs_np = np.array([[1.5, 0.05, 0.4, 0, 0, 0, 0]])
    obs = pad_obstacles(jnp.asarray(obs_np), K)
    goal = jnp.array([3.0, 0.0, 0.0, 0.0])
    st = mpc_cbf.init_state(DYNAMIC_UNICYCLE_2D, CFG)
    u_prev = jnp.zeros(2)

    solve = jax.jit(
        lambda x, st, up: mpc_cbf.solve(
            DYNAMIC_UNICYCLE_2D, SPEC, x, goal, obs, up, st, DT, CFG
        )
    )
    x = jnp.array([0.0, 0.0, 0.0, 0.0])
    min_clear = np.inf
    reached = False
    for t in range(600):
        res = solve(x, st, u_prev)
        x = MODEL.step(x, res.u, SPEC, DT)
        st, u_prev = res.state, res.u
        d = np.linalg.norm(np.asarray(x[:2]) - obs_np[0, :2]) - obs_np[0, 2]
        min_clear = min(min_clear, d)
        if np.linalg.norm(np.asarray(x[:2]) - np.asarray(goal[:2])) < 0.3:
            reached = True
            break
    assert reached, f"never reached goal, x={np.asarray(x)}"
    assert min_clear > float(SPEC.radius) - 0.02  # no collision (beta=1.01 margin)


@pytest.mark.slow
def test_batched_solve_consistency():
    obs = pad_obstacles(jnp.array([[1.5, 0.1, 0.3, 0, 0, 0, 0]]), K)
    goal = jnp.array([3.0, 0.0, 0.0, 0.0])
    st = mpc_cbf.init_state(DYNAMIC_UNICYCLE_2D, CFG)
    u_prev = jnp.zeros(2)
    xs = jnp.stack(
        [jnp.array([0.0, 0.0, 0.0, 0.5]), jnp.array([0.2, 0.3, 0.1, 0.4])]
    )
    solve_one = jax.jit(lambda x: mpc_cbf.solve(
        DYNAMIC_UNICYCLE_2D, SPEC, x, goal, obs, u_prev, st, DT, CFG
    ).u)
    batch = jax.jit(jax.vmap(solve_one))(xs)
    for i in range(2):
        single = solve_one(xs[i])
        np.testing.assert_allclose(
            np.asarray(batch[i]), np.asarray(single), atol=2e-5
        )


def test_scan_unroll_envelope_and_wrapper_key():
    """``scan_unroll`` is a scheduling knob: full unroll must agree with the
    default scan lowering to f32 op-ordering noise (<5e-3), and the wrapper
    must honor the ``mpc_scan_unroll`` robot_spec key (defaulting to 1 on
    CPU, where
    dispatch overhead is nil and unrolling only bloats compile; the
    accelerator default is full unroll)."""
    obs = pad_obstacles(jnp.array([[1.5, 0.1, 0.3, 0, 0, 0, 0]]), K)
    goal = jnp.array([3.0, 0.0, 0.0, 0.0])
    x0 = jnp.array([0.0, 0.0, 0.0, 0.5])
    u_prev = jnp.zeros(2)
    us = []
    for unroll in (1, N):
        cfg = CFG._replace(scan_unroll=unroll)
        st = mpc_cbf.init_state(DYNAMIC_UNICYCLE_2D, cfg)
        r = jax.jit(
            lambda x, _cfg=cfg, _st=st: mpc_cbf.solve(
                DYNAMIC_UNICYCLE_2D, SPEC, x, goal, obs, u_prev, _st, DT, _cfg
            ).u
        )(x0)
        us.append(np.asarray(r))
    assert np.max(np.abs(us[0] - us[1])) < 5e-3

    from safe_control_tpu.sim.controller import LocalTrackingController

    cfg = LocalTrackingController._build_mpc_cfg(
        {"model": "DynamicUnicycle2D", "mpc_scan_unroll": 4}, N, "mpc_cbf"
    )
    assert cfg.scan_unroll == 4
    cfg_default = LocalTrackingController._build_mpc_cfg(
        {"model": "DynamicUnicycle2D"}, N, "mpc_cbf"
    )
    import jax as _jax

    expected = 1 if _jax.default_backend() == "cpu" else N
    assert cfg_default.scan_unroll == expected


def test_loop_unroll_envelope_and_wrapper_key():
    """``loop_unroll`` (unrolling the Newton/AL fori_loops) is the same
    scheduling-knob class as ``scan_unroll``: results must agree with the
    rolled lowering to f32 op-ordering noise, and the wrapper must expose it
    via the ``mpc_loop_unroll`` robot_spec key.  Default OFF everywhere:
    measured marginal at the RTI budget (~1 ms through the wrapper) and a
    >15-minute XLA compile at the 24-Newton accuracy budget (PERF.md
    round-5) — an opt-in knob, not a default."""
    obs = pad_obstacles(jnp.array([[1.5, 0.1, 0.3, 0, 0, 0, 0]]), K)
    goal = jnp.array([3.0, 0.0, 0.0, 0.0])
    x0 = jnp.array([0.0, 0.0, 0.0, 0.5])
    u_prev = jnp.zeros(2)
    us = []
    for lu in (False, True):
        cfg = CFG._replace(loop_unroll=lu)
        st = mpc_cbf.init_state(DYNAMIC_UNICYCLE_2D, cfg)
        r = jax.jit(
            lambda x, _cfg=cfg, _st=st: mpc_cbf.solve(
                DYNAMIC_UNICYCLE_2D, SPEC, x, goal, obs, u_prev, _st, DT, _cfg
            ).u
        )(x0)
        us.append(np.asarray(r))
    assert np.max(np.abs(us[0] - us[1])) < 5e-3

    from safe_control_tpu.sim.controller import LocalTrackingController

    cfg = LocalTrackingController._build_mpc_cfg(
        {"model": "DynamicUnicycle2D", "mpc_loop_unroll": True}, N, "mpc_cbf"
    )
    assert cfg.loop_unroll is True
    # default OFF — everywhere, including the RTI preset
    cfg_default = LocalTrackingController._build_mpc_cfg(
        {"model": "DynamicUnicycle2D"}, N, "mpc_cbf"
    )
    assert cfg_default.loop_unroll is False
    cfg_rti = LocalTrackingController._build_mpc_cfg(
        {"model": "VTOL2D", "mpc_rti": True}, 30, "mpc_cbf"
    )
    assert cfg_rti.loop_unroll is False

"""End-to-end scenario tests: the reference's examples-as-tests (SURVEY.md §4).

Reproduces examples/test_tracking.py scenarios headless: success iff the run
ends with return code -1 (all waypoints) and never hits -2
(infeasible/collision), matching test_tracking.py:170-175.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safe_control_tpu.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DYNAMIC_UNICYCLE_2D,
    make_spec,
)
from safe_control_tpu.core.types import pad_obstacles
from safe_control_tpu.sim import tracking
from safe_control_tpu.solvers import mpc_cbf

# Scenario from examples/test_tracking.py:44-54.
WAYPOINTS = np.array(
    [[2, 2, np.pi / 2], [2, 12, 0], [12, 12, 0], [12, 2, 0]], dtype=float
)
KNOWN_OBS = np.array(
    [
        [2.2, 5.0, 0.2],
        [3.0, 5.0, 0.2],
        [4.0, 9.0, 0.3],
        [1.5, 10.0, 0.5],
        [9.0, 11.0, 1.0],
        [7.0, 7.0, 3.0],
        [4.0, 3.5, 1.5],
        [10.0, 7.3, 0.4],
        [6.0, 13.0, 0.7],
        [5.0, 10.0, 0.6],
        [11.0, 5.0, 0.8],
        [13.5, 11.0, 0.6],
        [2.0, 7.0, 0.7],
        [2.0, 8.0, 0.5],
    ]
)


def _run_scenario(cfg, spec, x0, yaw0, tf=100.0):
    known = pad_obstacles(jnp.asarray(KNOWN_OBS), 16)
    wps = jnp.asarray(WAYPOINTS, dtype=jnp.float32)
    st = tracking.init_state(cfg, spec, x0, yaw0, first_goal=WAYPOINTS[0][:2])
    n_steps = int(tf / cfg.dt)
    run = jax.jit(
        lambda st: tracking.run(
            cfg, spec, st, wps, jnp.asarray(len(WAYPOINTS)), known, n_steps
        )
    )
    final, traj = run(st)
    return final, traj


def test_di_cbf_qp_scenario():
    """examples/test_tracking.py --model di --algo cbf_qp analog."""
    spec = make_spec(DOUBLE_INTEGRATOR_2D, v_max=1.0, a_max=1.5, radius=0.25)
    cfg = tracking.TrackerConfig(
        model_name=DOUBLE_INTEGRATOR_2D, pos_controller="cbf_qp", dt=0.05
    )
    x0 = jnp.array([2.0, 2.0, 0.0, 0.0])
    final, traj = _run_scenario(cfg, spec, x0, yaw0=np.pi / 2)
    rets = np.asarray(traj["ret"])
    assert final.ret == tracking.RET_DONE, f"final ret {final.ret}, modes seen"
    assert not np.any(rets == tracking.RET_INFEASIBLE)
    # Robot must have visited the vicinity of every waypoint.
    xs = np.asarray(traj["x"])[:, :2]
    for wp in WAYPOINTS[1:]:
        assert np.min(np.linalg.norm(xs - wp[:2], axis=1)) < 0.35


@pytest.mark.slow
def test_du_mpc_cbf_scenario():
    """examples/test_tracking.py --model du --algo mpc_cbf analog (N=8)."""
    spec = make_spec(DYNAMIC_UNICYCLE_2D, w_max=0.5, a_max=1.0, radius=0.25)
    cfg = tracking.TrackerConfig(
        model_name=DYNAMIC_UNICYCLE_2D,
        pos_controller="mpc_cbf",
        dt=0.05,
        mpc=mpc_cbf.MPCConfig(horizon=8, num_obs=5),
    )
    x0 = jnp.array([2.0, 2.0, np.pi / 2, 0.0])
    final, traj = _run_scenario(cfg, spec, x0, yaw0=np.pi / 2, tf=120.0)
    rets = np.asarray(traj["ret"])
    assert not np.any(rets == tracking.RET_INFEASIBLE)
    assert final.ret == tracking.RET_DONE
    xs = np.asarray(traj["x"])[:, :2]
    for wp in WAYPOINTS[1:]:
        assert np.min(np.linalg.norm(xs - wp[:2], axis=1)) < 0.35


def test_batched_fleet_vmap():
    """A small fleet: vmap over initial positions, one scan — the batched
    replacement for the reference's sequential multi-robot loop
    (examples/test_multi_robot.py:77-84)."""
    spec = make_spec(DOUBLE_INTEGRATOR_2D, v_max=1.0, a_max=1.5)
    cfg = tracking.TrackerConfig(
        model_name=DOUBLE_INTEGRATOR_2D, pos_controller="cbf_qp", dt=0.05
    )
    known = pad_obstacles(jnp.asarray(KNOWN_OBS[:6]), 8)
    wps = jnp.asarray(WAYPOINTS, dtype=jnp.float32)
    x0s = jnp.asarray(
        [[2.0, 2.0, 0.0, 0.0], [2.5, 2.0, 0.0, 0.0], [2.0, 2.5, 0.0, 0.0]]
    )

    def sim(x0):
        st = tracking.init_state(cfg, spec, x0, 0.0, first_goal=WAYPOINTS[0][:2])
        final, _ = tracking.run(
            cfg, spec, st, wps, jnp.asarray(4), known, n_steps=100
        )
        return final.x

    out = jax.jit(jax.vmap(sim))(x0s)
    assert out.shape == (3, 4)
    assert np.isfinite(np.asarray(out)).all()
    # Robots started apart must stay distinct (no cross-batch leakage).
    assert not np.allclose(np.asarray(out[0]), np.asarray(out[1]))


@pytest.mark.slow
def test_strict_mpc_feasibility_flags_doomed_state():
    """strict_mpc_feasibility=True turns genuine MPC infeasibility into
    RET_INFEASIBLE; the default reproduces the reference's hardcoded
    'optimal' (mpc_cbf.py:10) and keeps running.

    Doomed state: DynamicUnicycle2D at 1 m/s pointed at a wall of obstacles
    0.6 m ahead with a_max=0.05 — no control satisfies the dt-HOCBF rows.
    """
    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=0.05, w_max=0.2, v_max=2.0)
    obs = pad_obstacles(
        jnp.asarray(
            [[1.2, 0.0, 0.4, 0, 0, 0, 0], [1.2, 0.9, 0.4, 0, 0, 0, 0],
             [1.2, -0.9, 0.4, 0, 0, 0, 0]], jnp.float32,
        ),
        16,
    )
    wps = jnp.asarray([[8.0, 0.0]], jnp.float32)
    x0 = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)

    rets = {}
    for strict in (False, True):
        cfg = tracking.TrackerConfig(
            model_name=DYNAMIC_UNICYCLE_2D, pos_controller="mpc_cbf", dt=0.05,
            num_obs=8, strict_mpc_feasibility=strict,
            mpc=mpc_cbf.MPCConfig(horizon=8, num_obs=5),
        )
        st = tracking.init_state(cfg, spec, x0, 0.0, first_goal=wps[0])
        step = jax.jit(
            lambda s: tracking.step(cfg, spec, s, wps, jnp.asarray(1), obs)
        )
        seen = []
        for _ in range(6):
            out = step(st)
            st = out.state
            seen.append(int(out.ret))
        rets[strict] = seen
    # strict mode must flag the doomed state quickly...
    assert tracking.RET_INFEASIBLE in rets[True], rets
    first_strict = rets[True].index(tracking.RET_INFEASIBLE)
    # ...while reference mode at the same instant has not (it only fails on
    # actual collision, which takes longer than the solver's verdict)
    assert rets[False][first_strict] != tracking.RET_INFEASIBLE, rets

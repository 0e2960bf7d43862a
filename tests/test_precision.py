"""Every f32 matrix product of a solver lowers at HIGHEST precision.

On the GPU an f32 dot at default precision may run in TF32 (about three
decimal digits), which would move the optimum of the ill-conditioned Newton
systems (solvers/precision.py).  Each case lowers one solver entry point and
checks the precision of every ``dot_general`` in the StableHLO.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safe_control_tpu.core.spec import (
    DOUBLE_INTEGRATOR_2D,
    DRIFTING_CAR,
    DYNAMIC_UNICYCLE_2D,
    make_spec,
)
from safe_control_tpu.core.types import pad_obstacles
from safe_control_tpu.solvers import cbf_qp, chol, mpc_cbf, mpcc


def _mpc_cbf():
    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    cfg = mpc_cbf.MPCConfig(horizon=3, num_obs=2, outer_iters=1,
                            newton_iters=1)
    st = mpc_cbf.init_state(DYNAMIC_UNICYCLE_2D, cfg)
    obs = pad_obstacles(jnp.asarray([[1.0, 0.0, 0.3, 0, 0, 0, 0]]), 2)
    return (lambda x: mpc_cbf.solve(DYNAMIC_UNICYCLE_2D, spec, x,
                                    jnp.ones(4), obs, jnp.zeros(2), st, 0.05,
                                    cfg).u,
            (jnp.zeros(4, jnp.float32),))


def _mpcc():
    spec = make_spec(DRIFTING_CAR)
    sx = np.linspace(0.0, 20.0, 41)
    path = mpcc.make_path(sx, np.full_like(sx, 2.0))
    cfg = mpcc.MPCCConfig(horizon=3)
    st = mpcc.init_state(cfg)
    return (lambda x: mpcc.solve(spec, x, path, st, jnp.zeros(2), 0.05,
                                 cfg).u,
            (jnp.zeros(8, jnp.float32),))


def _cbf_qp():
    spec = make_spec(DOUBLE_INTEGRATOR_2D)
    obs = pad_obstacles(jnp.asarray([[1.0, 0.0, 0.3, 0, 0, 0, 0]]), 3)
    return (lambda x: cbf_qp.solve(DOUBLE_INTEGRATOR_2D, spec, x,
                                   jnp.ones(2), obs, 0.05, iters=16).u,
            (jnp.zeros(4, jnp.float32),))


def _blocked_chol():
    D = 120
    return chol._chol_solve_blocked, (jnp.eye(D, dtype=jnp.float32),
                                      jnp.ones(D, jnp.float32))


def _backup_cbf():
    from safe_control_tpu.shielding import backup_cbf

    spec = make_spec(DOUBLE_INTEGRATOR_2D, radius=0.5, a_max=2.0, v_max=1.5)
    cfg = backup_cbf.BackupCBFConfig(model_name=DOUBLE_INTEGRATOR_2D,
                                     backup_steps=4, qp_iters=16)
    policy = lambda x: -x[2:]
    return (lambda x: backup_cbf.solve(
        cfg, spec, x, jnp.zeros(2), policy,
        lambda xx, t: 1.0 - xx[0] ** 2, lambda xx: 1.0 - xx[1] ** 2).u,
        (jnp.zeros(4, jnp.float32),))


ENTRIES = [_mpc_cbf, _mpcc, _cbf_qp, _blocked_chol, _backup_cbf]


def _dots_not_at(entry, level):
    """(dots of the entry's lowering not at ``level``, all dots)."""
    fn, args = entry()
    text = jax.jit(fn).lower(*args).as_text()
    dots = [ln for ln in text.splitlines() if "stablehlo.dot_general" in ln]
    assert dots, "expected matrix products in the lowering"
    return [ln for ln in dots if f"precision = [{level}, {level}]" not in ln], dots


@pytest.fixture
def global_precision():
    """Set JAX's global matmul precision, as JAX_DEFAULT_MATMUL_PRECISION
    does, and restore it afterwards."""
    old = jax.config.jax_default_matmul_precision
    yield lambda level: jax.config.update("jax_default_matmul_precision",
                                          level)
    jax.config.update("jax_default_matmul_precision", old)


@pytest.mark.parametrize("process_level", [None, "tensorfloat32", "bfloat16"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_solver_dots_lower_at_highest(entry, process_level, global_precision):
    """Whatever precision the process sets (none, or a lower one through
    the environment or ``jax.config``), every solver product is HIGHEST."""
    global_precision(process_level)
    loose, dots = _dots_not_at(entry, "HIGHEST")
    assert not loose, f"{len(loose)} of {len(dots)} dots below HIGHEST: {loose[0]}"


def test_measurement_override_lowers_at_default(monkeypatch):
    """bench_precision.py measures the cost of HIGHEST by rebinding the
    precision the solvers trace at; the rebinding reaches every dot."""
    from safe_control_tpu.solvers import precision

    monkeypatch.setattr(precision, "_PRECISION", "default")
    loose, dots = _dots_not_at(_mpc_cbf, "DEFAULT")
    assert not loose, f"{len(loose)} of {len(dots)} dots not at DEFAULT"

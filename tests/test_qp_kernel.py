"""Pallas QP kernel: parity with the XLA ADMM path (interpreter mode on CPU).

The kernel implements the exact same math as solvers/qp.py (equilibration,
staged adaptive-rho ADMM, active-set polish), so on well-posed problems the
two must agree to solver tolerance, and both must agree with the analytic
solution on problems small enough to solve by hand.  The comparison
compiled for the card, at full width, is chip_smoke.py's phase (d) and the
``gpu`` test below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safe_control_tpu.solvers.qp import solve_qp
from safe_control_tpu.solvers import qp_kernel
from safe_control_tpu.solvers.qp_kernel import solve_qp_batch_pallas


def _random_qps(seed, B, n, m, one_sided=3):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    P = M @ M.transpose(0, 2, 1) + np.eye(n)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    c = rng.normal(size=(B, m))
    l = c - rng.uniform(0.1, 2.0, size=(B, m))
    u = c + rng.uniform(0.1, 2.0, size=(B, m))
    u[:, :one_sided] = np.inf  # CBF-style one-sided rows
    to = lambda x: jnp.asarray(x, dtype=jnp.float32)
    return to(P), to(q), to(A), to(l), to(u)


@pytest.mark.slow
def test_matches_xla_path():
    P, q, A, l, u = _random_qps(0, 8, 3, 10)
    ref = jax.vmap(lambda *a: solve_qp(*a, iters=300))(P, q, A, l, u)
    got = solve_qp_batch_pallas(P, q, A, l, u, iters=300, interpret=True)
    # Compare only problems both paths solved (random QPs can be infeasible).
    ok = np.asarray(ref.prim_res < 1e-4) & np.asarray(got.prim_res < 1e-4)
    assert ok.sum() >= 4
    dx = np.max(np.abs(np.asarray(ref.x - got.x)[ok]))
    assert dx < 1e-3, dx


def test_analytic_projection():
    # min ||x - t||^2 s.t. x in [-1, 1]^2  => clamp(t).
    B = 4
    t = jnp.asarray([[2.0, 0.3], [-3.0, 0.0], [0.5, -0.2], [9.0, -9.0]])
    P = jnp.tile(2.0 * jnp.eye(2)[None], (B, 1, 1))
    q = -2.0 * t
    A = jnp.tile(jnp.eye(2)[None], (B, 1, 1))
    l = -jnp.ones((B, 2))
    u = jnp.ones((B, 2))
    sol = solve_qp_batch_pallas(P, q, A, l, u, iters=200, interpret=True)
    np.testing.assert_allclose(
        np.asarray(sol.x), np.clip(np.asarray(t), -1, 1), atol=1e-5
    )


def test_active_inequality_kkt():
    # min ||u||^2 s.t. a'u >= b with b > 0: solution u = a b / ||a||^2.
    a = jnp.asarray([[1.0, 2.0]])
    b = 3.0
    P = 2.0 * jnp.eye(2)[None]
    q = jnp.zeros((1, 2))
    A = a[:, None, :]
    l = jnp.full((1, 1), b)
    u = jnp.full((1, 1), jnp.inf)
    sol = solve_qp_batch_pallas(P, q, A, l, u, iters=300, interpret=True)
    expect = np.asarray(a[0]) * b / float(a[0] @ a[0])
    np.testing.assert_allclose(np.asarray(sol.x[0]), expect, atol=1e-5)
    assert float(sol.prim_res[0]) < 1e-5


@pytest.mark.slow
def test_non_tile_multiple_batch():
    # Batch not a multiple of the tile exercises the padding path.
    P, q, A, l, u = _random_qps(1, 5, 2, 6, one_sided=1)
    ref = jax.vmap(lambda *a: solve_qp(*a, iters=300))(P, q, A, l, u)
    got = solve_qp_batch_pallas(P, q, A, l, u, iters=300, interpret=True)
    ok = np.asarray(ref.prim_res < 1e-4) & np.asarray(got.prim_res < 1e-4)
    dx = np.max(np.abs(np.asarray(ref.x - got.x)[ok]))
    assert dx < 1e-3


@pytest.mark.slow
def test_manipulator_scale_row_count():
    # The Manipulator2D CBF-QP reaches ~150 rows (reference tracking.py:
    # 134-138): one problem's data no longer fits a thread's registers, and
    # the kernel must still match the XLA path at m=153.
    # Feasible-by-construction: bounds bracket A @ x_star (153 random rows in
    # R^3 would otherwise be jointly infeasible almost surely).
    rng = np.random.default_rng(7)
    B, n, m = 4, 3, 153  # 4 problems: interpret cost is linear in B
    M = rng.normal(size=(B, n, n))
    P = M @ M.transpose(0, 2, 1) + np.eye(n)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    x_star = rng.normal(size=(B, n))
    Ax = np.einsum("bmn,bn->bm", A, x_star)
    l = Ax - rng.uniform(0.05, 1.5, size=(B, m))
    u = Ax + rng.uniform(0.05, 1.5, size=(B, m))
    u[:, :100] = np.inf  # CBF-style one-sided rows
    to = lambda z: jnp.asarray(z, dtype=jnp.float32)
    P, q, A, l, u = to(P), to(q), to(A), to(l), to(u)
    ref = jax.vmap(lambda *a: solve_qp(*a, iters=300))(P, q, A, l, u)
    got = solve_qp_batch_pallas(P, q, A, l, u, iters=300, interpret=True)
    ok = np.asarray(ref.prim_res < 1e-4) & np.asarray(got.prim_res < 1e-4)
    assert ok.sum() >= 2
    dx = np.max(np.abs(np.asarray(ref.x - got.x)[ok]))
    assert dx < 2e-3, dx


@pytest.mark.slow
def test_manipulator_cbf_qp_pallas_backend():
    # End-to-end: the real Manipulator2D link-circle CBF-QP (n=3 joint
    # velocities, 5 obstacles x link-circle rows) through the Pallas backend.
    from safe_control_tpu.core.spec import MANIPULATOR_2D, make_spec
    from safe_control_tpu.core.types import pad_obstacles
    from safe_control_tpu.solvers import cbf_qp

    spec = make_spec(MANIPULATOR_2D)
    rng = np.random.default_rng(3)
    B = 4
    xs = jnp.asarray(rng.uniform(-1.0, 1.0, (B, 3)), dtype=jnp.float32)
    u_refs = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 3)), dtype=jnp.float32)
    obs_one = pad_obstacles(
        jnp.asarray(
            [[1.5, 1.5, 0.3, 0, 0, 0, 0], [-1.0, 2.0, 0.4, 0, 0, 0, 0]],
            dtype=jnp.float32,
        ),
        5,
    )
    obs = jnp.tile(obs_one[None], (B, 1, 1))
    # 800 ADMM iterations (default 1600): both backends run the same
    # count, and these well-conditioned 3-var problems converge far
    # earlier — the interpret-mode iteration replay is the suite cost.
    r_x = cbf_qp.solve_batch(
        MANIPULATOR_2D, spec, xs, u_refs, obs, 0.05, backend="xla", iters=600
    )
    r_p = cbf_qp.solve_batch(
        MANIPULATOR_2D, spec, xs, u_refs, obs, 0.05, backend="pallas",
        interpret=True, iters=600
    )
    np.testing.assert_allclose(np.asarray(r_x.u), np.asarray(r_p.u), atol=2e-3)


def test_cbf_qp_pallas_backend_matches_xla():
    from safe_control_tpu.core.spec import DYNAMIC_UNICYCLE_2D, make_spec
    from safe_control_tpu.core.types import pad_obstacles
    from safe_control_tpu.solvers import cbf_qp

    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    rng = np.random.default_rng(2)
    B = 6
    xs = jnp.asarray(
        np.concatenate(
            [
                rng.uniform(0, 3, (B, 2)),
                rng.uniform(-1, 1, (B, 1)),
                rng.uniform(0.1, 0.6, (B, 1)),
            ],
            axis=1,
        ),
        dtype=jnp.float32,
    )
    u_refs = jnp.asarray(rng.uniform(-0.3, 0.3, (B, 2)), dtype=jnp.float32)
    obs_one = pad_obstacles(
        jnp.asarray([[2.0, 2.0, 0.5, 0, 0, 0, 0]], dtype=jnp.float32), 5
    )
    obs = jnp.tile(obs_one[None], (B, 1, 1))
    r_x = cbf_qp.solve_batch(
        DYNAMIC_UNICYCLE_2D, spec, xs, u_refs, obs, 0.05, backend="xla"
    )
    r_p = cbf_qp.solve_batch(
        DYNAMIC_UNICYCLE_2D, spec, xs, u_refs, obs, 0.05, backend="pallas",
        interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(r_x.u), np.asarray(r_p.u), atol=2e-3
    )
    np.testing.assert_array_equal(
        np.asarray(r_x.feasible), np.asarray(r_p.feasible)
    )


def test_launch_shape_and_padding():
    """One problem per thread: a program is one warp of 32 problems (the
    launch measured on the card); the batch pads to a multiple of the
    (power-of-two) tile with zero problems."""
    assert qp_kernel.TILE == 32 * qp_kernel.NUM_WARPS
    assert qp_kernel.TILE & (qp_kernel.TILE - 1) == 0  # Triton: powers of two
    for b in (1, 31, 32, 33, 4096):
        packed = qp_kernel.lane_major([jnp.ones((b, 3))], qp_kernel.TILE)
        assert packed.shape == (3, -(-b // qp_kernel.TILE) * qp_kernel.TILE)
    x = jnp.arange(10.0).reshape(5, 2)
    y = jnp.ones((5, 3, 1))
    packed = qp_kernel.lane_major([x, y], 32)
    assert packed.shape == (5, 32)
    np.testing.assert_array_equal(np.asarray(packed[:2, :5]), np.asarray(x.T))
    assert float(jnp.abs(packed[:, 5:]).sum()) == 0.0


def test_pallas_backend_raises_off_gpu():
    """Asking for the kernel off the GPU raises and names the backend; the
    automatic choice never picks it there."""
    from safe_control_tpu.core.spec import DYNAMIC_UNICYCLE_2D, make_spec
    from safe_control_tpu.core.types import pad_obstacles
    from safe_control_tpu.solvers import cbf_qp

    P, q, A, l, u = _random_qps(0, 4, 2, 5)
    with pytest.raises(RuntimeError, match="'cpu'"):
        solve_qp_batch_pallas(P, q, A, l, u, iters=16)
    spec = make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.5)
    xs = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0, 0.3]], jnp.float32), (4, 1))
    obs = jnp.tile(pad_obstacles(jnp.asarray(
        [[2.0, 0.0, 0.5, 0, 0, 0, 0]], jnp.float32), 5)[None], (4, 1, 1))
    with pytest.raises(RuntimeError, match="'cpu'"):
        cbf_qp.solve_batch(DYNAMIC_UNICYCLE_2D, spec, xs, jnp.zeros((4, 2)),
                           obs, 0.05, backend="pallas")
    assert cbf_qp.pick_backend(4096, 7) == "xla"


def test_auto_backend_rule(monkeypatch):
    """On the GPU, ``auto`` takes the kernel only inside the measured
    region: batches that fill the SMs and rows that fit in registers."""
    from safe_control_tpu.solvers import cbf_qp

    monkeypatch.setattr(cbf_qp.jax, "default_backend", lambda: "gpu")
    assert cbf_qp.pick_backend(4096, 7) == "pallas"
    assert cbf_qp.pick_backend(cbf_qp.KERNEL_MIN_BATCH - 1, 7) == "xla"
    assert cbf_qp.pick_backend(4096, cbf_qp.KERNEL_MAX_ROWS + 1) == "xla"


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu_device):
    """The kernel compiled for the card against the XLA path, on QPs that
    are feasible by construction (bounds bracket A x*)."""
    rng = np.random.default_rng(5)
    B, n, m = 512, 4, 13
    M = rng.normal(size=(B, n, n))
    P = jnp.asarray(M @ M.transpose(0, 2, 1) + np.eye(n), jnp.float32)
    q = jnp.asarray(rng.normal(size=(B, n)), jnp.float32)
    A_np = rng.normal(size=(B, m, n))
    Ax = np.einsum("bmn,bn->bm", A_np, rng.normal(size=(B, n)))
    l = jnp.asarray(Ax - rng.uniform(0.05, 1.5, size=(B, m)), jnp.float32)
    u_np = Ax + rng.uniform(0.05, 1.5, size=(B, m))
    u_np[:, :8] = np.inf  # CBF-style one-sided rows
    A, u = jnp.asarray(A_np, jnp.float32), jnp.asarray(u_np, jnp.float32)
    ref = jax.vmap(lambda *a: solve_qp(*a, iters=1600))(P, q, A, l, u)
    got = solve_qp_batch_pallas(P, q, A, l, u, iters=1600)
    ok = np.asarray(ref.prim_res < 1e-4) & np.asarray(got.prim_res < 1e-4)
    assert ok.sum() >= 128
    assert np.max(np.abs(np.asarray(ref.x - got.x)[ok])) < 1e-3

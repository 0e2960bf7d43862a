"""Matrix-product precision of the solvers.

On the GPU an f32 ``dot_general`` at default precision may run in TF32,
which keeps about three decimal digits.  The solvers' Newton systems have
condition numbers near 1e4, and their line searches compare merit
differences at 4 eps_f32, so TF32 products would move the optimum rather
than add noise.  Every solver entry point therefore traces its body with
f32 products at ``HIGHEST``, whatever matmul precision the caller or the
environment (``JAX_DEFAULT_MATMUL_PRECISION``) has set;
tests/test_precision.py checks the lowering.
"""

from __future__ import annotations

import functools

import jax

# Read at trace time.  Only bench_precision.py rebinds it (under
# ``unittest.mock.patch``), to measure what HIGHEST costs.
_PRECISION = "highest"


def highest(fn):
    """Decorate a solver entry point: its matrix products run at HIGHEST."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(_PRECISION):
            return fn(*args, **kwargs)

    return wrapped

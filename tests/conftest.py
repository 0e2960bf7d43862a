"""Test configuration: force an 8-device virtual CPU mesh.

Multi-device sharding logic is tested on a virtual CPU mesh
(``xla_force_host_platform_device_count``) so distributed code paths run
without several GPUs.  The platform is switched in-process via
``jax.config`` before any backend is initialized (backend init is lazy), so
the suite runs on the CPU even where JAX_PLATFORMS is unset.  Tests that
need the GPU are marked ``gpu`` and skip here (see ``gpu_device``).
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
# CPU unless the run names another platform (``JAX_PLATFORMS=cuda`` runs
# the ``gpu`` tests on the card).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """The first GPU; the test skips where JAX has none (decided here, per
    test, so every xdist worker collects the same tests)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda python -m pytest "
                    "tests -m gpu -n 0` on the card")

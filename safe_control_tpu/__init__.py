"""safe_control_tpu — a batched safety-filter + MPC framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
tkkim-robot/safe_control: robot dynamics models, control barrier functions
(CBF-QP, MPC-CBF, optimal-decay variants), shielding (gatekeeper/MPS/
backup-CBF), perception, environments and tracking orchestration — all as
pure functions that ``vmap``/``shard_map`` across thousands of robots and
several GPUs.
"""

import os as _os

# Fixed default location of the persistent compile cache: the checkout
# root.  A cache's entries are keyed by the path, so it must not move.
_DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _enable_persistent_compile_cache() -> None:
    """Place JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    leaves the cache alone.  Otherwise the cache goes to ``.jax_cache/`` at
    the checkout root.  CPU-forced runs (tests, dev shells) skip the cache:
    XLA:CPU entries are pinned to the machine's CPU features, and CPU
    compiles are fast anyway.  Only compiles slower than 2 s are kept.
    """
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if "cpu" in _os.environ.get("JAX_PLATFORMS", "").lower():
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


_enable_persistent_compile_cache()

from safe_control_tpu.core.spec import RobotSpec, make_spec  # noqa: E402,F401
from safe_control_tpu.core.types import pad_obstacles  # noqa: E402,F401

__version__ = "0.1.0"

"""Where the package puts JAX's persistent compilation cache.

Each case imports the package in a fresh interpreter, as a user would, with
the platform left to JAX (the cache is skipped only for CPU-forced runs).
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = (
    "import jax, safe_control_tpu; "
    "print(jax.config.jax_compilation_cache_dir)"
)


def _cache_dir_after_import(env_cache_dir):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    if env_cache_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_cache_dir
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env, check=True,
        capture_output=True, text=True, timeout=120,
    )
    return out.stdout.strip().splitlines()[-1]


def test_cache_dir_from_environment_is_left_alone(tmp_path):
    target = str(tmp_path / "elsewhere")
    assert _cache_dir_after_import(target) == target


def test_cache_dir_defaults_to_checkout_root():
    assert _cache_dir_after_import(None) == os.path.join(ROOT, ".jax_cache")

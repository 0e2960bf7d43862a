"""What HIGHEST matrix-product precision costs the flagship step on the GPU.

    python bench_precision.py [--batch 4096] [--rounds 10]

Compiles the batched DynamicUnicycle2D MPC-CBF control step
(``__graft_entry__._build_step``, N=8, 5 obstacle slots) twice: with the
solvers' products at HIGHEST, as they always run, and at DEFAULT (TF32
allowed on the GPU), by rebinding ``solvers/precision._PRECISION`` while
that variant is traced.  Both run on the same inputs, timed in turns
(h, d, d, h).  Prints one JSON line: the median step time of each, and how
far DEFAULT moves the first controls from HIGHEST.
"""

from __future__ import annotations

import argparse
import json
import time
from unittest import mock

import jax
import numpy as np

from safe_control_tpu.solvers import precision

LEVELS = ("highest", "default")


def compile_step(level, batch):
    """The flagship step traced with solver products at ``level``, and the
    precision of each of its dots at HIGHEST (True) or not."""
    from __graft_entry__ import _build_step

    jax.clear_caches()  # the level is not part of JAX's trace cache key
    with mock.patch.object(precision, "_PRECISION", level):
        step, args = _build_step(batch=batch)
        lowered = jax.jit(step).lower(*args)
    at_highest = ["precision = [HIGHEST, HIGHEST]" in ln
                  for ln in lowered.as_text().splitlines()
                  if "stablehlo.dot_general" in ln]
    return lowered.compile(), args, at_highest


def measure(batch=4096, rounds=10):
    compiled, dots, times = {}, {}, {lv: [] for lv in LEVELS}
    for lv in LEVELS:
        compiled[lv], args, dots[lv] = compile_step(lv, batch)
    h, d = LEVELS
    # The solvers' dots move between the variants; the plant integration
    # around them (g(x) u) is the same in both.
    assert any(dots[h]) and not any(dots[d]) and len(dots[h]) == len(dots[d])
    u = {lv: np.asarray(jax.block_until_ready(compiled[lv](*args))[1])
         for lv in LEVELS}
    for _ in range(rounds):
        for lv in (h, d, d, h):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled[lv](*args))
            times[lv].append(time.perf_counter() - t0)
    dev = np.abs(u[h] - u[d]).max(axis=1)
    return {
        "batch": batch,
        "solver_dots": sum(dots[h]),
        "other_dots": len(dots[h]) - sum(dots[h]),
        **{f"{lv}_step_ms": float(np.median(times[lv])) * 1e3 for lv in LEVELS},
        "first_control_dev_max": float(dev.max()),
        "first_control_dev_median": float(np.median(dev)),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--rounds", type=int, default=10)
    args = parser.parse_args(argv)
    from bench import device_info

    device = device_info()
    print(json.dumps({"device": device,
                      **measure(args.batch, args.rounds)}), flush=True)


if __name__ == "__main__":
    main()

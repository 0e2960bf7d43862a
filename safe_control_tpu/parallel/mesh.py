"""Multi-device scale-out: scenario-sharded batches over a device mesh.

The reference has no parallelism of any kind (SURVEY.md §2.5): multi-robot
means sequential ``control_step()`` calls in one Python loop
(examples/test_multi_robot.py:77-84) and Monte-Carlo means re-running the
script.  The scale-out story here:

- **batch axis** = robots / scenarios, ``vmap``-ed on each device;
- **mesh axis** ``'scenario'`` = devices, 1-D over ``jax.devices()``
  (NVLink joins a host's GPUs all to all, so the mesh follows the
  algorithm alone), sharded with ``NamedSharding``/``jax.shard_map``;
- cross-scenario reductions (Monte-Carlo statistics, fleet-level minima)
  ride ``psum``, which XLA hands to NCCL.

No TP/PP/EP/ring-attention analog exists for this workload — the per-robot
state is a handful of scalars, there are no large weight matrices and no
attention; stating that explicitly is part of the design (SURVEY.md §2.5).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SCENARIO_AXIS = "scenario"


def scenario_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D device mesh over the scenario/batch axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (SCENARIO_AXIS,))


def shard_leading_axis(mesh: Mesh, tree):
    """Place every leaf of ``tree`` with its leading axis split across the
    scenario mesh axis (robots are independent => pure data sharding)."""
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS))
    return jax.device_put(tree, sharding)


def replicate(mesh: Mesh, tree):
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def sharded_batch_apply(mesh: Mesh, fn, reduce_stats=None):
    """Wrap a per-batch function for shard_map execution over the mesh.

    ``fn`` maps a local batch pytree -> (local outputs, local stats);
    ``reduce_stats`` (optional) maps stats -> stats via ``psum``-style
    collectives, e.g. Monte-Carlo success counts summed over the mesh.
    """

    def wrapped(batch):
        out, stats = fn(batch)
        if reduce_stats is not None:
            stats = reduce_stats(stats)
        return out, stats

    return jax.shard_map(
        wrapped,
        mesh=mesh,
        in_specs=(P(SCENARIO_AXIS),),
        out_specs=(P(SCENARIO_AXIS), P()),
        check_vma=False,
    )


def psum_scenario(x):
    return jax.lax.psum(x, SCENARIO_AXIS)

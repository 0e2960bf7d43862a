"""Heterogeneous fleet at scale (BASELINE anchor config 5).

Usage: python examples/heterogeneous_fleet.py --n 4096 --steps 200

Three model families (DoubleIntegrator2D, DynamicUnicycle2D,
KinematicBicycle2D_DPCBF) in corridor traffic with inter-robot coupling,
all inside one jit.  On the GPU this is the 4k-agent anchor; on CPU use a
smaller --n.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--chunk", type=int, default=10)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from safe_control_tpu.core.spec import (
        DOUBLE_INTEGRATOR_2D,
        DYNAMIC_UNICYCLE_2D,
        KINEMATIC_BICYCLE_2D_DPCBF,
        make_spec,
    )
    from safe_control_tpu.core.types import pad_obstacles
    from safe_control_tpu.parallel import fleet as fleet_mod
    from safe_control_tpu.sim import tracking

    per = args.n // 3
    rng = np.random.default_rng(0)

    def cfg(name):
        return tracking.TrackerConfig(
            model_name=name, pos_controller="cbf_qp", dt=0.05, num_obs=8,
            qp_iters=400,
        )

    groups = [
        fleet_mod.FleetGroup(cfg(DOUBLE_INTEGRATOR_2D), per, 0.25),
        fleet_mod.FleetGroup(cfg(DYNAMIC_UNICYCLE_2D), per, 0.25),
        fleet_mod.FleetGroup(cfg(KINEMATIC_BICYCLE_2D_DPCBF), per, 0.3),
    ]
    specs = [
        make_spec(DOUBLE_INTEGRATOR_2D, v_max=0.7, a_max=1.5, radius=0.25),
        make_spec(DYNAMIC_UNICYCLE_2D, a_max=1.0, w_max=0.8, v_max=0.7, radius=0.25),
        make_spec(KINEMATIC_BICYCLE_2D_DPCBF, a_max=5.0, v_max=1.0, radius=0.3),
    ]

    # Wide corridor lattice: robots spaced on a grid, each advancing +x.
    def lattice(n, y0):
        cols = int(np.ceil(np.sqrt(n)))
        x = np.zeros((n, 4), dtype=np.float32)
        idx = np.arange(n)
        x[:, 0] = 3.0 * (idx % cols) + rng.uniform(-0.2, 0.2, n)
        x[:, 1] = y0 + 3.0 * (idx // cols) + rng.uniform(-0.2, 0.2, n)
        x[:, 3] = 0.3
        return jnp.asarray(x)

    # each family in its own band; in-band coupling still active.
    # Multi-waypoint serpentine routes (sustained traffic, not a 5 m hop):
    # each robot weaves +-3 m laterally while advancing 8 m per leg, so
    # neighboring rows cross paths repeatedly and the CBF coupling stays
    # active for the whole run.
    x0s = [lattice(per, 0.0), lattice(per, 200.0), lattice(per, 400.0)]
    wps = []
    for x0 in x0s:
        g0 = np.asarray(x0)[:, :2]
        legs = []
        for i, (dx, dy) in enumerate([(8.0, 3.0), (16.0, -3.0), (24.0, 3.0), (32.0, 0.0)]):
            leg = g0.copy()
            leg[:, 0] += dx
            leg[:, 1] += dy
            legs.append(leg)
        wps.append(jnp.asarray(np.stack(legs, axis=1), dtype=jnp.float32))
    n_wps = [jnp.asarray(4)] * 3
    known = pad_obstacles(jnp.zeros((0, 7)), 4)

    state = fleet_mod.init_fleet(groups, specs, x0s, [w[:, 0] for w in wps])
    step = jax.jit(
        lambda s: fleet_mod.step_fleet(
            groups, specs, s, wps, n_wps, known, inter_robot=True,
            n_steps=args.chunk, coupling_margin=0.3,
        )
    )
    state = step(state)  # compile
    jax.block_until_ready(state.trackers[0].x)
    t0 = time.perf_counter()
    iters = max(args.steps // args.chunk, 1)
    for _ in range(iters):
        state = step(state)
    jax.block_until_ready(state.trackers[0].x)
    wall = time.perf_counter() - t0
    total_steps = args.n * iters * args.chunk
    stats = fleet_mod.fleet_stats(groups, state)
    # mean route progress: waypoint index per robot (4 = route done)
    prog = [float(np.mean(np.asarray(t.goal_idx))) for t in state.trackers]
    print(f"{args.n} agents x {iters * args.chunk} steps: {wall:.2f}s "
          f"({total_steps / wall:,.0f} agent-steps/s)")
    print(f"mean waypoint progress per family (of 4): "
          f"{[round(p, 2) for p in prog]}")
    print(stats)


if __name__ == "__main__":
    main()

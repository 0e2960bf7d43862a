"""Monte-Carlo DPCBF sweep across all local devices (BASELINE anchor 4).

Usage: python examples/monte_carlo_sweep.py --batch 1024 --steps 400

Runs the randomized dynamic-obstacle KinematicBicycle2D_DPCBF sweep sharded
over the scenario mesh with psum-reduced statistics, checkpointing every
chunk.  On the 8-device CPU mesh use:
  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/monte_carlo_sweep.py
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--chunk", type=int, default=100)
    parser.add_argument("--ckpt", type=str, default="")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from safe_control_tpu.core.spec import KINEMATIC_BICYCLE_2D_DPCBF, make_spec
    from safe_control_tpu.parallel import monte_carlo as mc
    from safe_control_tpu.parallel.mesh import scenario_mesh
    from safe_control_tpu.sim import tracking
    from safe_control_tpu.utils import checkpoint as ckpt

    spec = make_spec(KINEMATIC_BICYCLE_2D_DPCBF, a_max=5.0, radius=0.3)
    cfg = tracking.TrackerConfig(
        model_name=KINEMATIC_BICYCLE_2D_DPCBF, pos_controller="cbf_qp",
        dt=0.05, num_obs=8, qp_iters=400,
    )
    wps = jnp.asarray([[1.0, 7.5], [20.0, 7.5]], dtype=jnp.float32)
    mesh = scenario_mesh()
    print(f"devices: {mesh.devices.size} ({jax.devices()[0].platform})")

    state = mc.dpcbf_sweep_init(
        cfg, spec, jax.random.PRNGKey(0), args.batch, wps
    )
    t0 = time.perf_counter()
    state, res = mc.run_sharded_sweep(
        mesh, cfg, spec, state, wps, jnp.asarray(2), args.steps, chunk=args.chunk
    )
    dt_wall = time.perf_counter() - t0
    if args.ckpt:
        ckpt.save(args.ckpt, state, step=int(state.steps_done))
        print(f"checkpointed to {args.ckpt}")

    steps_total = args.batch * args.steps
    print(
        f"{args.batch} scenarios x {args.steps} steps in {dt_wall:.1f}s "
        f"({steps_total / dt_wall:,.0f} robot-steps/s)"
    )
    print(
        f"success {float(res.success_rate):.3f}  "
        f"collision {float(res.collision_rate):.3f}"
    )


if __name__ == "__main__":
    main()

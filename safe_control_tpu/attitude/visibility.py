"""Visibility-promoting yaw controllers over the occupancy-grid footprint.

JAX re-implementations of the reference's shapely-based exploration
yaw controllers, operating on the fixed-shape occupancy footprint
(perception/grid.py) instead of a GEOS polygon union:

- ``visibility_area_yaw``: samples 36 candidate yaws, scores the UNEXPLORED
  area inside each candidate FoV sector (attitude_control/visibility_area.py:
  106-167, ``sector.difference(footprints).area``), P-controls to the argmax.
- ``visibility_raycast_yaw``: casts 36 rays, scores each direction by
  boundary-distance + potential-new-FoV-area + ray-escape with the 0.3/0.5/
  0.2 weights and the 0.3 angular-distance penalty
  (attitude_control/visibility_raycast.py:46-296).

Both are branch-free: candidate scores come from one vmapped mask reduction,
so the whole controller is a handful of fused kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from safe_control_tpu.core.types import angle_normalize
from safe_control_tpu.perception import grid as grid_mod


def _candidate_yaws(n: int, dtype=jnp.float32):
    return jnp.linspace(-jnp.pi, jnp.pi, n, endpoint=False, dtype=dtype)


def visibility_area_yaw(
    footprint, gs: grid_mod.GridSpec, pos, current_yaw, spec,
    kp: float = 1.5, n_yaw_samples: int = 36,
):
    """Yaw rate maximizing newly observable area (visibility_area.py:106-167)."""
    yaws = _candidate_yaws(n_yaw_samples)

    def score(yaw):
        sector = grid_mod.fov_mask(gs, pos, yaw, spec)
        return jnp.sum(sector & ~footprint)

    scores = jax.vmap(score)(yaws)
    target = yaws[jnp.argmax(scores)]
    err = angle_normalize(target - current_yaw)
    w = jnp.clip(kp * err, -spec.w_max, spec.w_max)
    # Empty map: rotate at max rate (visibility_area.py:129-131).
    return jnp.where(jnp.any(footprint), w, spec.w_max)


def visibility_raycast_yaw(
    footprint, gs: grid_mod.GridSpec, pos, current_yaw, spec,
    kp: float = 1.5, num_rays: int = 36, max_ray_length: float = 10.0,
    n_ray_samples: int = 32,
):
    """Ray-cast exploration yaw (visibility_raycast.py:46-296).

    Per ray: boundary distance = arc length to the first unexplored cell;
    potential area = unexplored fraction of the candidate FoV sector;
    ray score = 1.0 if fully outside the map, 0.8 if extending well beyond,
    0.2 otherwise.  Combined 0.3/0.5/0.2, then the 0.3 angular penalty.
    """
    yaws = _candidate_yaws(num_rays)
    ts = jnp.linspace(0.05, 1.0, n_ray_samples)

    def in_footprint(p):
        ix = jnp.clip((p[0] / gs.resolution).astype(jnp.int32), 0, gs.nx - 1)
        iy = jnp.clip((p[1] / gs.resolution).astype(jnp.int32), 0, gs.ny - 1)
        return footprint[ix, iy]

    def ray_metrics(yaw):
        d = jnp.array([jnp.cos(yaw), jnp.sin(yaw)])
        pts = pos[None, :] + (ts * max_ray_length)[:, None] * d[None, :]
        inside = jax.vmap(in_footprint)(pts)
        # boundary distance: first sample outside the footprint
        any_out = jnp.any(~inside)
        first_out = jnp.argmax(~inside)
        boundary_dist = jnp.where(any_out, ts[first_out] * max_ray_length, max_ray_length)
        # ray intersection score (:203-221): fraction of ray inside the map
        frac_in = jnp.mean(inside.astype(jnp.float32))
        ray_score = jnp.where(
            frac_in <= 0.0, 1.0, jnp.where(frac_in < 0.8, 0.8, 0.2)
        )
        # potential FoV area (:155-200)
        sector = grid_mod.fov_mask(gs, pos, yaw, spec)
        sector_n = jnp.maximum(jnp.sum(sector), 1)
        potential = jnp.sum(sector & ~footprint) / sector_n
        return 0.3 / (boundary_dist + 0.1) + 0.5 * potential + 0.2 * ray_score

    scores = jax.vmap(ray_metrics)(yaws)
    penalty = jnp.abs(angle_normalize(yaws - current_yaw)) / jnp.pi
    combined = scores * (1.0 - 0.3 * penalty)
    target = yaws[jnp.argmax(combined)]
    err = angle_normalize(target - current_yaw)
    w = jnp.clip(kp * err, -spec.w_max, spec.w_max)
    return jnp.where(jnp.any(footprint), w, spec.w_max)

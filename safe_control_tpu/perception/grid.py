"""Occupancy-grid sensing footprint and braking-distance safety area.

JAX replacement of the reference's shapely polygon machinery
(robots/robot.py:646-753, utils/geometry.py custom_merge): the unboundedly
growing polygon union of FoV triangles becomes a fixed-shape boolean
occupancy grid that is OR-updated in place each step — an O(cells)
``jnp.where`` instead of a GEOS union whose cost grows with history.

Behavioral deltas (documented per SURVEY.md §7 hard part 4): coverage is
tested at grid resolution (default 0.1 m, matching utils/env.py:4), so
boundary-grazing cases within one cell of the polygon edge may differ from
shapely's exact ``covers``.

- ``fov_mask``: cells inside the current FoV triangle (sector approximated
  by the triangle robot/fov_left/fov_right like robot.py:646-649)
- ``update_footprint``: OR-in the current FoV mask
- ``safety_area_mask``: velocity-aligned braking tube for integrators
  (robot.py:681-701), decelerating-arc rollout for yaw-rate models
  (:704-741)
- ``is_beyond_footprint``: 'point_mass' or 'safety_area' coverage test
  (:743-753)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from safe_control_tpu.core.types import angle_normalize


@dataclasses.dataclass(frozen=True)
class GridSpec:
    width: float
    height: float
    resolution: float = 0.1

    @property
    def nx(self) -> int:
        return int(round(self.width / self.resolution))

    @property
    def ny(self) -> int:
        return int(round(self.height / self.resolution))


def cell_centers(gs: GridSpec):
    xs = (jnp.arange(gs.nx) + 0.5) * gs.resolution
    ys = (jnp.arange(gs.ny) + 0.5) * gs.resolution
    return jnp.meshgrid(xs, ys, indexing="ij")  # (nx, ny) each


def empty_footprint(gs: GridSpec):
    return jnp.zeros((gs.nx, gs.ny), dtype=bool)


def init_footprint(gs: GridSpec, pos, spec, exploration: bool = False):
    """Initial footprint: a disk of 2x robot radius around the start pose
    (robot.py:341-351); exploration mode buffers by a further 10x radius."""
    r = 2.0 * spec.radius + (10.0 * spec.radius if exploration else 0.0)
    return disk_mask(gs, pos, r)


def disk_mask(gs: GridSpec, center, radius):
    cx, cy = cell_centers(gs)
    return (cx - center[0]) ** 2 + (cy - center[1]) ** 2 <= radius**2


def fov_mask(gs: GridSpec, pos, yaw, spec):
    """Cells inside the FoV triangle (robot, fov_left, fov_right).

    The reference draws the triangle robot->left->right (robot.py:646-649);
    we use the sector (angle window + range), which contains the triangle —
    conservative in the robot's favor by a sliver near the arc.
    """
    cx, cy = cell_centers(gs)
    dx = cx - pos[0]
    dy = cy - pos[1]
    dist2 = dx**2 + dy**2
    ang = jnp.arctan2(dy, dx)
    in_cone = jnp.abs(angle_normalize(ang - yaw)) <= spec.fov_angle / 2.0
    return (dist2 <= spec.cam_range**2) & in_cone


def update_footprint(footprint, gs: GridSpec, pos, yaw, spec):
    return footprint | fov_mask(gs, pos, yaw, spec)


def segment_tube_mask(gs: GridSpec, p0, p1, radius):
    """Cells within ``radius`` of segment p0-p1 (LineString.buffer analog)."""
    cx, cy = cell_centers(gs)
    d = p1 - p0
    len2 = jnp.maximum(d @ d, 1e-12)
    t = jnp.clip(((cx - p0[0]) * d[0] + (cy - p0[1]) * d[1]) / len2, 0.0, 1.0)
    qx = p0[0] + t * d[0]
    qy = p0[1] + t * d[1]
    return (cx - qx) ** 2 + (cy - qy) ** 2 <= radius**2


def braking_arc_points(pos, yaw, v, yaw_rate, spec, dt, max_decel, max_ang_decel, n_pts=32):
    """Decelerating-arc rollout for yaw-rate models (robot.py:704-731),
    fixed length with a stop mask."""

    def body(carry, k):
        p, yw = carry
        t = k * dt
        v_c = jnp.maximum(v - max_decel * t, 0.0)
        om = yaw_rate - jnp.sign(yaw_rate) * max_ang_decel * t
        om = jnp.where(jnp.sign(om) != jnp.sign(yaw_rate), 0.0, om)
        yw = yw + om * dt
        p_new = p + v_c * jnp.array([jnp.cos(yw), jnp.sin(yw)]) * dt
        p_out = jnp.where(v_c > 0.0, p_new, p)
        return (p_out, yw), p_out

    (_, _), pts = jax.lax.scan(
        body, (jnp.asarray(pos), jnp.asarray(yaw)), jnp.arange(n_pts)
    )
    return jnp.concatenate([jnp.asarray(pos)[None], pts], axis=0)


def safety_area_mask(
    gs: GridSpec, pos, yaw, v, yaw_rate, spec, dt, max_decel=1.0, max_ang_decel=1.0,
    integrator: bool = False, vel=None, n_pts=32,
):
    """Braking-distance safety area as a grid mask (robot.py:656-741)."""
    if integrator:
        speed = jnp.linalg.norm(vel)
        braking = speed**2 / (2.0 * jnp.maximum(max_decel, 1e-6))
        heading = jnp.where(
            speed > 1e-6,
            vel / jnp.maximum(speed, 1e-9),
            jnp.array([jnp.cos(yaw), jnp.sin(yaw)]),
        )
        p1 = jnp.asarray(pos) + braking * heading
        return segment_tube_mask(gs, jnp.asarray(pos), p1, spec.radius)

    pts = braking_arc_points(pos, yaw, v, yaw_rate, spec, dt, max_decel, max_ang_decel, n_pts)
    masks = jax.vmap(
        lambda p0, p1: segment_tube_mask(gs, p0, p1, spec.radius)
    )(pts[:-1], pts[1:])
    return jnp.any(masks, axis=0)


def is_beyond_footprint(footprint, gs: GridSpec, pos, safety_mask=None):
    """Visibility-violation test (robot.py:743-753).

    'point_mass' mode: the robot's cell must be known.
    'safety_area' mode (pass ``safety_mask``): every safety-area cell must
    be known.
    """
    if safety_mask is not None:
        return jnp.any(safety_mask & ~footprint)
    ix = jnp.clip((pos[0] / gs.resolution).astype(jnp.int32), 0, gs.nx - 1)
    iy = jnp.clip((pos[1] / gs.resolution).astype(jnp.int32), 0, gs.ny - 1)
    return ~footprint[ix, iy]

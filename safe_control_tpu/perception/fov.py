"""Field-of-view sensing: detection, membership, persistent obstacle memory.

JAX re-implementation of the reference's RGB-D FoV simulation:

- circle-vs-sector intersection incl. the angular-radius term
  (utils/detection.py:28-43)
- ``detect_unknown_obs`` 'fov' mode with superellipsoids conservatively
  circularized on detection (utils/detection.py:45-88)
- ``is_in_fov`` point membership (robots/robot.py:854-873)
- persistent detected-obstacle memory with tolerance-based dedup
  (robots/robot.py:773-797) so CBF constraints persist after obstacles
  leave the instantaneous FoV

Everything is fixed-shape: unknown obstacles come in as a padded (K, 7)
array, memory is a fixed (M, 7) slot array + validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from safe_control_tpu.core.types import (
    OBS_B,
    OBS_E,
    OBS_FLAG,
    OBS_R,
    angle_normalize,
    dummy_obstacle,
    is_dummy,
)


def circle_intersects_fov(robot_pos, robot_yaw, fov_angle, cam_range, center, radius):
    """Branch-free port of utils/detection.py:28-43 semantics."""
    to_c = center - robot_pos
    dist = jnp.linalg.norm(to_c)
    inside = dist <= radius
    too_far = dist - radius > cam_range
    angle_to_c = jnp.arctan2(to_c[1], to_c[0])
    angle_diff = jnp.abs(angle_normalize(angle_to_c - robot_yaw))
    in_cone = angle_diff <= fov_angle / 2
    ang_rad = jnp.arcsin(jnp.clip(radius / jnp.maximum(dist, 1e-9), 0.0, 1.0))
    in_widened = angle_diff <= fov_angle / 2 + ang_rad
    return inside | (~too_far & (in_cone | in_widened))


def circularize(obs):
    """Superellipsoids become conservative circles on detection
    (utils/detection.py:63-67)."""
    is_se = obs[OBS_FLAG] >= 0.5
    r_circ = jnp.maximum(jnp.maximum(obs[OBS_R], obs[OBS_B]), 0.0)
    out = jnp.where(
        is_se,
        jnp.array([obs[0], obs[1], r_circ, 0.0, 0.0, 0.0, 0.0], dtype=obs.dtype),
        obs,
    )
    return out


def detect_unknown_obs_fov(robot_pos, robot_yaw, unknown_obs, spec):
    """Returns (obs (K,7) circularized, detected_mask (K,)) for padded input."""
    def one(obs):
        c = circularize(obs)
        hit = circle_intersects_fov(
            robot_pos, robot_yaw, spec.fov_angle, spec.cam_range, c[:2], c[OBS_R]
        )
        return c, hit & ~is_dummy(obs)

    circs, hits = jax.vmap(one)(unknown_obs)
    return circs, hits


def is_in_fov(robot_pos, robot_yaw, point, spec, check_range: bool = False):
    """Point-in-FoV test (robots/robot.py:854-873)."""
    to_p = point[:2] - robot_pos
    angle = jnp.arctan2(to_p[1], to_p[0])
    diff = jnp.abs(angle_normalize(angle - robot_yaw))
    ok = diff <= spec.fov_angle / 2
    if check_range:
        ok = ok & (jnp.linalg.norm(to_p) <= spec.cam_range)
    return ok


def detect_unknown_obs_ray(
    robot_pos,
    unknown_obs,
    footprint,
    gs,
    obs_margin: float = 0.05,
    n_boundary: int = 24,
):
    """Legacy 'ray' detection mode (utils/detection.py:90-132), grid-based.

    The reference intersects each obstacle disc with the shapely sensing
    footprint and fits a circle to the extreme points of the intersection.
    Here: sample ``n_boundary`` points on each obstacle's (margin-shrunk)
    boundary, keep those inside the occupancy footprint, and fit the
    detected circle from the angular-extreme visible points — the same
    extreme-point construction (detection.py:18-25).

    Returns (obs (K, 7) fitted circles, detected_mask (K,)).
    """
    angles = jnp.linspace(0.0, 2.0 * jnp.pi, n_boundary, endpoint=False)

    def in_fp(p):
        ix = jnp.clip((p[0] / gs.resolution).astype(jnp.int32), 0, gs.nx - 1)
        iy = jnp.clip((p[1] / gs.resolution).astype(jnp.int32), 0, gs.ny - 1)
        return footprint[ix, iy]

    def one(obs):
        c = circularize(obs)
        r_eff = jnp.maximum(c[OBS_R] - obs_margin, 1e-3)
        pts = c[:2][None, :] + r_eff * jnp.stack(
            [jnp.cos(angles), jnp.sin(angles)], axis=1
        )
        visible = jax.vmap(in_fp)(pts)
        any_vis = jnp.any(visible) & ~is_dummy(obs)
        # extreme points by bearing from the robot (detection.py:18-25)
        to_pts = pts - robot_pos[None, :]
        bearings = angle_normalize(
            jnp.arctan2(to_pts[:, 1], to_pts[:, 0])
            - jnp.arctan2(c[1] - robot_pos[1], c[0] - robot_pos[0])
        )
        b_masked_lo = jnp.where(visible, bearings, jnp.inf)
        b_masked_hi = jnp.where(visible, bearings, -jnp.inf)
        left = pts[jnp.argmin(b_masked_lo)]
        right = pts[jnp.argmax(b_masked_hi)]
        center = (left + right) / 2.0
        radius = jnp.linalg.norm(right - left) / 2.0
        fitted = jnp.array(
            [center[0], center[1], radius, 0.0, 0.0, 0.0, 0.0], dtype=obs.dtype
        )
        return jnp.where(any_vis, fitted, obs), any_vis

    return jax.vmap(one)(unknown_obs)


class ObsMemory(NamedTuple):
    """Fixed-slot persistent memory of detected unknown obstacles."""

    slots: jnp.ndarray  # (M, 7)
    valid: jnp.ndarray  # (M,) bool


def init_memory(num_slots: int, dtype=jnp.float32) -> ObsMemory:
    return ObsMemory(
        slots=jnp.tile(dummy_obstacle(dtype), (num_slots, 1)),
        valid=jnp.zeros((num_slots,), dtype=bool),
    )


def merge_memory(
    mem: ObsMemory,
    detected: jnp.ndarray,
    detected_mask: jnp.ndarray,
    merge_tol: float = 1e-3,
    radius_tol: float = 1e-2,
) -> ObsMemory:
    """Tolerance-dedup merge (robots/robot.py:773-797), fixed shapes.

    Sequential scan over the K detections (K is small); each either updates a
    matching slot or claims the first free slot.  If memory is full new
    detections are dropped (the reference grows unboundedly; we bound it).
    """

    def insert(carry, obs_and_mask):
        slots, valid = carry
        obs, m = obs_and_mask
        center_d = jnp.linalg.norm(slots[:, :2] - obs[:2], axis=1)
        radius_d = jnp.abs(slots[:, OBS_R] - obs[OBS_R])
        shape_d = jnp.abs(slots[:, OBS_FLAG] - obs[OBS_FLAG])
        match = valid & (center_d <= merge_tol) & (radius_d <= radius_tol) & (
            shape_d <= 0.5
        )
        has_match = jnp.any(match)
        match_idx = jnp.argmax(match)
        free_idx = jnp.argmin(valid)  # first False slot (or 0 if full)
        has_free = jnp.any(~valid)
        idx = jnp.where(has_match, match_idx, free_idx)
        do_write = m & (has_match | has_free)
        slots = jnp.where(
            do_write,
            slots.at[idx].set(obs),
            slots,
        )
        valid = jnp.where(do_write, valid.at[idx].set(True), valid)
        return (slots, valid), None

    (slots, valid), _ = jax.lax.scan(
        insert, (mem.slots, mem.valid), (detected, detected_mask)
    )
    return ObsMemory(slots=slots, valid=valid)

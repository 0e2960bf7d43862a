"""Drifting environment: tracks, lanes, friction puddles, obstacle cars.

JAX re-implementation of the reference's envs/drifting_env.py: track
generation stays host-side NumPy (straight :90-119, oval :139-178, L-shape
:179-227, multi-lane geometry :105-113); all per-step queries are pure jnp
functions over fixed-shape arrays so the gatekeeper/MPCC can batch them —
centerline-normal boundary collision (:340-424), friction puddles
(:435-484), static + moving obstacle cars with constant-velocity prediction
(:486-673).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

MAX_PUDDLES = 8
MAX_OBSTACLE_CARS = 8


class DriftingEnv:
    """Host-side container; exposes frozen jnp arrays + pure query methods."""

    def __init__(self, track_type="straight", track_width=8.0, track_length=100.0,
                 num_lanes=1):
        self.track_type = track_type
        self.track_width = float(track_width)
        self.track_length = float(track_length)
        self.num_lanes = int(num_lanes)
        self.lane_width = track_width / num_lanes if num_lanes > 1 else track_width

        if track_type == "straight":
            n = 100
            x = np.linspace(0, track_length, n)
            y = np.zeros(n)
        elif track_type == "oval":
            n = 200
            a, b = track_length / 2, track_length / 2.5
            t = np.linspace(0, 2 * np.pi, n)
            x = a * np.cos(t) + a
            y = b * np.sin(t)
        elif track_type == "l_shape":
            seg1, seg2 = track_length * 0.6, track_length * 0.4
            cr = track_width
            x1 = np.linspace(0, seg1, 60)
            y1 = np.zeros(60)
            th = np.linspace(-np.pi / 2, 0, 20)
            xc = seg1 + cr + cr * np.cos(th)
            yc = cr + cr * np.sin(th)
            x2 = np.full(40, seg1 + cr)
            y2 = np.linspace(cr, cr + seg2, 40)
            x = np.concatenate([x1, xc, x2])
            y = np.concatenate([y1, yc, y2])
        else:
            raise ValueError(f"Unknown track type: {track_type}")

        self.centerline_np = np.column_stack([x, y])
        dx, dy = np.gradient(x), np.gradient(y)
        ln = np.sqrt(dx**2 + dy**2)
        nx, ny = -dy / ln, dx / ln
        hw = track_width / 2
        self.left_boundary_np = np.column_stack([x + hw * nx, y + hw * ny])
        self.right_boundary_np = np.column_stack([x - hw * nx, y - hw * ny])
        self.normals_np = np.column_stack([nx, ny])

        # Lane centers (straight multi-lane only, :105-113).
        if num_lanes > 1 and track_type == "straight":
            self.lane_centers = [hw - (i + 0.5) * self.lane_width for i in range(num_lanes)]
        else:
            self.lane_centers = [0.0]

        self.centerline = jnp.asarray(self.centerline_np, jnp.float32)
        self.normals = jnp.asarray(self.normals_np, jnp.float32)

        # Fixed-slot puddles: [x, y, radius, friction]; inactive slots r=0.
        self._puddles = np.zeros((MAX_PUDDLES, 4))
        self._n_puddles = 0
        # Fixed-slot obstacle cars: [x, y, theta, vx, vy, radius]; r=0 inactive.
        self._cars = np.zeros((MAX_OBSTACLE_CARS, 6))
        self._n_cars = 0

    # ----------------------------------------------------------- mutation
    def add_puddle(self, x, y, radius, friction=0.3):
        self._puddles[self._n_puddles] = [x, y, radius, friction]
        self._n_puddles += 1

    def add_obstacle_car(self, x, y, theta, radius=1.2):
        self._cars[self._n_cars] = [x, y, theta, 0.0, 0.0, radius]
        self._n_cars += 1
        return self._n_cars - 1

    def add_dynamic_obstacle_car(self, x, y, theta, vx, vy, radius=1.2):
        self._cars[self._n_cars] = [x, y, theta, vx, vy, radius]
        self._n_cars += 1
        return self._n_cars - 1

    def get_lane_center(self, lane_idx):
        return self.lane_centers[lane_idx]

    def get_middle_lane_idx(self):
        return self.num_lanes // 2

    @property
    def puddles(self):
        return jnp.asarray(self._puddles, jnp.float32)

    @property
    def obstacle_cars(self):
        return jnp.asarray(self._cars, jnp.float32)

    # ------------------------------------------------------------ queries
    def check_collision(self, position, robot_radius=0.0):
        """Centerline-distance boundary collision (:340-371), pure jnp."""
        d2 = jnp.sum((self.centerline - position[None, :2]) ** 2, axis=1)
        idx = jnp.argmin(d2)
        dist_from_center = jnp.sqrt(d2[idx])
        return dist_from_center + robot_radius > self.track_width / 2.0

    def signed_lateral_offset(self, position):
        """Signed distance from centerline along the track normal (:401-424)."""
        d2 = jnp.sum((self.centerline - position[None, :2]) ** 2, axis=1)
        idx = jnp.argmin(d2)
        return (position[:2] - self.centerline[idx]) @ self.normals[idx]

    def get_friction_at_position(self, position, default_friction=1.0):
        """Puddle friction lookup (:459-484): nearest active puddle wins."""
        p = self.puddles
        d = jnp.sqrt((position[0] - p[:, 0]) ** 2 + (position[1] - p[:, 1]) ** 2)
        inside = (d <= p[:, 2]) & (p[:, 2] > 0)
        # first active puddle wins (reference iterates in insertion order)
        frictions = jnp.where(inside, p[:, 3], jnp.inf)
        mu = jnp.min(frictions)
        return jnp.where(jnp.isfinite(mu), mu, default_friction)

    def obstacle_car_states(self, t=0.0):
        """(M, 6) predicted obstacle-car rows at time t (const velocity,
        :660-673): [x, y, theta, vx, vy, radius]."""
        c = self.obstacle_cars
        return c.at[:, 0].add(c[:, 3] * t).at[:, 1].add(c[:, 4] * t)

    def check_obstacle_collision(self, position, robot_radius=0.0, t=0.0):
        c = self.obstacle_car_states(t)
        d = jnp.sqrt((position[0] - c[:, 0]) ** 2 + (position[1] - c[:, 1]) ** 2)
        hit = (d < robot_radius + c[:, 5]) & (c[:, 5] > 0)
        return jnp.any(hit)

    def step_dynamic_obstacles(self, dt):
        """Host-side advance of the obstacle cars (:652-658)."""
        self._cars[:, 0] += self._cars[:, 3] * dt
        self._cars[:, 1] += self._cars[:, 4] * dt

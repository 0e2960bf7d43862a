"""Rectangular workspace environment.

JAX re-implementation of the reference's utils/env.py: boundary
strips (:49-60), circle / superellipsoid obstacle lists split by flag
(:73-92), and the grid discretization helpers (:16-47) — here the grid is a
static shape used by the occupancy-based perception (perception/grid.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from safe_control_tpu.core.types import OBS_DIM


class Env:
    """Host-side environment container (construction is host code; all
    per-step math consumes the padded obstacle arrays)."""

    def __init__(self, width=20.0, height=20.0, known_obs: Sequence = (), resolution=0.1):
        self.width = float(width)
        self.height = float(height)
        self.resolution = float(resolution)
        self.x_range = (0.0, self.width)
        self.y_range = (0.0, self.height)

        known = np.asarray(list(known_obs), dtype=float)
        if known.size == 0:
            known = np.zeros((0, OBS_DIM))
        if known.shape[1] < OBS_DIM:
            known = np.hstack(
                [known, np.zeros((known.shape[0], OBS_DIM - known.shape[1]))]
            )
        self.obs_circle = known[known[:, -1] == 0]
        se = known[known[:, -1] == 1]
        if len(se):
            assert (se[:, 4] >= 2).all(), "e should be >= 2 for superellipsoid"
        self.obs_superellipsoid = se
        self.obs_boundary = self._boundary_strips(self.width, self.height)
        self.obs_rectangle = np.zeros((0, 4))

        self.grid_width = int(self.width / self.resolution)
        self.grid_height = int(self.height / self.resolution)

    @staticmethod
    def _boundary_strips(w, h, linewidth=0.05):
        return np.array(
            [
                [0, 0, linewidth, h],
                [0, h, w, linewidth],
                [linewidth, 0, w, linewidth],
                [w, linewidth, linewidth, h],
            ]
        )

    def get_map_shape(self):
        return (self.grid_height, self.grid_width)

    def f_to_grid(self, points):
        points = np.asarray(points)
        return (points / self.resolution).astype(int)

    def grid_to_f(self, grid_points):
        grid_points = np.asarray(grid_points)
        return grid_points * self.resolution + self.resolution / 2.0

    @property
    def all_obs(self) -> np.ndarray:
        """(N, 7) combined circle + superellipsoid obstacle rows."""
        return np.vstack([self.obs_circle, self.obs_superellipsoid])

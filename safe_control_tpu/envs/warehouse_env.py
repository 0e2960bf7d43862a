"""Warehouse environment: 100x100 grid world, static obstacles, "ghosts".

JAX re-implementation of the reference's envs/warehouse_env.py: a
4x4 grid of circular static obstacles (:31-41), leveled moving "ghost"
obstacles that bounce off the walls (:60-266, :267-277), start (10,10) /
goal (90,90) and the zig-zag nominal waypoint path (:333-343).  Ghost
tables — including the reference's level>=6 hand-shuffled variants and
their SEQUENTIAL reshuffle semantics — are reproduced exactly for every
level (see ``_ghost_table``).

Bounce semantics: the reference flips velocity when a ghost crosses the
[2, 98] band (warehouse_env.py:274-277) but leaves the overshot position in
place, so the true path lags an ideal reflection by up to |v|*dt per
bounce.  Here ``step`` REFLECTS the position off the same [2, 98] band
(single reflection per step is exact: overshoot <= |v|*dt << band width),
which makes ghost paths ideal triangle waves — so the gatekeeper's folded
constant-velocity prediction (sim/warehouse_sim.py) has zero model error,
and its margin needs to cover only intra-sample motion.  This is a
documented behavioral delta vs the reference: up to |v|*dt (= 0.4 m) of
phase lag is introduced PER BOUNCE and the lag ACCUMULATES — after k
bounces a reference ghost trails the ideal triangle wave by up to
k*|v|*dt, so long-run ghost POSITIONS can diverge arbitrarily between
the two semantics (bounded only by the band width).  Scenario-level
warehouse claims therefore hold for THIS env's triangle-wave ghosts, not
as trajectory parity with the reference's lagged ghosts; what is
preserved is the structural contract every shielding claim relies on —
same bounce band, same speeds, same period (to one dt per bounce), and a
prediction model that is exact for the env it runs against.  (The
reference's own gatekeeper enjoys the same exactness property against
its lagged ghosts only approximately, since its constant-velocity
prediction does not model the lag either.)

All queries are pure jnp over fixed-shape arrays: ghosts are an (G, 5)
array [x, y, vx, vy, radius] padded with radius 0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

MAX_GHOSTS = 32
GHOST_RADIUS = 2.0
OBS_RADIUS = 7.0
BOUNCE_LO = 2.0  # reference bounce band (warehouse_env.py:274-277)
BOUNCE_HI = 98.0


def fold_position(z, lo=BOUNCE_LO, hi=BOUNCE_HI):
    """Triangle-wave fold of an unbounded coordinate into the bounce band.

    With position-reflecting bounces (``WarehouseEnv.step``), a ghost's
    path is EXACTLY ``fold_position(x0 + vx * t)`` — the prediction used by
    the warehouse gatekeeper's collision check.  Works on scalars or jnp
    arrays.
    """
    w = hi - lo
    m = jnp.mod(z - lo, 2.0 * w)
    return lo + (w - jnp.abs(w - m))


def _ghost_table(level) -> list:
    """Exact ghost tables for every level (warehouse_env.py:60-266).

    The constants and the SEQUENTIAL level-6 reshuffle semantics are
    reproduced verbatim as behavioral parameters: in the reference's
    reshuffle loop each ghost passes through every ``if`` in order, so an
    earlier rewrite can trigger a later rule on the same ghost (e.g. the
    (5,30) sweeper first moves to y=25, then the left-boundary-relief rule
    for (5,25) flips it to start at x=95).
    """
    s = str(level).lower()
    lvl = 3 if s == "hero" else int(level)
    g = []
    add = lambda x, y, vx, vy: g.append([x, y, vx, vy, GHOST_RADIUS])
    if lvl == 0:
        return g
    if lvl == 1:  # (:91-97)
        add(95, 50, -4.0, 0.0)
        add(50, 5, 0.0, 4.0)
        add(5, 70, 4.0, 0.0)
        return g
    if lvl == 2:  # (:99-106)
        add(95, 50, -4.0, 0.0)
        add(50, 5, 0.0, 4.0)
        add(5, 70, 2.5, 0.0)
        add(30, 95, 0.0, -4.0)
        add(90, 90, -2.0, -2.0)
        return g

    # Hero layouts, lvl >= 3 (:108-266).
    speed = {3: 2.5, 4: 3.0, 5: 3.0, 6: 2.7}.get(lvl, 2.6)
    num_extra = {3: 0, 4: 3, 5: 6, 6: 10}.get(lvl, 0)
    # Main 11 (:134-150)
    add(95, 50, -speed, 0.0)
    add(50, 5, 0.0, speed)
    add(5, 70, speed, 0.0)
    add(30, 95, 0.0, -speed)
    add(90, 90, -speed * 0.7, -speed * 0.7)
    add(95, 10, -speed, 0.0)
    add(5, 30, speed, 0.0)
    add(95, 90, -speed, 0.0)
    add(10, 95, 0.0, -speed)
    add(70, 5, 0.0, speed)
    add(90, 95, 0.0, -speed)
    # Level 4 additions (:153-160)
    if num_extra >= 3:
        add(20, 20, 1.5, 1.5)
        add(80, 80, -1.5, -1.5)
        add(20, 80, speed, -speed)
    # Level 5 additions (:162-168)
    if num_extra >= 6:
        add(80, 20, -speed, speed)
        add(5, 40, speed * 0.8, 0.0)
        add(95, 60, -speed * 0.8, 0.0)
    # Levels 3-5: y=70 sweeper slow-down (:170-175)
    if lvl in (3, 4, 5):
        tgt = 1.5 if lvl == 3 else 2.5
        for row in g:
            if abs(row[1] - 70.0) < 1e-6 and abs(row[3]) < 1e-9:
                row[2] = tgt if row[2] > 0 else -tgt
    # Levels 4-5: slow-blocker shift off the diagonal (:177-185)
    if lvl in (4, 5):
        for row in g:
            if abs(row[0] - 20.0) < 1e-6 and abs(row[1] - 20.0) < 1e-6:
                row[1], row[3] = 15.0, 0.0
            if abs(row[0] - 80.0) < 1e-6 and abs(row[1] - 80.0) < 1e-6:
                row[1], row[3] = 85.0, 0.0
    # Level 6 additions, "super dense" (:187-201)
    if num_extra >= 10:
        add(5, 15, speed * 0.9, 0.0)
        add(95, 80, -speed * 0.9, 0.0)
        add(20, 95, 0.0, -speed * 0.9)
        add(80, 5, 0.0, speed * 0.9)
        add(15, 85, speed * 0.7, -speed * 0.7)
        add(85, 15, -speed * 0.7, speed * 0.7)
        add(35, 5, 0.0, speed * 0.9)
        add(75, 95, 0.0, -speed * 0.9)
        add(95, 30, -speed * 0.9, 0.0)
        add(5, 65, speed * 0.9, 0.0)
        add(50, 10, 0.0, speed * 0.45)
    # Level 7 additions, cross-flow (:203-224)
    if lvl >= 7:
        fs = speed * 0.8
        for y in (44.0, 58.0, 72.0, 86.0):
            add(5, y, fs, 0.0)
        for x in (44.0, 58.0, 72.0, 86.0):
            add(x, 5, 0.0, fs)
        add(5, 54, fs, -fs * 0.4)
        add(54, 5, -fs * 0.4, fs)
        add(40, 5, 0.0, fs * 1.1)
        add(6, 40, fs * 1.1, 0.0)
        add(95, 34, -fs * 1.1, 0.0)
        add(95, 30, -speed, 0.0)
        add(66, 80, 0.0, -fs * 1.2)
        add(66, 60, 0.0, fs * 1.2)
        add(20, 70, speed * 1.02, 0.0)
    # Level >= 6 sequential reshuffle (:227-266).
    if lvl >= 6:
        for row in g:
            if abs(row[0] - 5.0) < 1e-6 and abs(row[1] - 30.0) < 1e-6:
                row[1] = 25.0
            if abs(row[0] - 20.0) < 1e-6 and abs(row[1] - 20.0) < 1e-6:
                row[0], row[1], row[3] = 45.0, 25.0, 0.0
            if abs(row[0] - 50.0) < 1e-6 and abs(row[1] - 5.0) < 1e-6:
                row[0] = 95.0
            if abs(row[0] - 70.0) < 1e-6 and abs(row[1] - 5.0) < 1e-6:
                row[0] = 25.0
            if abs(row[1] - 50.0) < 1e-6 and abs(row[3]) < 1e-9 and row[2] < 0:
                row[1] = 55.0
            if abs(row[0] - 80.0) < 1e-6 and abs(row[1] - 80.0) < 1e-6:
                row[1], row[3] = 85.0, 0.0
            for y_relief in (15.0, 25.0, 40.0, 65.0, 70.0):
                if abs(row[0] - 5.0) < 1e-6 and abs(row[1] - y_relief) < 1e-6:
                    row[0], row[2] = 95.0, -abs(row[2])
    return g


class WarehouseEnv:
    def __init__(self, level=1, dt=0.05):
        self.level = level
        self.dt = dt
        self.width = 100.0
        self.height = 100.0
        self.obs_radius = OBS_RADIUS
        # 4x4 static grid (:31-35)
        static = [[x, y, OBS_RADIUS] for x in (20, 40, 60, 80) for y in (20, 40, 60, 80)]
        self.static_obstacles = np.array(static, dtype=float)
        self.start_pos = np.array([10.0, 10.0])
        self.goal_pos = np.array([90.0, 90.0])
        self.goal_radius = 5.0
        self.reset()

    def reset(self):
        rows = _ghost_table(self.level)
        ghosts = np.zeros((MAX_GHOSTS, 5))
        for i, r in enumerate(rows):
            ghosts[i] = r
        self._ghosts = ghosts

    @property
    def ghosts(self):
        return jnp.asarray(self._ghosts, jnp.float32)

    @property
    def static_obs7(self):
        """Static obstacles as reference 7-vectors for controller use."""
        s = self.static_obstacles
        return np.hstack([s, np.zeros((len(s), 4))])

    def step(self):
        """Advance ghosts with position-reflecting wall bounces (:267-277).

        The reference flips only the velocity at the [2, 98] band; here the
        overshoot is also reflected (``x -> 2*hi - x``), which makes the
        path an ideal triangle wave (see module docstring).  One reflection
        per step is exact because |v|*dt <= 0.44 << the 96 m band.
        """
        g = self._ghosts
        lo, hi = BOUNCE_LO, BOUNCE_HI
        for dim in (0, 1):
            v = dim + 2
            g[:, dim] += g[:, v] * self.dt
            over = g[:, dim] > hi
            under = g[:, dim] < lo
            g[over, dim] = 2.0 * hi - g[over, dim]
            g[under, dim] = 2.0 * lo - g[under, dim]
            g[over | under, v] *= -1

    def safe_spots(self, robot_radius=0.8, margin=0.7, grid_step=2.0,
                   sim_seconds=240.0):
        """(S, 2) parking points that no ghost's bouncing path ever visits.

        Ghost trajectories are deterministic rays with wall bounces, so
        their reachable sets are fixed polylines; a robot parked at least
        ``robot_radius + ghost_radius + margin`` from every polyline (and
        from statics/walls) is safe for all time.  This is the warehouse
        analog of the reference's evade-to-pocket backup target
        (position_control/backup_controller.py:420-626): a backup POLICY
        that drives to the nearest such spot turns "braked to rest" (not
        invariant under sweeper traffic) into a genuine invariant set.

        Host-side, one-time per level: simulates every active ghost for
        ``sim_seconds`` and excludes a candidate grid against the sampled
        paths.
        """
        g = self._ghosts
        act = g[g[:, 4] > 0]
        xs = np.arange(3.0, self.width - 2.0, grid_step)
        ys = np.arange(3.0, self.height - 2.0, grid_step)
        cand = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
        keep = np.ones(len(cand), dtype=bool)
        # statics
        for sx, sy, sr in self.static_obstacles:
            keep &= (
                np.linalg.norm(cand - np.array([sx, sy]), axis=1)
                > sr + robot_radius + 0.2
            )
        if len(act):
            n_steps = int(sim_seconds / self.dt)
            pos = act[:, :2].copy()
            vel = act[:, 2:4].copy()
            clearance = act[:, 4] + robot_radius + margin  # (G,)
            min_d = np.full(len(cand), np.inf)
            lo, hi = BOUNCE_LO, BOUNCE_HI
            for _ in range(n_steps):
                # same position-reflecting bounce as ``step``
                pos += vel * self.dt
                for dim in (0, 1):
                    over = pos[:, dim] > hi
                    under = pos[:, dim] < lo
                    pos[over, dim] = 2.0 * hi - pos[over, dim]
                    pos[under, dim] = 2.0 * lo - pos[under, dim]
                    vel[over | under, dim] *= -1
                d = np.linalg.norm(
                    cand[:, None, :] - pos[None, :, :], axis=-1
                ) - clearance[None, :]
                min_d = np.minimum(min_d, d.min(axis=1))
            keep &= min_d > 0.0
        return cand[keep]

    def ghost_states(self, t=0.0):
        """(G, 5) constant-velocity ghost prediction at time t (no bounce)."""
        g = self.ghosts
        return g.at[:, 0].add(g[:, 2] * t).at[:, 1].add(g[:, 3] * t)

    def check_boundary_collision(self, position, robot_radius=0.0):
        x, y = position[0], position[1]
        return (
            (x - robot_radius < 0)
            | (x + robot_radius > self.width)
            | (y - robot_radius < 0)
            | (y + robot_radius > self.height)
        )

    def check_static_collision(self, position, robot_radius=0.0):
        s = jnp.asarray(self.static_obstacles, jnp.float32)
        d = jnp.sqrt((position[0] - s[:, 0]) ** 2 + (position[1] - s[:, 1]) ** 2)
        return jnp.any(d < robot_radius + s[:, 2])

    def check_ghost_collision(self, position, robot_radius=0.0, t=0.0):
        g = self.ghost_states(t)
        d = jnp.sqrt((position[0] - g[:, 0]) ** 2 + (position[1] - g[:, 1]) ** 2)
        return jnp.any((d < robot_radius + g[:, 4]) & (g[:, 4] > 0))

    def check_goal_reached(self, position):
        return jnp.linalg.norm(position[:2] - jnp.asarray(self.goal_pos, jnp.float32)) < self.goal_radius

    @staticmethod
    def get_nominal_waypoints():
        """Diagonal zig-zag path (:333-343)."""
        return np.array(
            [
                (10, 10),
                (30, 10), (30, 30),
                (50, 30), (50, 50),
                (70, 50), (70, 70),
                (90, 70), (90, 90),
            ],
            dtype=float,
        )

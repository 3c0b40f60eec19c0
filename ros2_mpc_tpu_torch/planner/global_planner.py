"""Global planners — API-parity port family for
ros2_mpc/planner/global_planner.py, rebuilt without the reference's
``pyastar2d``/``astar``/``rrtplanner`` dependencies.

* :class:`AStarPlanner2` — the live planner (reference :81-106): weighted-grid
  A* (native C++ core with NumPy fallback) + Savitzky-Golay smoothing of the
  row coordinate.
* :class:`AstarGlobalPlanner` — 4-neighborhood binary-grid A*
  (reference :35-63).
* :class:`RRTGlobalPlanner` — RRT* (n=1200 samples, rewire radius 80,
  reference :66-78) + Bresenham densification.
* :func:`get_points_on_lines` — Bresenham over segment lists (reference :8-32).

Planning is host-side (latency-tolerant at the reference's 1 Hz replan rate).
The port's own copy of :mod:`ros2_mpc_tpu.planner.global_planner`; the
wavefront distance fields are in :mod:`.wavefront`.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import savgol_filter

from .astar_py import astar_path_py
from .native import astar_path_native


def astar_path(weights: np.ndarray, start, goal, allow_diagonal: bool = False) -> np.ndarray:
    """Weighted-grid A* (drop-in for ``pyastar2d.astar_path``): native C++ if
    available, NumPy heap otherwise. Returns (L, 2) (row, col) cells, start
    first; empty (0, 2) when unreachable."""
    path = astar_path_native(weights, start, goal, allow_diagonal)
    if path is None:
        path = astar_path_py(weights, start, goal, allow_diagonal)
    return path


def _bresenham(a, b):
    """8-connected cells of the segment a -> b, endpoints included."""
    (cx, cy), (tx, ty) = (int(a[0]), int(a[1])), (int(b[0]), int(b[1]))
    step_x = 1 if tx >= cx else -1
    step_y = 1 if ty >= cy else -1
    span_x, span_y = abs(tx - cx), abs(ty - cy)
    residual = span_x - span_y
    cells = []
    while (cx, cy) != (tx, ty):
        cells.append((cx, cy))
        doubled = residual * 2
        if doubled > -span_y:
            residual -= span_y
            cx += step_x
        if doubled < span_x:
            residual += span_x
            cy += step_y
    cells.append((tx, ty))
    return cells


def get_points_on_lines(line_segments) -> np.ndarray:
    """Bresenham densification of ``[((x1,y1),(x2,y2)), ...]`` segment lists —
    the same contract as the reference helper (global_planner.py:8-32)."""
    cells = []
    for seg in line_segments:
        cells.extend(_bresenham(seg[0], seg[1]))
    return np.array(cells)


class AStarPlanner2:
    """The live global planner (reference global_planner.py:81-106).

    ``get_path`` expects the dilated binary map image (free 0/1, occupied 255
    after MapSubscriber processing + dilation), remaps it to A* weights
    (occupied 1 -> 255, free 0 -> 1 — occupied cells stay *passable* but
    expensive, exactly like the reference :88-90), runs A* with no diagonals,
    Savitzky-Golay-smooths the row coordinate (window 15, degree 4,
    ``mode='interp'``; ValueError -> unsmoothed, :96-99), and returns
    ``list(zip(smoothed_y, x))``."""

    def __init__(self):
        self.window_size = 15
        self.poly_degree = 4

    def get_path(self, start, goal, map_image):
        occ = np.asarray(map_image)
        # Occupied cells stay *passable* but 255x the free-cell weight, so a
        # walled-in goal still yields some path (reference contract :88-90).
        weights = np.select([occ == 1, occ == 0], [255.0, 1.0], occ).astype(np.float32)
        cells = astar_path(weights, tuple(start), tuple(goal), allow_diagonal=False)
        if cells.shape[0] == 0:
            return []
        rows = self._smooth_rows(cells[:, 0].astype(float))
        return [(r, c) for r, c in zip(rows, cells[:, 1])]

    def _smooth_rows(self, rows: np.ndarray) -> np.ndarray:
        """Savitzky-Golay filter over the row coordinate only (the reference
        leaves columns raw); too-short paths pass through unsmoothed (the
        reference's ValueError fallback, :96-99)."""
        try:
            return savgol_filter(rows, self.window_size, self.poly_degree, mode="interp")
        except ValueError:
            return rows


class AstarGlobalPlanner:
    """Pure 4-neighborhood binary-grid A* (reference global_planner.py:35-63):
    cells are blocked when truthy; Euclidean heuristic. Returns the cell list
    or [] when unreachable."""

    def get_path(self, start, goal, map_image):
        grid = np.asarray(map_image)
        # Blocked cells get infinite weight (impassable), free cells weight 1.
        weights = np.where(grid.astype(bool), np.inf, 1.0).astype(np.float32)
        if grid[start[0], start[1]] or grid[goal[0], goal[1]]:
            return []
        path = astar_path_py(weights, start, goal, allow_diagonal=False)
        return [tuple(p) for p in path]


class RRTGlobalPlanner:
    """RRT* over an occupancy grid (reference global_planner.py:66-78 wraps the
    ``rrtplanner`` lib with n=1200 samples and rewire radius 80; free cells
    are 0). Independent implementation; ``get_path`` returns the
    Bresenham-densified waypoint array like the reference."""

    def __init__(self, og, n: int = 1200, rewire_radius: float = 80.0, seed: int = 0, step: float = 40.0):
        self.og = np.asarray(og)
        self.n = n
        self.rewire = rewire_radius
        self.step = step
        self.rng = np.random.default_rng(seed)

    def _free(self, p) -> bool:
        r, c = int(round(p[0])), int(round(p[1]))
        h, w = self.og.shape
        return 0 <= r < h and 0 <= c < w and self.og[r, c] == 0

    def _collision_free(self, a, b) -> bool:
        pts = get_points_on_lines([[(int(round(a[0])), int(round(a[1]))), (int(round(b[0])), int(round(b[1])))]])
        return all(self._free(p) for p in pts)

    def plan(self, start, goal):
        """RRT* tree growth; returns (nodes, parents, goal_idx or -1)."""
        nodes = [np.asarray(start, dtype=float)]
        parents = [-1]
        costs = [0.0]
        h, w = self.og.shape
        goal = np.asarray(goal, dtype=float)
        goal_idx = -1
        for i in range(self.n):
            sample = goal if self.rng.random() < 0.05 else self.rng.uniform([0, 0], [h - 1, w - 1])
            arr = np.asarray(nodes)
            dists = np.linalg.norm(arr - sample, axis=1)
            nearest = int(np.argmin(dists))
            direction = sample - arr[nearest]
            dist = np.linalg.norm(direction)
            if dist < 1e-9:
                continue
            new = arr[nearest] + direction * min(1.0, self.step / dist)
            if not self._free(new) or not self._collision_free(arr[nearest], new):
                continue
            # Choose best parent within the rewire radius.
            near_mask = np.linalg.norm(arr - new, axis=1) <= self.rewire
            best_parent, best_cost = nearest, costs[nearest] + float(np.linalg.norm(new - arr[nearest]))
            for j in np.nonzero(near_mask)[0]:
                cand = costs[j] + float(np.linalg.norm(new - arr[j]))
                if cand < best_cost and self._collision_free(arr[j], new):
                    best_parent, best_cost = int(j), cand
            nodes.append(new)
            parents.append(best_parent)
            costs.append(best_cost)
            k = len(nodes) - 1
            # Rewire neighbors through the new node.
            for j in np.nonzero(near_mask)[0]:
                cand = best_cost + float(np.linalg.norm(nodes[j] - new))
                if cand < costs[j] and self._collision_free(new, nodes[j]):
                    parents[j] = k
                    costs[j] = cand
            if np.linalg.norm(new - goal) <= self.step and self._collision_free(new, goal):
                if goal_idx == -1 or best_cost + float(np.linalg.norm(new - goal)) < costs[goal_idx]:
                    nodes.append(goal.copy())
                    parents.append(k)
                    costs.append(best_cost + float(np.linalg.norm(new - goal)))
                    goal_idx = len(nodes) - 1
        return nodes, parents, goal_idx

    def get_path(self, start, goal):
        nodes, parents, goal_idx = self.plan(start, goal)
        if goal_idx == -1:
            return np.empty((0, 2), dtype=int)
        waypoints = []
        cur = goal_idx
        while cur != -1:
            waypoints.append(nodes[cur])
            cur = parents[cur]
        waypoints = waypoints[::-1]
        segments = [
            [tuple(np.round(waypoints[i]).astype(int)), tuple(np.round(waypoints[i + 1]).astype(int))]
            for i in range(len(waypoints) - 1)
        ]
        if not segments:
            return np.round(np.asarray(waypoints)).astype(int)
        return get_points_on_lines(segments)

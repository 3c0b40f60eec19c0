"""Frontier-based autonomous exploration over the live occupancy map —
the port's own copy of :mod:`ros2_mpc_tpu.planner.frontier` (NumPy, host).

With the on-device mapper (nodes/mapper.py) publishing a trinary grid
(100 occupied / 0 free / -1 unknown), autonomy needs one more piece: where
to go next. The classic answer (Yamauchi 1997) is the *frontier* — free
cells adjacent to unknown cells. Driving to frontiers until none remain
maps the reachable world with no human goals. The reference has no notion
of any of this: it needs a human goal AND a pre-built map.

Pure functions over numpy grids (host-side planning, like the A* core):

* :func:`frontier_cells` — boolean mask of free-next-to-unknown cells.
* :func:`cluster_frontiers` — connected frontier components with centroids
  and sizes (4-connected BFS; grids are small and this runs at replan rate).
* :func:`pick_frontier_goal` — nearest sufficiently large cluster centroid,
  in world coordinates, or ``None`` when the map is closed (exploration
  done).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np


def frontier_cells(occ: np.ndarray) -> np.ndarray:
    """``occ``: trinary grid (100/0/-1), row 0 = top. True where a FREE cell
    touches an UNKNOWN cell (4-neighborhood)."""
    free = occ == 0
    unknown = occ == -1
    near_unknown = np.zeros_like(unknown)
    near_unknown[1:, :] |= unknown[:-1, :]
    near_unknown[:-1, :] |= unknown[1:, :]
    near_unknown[:, 1:] |= unknown[:, :-1]
    near_unknown[:, :-1] |= unknown[:, 1:]
    return free & near_unknown


def cluster_frontiers(mask: np.ndarray, min_size: int = 8):
    """4-connected components of the frontier mask, largest-first.

    Returns a list of dicts ``{"cells": (k, 2) int array, "centroid":
    (row, col) float, "size": k}``; components under ``min_size`` cells are
    dropped (single-cell frontiers are usually quantization noise)."""
    seen = np.zeros(mask.shape, dtype=bool)
    out = []
    H, W = mask.shape
    rows, cols = np.nonzero(mask)
    for r0, c0 in zip(rows, cols):
        if seen[r0, c0]:
            continue
        comp = []
        q = deque([(r0, c0)])
        seen[r0, c0] = True
        while q:
            r, c = q.popleft()
            comp.append((r, c))
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < H and 0 <= cc < W and mask[rr, cc] and not seen[rr, cc]:
                    seen[rr, cc] = True
                    q.append((rr, cc))
        if len(comp) >= min_size:
            cells = np.asarray(comp)
            out.append(
                {"cells": cells, "centroid": cells.mean(axis=0), "size": len(comp)}
            )
    out.sort(key=lambda d: -d["size"])
    return out


def frontier_goal_candidates(
    occ: np.ndarray,
    robot_xy,
    origin,
    resolution: float,
    min_size: int = 8,
    min_distance: float = 0.5,
) -> list:
    """World-XY centroids of every qualifying frontier cluster, nearest
    first. The single place the grid-to-world conversion lives (row 0 = top,
    ``origin`` = world coordinates of the bottom-left corner)."""
    clusters = cluster_frontiers(frontier_cells(occ), min_size=min_size)
    H = occ.shape[0]
    cands = []
    for cl in clusters:
        r, c = cl["centroid"]
        x = origin[0] + (c + 0.5) * resolution
        y = origin[1] + (H - 1 - r + 0.5) * resolution
        d = float(np.hypot(x - robot_xy[0], y - robot_xy[1]))
        if d >= min_distance:
            cands.append((d, np.array([x, y])))
    cands.sort(key=lambda t: t[0])
    return [xy for _, xy in cands]


def pick_frontier_goal(
    occ: np.ndarray,
    robot_xy,
    origin,
    resolution: float,
    min_size: int = 8,
    min_distance: float = 0.5,
) -> Optional[np.ndarray]:
    """World-XY of the nearest frontier-cluster centroid at least
    ``min_distance`` away, or ``None`` when no frontier remains (done)."""
    cands = frontier_goal_candidates(
        occ, robot_xy, origin, resolution, min_size=min_size, min_distance=min_distance
    )
    return cands[0] if cands else None

"""Pure-NumPy weighted-grid A* fallback (same contract as native.astar_path_native).

The port's own copy of :mod:`ros2_mpc_tpu.planner.astar_py`.

Used when the C++ core (native/astar.cpp) cannot be compiled. Heap-based,
host-side — global planning is latency-tolerant (the reference replans at
1 Hz, scripts/path_follower_local_planner.py:157)."""

from __future__ import annotations

import heapq

import numpy as np


def astar_path_py(weights: np.ndarray, start, goal, allow_diagonal: bool = False) -> np.ndarray:
    h, w = weights.shape
    sr, sc = int(start[0]), int(start[1])
    gr, gc = int(goal[0]), int(goal[1])
    empty = np.empty((0, 2), dtype=np.int32)
    if not (0 <= sr < h and 0 <= sc < w and 0 <= gr < h and 0 <= gc < w):
        return empty

    if allow_diagonal:
        nbrs = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)]

        def heur(r, c):
            dr, dc = abs(r - gr), abs(c - gc)
            return max(dr, dc) + 0.41421356 * min(dr, dc)

    else:
        nbrs = [(-1, 0), (1, 0), (0, -1), (0, 1)]

        def heur(r, c):
            return abs(r - gr) + abs(c - gc)

    g = np.full((h, w), np.inf)
    parent = np.full((h, w), -1, dtype=np.int64)
    closed = np.zeros((h, w), dtype=bool)
    g[sr, sc] = 0.0
    open_heap = [(heur(sr, sc), sr * w + sc)]
    weights = np.asarray(weights, dtype=np.float64)

    found = False
    while open_heap:
        _, idx = heapq.heappop(open_heap)
        r, c = divmod(idx, w)
        if closed[r, c]:
            continue
        closed[r, c] = True
        if r == gr and c == gc:
            found = True
            break
        for dr, dc in nbrs:
            nr, nc = r + dr, c + dc
            if not (0 <= nr < h and 0 <= nc < w) or closed[nr, nc]:
                continue
            ng = g[r, c] + weights[nr, nc]
            if ng < g[nr, nc]:
                g[nr, nc] = ng
                parent[nr, nc] = idx
                heapq.heappush(open_heap, (ng + heur(nr, nc), nr * w + nc))

    if not found:
        return empty
    rev = []
    cur = gr * w + gc
    while cur != -1:
        rev.append(divmod(cur, w))
        cur = int(parent[rev[-1][0], rev[-1][1]])
    return np.asarray(rev[::-1], dtype=np.int32)

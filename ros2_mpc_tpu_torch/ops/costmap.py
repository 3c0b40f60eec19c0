"""Costmap inflation and morphology on tensors — port of
:mod:`ros2_mpc_tpu.ops.costmap` (the replacements for the reference's numba
stamping loops, ros2_mpc/utils/costmap.py, and its OpenCV dilation calls,
cv2.dilate at scripts/global_path_publisher.py:65-67,
core/local_costmap_publisher.py:34-35, core/global_costmap_publisher.py:44-45).

The per-obstacle stamping loop is a grayscale min-correlation written as a
shift-and-reduce over the (small) inflation footprint; dilation is a max
pool. Each op runs on the device of the grid it is given.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

_F32 = torch.float32


def _chebyshev_rings(c: int, device) -> torch.Tensor:
    """(2c+1, 2c+1) Chebyshev distance from the centre cell."""
    i = torch.arange(2 * c + 1, device=device)
    return torch.maximum((i[:, None] - c).abs(), (i[None, :] - c).abs())


def get_inflation_matrix(cells_inflation: int, factor: float = 1.3, device=None) -> torch.Tensor:
    """Square decaying stamp: 100 at the center, rings decaying outward by
    ``(1/cells)/factor * 100`` per ring (ros2_mpc/utils/costmap.py:44-59).

    Ring at Chebyshev radius r in [1, c] holds ``decay * (c - r + 1) * 100``,
    in closed form. On ``device`` (``None``: the card)."""
    c = cells_inflation
    r = _chebyshev_rings(c, resolve_device(device))
    decay = (1.0 / c) / factor
    ring_value = decay * (c - r + 1) * 100.0
    return torch.where(r == 0, 100.0, ring_value)


def inflate_global(occupancy_grid, inflation_matrix, cells_inflation: int):
    """Stamp ``min(grid, inflation_matrix)`` around every occupied cell
    (value 0), matching ros2_mpc/utils/costmap.py:5-20 including its border
    quirk: obstacles closer than ``cells_inflation`` to any edge are skipped
    entirely (the reference ``continue``s when the clipped window shape
    mismatches the stamp)."""
    c = cells_inflation
    H, W = occupancy_grid.shape
    dev = occupancy_grid.device
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    interior = (rows >= c) & (rows < H - c) & (cols >= c) & (cols < W - c)
    obstacle = (occupancy_grid == 0) & interior

    new_grid = occupancy_grid
    big = torch.tensor(torch.inf, dtype=occupancy_grid.dtype, device=dev)
    for di in range(-c, c + 1):
        for dj in range(-c, c + 1):
            # A cell (i, j) receives inflation_matrix[c+di, c+dj] from an
            # obstacle at (i-di, j-dj).
            shifted = torch.roll(obstacle, shifts=(di, dj), dims=(0, 1))
            stamp = torch.where(shifted, inflation_matrix[c + di, c + dj], big)
            new_grid = torch.minimum(new_grid, stamp)
    return new_grid


def inflate_local(occupancy_grid, inflation_matrix, cells_inflation: int, robot_position, costmap_size: int):
    """Crop a ``costmap_size``-cell window centered at the robot, then inflate
    (ros2_mpc/utils/costmap.py:23-41). Crop start follows the reference's
    ``int(pos - size/2)`` truncation; as ``lax.dynamic_slice`` places it, a
    negative start counts from the far edge, then the window is clamped
    inside the grid."""
    pos = torch.as_tensor(robot_position, dtype=_F32)
    start = (pos - costmap_size / 2).to(torch.int32).tolist()

    def place(s, dim):
        return min(max(s + dim if s < 0 else s, 0), dim - costmap_size)

    r0, c0 = place(start[1], occupancy_grid.shape[0]), place(start[0], occupancy_grid.shape[1])
    window = occupancy_grid[r0 : r0 + costmap_size, c0 : c0 + costmap_size]
    return inflate_global(window, inflation_matrix, cells_inflation)


def dilate(grid, kernel_size: int, iterations: int = 1):
    """Grayscale dilation with an all-ones rectangular kernel — drop-in for
    ``cv2.dilate(grid, np.ones((k, k)), iterations=n)``
    (core/local_costmap_publisher.py:34-35, scripts/global_path_publisher.py:65-67).

    cv2 anchors even kernels at (k//2, k//2); a max pool over the grid padded
    with -inf by (k//2, k-1-k//2) on each axis reproduces it (``max_pool2d``
    pads symmetrically, so the padding is explicit). float32 out."""
    lo = kernel_size // 2
    hi = kernel_size - 1 - lo
    out = grid.to(_F32)[None, None]
    for _ in range(iterations):
        out = F.max_pool2d(F.pad(out, (lo, hi, lo, hi), value=-torch.inf), kernel_size, stride=1)
    return out[0, 0]


def erode_image(image, kernel_size: int):
    """Name-parity helper for the reference's mislabeled ``erode_image`` —
    which actually dilates twice (scripts/global_path_publisher.py:54-67,
    quirk #5 in the SURVEY ledger)."""
    return dilate(image, kernel_size, iterations=2).to(torch.uint8)


def threshold_map_message(map_data: np.ndarray) -> np.ndarray:
    """OccupancyGrid -> binary uint8 image exactly as MapSubscriber does
    (core/ros_topics.py:27-35): <=60 free, >60 occupied, inverted, x255,
    flipped upside down."""
    img = np.asarray(map_data).copy()
    img[img <= 60] = 1
    img[img > 60] = 0
    img = ((1 - img).astype(np.uint8)) * 255
    return np.flipud(img)

"""Scan/grid/coordinate ops on tensors — port of :mod:`ros2_mpc_tpu.ops.grid`
(the JAX replacements for the reference's numba functions,
ros2_mpc/utils/utils.py).

Each op runs on the device of the tensors it is given and keeps shapes
static: scan rasterization scatters into a grid with one spare row that
takes the out-of-range points (no host round trip to filter them), gathers
are masks over dense coordinate fields. The factories close over
resolution and size, as the JAX ones do.

Arithmetic is float32, as the JAX package's under its tests (x64 off).
The port divides by a constant as XLA does inside ``jit``: it multiplies by
the float32 reciprocal (PyTorch on CUDA does that for a Python-scalar
divisor, on the CPU it divides), so both devices round alike.

Reference quirks preserved or documented, as in the JAX module:

* index truncation toward zero (``int(x)``) when scattering
  (utils/utils.py:39,88) — ``.to(torch.int32)`` truncates like
  ``astype(int32)``;
* NaN sanitization in ``convert_laser_scan_to_xy_coordinates`` corrected to
  the min over finite values (utils/utils.py:62-63);
* ``convert_to_map_coordinates`` returns ``(meter_y, meter_x)`` in that order
  with negated axes (utils/utils.py:114-124).

``euler_from_quaternion``, ``quaternion_from_yaw``, ``world_to_map`` and
``map_to_world`` work on a handful of numbers and stay NumPy (float32, as
the JAX versions compute them), for the host code that calls them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_F32 = torch.float32


def reciprocal_f32(v: float) -> float:
    """The float32 reciprocal XLA multiplies by when it divides by ``v``."""
    return float(np.float32(1.0) / np.float32(v))


def rotate_coordinates(coordinates: torch.Tensor, rotation) -> torch.Tensor:
    """2D rotation of ``(2, P)`` stacked coordinates (utils/utils.py:145-152)."""
    r = torch.as_tensor(rotation, dtype=_F32, device=coordinates.device)
    c, s = torch.cos(r), torch.sin(r)
    rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    return rot @ coordinates.to(_F32)


def euler_from_quaternion(x, y, z, w):
    """Quaternion -> (roll, pitch, yaw) as float32 scalars (utils/utils.py:127-142;
    duplicated at core/robot_state_publisher.py:34-55)."""
    f = np.float32
    x, y, z, w = f(x), f(y), f(z), f(w)
    roll = np.arctan2(f(2) * (w * x + y * z), f(1) - f(2) * (x * x + y * y))
    pitch = np.arcsin(np.clip(f(2) * (w * y - z * x), f(-1), f(1)))
    yaw = np.arctan2(f(2) * (w * z + x * y), f(1) - f(2) * (y * y + z * z))
    return roll, pitch, yaw


def quaternion_from_yaw(yaw):
    """(z, w) of a pure-yaw quaternion — the inverse the reference inlines when
    publishing poses (scripts/global_path_publisher.py:46-47)."""
    h = np.float32(yaw) / np.float32(2)
    return np.sin(h), np.cos(h)


def _sanitize_scan_xy(ranges: torch.Tensor, angle_min, angle_max, rotation):
    """Polar -> rotated Cartesian with NaN/Inf handling shared by the scan
    converters (utils/utils.py:19-32)."""
    n = ranges.shape[0]
    span = torch.arange(n, device=ranges.device) * (angle_max - angle_min)
    angles = span * reciprocal_f32(n) + angle_min
    xy = rotate_coordinates(torch.stack([ranges * torch.cos(angles), ranges * torch.sin(angles)]), rotation)
    x, y = xy[0], xy[1]
    inf = torch.tensor(torch.inf, dtype=_F32, device=ranges.device)

    def fix(v, nan_fill):
        vmax = torch.where(torch.isfinite(v), v, -inf).amax()
        v = torch.where(torch.isinf(v), vmax, v)
        return torch.where(torch.isnan(v), nan_fill, v)

    # occupancy-grid variant fills NaN with 0 (utils/utils.py:28-29)
    x0, y0 = fix(x, 0.0), fix(y, 0.0)
    # xy variant fills NaN with the finite minimum (corrected; see module doc)
    xmin = fix(x, torch.where(torch.isfinite(x), x, inf).amin())
    ymin = fix(y, torch.where(torch.isfinite(y), y, inf).amin())
    return (x0, y0), (xmin, ymin)


def _scatter(xi, yi, rows: int, cols: int) -> torch.Tensor:
    """(rows, cols) grid, 100.0 where an in-range (yi, xi) lands, else 0.0.
    Out-of-range points go to a spare row that is cut off."""
    valid = (xi >= 0) & (xi < cols) & (yi >= 0) & (yi < rows)
    grid = torch.zeros((rows + 1, cols), dtype=_F32, device=xi.device)
    yi = torch.where(valid, yi, rows).long()
    xi = torch.where(valid, xi, 0).long()
    grid.index_put_((yi, xi), torch.tensor(100.0, dtype=_F32, device=xi.device))
    return grid[:rows]


@lru_cache(maxsize=None)
def make_scan_to_occupancy(map_resolution: float, map_size: float):
    """Factory for the laser-scan rasterizer (utils/utils.py:5-43).

    ``map_size`` is meters per side; the grid is ``num_cells^2`` with the
    sensor at the center. Returns occupied cells as 100.0, free as 0.0.
    """
    num_cells = int(map_size / map_resolution)
    inv, half = reciprocal_f32(map_resolution), map_size / 2

    def scan_to_occupancy(ranges, angles, rotation=0.0):
        (x, y), _ = _sanitize_scan_xy(ranges.to(_F32), angles[0], angles[1], rotation)
        xi = ((x + half) * inv).to(torch.int32)
        yi = ((y + half) * inv).to(torch.int32)
        return _scatter(xi, yi, num_cells, num_cells)

    return scan_to_occupancy


def scan_to_xy(ranges, angles, rotation=0.0):
    """Sanitized world-frame XY point lists from a scan (utils/utils.py:46-68)."""
    _, (x, y) = _sanitize_scan_xy(ranges.to(_F32), angles[0], angles[1], rotation)
    return x, y


@lru_cache(maxsize=None)
def make_xy_to_occupancy(map_resolution: float, num_cells_x: int, num_cells_y: int):
    """Factory for the XY -> occupancy scatter (utils/utils.py:71-92)."""
    inv = reciprocal_f32(map_resolution)

    def xy_to_occupancy(x, y, map_origin):
        xi = ((x.to(_F32) - map_origin[0]) * inv).to(torch.int32)
        yi = ((y.to(_F32) - map_origin[1]) * inv).to(torch.int32)
        return _scatter(xi, yi, num_cells_x, num_cells_y)

    return xy_to_occupancy


def occupancy_to_xy_fields(occ_grid, map_resolution, map_origin, occupied_value=255.0):
    """Occupancy -> (mask, x_field, y_field): the static-shape core of
    ``convert_occ_grid_to_xy_coordinates`` (utils/utils.py:95-111). The
    reference flips the grid and appends list entries per occupied cell;
    here the mask selects entries from dense coordinate fields."""
    g = torch.flipud(occ_grid)
    mask = g == occupied_value
    H, W = g.shape
    dev = g.device
    rows = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(H, W)
    cols = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    origin = torch.as_tensor(map_origin, dtype=_F32, device=dev)
    x = cols * map_resolution + origin[0]
    y = rows * map_resolution + origin[1]
    return mask, x, y


def convert_occ_grid_to_xy_coordinates(occ_grid, map_resolution, map_origin, device=None):
    """Ragged host API matching the reference's list return. ``occ_grid`` is
    an array or tensor; a NumPy grid is moved to ``device`` (``None``: the
    card, see :func:`ros2_mpc_tpu_torch.device.resolve_device`)."""
    if not torch.is_tensor(occ_grid):
        from ..device import resolve_device

        occ_grid = torch.as_tensor(np.asarray(occ_grid, dtype=np.float32), device=resolve_device(device))
    mask, x, y = occupancy_to_xy_fields(occ_grid.to(_F32), map_resolution, map_origin)
    return x[mask].tolist(), y[mask].tolist()


def convert_to_map_coordinates(occ_grid, map_resolution=0.8):
    """Per-cell meter coordinate fields centered on the grid midpoint,
    returned as ``(meter_y, meter_x)`` with negated axes — exact preserve of
    utils/utils.py:114-124 (the local-costmap -> obstacle-XY transform)."""
    h, w = occ_grid.shape
    dev = occ_grid.device
    res = torch.tensor(map_resolution, dtype=_F32, device=dev)
    origin_y = (h // 2) * res
    origin_x = (w // 2) * res
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    meter_x = -cols * res + origin_x
    meter_y = -rows * res + origin_y
    return meter_y, meter_x


def world_to_map(world_x, world_y, map_shape, map_origin, map_resolution) -> np.ndarray:
    """World meters -> map pixel (col, row-from-bottom flipped), matching
    utils/utils.py:155-158 (note the y-flip against image row order). The
    cast to int32 truncates and saturates, NaN to 0, as XLA's does."""
    f = np.float32
    mx = np.array([world_x, world_y], dtype=f)
    q = np.trunc((mx - np.asarray(map_origin, dtype=f)) / f(map_resolution)).astype(np.float64)
    info = np.iinfo(np.int32)
    mc = np.clip(np.nan_to_num(q, nan=0.0), info.min, info.max).astype(np.int64)
    # int32 arithmetic, wrapping as XLA's does
    return np.array([mc[0], map_shape[0] - mc[1]]).astype(np.int32)


def map_to_world(path, map_shape, map_origin, map_resolution):
    """Map pixel path ``(P, 2)`` (row, col) -> world XY ``(P, 2)``
    (utils/utils.py:161-169). Returns None on an empty path as the reference
    does."""
    path = np.asarray(path)
    if path.ndim != 2 or path.shape[0] == 0:
        return None
    flipped = np.column_stack((path[:, 1], map_shape[0] - path[:, 0]))
    return flipped * map_resolution + np.asarray(map_origin)

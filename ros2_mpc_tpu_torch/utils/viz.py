"""Offline visualization — the port's own copy of
:mod:`ros2_mpc_tpu.utils.viz` (NumPy and zlib only), the stand-in for the
reference's RViz dashboard
(config/rviz_config.rviz displays /map, /scan, /goal_pose, /smoothed_plan and
the costmaps; the global costmap node even pops a cv2.imshow debug window,
core/global_costmap_publisher.py:40-42). Headless here: render the world,
plan, and robot trace to a PNG for CI artifacts and debugging."""

from __future__ import annotations

from typing import Optional

import numpy as np


def render_world(
    map_image: np.ndarray,  # trinary pgm convention
    map_info: dict,
    robot_trace: Optional[np.ndarray] = None,  # (T, >=2) world xy
    path_xy: Optional[np.ndarray] = None,  # (P, 2) world xy
    goal_xy=None,
    out_path: Optional[str] = None,
    scan_xy: Optional[np.ndarray] = None,
):
    """Compose an RGB image (H, W, 3) of the world; save if out_path given."""
    img = np.asarray(map_image)
    h, w = img.shape
    rgb = np.zeros((h, w, 3), dtype=np.uint8)
    rgb[img == 254] = (255, 255, 255)  # free
    rgb[img == 205] = (160, 160, 160)  # unknown
    rgb[img == 0] = (30, 30, 30)  # walls

    res = float(map_info["resolution"])
    ox, oy = float(map_info["origin"][0]), float(map_info["origin"][1])

    def world_to_px(xy):
        xy = np.atleast_2d(np.asarray(xy, dtype=float))
        col = ((xy[:, 0] - ox) / res).astype(int)
        row = h - 1 - ((xy[:, 1] - oy) / res).astype(int)
        ok = (col >= 0) & (col < w) & (row >= 0) & (row < h)
        return row[ok], col[ok]

    def stamp(rows, cols, color, size=0):
        for dr in range(-size, size + 1):
            for dc in range(-size, size + 1):
                rr = np.clip(rows + dr, 0, h - 1)
                cc = np.clip(cols + dc, 0, w - 1)
                rgb[rr, cc] = color

    if scan_xy is not None and len(scan_xy):
        stamp(*world_to_px(scan_xy), (120, 180, 255))
    if path_xy is not None and len(path_xy):
        stamp(*world_to_px(path_xy), (60, 120, 255))
    if robot_trace is not None and len(robot_trace):
        stamp(*world_to_px(np.asarray(robot_trace)[:, :2]), (220, 60, 60))
        stamp(*world_to_px(np.asarray(robot_trace)[-1:, :2]), (255, 0, 0), size=2)
    if goal_xy is not None:
        stamp(*world_to_px([goal_xy]), (0, 180, 0), size=2)

    if out_path is not None:
        _write_png(out_path, rgb)
    return rgb


def _write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal PNG writer (stdlib zlib; no imaging deps in the hot path)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as fh:
        fh.write(png)

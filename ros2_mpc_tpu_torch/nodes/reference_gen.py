"""Reference-trajectory and obstacle extraction helpers for the control-loop
nodes — the port's own copy of :mod:`ros2_mpc_tpu.nodes.reference_gen`
(NumPy on the host; the parity-mode :func:`get_obstacles` runs the port's
grid ops on a device), behavior-parity rebuilds of the free functions in
ros2_mpc/scripts/path_follower_local_planner.py and
ros2_mpc/scripts/point_follower_local_planner.py.

All documented reference quirks are preserved (SURVEY.md ledger):
* omega finite-difference is Delta-heading / 2 and velocity is
  ||Delta xy|| / dt * 2 (path_follower:14-23);
* obstacle vectors pad by broadcasting the first obstacle; an empty scan
  yields sentinel obstacles at 100 m (path_follower:101-131, quirk #10);
* the tracking node's occupancy math (``1 - grid`` with grid in {0, 100})
  can never equal 0, so its obstacle extraction *always* degenerates to the
  100 m sentinels (path_follower:102,106 — on top of the obstacle cost being
  discarded, quirk #1). ``normalized=True`` gives the point-follower variant
  (``1 - grid/100``, point_follower:89) which does find obstacles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import grid as gridops


def _clamped_window(profile: np.ndarray, start: int, length: int) -> np.ndarray:
    """``length`` consecutive samples of ``profile`` from ``start``, holding
    the final sample once the window runs off the end."""
    profile = np.asarray(profile, dtype=float).reshape(len(profile), -1)
    rows = np.minimum(start + np.arange(length), len(profile) - 1)
    return profile[rows]


def path_motion_profile(waypoints: np.ndarray, dt: float):
    """Per-waypoint (yaw, speed, turn-rate) finite differences along a path.

    Contract (quirk-faithful to path_follower_local_planner.py:14-23): speed
    is the segment length over ``dt`` *doubled*; turn-rate is the yaw
    difference *halved* (the reference's empirical gains). Yaw and speed
    repeat their final sample to match the waypoint count; turn-rate stays
    one sample short — :func:`tracking_reference_window` clamps it.
    """
    steps = np.diff(np.asarray(waypoints, dtype=float), axis=0)
    yaw = np.arctan2(steps[:, 1], steps[:, 0])
    yaw = np.concatenate([yaw, yaw[-1:]])
    turn_rate = np.diff(yaw) / 2.0
    speed = np.hypot(steps[:, 0], steps[:, 1]) / dt * 2.0
    speed = np.concatenate([speed, speed[-1:]])
    return yaw, speed, turn_rate


def path_yaw_profile(waypoints: np.ndarray) -> np.ndarray:
    """Segment yaw per waypoint, final sample repeated — the heading the
    global path publisher attaches to each pose
    (scripts/global_path_publisher.py:13-25)."""
    yaw, _, _ = path_motion_profile(np.asarray(waypoints, dtype=float), dt=1.0)
    return yaw


def tracking_reference_window(state, goal, waypoints, yaw, speed, turn_rate, horizon: int):
    """Reference window (pxf, puf) for the tracking MPC, flattened to the
    column-vector layout the solver's parameter pack expects.

    Contract (path_follower_local_planner.py:26-73):
    * the window anchors at the waypoint nearest the robot;
    * within 0.5 m of the final waypoint the state reference collapses to
      ``horizon`` copies of the goal pose (terminal latch);
    * windows running past the end of any profile hold its final sample.
    """
    waypoints = np.asarray(waypoints, dtype=float).reshape(-1, 2)
    pos = np.asarray(state, dtype=float)[:2]
    anchor = int(np.argmin(np.linalg.norm(waypoints - pos, axis=1)))

    if np.linalg.norm(pos - waypoints[-1]) < 0.5:
        x_ref = np.tile(np.asarray(goal, dtype=float)[:3], horizon)
    else:
        x_ref = np.column_stack(
            (
                _clamped_window(waypoints, anchor, horizon),
                _clamped_window(np.asarray(yaw).reshape(-1), anchor, horizon),
            )
        ).ravel()

    u_ref = np.column_stack(
        (
            _clamped_window(np.asarray(speed).reshape(-1), anchor, horizon),
            _clamped_window(np.asarray(turn_rate).reshape(-1), anchor, horizon),
        )
    ).ravel()
    return x_ref.reshape(-1, 1), u_ref.reshape(-1, 1)


# Reference-parity aliases (the upstream helper names; compat surface).
get_headings = path_motion_profile
get_path_headings = path_yaw_profile


def get_reference_trajectory(x0, goal, path_xy, path_heading, path_velocity, path_omega, N):
    """Reference-parity alias for :func:`tracking_reference_window` with the
    upstream argument order."""
    return tracking_reference_window(
        x0, goal, path_xy, path_heading, path_velocity, path_omega, N
    )


def get_goal_for_mpc(path_xy, path_heading, goal, pos, lookahead_dist: float = 0.5):
    """Carrot selection for point stabilization
    (point_follower_local_planner.py:16-30): nearer than the lookahead, chase
    the true goal pose (yaw = goal[4] mod 2pi); otherwise the first path point
    farther than the lookahead."""
    path_heading = np.asarray(path_heading).reshape(-1)
    if np.linalg.norm(goal[:2] - pos[:2]) < lookahead_dist:
        return np.array([goal[0], goal[1], goal[4] % (2 * np.pi)])
    dist = np.linalg.norm(path_xy - pos[:2], axis=1)
    idx = np.where(dist > lookahead_dist)[0]
    idx = int(np.argmin(dist)) if len(idx) == 0 else int(idx[0])
    return np.append(path_xy[idx], path_heading[idx] % (2 * np.pi))


def get_obstacles(
    scan_data,
    angles,
    size,
    resolution,
    pos,
    ori,
    n_obstacle_points: int,
    normalized: bool,
    device=None,
):
    """Obstacle XY vectors (fixed length) from a laser scan
    (path_follower_local_planner.py:101-131 / point_follower:88-118).

    ``normalized=False`` reproduces the tracking node's broken ``1 - grid``
    selection (always sentinels); ``normalized=True`` the working
    ``1 - grid/100`` variant. The grid ops run on ``device`` (``None``: the
    card); the selection and padding on the host."""
    dev = resolve_device(device)
    on_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=dev)  # noqa: E731
    raster = gridops.make_scan_to_occupancy(resolution, size * 2)
    occ = raster(on_dev(scan_data), on_dev(angles)).cpu().numpy()
    occ = (1 - occ / 100.0) if normalized else (1 - occ)
    occ = np.rot90(occ, k=2)
    # NOTE: the reference binds the *first* return (meter_y) to its local
    # ``x`` (path_follower:104 vs utils/utils.py:124) — mirrored exactly.
    x_field, y_field = gridops.convert_to_map_coordinates(on_dev(occ), resolution)
    x_field, y_field = x_field.cpu().numpy(), y_field.cpu().numpy()
    obstacles_idx = np.where(occ == 0)
    obs_x, obs_y = x_field[obstacles_idx], y_field[obstacles_idx]
    rotated = gridops.rotate_coordinates(on_dev(np.array([obs_x, obs_y])), float(ori[2])).cpu().numpy()
    rotated[0, :] += pos[0]
    rotated[1, :] += pos[1]
    x_obs, y_obs = rotated[0], rotated[1]
    ones = np.ones(n_obstacle_points)
    try:
        x_arr = ones * x_obs[0]
        x_arr[: len(x_obs)] = x_obs[:n_obstacle_points]
        y_arr = ones * y_obs[0]
        y_arr[: len(y_obs)] = y_obs[:n_obstacle_points]
    except IndexError:
        # quirk #10: empty scan -> phantom obstacles at 100 m
        x_arr = ones * 100.0
        y_arr = ones * 100.0
    return x_arr, y_arr


def mapped_structure_mask(map_image: np.ndarray, dilate_cells: int = 3) -> np.ndarray:
    """Boolean mask of cells on (or within ``dilate_cells`` of) mapped
    structure, from a MapSubscriber-processed binary image (occupied 255).

    Used to restrict the MPC's live obstacle set to *unmapped* returns: the
    global planner + costmap inflation already own the static walls, and
    feeding wall returns to the soft obstacle cost creates potential-field
    equilibria that stall the solver in doorways and wall-adjacent goals.
    The dilation absorbs localization error and scan/grid discretization."""
    occ = np.asarray(map_image) > 0
    if dilate_cells <= 0:
        return occ
    out = occ.copy()
    padded = np.pad(occ, dilate_cells, mode="edge")
    h, w = occ.shape
    for dr in range(-dilate_cells, dilate_cells + 1):
        for dc in range(-dilate_cells, dilate_cells + 1):
            out |= padded[
                dilate_cells + dr : dilate_cells + dr + h,
                dilate_cells + dc : dilate_cells + dc + w,
            ]
    return out


def scan_to_world_obstacles(
    scan_data,
    angles,
    size,
    pos,
    yaw,
    n_obstacle_points: int,
    static_mask: np.ndarray | None = None,
    map_info: dict | None = None,
):
    """Corrected obstacle extraction: world-frame obstacle points straight
    from scan polar geometry, restricted to the local costmap window.

    The reference's pipeline (rasterize -> rot90 -> meter fields -> gather ->
    rotate) additionally *transposes* the cloud because it binds
    ``convert_to_map_coordinates``'s ``(meter_y, meter_x)`` return to
    ``x, y`` (path_follower:104 vs utils/utils.py:124) — harmless there since
    the obstacle cost is never active (quirk #1), but fatal once it is. This
    function is the geometrically-correct default for the live nodes;
    :func:`get_obstacles` remains the quirk-faithful variant."""
    r = np.asarray(scan_data, dtype=float)
    n = len(r)
    beam = np.arange(n) * (angles[1] - angles[0]) / n + angles[0]
    with np.errstate(invalid="ignore"):
        wx = pos[0] + r * np.cos(yaw + beam)
        wy = pos[1] + r * np.sin(yaw + beam)
    keep = np.isfinite(wx) & np.isfinite(wy)
    keep &= (np.abs(wx - pos[0]) <= size) & (np.abs(wy - pos[1]) <= size)
    wx, wy = wx[keep], wy[keep]
    if static_mask is not None and map_info is not None and len(wx):
        # Keep only *unmapped* returns (see mapped_structure_mask).
        res = float(map_info["resolution"])
        origin = np.asarray(map_info["origin"], dtype=float)
        h, w = static_mask.shape
        # floor, not int-truncation: points just past the left/bottom map edge
        # must fall OUTSIDE (col/row -1), not alias into border cell 0
        col = np.floor((wx - origin[0]) / res).astype(int)
        row = h - 1 - np.floor((wy - origin[1]) / res).astype(int)
        inside = (col >= 0) & (col < w) & (row >= 0) & (row < h)
        mapped = np.zeros(len(wx), dtype=bool)
        mapped[inside] = static_mask[row[inside], col[inside]]
        wx, wy = wx[~mapped], wy[~mapped]
    # When the scan returns more points than the parameter vector holds, keep
    # the *nearest* ones — they carry the collision risk. Truncating in beam
    # order instead (the reference's layout) keeps a half-view whose covered
    # side swings as the robot rotates; with live obstacle costs that feedback
    # oscillates the solver in narrow corridors.
    if len(wx) > n_obstacle_points:
        nearest = np.argpartition(np.hypot(wx - pos[0], wy - pos[1]), n_obstacle_points - 1)
        wx, wy = wx[nearest[:n_obstacle_points]], wy[nearest[:n_obstacle_points]]
    # Pad with far sentinels — NOT the reference's first-obstacle broadcast
    # (quirk #10), which multiplies one real point's soft-cost weight ~160x
    # and repels the robot from phantom mass once obstacle costs are live.
    x_arr = np.full(n_obstacle_points, 100.0)
    y_arr = np.full(n_obstacle_points, 100.0)
    x_arr[: len(wx)] = wx
    y_arr[: len(wy)] = wy
    return x_arr, y_arr


class StaticStructureFilter:
    """Per-node cache of the dilated mapped-structure mask (corrected-mode
    followers): recomputed only when a new /map message arrives."""

    def __init__(self, map_node, dilate_cells: int = 3):
        self.map_node = map_node
        self.dilate_cells = dilate_cells
        self._source = None
        self._mask = None
        self._info = None

    def current(self):
        """(mask, map_info) or (None, None) before the first map message."""
        img, info = self.map_node.get_map()
        if img is None:
            return None, None
        if img is not self._source:
            self._mask = mapped_structure_mask(img, self.dilate_cells)
            self._source = img
            self._info = info
        return self._mask, self._info


def slew_limited_command(u, u_last, slew: float):
    """The reference's per-tick slew limiter, including its quirk of adding
    +slew to *both* channels regardless of error sign
    (path_follower_local_planner.py:197-203, quirk #6). Returns
    (v_cmd, w_cmd, u_last_next)."""
    u = np.asarray(u, dtype=float)
    if np.linalg.norm(u - u_last) > slew:
        return float(u_last[0]) + slew, float(u_last[1]) + slew, u
    return float(u[0]), float(u[1]), u

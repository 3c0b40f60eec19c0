"""Global path publisher node — behavior-parity rebuild of
ros2_mpc/scripts/global_path_publisher.py:70-135 (call stack SURVEY.md §3.3):
goal + map + odom -> dilate map -> A* -> Savitzky-Golay smoothing ->
world-frame path with heading quaternions on 'smoothed_plan'. Keeps the
reference's empty-path fallback to the previous path and its
"Goal Unreachable!" handling.

Port of :mod:`ros2_mpc_tpu.nodes.global_path_publisher`: the map dilation
runs on ``device`` (``None``: the card), the scan stamping and the A*
search on the host, as in the JAX package."""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import Params
from ..device import resolve_device
from ..ops import costmap as costmapops
from ..ops import grid as gridops
from ..planner import AStarPlanner2
from .bus import MessageBus
from .reference_gen import path_yaw_profile, scan_to_world_obstacles
from .topics import GoalSubscriber, LaserSubscriber, MapSubscriber, OdomSubscriber, PathPublisher

log = logging.getLogger("global_path_publisher")


class GlobalPathPublisherNode:
    """``use_scan_obstacles=True`` (the corrected default) merges live lidar
    returns into the planning map before A*, so unmapped obstacles re-route
    the global plan. The reference computes a merged global costmap
    (core/global_costmap_publisher.py) but nothing ever consumes it — its
    planner sees only the static map and its MPC obstacle cost is dead, so
    an unmapped obstacle is simply hit. ``False`` restores that behavior."""

    def __init__(
        self, bus: MessageBus, params: Params = Params(), use_scan_obstacles: bool = True, device=None
    ):
        self.params = params
        self.device = resolve_device(device)
        self.path_publisher = PathPublisher(bus)
        self.map_node = MapSubscriber(bus)
        self.odom_node = OdomSubscriber(bus)
        self.goal_listener = GoalSubscriber(bus)
        self.laser_node = LaserSubscriber(bus)
        self.use_scan_obstacles = use_scan_obstacles
        self.planner = AStarPlanner2()
        self.path_last = None

    def _stamp_scan_obstacles(self, map_image, map_info, pos, ori):
        """Mark lidar returns (world frame) as occupied cells, with a small
        square inflation so A* keeps clearance."""
        scan, angles = self.laser_node.get_scan()
        if scan is None or ori is None:
            return map_image
        ox, oy = scan_to_world_obstacles(
            scan, angles, self.params.costmap_size, pos, ori[2], self.params.n_obstacle_points
        )
        real = (np.abs(ox) < 50) & (np.abs(oy) < 50)
        if not np.any(real):
            return map_image
        res = map_info["resolution"]
        H = map_image.shape[0]
        col = ((ox[real] - map_info["origin"][0]) / res).astype(int)
        row = H - ((oy[real] - map_info["origin"][1]) / res).astype(int)
        # Inflate to the MPC's *effective* repulsion radius (~2x the Gaussian
        # inflation_radius): corridors narrower than what the soft costs will
        # let the robot traverse must not be planned through.
        r_inf = max(1, int(2.0 * self.params.inflation_radius / res))
        out = map_image.copy()
        for dr in range(-r_inf, r_inf + 1):
            for dc in range(-r_inf, r_inf + 1):
                rr = np.clip(row + dr, 0, H - 1)
                cc = np.clip(col + dc, 0, map_image.shape[1] - 1)
                out[rr, cc] = 255
        return out

    def tick(self) -> dict:
        p = self.params
        goal = self.goal_listener.get_goal()
        if goal is None:
            return {"status": "waiting_for_goal"}
        goal_xy = goal[:2]
        map_image, map_info = self.map_node.get_map()
        pos, _ = self.odom_node.get_states()
        if map_image is None or pos is None:
            return {"status": "waiting_for_map_or_odom"}

        # dilate x2 with the reference's kernel 8 (quirk #5: named 'erode')
        on_dev = torch.as_tensor(np.ascontiguousarray(map_image, dtype=np.float32), device=self.device)
        map_image = costmapops.erode_image(on_dev, p.map_dilation_kernel).cpu().numpy()
        if self.use_scan_obstacles:
            map_image = self._stamp_scan_obstacles(map_image, map_info, pos, self.odom_node.orientation)
        robot_on_map = gridops.world_to_map(pos[0], pos[1], map_image.shape, map_info["origin"], map_info["resolution"])
        start = (int(robot_on_map[1]), int(robot_on_map[0]))
        goal_on_map = gridops.world_to_map(
            goal_xy[0], goal_xy[1], map_image.shape, map_info["origin"], map_info["resolution"]
        )
        goal_rc = (int(goal_on_map[1]), int(goal_on_map[0]))

        path = self.planner.get_path(start, goal_rc, map_image)
        if len(path) == 0:
            log.warning("Path empty. Using last path as reference!")
            path = self.path_last
        else:
            self.path_last = path
        if self.path_last is None:
            log.error("Goal Unreachable!")
            return {"status": "unreachable"}

        path_xy = gridops.map_to_world(path, map_image.shape, map_info["origin"], map_info["resolution"])
        if path_xy is None:
            log.error("Goal Unreachable!")
            return {"status": "unreachable"}
        try:
            path_heading = path_yaw_profile(path_xy)
            self.path_publisher.publish_path(path_xy, path_heading)
            if len(path_xy) <= 5:
                log.info("Goal Reached!")
                return {"status": "goal_reached", "path_xy": path_xy}
        except IndexError:
            log.info("Goal Reached!")
            return {"status": "goal_reached"}
        return {"status": "published", "path_xy": path_xy}


def main(argv=None):
    """Standalone global-planner process: replan + publish /smoothed_plan at
    the reference's ~1 Hz refresh (global_path_publisher.py:70-135)."""
    from .live import single_node_main

    return single_node_main(
        lambda bus, params, device: GlobalPathPublisherNode(bus, params, device=device),
        "global_planner", lambda p: p.path_refresh_period, argv=argv,
    )


if __name__ == "__main__":
    main()

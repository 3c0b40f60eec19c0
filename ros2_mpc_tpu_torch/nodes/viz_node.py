"""Live observability node — the port's own copy of
:mod:`ros2_mpc_tpu.nodes.viz_node` (host code over bus topics, which are
NumPy), the running-stack counterpart of the
reference's RViz dashboard (config/rviz_config.rviz displays /map, /scan,
/goal_pose, /smoothed_plan and the costmaps) and of the global costmap
node's ``cv2.imshow`` debug window (core/global_costmap_publisher.py:40-42).

The node is a plain bus subscriber: it composes whatever is currently on
/map, /scan, /robot_position, /goal_pose and smoothed_plan into one RGB
frame (utils/viz.py) and writes ``latest.png`` (atomically, via rename) plus
an optional bounded frame history. Because it reads only bus topics it works
unchanged against the simulator or a physical robot over the DDS bridge —
point any image viewer (or a browser auto-refresh) at the output directory.
"""

from __future__ import annotations

import os
import tempfile
from collections import deque
from typing import Optional

import numpy as np

from ..utils import viz
from .bus import MessageBus
from .topics import GoalSubscriber, LaserSubscriber, MapSubscriber, OdomSubscriber, RobotController


class LiveVizNode:
    """Periodic frame renderer over live topics."""

    def __init__(
        self,
        bus: MessageBus,
        out_dir: Optional[str] = None,
        trace_len: int = 2000,
        history: int = 0,
    ):
        if out_dir is None:
            out_dir = os.path.join(tempfile.gettempdir(), "cuda_mpc_viz")
        self.out_dir = out_dir
        self.history = history
        self.map_node = MapSubscriber(bus)
        self.odom_node = OdomSubscriber(bus)
        self.laser_node = LaserSubscriber(bus)
        self.goal_node = GoalSubscriber(bus)
        self.path_node = RobotController(bus)
        self.trace: deque = deque(maxlen=trace_len)
        self.frames = 0
        os.makedirs(out_dir, exist_ok=True)

    def _scan_world_xy(self, pos, yaw):
        ranges, angles = self.laser_node.get_scan()
        if ranges is None:
            return None
        n = len(ranges)
        beam = np.arange(n) * (angles[1] - angles[0]) / n + angles[0]
        with np.errstate(invalid="ignore"):
            wx = pos[0] + ranges * np.cos(yaw + beam)
            wy = pos[1] + ranges * np.sin(yaw + beam)
        ok = np.isfinite(wx) & np.isfinite(wy)
        return np.stack([wx[ok], wy[ok]], axis=1)

    def tick(self) -> dict:
        map_image, map_info = self.map_node.get_map()
        pos, ori = self.odom_node.get_states()
        if map_image is None or pos is None:
            return {"status": "waiting_for_topics"}
        self.trace.append((float(pos[0]), float(pos[1])))

        # MapSubscriber images are binary (occupied 255 / free 0); recolor to
        # the trinary pgm convention utils/viz.py renders.
        trinary = np.where(np.asarray(map_image) > 0, 0, 254).astype(np.uint8)
        goal = self.goal_node.get_goal()
        rgb = viz.render_world(
            trinary,
            {"resolution": map_info["resolution"], "origin": np.asarray(map_info["origin"])},
            robot_trace=np.asarray(self.trace),
            path_xy=self.path_node.path_xy,
            goal_xy=None if goal is None else goal[:2],
            scan_xy=self._scan_world_xy(pos, float(ori[2])),
        )
        tmp = os.path.join(self.out_dir, ".latest.png.tmp")
        viz._write_png(tmp, rgb)
        os.replace(tmp, os.path.join(self.out_dir, "latest.png"))
        if self.history:
            viz._write_png(
                os.path.join(self.out_dir, f"frame_{self.frames % self.history:04d}.png"), rgb
            )
        self.frames += 1
        return {"status": "rendered", "frames": self.frames}

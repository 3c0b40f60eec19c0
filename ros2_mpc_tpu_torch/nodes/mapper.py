"""Occupancy-mapper node: build a map from scans + poses, live on the bus —
port of :mod:`ros2_mpc_tpu.nodes.mapper`.

The reference's map is an offline cartographer artifact; this node closes
that gap for the known-pose case (the tf/odometry chain the stack already
consumes): every (scan, pose) pair folds into a log-odds grid on ``device``
(ops/mapping.py), and the thresholded result publishes as a standard
OccupancyGrid on ``mapped_map`` — the same message shape the map server
emits, so planners and costmap nodes can consume a LIVE map instead of a
stale file. Run it on the wall-clock graph or tick it in the sim loop.

A tick copies the pose and the scan to the device in one transfer; the
log-odds grid never leaves it. :meth:`probability`, :meth:`occupancy` and
:meth:`publish` read the grid back once a call; what goes on the bus is
NumPy."""

from __future__ import annotations

import numpy as np
import torch

from ..config import Params
from ..device import resolve_device
from ..ops.mapping import logodds_update, occupancy_probability
from .bus import MapMetaData, MessageBus, OccupancyGrid
from .topics import LaserSubscriber, OdomSubscriber


class MapperNode:
    def __init__(
        self,
        bus: MessageBus,
        params: Params = Params(),
        size_m: float = 8.0,
        resolution: float = 0.05,
        origin_xy=None,
        max_range: float = 3.5,
        occupied_threshold: float = 0.65,
        free_threshold: float = 0.35,
        topic: str = "mapped_map",
        device=None,
    ):
        self.device = dev = resolve_device(device)
        self.bus = bus
        self.params = params
        self.resolution = float(resolution)
        n = int(round(size_m / resolution))
        self.shape = (n, n)
        if origin_xy is None:  # the grid centered on the world origin
            origin_xy = (-size_m / 2.0, -size_m / 2.0)
        self.origin = np.asarray(origin_xy, dtype=float)
        self._origin_dev = torch.tensor(self.origin, dtype=torch.float32, device=dev)
        self.max_range = float(max_range)
        self.occupied_threshold = float(occupied_threshold)
        self.free_threshold = float(free_threshold)
        self.topic = topic
        self.L = torch.zeros(self.shape, dtype=torch.float32, device=dev)
        self.n_scans = 0
        self.scan_sub = LaserSubscriber(bus)
        self.odom_sub = OdomSubscriber(bus)

    def tick(self) -> dict:
        ranges, angle_span = self.scan_sub.get_scan()
        pos, ori = self.odom_sub.get_states()
        if ranges is None or pos is None:
            return {"status": "waiting_for_sensors"}
        # x, y, yaw, angle_min, angle_max, then the ranges: one host-to-device copy
        host = np.concatenate(
            [np.array([pos[0], pos[1], ori[2], angle_span[0], angle_span[1]]), np.asarray(ranges)]
        ).astype(np.float32)
        packed = torch.from_numpy(host).to(self.device)
        self.L = logodds_update(
            self.L,
            packed[:3],
            packed[5:],
            len(ranges),
            packed[3],
            packed[4],
            self._origin_dev,
            self.resolution,
            self.max_range,
        )
        self.n_scans += 1
        return {"status": "ok", "n_scans": self.n_scans}

    def probability(self) -> np.ndarray:
        """(H, W) p(occupied), row 0 = top (PGM convention)."""
        return occupancy_probability(self.L).cpu().numpy()

    def occupancy(self) -> np.ndarray:
        """Trinary grid in the map-server convention: 100 occupied, 0 free,
        -1 unknown (never observed / inconclusive)."""
        p = self.probability()
        out = np.full(self.shape, -1, dtype=np.int8)
        out[p >= self.occupied_threshold] = 100
        out[p <= self.free_threshold] = 0
        return out

    def publish(self):
        """OccupancyGrid on ``self.topic`` (ROS row order: flipud of PGM)."""
        occ = self.occupancy()
        H, W = occ.shape
        self.bus.publish(
            self.topic,
            OccupancyGrid(
                data=np.flipud(occ),
                info=MapMetaData(
                    resolution=self.resolution,
                    width=W,
                    height=H,
                    origin_x=float(self.origin[0]),
                    origin_y=float(self.origin[1]),
                ),
            ),
        )

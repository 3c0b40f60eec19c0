"""Costmap publisher nodes — port of :mod:`ros2_mpc_tpu.nodes.costmap_nodes`,
behavior-parity rebuilds of ros2_mpc/core/local_costmap_publisher.py:12-42,
ros2_mpc/core/global_costmap_publisher.py:9-50 and
ros2_mpc/core/global_costmap_publisher_nav.py:11-59 (call stack SURVEY.md §3.5).

The numba scan rasterizer + OpenCV dilation pipelines run as the port's grid
and costmap ops on ``device`` (``None``: the card); the published costmap
comes back to the host as NumPy."""

from __future__ import annotations

import numpy as np
import torch

from ..config import Params
from ..device import resolve_device
from ..ops import costmap as costmapops
from ..ops import grid as gridops
from ..utils import pgm
from .bus import MessageBus
from .topics import (
    GlobalCostmapPublisher,
    LaserSubscriber,
    LocalCostmapPublisher,
    MapSubscriber,
    OdomSubscriber,
)


def _on(device, a) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)


class LocalCostmapNode:
    """scan -> occupancy (rotated by yaw) -> 10x10 dilation -> /my_local_costmap
    with origin at robot - size/2 (core/local_costmap_publisher.py)."""

    def __init__(self, bus: MessageBus, params: Params = Params(), device=None):
        self.params = params
        self.device = resolve_device(device)
        self.scan_subscriber = LaserSubscriber(bus)
        self.odom_subscriber = OdomSubscriber(bus)
        self.costmap_publisher = LocalCostmapPublisher(bus)
        self._raster = gridops.make_scan_to_occupancy(
            params.resolution, params.costmap_size * 2
        )

    def tick(self) -> dict:
        p = self.params
        scan, angles = self.scan_subscriber.get_scan()
        if scan is None:
            return {"status": "waiting_for_scan"}
        position, orientation = self.odom_subscriber.get_states()
        if position is None:
            return {"status": "waiting_for_odom"}
        occ = self._raster(_on(self.device, scan), _on(self.device, angles), float(orientation[2]))
        inflated = costmapops.dilate(occ, p.costmap_dilation_kernel, 1).to(torch.uint8).cpu().numpy()
        self.costmap_publisher.publish_costmap(inflated, p.costmap_size * 2, position)
        return {"status": "published", "costmap": inflated}


class GlobalCostmapNode:
    """scan XY + map XY -> merged scatter -> dilation -> /my_global_costmap.

    ``reload_map_every_tick=False`` is the /map-topic variant
    (core/global_costmap_publisher.py — its cv2.imshow debug window is
    dropped); True mirrors the nav variant that re-reads the PGM each
    iteration (core/global_costmap_publisher_nav.py:23-33)."""

    def __init__(
        self,
        bus: MessageBus,
        params: Params = Params(),
        map_pgm_path: str | None = None,
        map_yaml_path: str | None = None,
        reload_map_every_tick: bool = False,
        device=None,
    ):
        self.params = params
        self.device = resolve_device(device)
        self.scan_subscriber = LaserSubscriber(bus)
        self.odom_subscriber = OdomSubscriber(bus)
        self.map_subscriber = MapSubscriber(bus)
        self.publisher = GlobalCostmapPublisher(bus)
        self.map_pgm_path = map_pgm_path
        self.map_yaml_path = map_yaml_path
        self.reload_map_every_tick = reload_map_every_tick
        self._file_map = None
        self._file_info = None

    def _map_from_file(self):
        if self._file_map is None or self.reload_map_every_tick:
            img = pgm.read_pgm(self.map_pgm_path)
            meta = pgm.load_map_yaml(self.map_yaml_path)
            # occupied (0) -> 255 landmark cells, free -> 0 (matching the
            # MapSubscriber binary convention used by the merge below)
            binary = np.where(img == 0, 255, 0).astype(np.uint8)
            self._file_map = np.flipud(binary)
            self._file_info = {
                "resolution": meta["resolution"],
                "origin": np.array(meta["origin"][:2]),
            }
        return self._file_map, self._file_info

    def tick(self) -> dict:
        p = self.params
        scan, angles = self.scan_subscriber.get_scan()
        if scan is None:
            return {"status": "waiting_for_scan"}
        position, orientation = self.odom_subscriber.get_states()
        if position is None:
            return {"status": "waiting_for_odom"}
        if self.map_pgm_path is not None:
            map_image, map_info = self._map_from_file()
        else:
            map_image, map_info = self.map_subscriber.get_map()
        if map_image is None:
            return {"status": "waiting_for_map"}

        # scan -> world XY (rotated by yaw, translated to the robot)
        dev = self.device
        sx, sy = gridops.scan_to_xy(_on(dev, scan), _on(dev, angles), float(orientation[2]))
        sx = sx.cpu().numpy() + position[0]
        sy = sy.cpu().numpy() + position[1]
        # map occupied cells -> world XY
        mx, my = gridops.convert_occ_grid_to_xy_coordinates(
            map_image, map_info["resolution"], map_info["origin"], device=dev
        )
        all_x = np.concatenate([sx, np.asarray(mx)])
        all_y = np.concatenate([sy, np.asarray(my)])
        scatter = gridops.make_xy_to_occupancy(
            float(map_info["resolution"]), int(map_image.shape[0]), int(map_image.shape[1])
        )
        occ = scatter(_on(dev, all_x), _on(dev, all_y), _on(dev, map_info["origin"]))
        inflated = costmapops.dilate(occ, p.costmap_dilation_kernel, 1).cpu().numpy().astype(np.uint8)
        self.publisher.publish_costmap(inflated, map_info["origin"])
        return {"status": "published", "costmap": inflated}


def local_main(argv=None):
    """Standalone ~10 Hz local-costmap process (local_costmap_publisher.py:38)."""
    from .live import single_node_main

    return single_node_main(
        lambda bus, params, device: LocalCostmapNode(bus, params, device=device),
        "local_costmap", lambda p: p.local_costmap_period, argv=argv,
    )


def global_main(argv=None):
    """Standalone global-costmap process (global_costmap_publisher.py:9-50)."""
    from .live import single_node_main

    return single_node_main(
        lambda bus, params, device: GlobalCostmapNode(bus, params, device=device),
        "global_costmap", lambda p: p.local_costmap_period, argv=argv,
    )


def global_nav_main(argv=None):
    """Standalone file-reload global-costmap process — the nav variant that
    re-reads the map PGM every iteration (global_costmap_publisher_nav.py:11-59).
    The map files: ``TPU_MPC_MAP_PGM``/``TPU_MPC_MAP_YAML`` (the JAX
    package's variables), else the repository's ``maps/map_synthetic``."""
    import os

    from .live import single_node_main

    maps_dir = os.path.join(os.path.dirname(__file__), "..", "..", "maps")
    pgm_path = os.environ.get("TPU_MPC_MAP_PGM", os.path.join(maps_dir, "map_synthetic.pgm"))
    yaml_path = os.environ.get("TPU_MPC_MAP_YAML", os.path.join(maps_dir, "map_synthetic.yaml"))
    return single_node_main(
        lambda bus, params, device: GlobalCostmapNode(
            bus, params,
            map_pgm_path=pgm_path, map_yaml_path=yaml_path,
            reload_map_every_tick=True, device=device,
        ),
        "global_costmap_nav",
        lambda p: p.local_costmap_period,
        argv=argv,
    )

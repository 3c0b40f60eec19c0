"""Map server node — the port's own copy of :mod:`ros2_mpc_tpu.nodes.map_server`,
a behavior-parity rebuild of ros2_mpc/core/map_server.py:
load the PGM map, threshold to ROS occupancy values (0 -> 100 occupied,
254/205 -> 0 free), int8, flipud, and (re)publish /map when the subscriber
count changes. PGM I/O is stdlib (utils/pgm.py) instead of OpenCV."""

from __future__ import annotations

import numpy as np

from ..utils import pgm
from .bus import MessageBus
from .topics import MapServer as MapServerPublisher


class MapServerNode:
    def __init__(
        self,
        bus: MessageBus,
        map_pgm_path: str | None = None,
        map_yaml_path: str | None = None,
        map_image: np.ndarray | None = None,
        map_info: dict | None = None,
    ):
        self.publisher = MapServerPublisher(bus)
        if map_image is None:
            img = pgm.read_pgm(map_pgm_path)
            meta = pgm.load_map_yaml(map_yaml_path)
            map_info = {"resolution": meta["resolution"], "origin": meta["origin"]}
        else:
            img = np.asarray(map_image)
            map_info = map_info or dict(pgm.DEFAULT_MAP_INFO)
        # core/map_server.py:16-20 thresholding
        out = img.astype(np.int16).copy()
        out[out == 0] = 100
        out[out == 254] = 0
        out[out == 205] = 0
        self.map_image = np.flipud(out.astype(np.int8))
        self.map_info = map_info
        self._last_count = 0

    def tick(self) -> dict:
        count = self.publisher.subscription_count()
        if count != self._last_count and count > 0:
            self.publisher.publish_map(self.map_image, self.map_info)
            self._last_count = count
            return {"status": "published", "subscribers": count}
        return {"status": "idle", "subscribers": count}

    def publish(self):
        self.publisher.publish_map(self.map_image, self.map_info)


def main(argv=None):
    """Standalone map-server process: load the packaged map asset (the
    reference loads maps/map_carto.pgm) and (re)publish /map on
    subscriber-count changes at 1 Hz (core/map_server.py:25-31). The map
    files: ``TPU_MPC_MAP_PGM``/``TPU_MPC_MAP_YAML`` (the JAX package's
    variables), else the repository's ``maps/map_synthetic``."""
    import os

    from .live import single_node_main

    maps_dir = os.path.join(os.path.dirname(__file__), "..", "..", "maps")
    pgm_path = os.environ.get("TPU_MPC_MAP_PGM", os.path.join(maps_dir, "map_synthetic.pgm"))
    yaml_path = os.environ.get("TPU_MPC_MAP_YAML", os.path.join(maps_dir, "map_synthetic.yaml"))
    return single_node_main(
        lambda bus, params, device: MapServerNode(bus, map_pgm_path=pgm_path, map_yaml_path=yaml_path),
        "map_server_node",
        lambda p: 1.0,
        # the scaffolding's synthetic-map server would race this node on /map
        exclude_source_tasks=frozenset({"map_server"}),
        argv=argv,
    )

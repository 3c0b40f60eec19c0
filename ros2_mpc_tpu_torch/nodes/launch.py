"""Node-graph runner — port of :mod:`ros2_mpc_tpu.nodes.launch`, the
single-process equivalent of the reference's two launch files
(launch/launch_all.launch.py:8-64 live config,
launch/launch_all_nav.launch.py:8-87 sim config with map_server +
map->odom tf publisher).

Instead of nine OS processes exchanging DDS messages, the graph runs as
deterministic round-robin ticks over one :class:`MessageBus` — reproducible
in tests, steppable in simulation. ``device`` (``None``: the card) holds the
simulator's world and pose, the grid and costmap ops and the followers'
solves (K1 and K2 at B=1); the bus, the A* search and the reference
generation stay on the host."""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np

from ..config import Params
from ..device import resolve_device
from ..utils import pgm
from ..utils.telemetry import Telemetry
from .bus import MessageBus, Pose, PoseStamped, Quaternion
from .costmap_nodes import GlobalCostmapNode, LocalCostmapNode
from .global_path_publisher import GlobalPathPublisherNode
from .map_server import MapServerNode
from .path_follower import PathFollowerNode
from .point_follower import PointFollowerNode
from .sim import Simulator
from .state_publishers import TransformPublisherNode

log = logging.getLogger("launch")


class _MapperMapSource:
    """map_server-shaped adapter over the occupancy mapper: every graph tick
    folds the newest scan in; /map republishes at 1 Hz of sim time (the same
    cadence a real mapping stack publishes at)."""

    def __init__(self, mapper, publish_every: int = 5):
        self.mapper = mapper
        self.publish_every = publish_every
        self._i = 0

    def tick(self):
        self.mapper.tick()
        self._i += 1
        if self._i % self.publish_every == 0:
            self.mapper.publish()

    def publish(self):
        self.mapper.publish()


@dataclasses.dataclass
class SimStack:
    bus: MessageBus
    sim: Simulator
    map_server: MapServerNode
    global_planner: GlobalPathPublisherNode
    follower: object
    local_costmap: LocalCostmapNode
    global_costmap: GlobalCostmapNode
    transform_publisher: TransformPublisherNode
    params: Params
    safety: Optional[object] = None
    mapper: Optional[object] = None
    # host clock of each stack tick (tick_s) and of its stages: map server
    # and local costmap (costmap_s), global planner (plan_s), follower
    # (control_s), plant and sensors (plant_s); each stage ends on a read
    # back from the device, so its device work is inside its own time
    telemetry: Telemetry = dataclasses.field(default_factory=lambda: Telemetry("sim_stack"))

    def publish_goal(self, x: float, y: float, yaw: float = 0.0):
        self.bus.publish(
            "/goal_pose",
            PoseStamped(
                pose=Pose(
                    x=x, y=y,
                    orientation=Quaternion(z=float(np.sin(yaw / 2)), w=float(np.cos(yaw / 2))),
                )
            ),
        )

    def tick(self) -> dict:
        """One control period: sensors -> plan -> control -> plant. The
        follower gets *simulation* time (tick count x dt) so its 1 s path
        refresh (reference REFRESH_TIME) paces in sim seconds, not in however
        fast the lock-step loop happens to run."""
        self._ticks = getattr(self, "_ticks", 0) + 1
        timer = self.telemetry.timer
        with timer("tick_s"):
            with timer("costmap_s"):
                self.map_server.tick()
                self.local_costmap.tick()
            with timer("plan_s"):
                plan = self.global_planner.tick()
            with timer("control_s"):
                ctrl = self.follower.tick(now=self._ticks * self.params.dt)
            with timer("plant_s"):
                pose = self.sim.step()
        return {"plan": plan, "control": ctrl, "pose": pose}

    def run_to_goal(self, goal_xy, yaw: float = 0.0, max_ticks: int = 400):
        """Publish a goal and tick until the follower latches or the budget
        runs out. Returns (reached, ticks, final_pose)."""
        self.publish_goal(goal_xy[0], goal_xy[1], yaw)
        for i in range(max_ticks):
            out = self.tick()
            if out["control"].get("status") == "goal_reached":
                return True, i + 1, out["pose"]
        return False, max_ticks, self.sim.pose.cpu().numpy()


def build_sim_stack(
    follower: str = "tracking",
    params: Params = Params(),
    map_image: Optional[np.ndarray] = None,
    map_info: Optional[dict] = None,
    start_pose=(0.0, 0.0, 0.0),
    horizon: Optional[int] = None,
    reference_parity: bool = False,
    planner_map_image: Optional[np.ndarray] = None,
    noise: Optional[dict] = None,
    noise_seed: int = 0,
    follower_kwargs: Optional[dict] = None,
    safety_stop: Optional[float] = None,
    map_source: str = "server",
    mapper_kwargs: Optional[dict] = None,
    device=None,
) -> SimStack:
    """Assemble the nav-config node graph (launch_all_nav.launch.py) against
    the in-process simulator, on ``device`` (``None``: the card; raises
    without one unless ``device="cpu"`` is passed).

    ``planner_map_image`` lets the map server publish a different (e.g.
    stale) map than the simulated world — unmapped obstacles are then visible
    only through the lidar, exercising the MPC's live obstacle costs.

    ``safety_stop`` inserts a SafetyMonitorNode (nodes/safety.py) into the
    command chain: the follower publishes to cmd_vel_raw and the monitor
    forwards to cmd_vel, zeroing linear motion whenever the commanded
    direction has a scan return closer than this distance [m].

    ``map_source="mapper"`` replaces the file map server with the occupancy
    mapper (nodes/mapper.py, its log-odds grid on ``device``): /map starts
    fully unknown (which the planner treats optimistically as free) and is
    built live from scans — navigate-while-mapping. The simulated world is
    still ``map_image``. ``mapper_kwargs`` go to :class:`MapperNode`
    (default ``size_m=12.0, resolution=0.05``: a 240x240 grid centered on
    the world origin; pass ``origin_xy`` for a world that is not)."""
    device = resolve_device(device)
    bus = MessageBus()
    if map_image is None:
        map_image = pgm.synthetic_indoor_map()
        map_info = dict(pgm.DEFAULT_MAP_INFO)
    sim = Simulator(
        bus, map_image, map_info, start_pose=start_pose, params=params,
        noise=noise, noise_seed=noise_seed, device=device,
    )
    mapper = None
    if map_source == "mapper":
        from .mapper import MapperNode

        mkw = dict(size_m=12.0, resolution=0.05)
        mkw.update(mapper_kwargs or {})
        mapper = MapperNode(bus, params, topic="/map", device=device, **mkw)
        map_server = _MapperMapSource(mapper)
    elif map_source == "server":
        map_server = MapServerNode(
            bus,
            map_image=planner_map_image if planner_map_image is not None else map_image,
            map_info=map_info,
        )
    else:
        raise ValueError(f"unknown map_source {map_source!r}")
    transform_publisher = TransformPublisherNode(bus)
    global_planner = GlobalPathPublisherNode(
        bus, params, use_scan_obstacles=not reference_parity, device=device
    )
    fkw = dict(follower_kwargs or {}, device=device)
    safety = None
    if safety_stop is not None:
        from .safety import SafetyMonitorNode

        fkw.setdefault("cmd_topic", "cmd_vel_raw")
        safety = SafetyMonitorNode(bus, params, stop_distance=safety_stop)
    if follower == "tracking":
        ctrl = PathFollowerNode(
            bus, params, horizon=horizon, reference_parity=reference_parity, **fkw
        )
    else:
        ctrl = PointFollowerNode(
            bus, params, horizon=horizon, reference_parity=reference_parity, **fkw
        )
    local_costmap = LocalCostmapNode(bus, params, device=device)
    global_costmap = GlobalCostmapNode(bus, params, device=device)
    # Prime the bus: all subscribers exist now, so republish the initial
    # sensor state (the reference's nodes spin-wait for the first messages
    # instead — e.g. path_follower:163-171).
    map_server.publish()
    sim.publish_state()
    sim.publish_scan()
    return SimStack(
        bus=bus,
        sim=sim,
        map_server=map_server,
        global_planner=global_planner,
        follower=ctrl,
        local_costmap=local_costmap,
        global_costmap=global_costmap,
        transform_publisher=transform_publisher,
        params=params,
        safety=safety,
        mapper=mapper,
    )


def run_sim_stack(follower: str = "tracking", n_ticks: int = 200, goal=(1.0, -1.0), device=None):
    """Console entry: run the stack for a bounded number of ticks. The default
    scenario starts in the lower room of the synthetic map with a clear path.
    ``device``: ``None`` is the card."""
    logging.basicConfig(level=logging.INFO)
    stack = build_sim_stack(follower=follower, horizon=20, start_pose=(-1.0, -1.0, 0.0), device=device)
    t0 = time.time()
    reached, ticks, pose = stack.run_to_goal(goal, max_ticks=n_ticks)
    log.info(
        "follower=%s reached=%s ticks=%d pose=%s wall=%.1fs solve_s=%s tick_s=%s",
        follower, reached, ticks, np.round(pose, 3), time.time() - t0,
        stack.follower.telemetry.percentiles("solve_s"), stack.telemetry.percentiles("tick_s"),
    )
    return reached


def main(argv=None):
    """Console entry (``cuda-mpc-launch``): ``run_sim_stack`` on ``--device``
    (default: the card, refused without one)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--follower", default="tracking", choices=["point", "tracking"])
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)
    run_sim_stack(args.follower, device=args.device)


if __name__ == "__main__":
    main()

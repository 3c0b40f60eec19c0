"""Wall-clock live-robot graph — port of :mod:`ros2_mpc_tpu.nodes.live`, the
deployment counterpart of the reference's ``launch/launch_all.launch.py:8-64``.

Where :mod:`~ros2_mpc_tpu_torch.nodes.launch` ticks the node graph in
lock-step (deterministic tests/simulation), this module paces each node on
its own wall-clock timer at the reference's real rates:

* 20 Hz robot state republish (core/robot_state_publisher.py:17-19),
* ~10 Hz local/global costmaps (core/local_costmap_publisher.py:38),
* 5 Hz control ticks (config/params.yaml:1, dt = 0.2 s),
* 1 Hz global replanning (scripts/path_follower_local_planner.py:157).

Sensor/actuation edges are pluggable: ``source='sim'`` runs against the
in-process simulator (ground truth enters through the tf tree exactly as a
cartographer-style localizer would provide it, so
:class:`~ros2_mpc_tpu_torch.nodes.state_publishers.RobotStatePublisherNode`
is on the live data path); ``source='ros'`` bridges the same bus onto DDS
via :class:`~ros2_mpc_tpu_torch.nodes.ros_adapter.RclpyBusBridge` for a
physical robot.

``device`` (``None``: the card; raises without one unless ``"cpu"`` is
passed) holds the simulator, the grid and costmap ops and the followers'
solves (K1 and K2 at B=1). The scheduler's warm-up runs every task once off
the clock, which also absorbs the first CUDA call's kernel build.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np

from ..config import Params
from ..device import resolve_device
from ..utils import pgm
from .bus import MessageBus, Pose, PoseStamped, Quaternion, Transform
from .costmap_nodes import GlobalCostmapNode, LocalCostmapNode
from .global_path_publisher import GlobalPathPublisherNode
from .map_server import MapServerNode
from .path_follower import PathFollowerNode
from .point_follower import PointFollowerNode
from .sim import Simulator
from .state_publishers import RobotStatePublisherNode, TransformPublisherNode

log = logging.getLogger("live")


@dataclasses.dataclass
class Task:
    """One rate-scheduled node tick."""

    name: str
    period: float
    fn: Callable[[], object]
    runs: int = 0
    misses: int = 0
    max_lateness: float = 0.0
    total_runtime: float = 0.0


class RateScheduler:
    """Multi-rate wall-clock executor for the single-process node graph.

    The reference runs each node as its own OS process with free-running
    ``while True`` loops or rclpy timers; here one earliest-deadline loop
    drives every node, which keeps the graph single-threaded (the bus needs
    no cross-thread ordering) while preserving per-node rates. A task is
    charged a *miss* when it starts more than half its period late — the
    same criterion as missing a 200 ms control deadline by > 100 ms.
    """

    def __init__(self, tasks: list[Task]):
        self.tasks = tasks

    def warmup(self):
        """Run every task once off the clock (first calls build kernels and
        allocate on the device)."""
        for t in self.tasks:
            t.fn()

    def run(
        self,
        duration: float,
        stop: Optional[Callable[[], bool]] = None,
        warmup: bool = True,
    ) -> dict:
        """Run until ``duration`` seconds elapse or ``stop()`` goes true.
        Returns per-task stats (runs, deadline misses, max lateness)."""
        if warmup:
            self.warmup()
        t0 = time.monotonic()
        t_end = t0 + duration
        deadlines = [t0 + t.period for t in self.tasks]
        while True:
            now = time.monotonic()
            if now >= t_end or (stop is not None and stop()):
                break
            i = int(np.argmin(deadlines))
            wait = deadlines[i] - now
            if wait > 0:
                time.sleep(min(wait, t_end - now))
                continue
            task = self.tasks[i]
            start = time.monotonic()
            lateness = start - deadlines[i]
            task.fn()
            task.runs += 1
            task.total_runtime += time.monotonic() - start
            task.max_lateness = max(task.max_lateness, lateness)
            if lateness > task.period / 2:
                task.misses += 1
            # Next deadline on the fixed grid — but never schedule into the
            # past, or a long solve would trigger a thundering catch-up burst.
            deadlines[i] = max(deadlines[i] + task.period, time.monotonic())
        elapsed = time.monotonic() - t0
        return {
            "elapsed_s": elapsed,
            "tasks": {
                t.name: {
                    "runs": t.runs,
                    "rate_hz": t.runs / elapsed if elapsed > 0 else 0.0,
                    "misses": t.misses,
                    "max_lateness_s": t.max_lateness,
                    "mean_runtime_s": t.total_runtime / max(t.runs, 1),
                }
                for t in self.tasks
            },
        }


class SimLocalization:
    """Stands in for the reference's external localizer (cartographer):
    publishes tf ``map -> base_footprint`` from simulator ground truth, so
    the live graph's state chain (tf lookup -> /robot_position) is exercised
    end-to-end (core/robot_state_publisher.py:21-32)."""

    def __init__(self, bus: MessageBus, sim: Simulator):
        self.bus = bus
        self.sim = sim

    def tick(self) -> dict:
        x, y, yaw = (float(v) for v in self.sim.measured_pose())
        self.bus.set_transform(
            "map",
            "base_footprint",
            Transform(
                x=x,
                y=y,
                orientation=Quaternion(z=float(np.sin(yaw / 2)), w=float(np.cos(yaw / 2))),
            ),
        )
        return {"status": "published"}


@dataclasses.dataclass
class LiveStack:
    """The assembled wall-clock graph (either sensor source)."""

    bus: MessageBus
    scheduler: RateScheduler
    follower: object
    global_planner: GlobalPathPublisherNode
    robot_state: RobotStatePublisherNode
    params: Params
    sim: Optional[Simulator] = None
    bridge: Optional[object] = None

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

    def run(self, duration: float, stop_on_goal: bool = True) -> dict:
        self._last_control = {}

        stop = None
        if stop_on_goal:
            stop = lambda: self._last_control.get("status") == "goal_reached"  # noqa: E731
        stats = self.scheduler.run(duration, stop=stop)
        stats["goal_reached"] = self._last_control.get("status") == "goal_reached"
        if self.sim is not None:
            stats["final_pose"] = self.sim.pose.cpu().numpy()
        return stats


def build_live_stack(
    follower: str = "point",
    params: Params = Params(),
    source: str = "sim",
    map_image: Optional[np.ndarray] = None,
    map_info: Optional[dict] = None,
    start_pose=(-1.0, -1.0, 0.0),
    horizon: Optional[int] = None,
    global_costmap: bool = True,
    viz_dir: Optional[str] = None,
    viz_period: float = 1.0,
    follower_kwargs: Optional[dict] = None,
    safety_stop: Optional[float] = None,
    device=None,
) -> LiveStack:
    """Assemble the live-config node graph (launch_all.launch.py:8-64:
    follower + global path publisher + robot state publisher + both costmap
    publishers) on wall-clock rate tasks, on ``device`` (``None``: the card).
    ``params`` reaches every node built here (simulator, planner, costmaps,
    follower, safety monitor); ``global_costmap=False`` builds no global
    costmap node; ``viz_period`` [s] spaces the dashboard frames.

    ``source='sim'``: in-process simulator plays plant + lidar + localizer
    on ``map_image``/``map_info`` (``None``: the synthetic indoor map), from
    ``start_pose``.
    ``source='ros'``: attach an ``RclpyBusBridge`` (requires rclpy) — sensors
    and cmd_vel flow over DDS; rates and nodes are identical.
    """
    device = resolve_device(device)
    bus = MessageBus()
    stack_sim = None
    bridge = None
    tasks: list[Task] = []

    if source == "sim":
        if map_image is None:
            map_image = pgm.synthetic_indoor_map()
            map_info = dict(pgm.DEFAULT_MAP_INFO)
        stack_sim = Simulator(bus, map_image, map_info, start_pose=start_pose, params=params, device=device)
        localizer = SimLocalization(bus, stack_sim)
        map_server = MapServerNode(bus, map_image=map_image, map_info=map_info)
        tasks.append(Task("localizer", params.state_publish_period, localizer.tick))
        tasks.append(Task("lidar", params.local_costmap_period, stack_sim.publish_scan))
        tasks.append(Task("map_server", 1.0, map_server.tick))
    elif source == "ros":
        from .ros_adapter import RclpyBusBridge

        bridge = RclpyBusBridge(bus)
        # Pump DDS callbacks well above the fastest consumer rate.
        tasks.append(Task("dds_spin", params.state_publish_period / 2, bridge.spin_once))
    else:
        raise ValueError(f"unknown source {source!r}")

    # The live config's state chain: tf -> /robot_position at 20 Hz.
    robot_state = RobotStatePublisherNode(bus)
    tasks.append(Task("robot_state", params.state_publish_period, robot_state.tick))
    # map->odom broadcast (negated-translation quirk #7) is subscription-driven.
    transform_publisher = TransformPublisherNode(bus)

    planner = GlobalPathPublisherNode(bus, params, device=device)
    tasks.append(Task("replan", params.path_refresh_period, planner.tick))

    fkw = dict(follower_kwargs or {}, device=device)
    if safety_stop is not None:
        # command-chain collision guard (nodes/safety.py): follower ->
        # cmd_vel_raw -> monitor -> cmd_vel; event-driven, no rate task
        from .safety import SafetyMonitorNode

        fkw.setdefault("cmd_topic", "cmd_vel_raw")
        SafetyMonitorNode(bus, params, stop_distance=safety_stop)
    if follower == "tracking":
        ctrl = PathFollowerNode(bus, params, horizon=horizon, **fkw)
    else:
        ctrl = PointFollowerNode(bus, params, horizon=horizon, **fkw)

    local_costmap = LocalCostmapNode(bus, params, device=device)
    tasks.append(Task("local_costmap", params.local_costmap_period, local_costmap.tick))
    if global_costmap:
        gc = GlobalCostmapNode(bus, params, device=device)
        tasks.append(Task("global_costmap", params.local_costmap_period, gc.tick))
    if viz_dir is not None:
        from .viz_node import LiveVizNode

        tasks.append(Task("viz", viz_period, LiveVizNode(bus, out_dir=viz_dir).tick))

    stack = LiveStack(
        bus=bus,
        scheduler=None,  # set below (control task closes over stack)
        follower=ctrl,
        global_planner=planner,
        robot_state=robot_state,
        params=params,
        sim=stack_sim,
        bridge=bridge,
    )
    stack._last_control = {}

    def control_tick():
        out = ctrl.tick()
        stack._last_control = out
        if stack_sim is not None:
            # advance the plant one control period; sensors republish on
            # their own timers (lidar/localizer tasks above)
            stack_sim.step(params.dt, publish=False)
        return out

    tasks.append(Task("control", params.dt, control_tick))
    stack.scheduler = RateScheduler(tasks)
    # the transform publisher lives as long as the bus (subscription side effect)
    stack.transform_publisher = transform_publisher
    return stack


def _source_tasks(
    bus: MessageBus, params: Params, source: str, device, exclude: frozenset = frozenset()
) -> tuple[list[Task], Optional[Simulator]]:
    """Sensor-source scaffolding for a standalone node process: either the
    in-process simulator chain (plant + localizer + tf-fed state publisher +
    lidar + map server) on ``device`` or a DDS bridge pump. ``exclude`` drops
    scaffolding tasks by name so a node under test never competes with a
    scaffolding twin publishing the same topic (e.g. the standalone map
    server vs the scaffolding 'map_server')."""
    tasks: list[Task] = []
    if source == "sim":
        image = pgm.synthetic_indoor_map()
        info = dict(pgm.DEFAULT_MAP_INFO)
        sim = Simulator(bus, image, info, device=device)
        localizer = SimLocalization(bus, sim)
        tasks.append(Task("localizer", params.state_publish_period, localizer.tick))
        if "robot_state" not in exclude:
            robot_state = RobotStatePublisherNode(bus)
            tasks.append(Task("robot_state", params.state_publish_period, robot_state.tick))
        tasks.append(Task("lidar", params.local_costmap_period, sim.publish_scan))
        if "map_server" not in exclude:
            map_server = MapServerNode(bus, map_image=image, map_info=info)
            tasks.append(Task("map_server", 1.0, map_server.tick))
        return tasks, sim
    if source == "ros":
        from .ros_adapter import RclpyBusBridge

        bridge = RclpyBusBridge(bus)
        tasks.append(Task("dds_spin", params.state_publish_period / 2, bridge.spin_once))
        return tasks, None
    raise ValueError(f"unknown source {source!r}")


def run_single_node(
    node_factory: Callable[[MessageBus, Params, object], object],
    task_name: str,
    period: Callable[[Params], float],
    source: str = "sim",
    duration: float = 60.0,
    exclude_source_tasks: frozenset = frozenset(),
    device=None,
) -> dict:
    """Run ONE node as its own paced process against live topics — the
    reference's per-node console-script model (setup.py:28-40), with the
    sensor source provided by the simulator chain or a DDS bridge.
    ``node_factory(bus, params, device)`` builds the node; ``device``
    (``None``: the card) holds the node's and the simulator's tensors."""
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(device)
    bus = MessageBus()
    params = Params()
    tasks, _ = _source_tasks(bus, params, source, device, exclude=exclude_source_tasks)
    node = node_factory(bus, params, device)
    tasks.append(Task(task_name, period(params), node.tick))
    stats = RateScheduler(tasks).run(duration)
    log.info("%s: %s", task_name, stats["tasks"][task_name])
    return stats


def _device_arg(ap) -> None:
    ap.add_argument(
        "--device", default=None,
        help="torch device of the graph's tensors and solves (default: the card, "
             "refused without one; 'cpu' runs the plain versions on the host)",
    )


def single_node_main(node_factory, task_name: str, period, exclude_source_tasks=frozenset(), argv=None) -> dict:
    """argparse wrapper shared by the standalone node console entries."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--source", default="sim", choices=["sim", "ros"])
    _device_arg(ap)
    args = ap.parse_args(argv)
    return run_single_node(
        node_factory, task_name, period, args.source, args.duration,
        exclude_source_tasks=exclude_source_tasks, device=args.device,
    )


def run_live(
    follower: str = "point",
    duration: float = 60.0,
    goal=(1.0, -1.0),
    source: str = "sim",
    viz_dir: Optional[str] = None,
    escape_after: Optional[int] = None,
    bag_path: Optional[str] = None,
    safety_stop: Optional[float] = None,
    device=None,
) -> dict:
    """Console entry: run the live graph until the goal latches or the time
    budget expires; log per-task rate/deadline stats. ``device``: ``None``
    is the card."""
    logging.basicConfig(level=logging.INFO)
    fkw = {}
    if escape_after is not None:
        fkw["escape_after"] = escape_after
    stack = build_live_stack(
        follower=follower, source=source, horizon=20, viz_dir=viz_dir,
        follower_kwargs=fkw, safety_stop=safety_stop, device=device,
    )
    recorder = None
    if bag_path is not None:
        from .bag import BagRecorder

        recorder = BagRecorder(stack.bus)
    stack.publish_goal(goal[0], goal[1])
    stats = stack.run(duration)
    if recorder is not None:
        from .bag import save_bag

        records = recorder.stop()
        save_bag(bag_path, records)
        log.info("bag: %d records -> %s", len(records), bag_path)
    for name, s in stats["tasks"].items():
        log.info(
            "%-14s %5.1f Hz  runs=%-5d misses=%-3d max_late=%.3fs mean_run=%.4fs",
            name, s["rate_hz"], s["runs"], s["misses"],
            s["max_lateness_s"], s["mean_runtime_s"],
        )
    log.info(
        "goal_reached=%s elapsed=%.1fs pose=%s",
        stats["goal_reached"], stats["elapsed_s"],
        np.round(stats.get("final_pose", np.full(3, np.nan)), 3),
    )
    return stats


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--follower", default="point", choices=["point", "tracking"])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--goal", type=float, nargs=2, default=(1.0, -1.0))
    ap.add_argument("--source", default="sim", choices=["sim", "ros"])
    ap.add_argument(
        "--viz", default=None, metavar="DIR",
        help="render the running stack to DIR/latest.png at 1 Hz (RViz surrogate)",
    )
    ap.add_argument(
        "--safety-stop", type=float, default=None, metavar="DIST",
        help="insert the command-chain collision guard (nodes/safety.py): "
             "zero linear motion when the commanded direction has a scan "
             "return closer than DIST meters",
    )
    ap.add_argument(
        "--bag", default=None, metavar="PATH",
        help="record every bus topic to PATH (nodes/bag.py; replay with "
             "ros2_mpc_tpu_torch.nodes.bag.replay)",
    )
    ap.add_argument(
        "--escape-after", type=int, default=None, metavar="K",
        help="after K consecutive non-converged solves run one multi-start "
             "basin-escape tick (solver/mppi.py) that re-seeds the warm start",
    )
    _device_arg(ap)
    args = ap.parse_args(argv)
    stats = run_live(
        args.follower, args.duration, tuple(args.goal), args.source, args.viz,
        escape_after=args.escape_after, bag_path=args.bag,
        safety_stop=args.safety_stop, device=args.device,
    )
    raise SystemExit(0 if stats["goal_reached"] else 1)


if __name__ == "__main__":
    main()

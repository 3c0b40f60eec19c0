"""Multi-process node graph over the native shared-memory bus — port of
:mod:`ros2_mpc_tpu.nodes.multiproc`.

The reference's deployment shape is nine OS processes exchanging DDS topics
(launch/launch_all.launch.py:8-64, setup.py:28-40). The single-process
wall-clock graph (:mod:`~ros2_mpc_tpu_torch.nodes.live`) reproduces the
rates; this module reproduces the *process topology*: each role below runs
as its own OS process with its own rate scheduler, and every topic crosses a
process boundary through the C++ seqlock bus (native/shm_bus.cpp) — the
framework's DDS replacement.

Roles (mirroring the reference's process groups):

* ``world``    — simulator plant + lidar + localizer tf + robot state
  republisher + map server (on a physical robot this side is the hardware:
  drivers, cartographer, map server).
* ``planner``  — the global path publisher (A* + smoothing, 1 Hz).
* ``costmaps`` — local + global costmap publishers (10 Hz).
* ``follower`` — the MPC control loop (5 Hz), publishing ``cmd_vel`` and a
  ``_control_status`` heartbeat the supervisor watches for goal latching.
* ``safety``   — optional command-chain collision guard (nodes/safety.py) as
  its OWN process: the follower publishes ``cmd_vel_raw``, the monitor gates
  to ``cmd_vel``. Process isolation is the point — the last safety stage
  survives a crash of the planner or follower.

``run_multiprocess`` is the supervisor: it spawns the compute roles, runs
the world role in-process, and broadcasts ``_shutdown`` once the follower
reports ``goal_reached`` (or the time budget expires).

Every role's tensors live on ``role_device`` (``None``: the card; several
processes share one card, each with its own CUDA context). Children start
with ``spawn``: CUDA cannot run in a forked child. If the native bus does
not build, ``run_multiprocess`` raises.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import tempfile
import time
from typing import Optional

import numpy as np

from ..config import Params
from ..device import resolve_device
from ..utils import pgm
from .bus import Pose, PoseStamped, Quaternion
from .costmap_nodes import GlobalCostmapNode, LocalCostmapNode
from .global_path_publisher import GlobalPathPublisherNode
from .live import RateScheduler, SimLocalization, Task
from .map_server import MapServerNode
from .path_follower import PathFollowerNode
from .point_follower import PointFollowerNode
from .shm_bus import SharedMemoryBus
from .sim import Simulator
from .state_publishers import RobotStatePublisherNode

log = logging.getLogger("multiproc")

SHUTDOWN_TOPIC = "_shutdown"
STATUS_TOPIC = "_control_status"
ROLES = ("world", "planner", "costmaps", "follower", "safety")
SAFETY_STATUS_TOPIC = "_safety_status"
ROLE_STATS_TOPIC = "_role_stats/"  # + role: each child's rate stats when it ends
COMPUTE_ROLES = ("planner", "costmaps", "follower")  # the default child processes


def publish_goal(bus, x: float, y: float, yaw: float = 0.0):
    bus.publish(
        "/goal_pose",
        PoseStamped(
            pose=Pose(
                x=float(x),
                y=float(y),
                orientation=Quaternion(z=float(np.sin(yaw / 2)), w=float(np.cos(yaw / 2))),
            )
        ),
    )


def _stop_requested(bus) -> bool:
    return bus.latest(SHUTDOWN_TOPIC)[1] > 0


def build_role_tasks(
    role: str,
    bus,
    params: Params,
    follower: str = "point",
    horizon: Optional[int] = None,
    start_pose=(-1.0, -1.0, 0.0),
    map_image=None,
    map_info=None,
    cmd_topic: str = "cmd_vel",
    safety_stop: float = 0.25,
    device=None,
):
    """(tasks, extras) for one role, its tensors on ``device`` (``None``: the
    card); the world role simulates ``map_image``/``map_info`` (``None``: the
    synthetic indoor map) from ``start_pose``. Every role leads with a
    ``bus_spin`` task — the rclpy.spin_once analogue pumping remote publishes
    into local callbacks — paced at twice the fastest consumer rate."""
    if role not in ROLES:
        raise ValueError(f"unknown role {role!r} (choose from {ROLES})")
    device = resolve_device(device)
    tasks = [Task("bus_spin", params.state_publish_period / 2, bus.spin_once)]
    extras: dict = {}
    if role == "world":
        if map_image is None:
            map_image = pgm.synthetic_indoor_map()
            map_info = dict(pgm.DEFAULT_MAP_INFO)
        sim = Simulator(bus, map_image, map_info, start_pose=start_pose, params=params, device=device)
        localizer = SimLocalization(bus, sim)
        robot_state = RobotStatePublisherNode(bus)
        map_server = MapServerNode(bus, map_image=map_image, map_info=map_info)
        plant_dt = params.dt / 4.0
        tasks += [
            # free-running plant: integrates the latest cmd_vel continuously,
            # as a physical robot would (the lock-step sim instead advances
            # inside the control tick)
            Task("plant", plant_dt, lambda: sim.step(plant_dt, publish=False)),
            Task("localizer", params.state_publish_period, localizer.tick),
            Task("robot_state", params.state_publish_period, robot_state.tick),
            Task("lidar", params.local_costmap_period, sim.publish_scan),
            Task("map_server", 1.0, map_server.tick),
        ]
        extras["sim"] = sim
    elif role == "planner":
        node = GlobalPathPublisherNode(bus, params, device=device)
        tasks.append(Task("replan", params.path_refresh_period, node.tick))
    elif role == "costmaps":
        tasks.append(
            Task("local_costmap", params.local_costmap_period, LocalCostmapNode(bus, params, device=device).tick)
        )
        tasks.append(
            Task("global_costmap", params.local_costmap_period, GlobalCostmapNode(bus, params, device=device).tick)
        )
    elif role == "follower":
        node_cls = PathFollowerNode if follower == "tracking" else PointFollowerNode
        ctrl = node_cls(bus, params, horizon=horizon, cmd_topic=cmd_topic, device=device)

        def control_tick():
            out = ctrl.tick()
            bus.publish(STATUS_TOPIC, out.get("status"))
            return out

        tasks.append(Task("control", params.dt, control_tick))
        extras["ctrl"] = ctrl
    else:  # safety: host code, no tensors
        from .safety import SafetyMonitorNode

        monitor = SafetyMonitorNode(bus, params, stop_distance=safety_stop)

        def heartbeat():
            bus.publish(
                SAFETY_STATUS_TOPIC,
                {"blocked": monitor.n_blocked, "passed": monitor.n_passed},
            )

        # gating itself is event-driven off bus_spin; the 1 s heartbeat just
        # exposes the counters to the supervisor
        tasks.append(Task("safety_heartbeat", 1.0, heartbeat))
        extras["monitor"] = monitor
    return tasks, extras


def run_role(
    role: str,
    bus_path: str,
    duration: float,
    follower: str = "point",
    horizon: Optional[int] = None,
    params: Optional[Params] = None,
    cmd_topic: str = "cmd_vel",
    safety_stop: float = 0.25,
    device=None,
) -> dict:
    """Run one role against an existing bus file until the duration expires
    or a ``_shutdown`` broadcast arrives; publish its stats when it ends.
    ``params``: ``None`` is ``Params()``."""
    params = params or Params()
    bus = SharedMemoryBus(bus_path)
    try:
        tasks, _ = build_role_tasks(
            role, bus, params, follower=follower, horizon=horizon,
            cmd_topic=cmd_topic, safety_stop=safety_stop, device=device,
        )
        stats = RateScheduler(tasks).run(duration, stop=lambda: _stop_requested(bus))
        bus.publish(ROLE_STATS_TOPIC + role, stats)
        return stats
    finally:
        bus.close()


def _role_entry(role, bus_path, duration, follower, horizon, device, cmd_topic="cmd_vel", safety_stop=0.25):
    """Child-process entry (module-level for the spawn pickler)."""
    logging.basicConfig(level=logging.WARNING)
    run_role(role, bus_path, duration, follower=follower, horizon=horizon,
             cmd_topic=cmd_topic, safety_stop=safety_stop, device=device)


def run_multiprocess(
    follower: str = "point",
    duration: float = 60.0,
    goal=(1.0, -1.0),
    start_pose=(-1.0, -1.0, 0.0),
    horizon: Optional[int] = 20,
    params: Optional[Params] = None,
    bus_path: Optional[str] = None,
    roles=COMPUTE_ROLES,
    role_device=None,
    safety_stop: Optional[float] = None,
) -> dict:
    """Supervisor: spawn ``roles`` as OS processes, run the world role here
    from ``start_pose``, stop everything once the follower latches the goal.
    ``bus_path``: the bus file (default: a new one under /dev/shm, removed
    at the end).

    ``params`` (``None``: ``Params()``) reaches the world role only, as in
    the JAX package: the child roles build ``Params()`` in ``run_role``, so
    the simulator runs the caller's values and the planner, costmaps and
    follower their defaults.

    ``role_device`` is the device of every role's tensors and solves, the
    world role's here included (``None``: the card; raises without one).
    ``safety_stop`` adds the safety role (its own OS process) where
    ``roles`` lacks it: the follower publishes cmd_vel_raw and the monitor
    gates to cmd_vel at this stop distance [m]; the supervisor surfaces its
    counters as stats["safety"]. A role outside ``ROLES``, or ``"world"``,
    raises ``ValueError`` before anything starts.

    Returns the world role's rate stats plus ``goal_reached`` /
    ``final_pose``, ``failed_roles`` and ``roles`` (each child role's rate
    stats, None for a role that did not end cleanly).
    """
    params = params or Params()
    unknown = [r for r in roles if r not in ROLES or r == "world"]
    if unknown:
        raise ValueError(
            f"unknown child roles {unknown} (choose from {ROLES[1:]}; the world runs here)"
        )
    role_device = resolve_device(role_device)
    if safety_stop is not None and "safety" not in roles:
        roles = tuple(roles) + ("safety",)
    cmd_topic = "cmd_vel_raw" if "safety" in roles else "cmd_vel"
    ctx = multiprocessing.get_context("spawn")  # CUDA cannot run in a forked child
    workdir = None
    if bus_path is None:
        shm_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
        workdir = tempfile.mkdtemp(prefix="cuda_mpc_bus_", dir=shm_root)
        bus_path = os.path.join(workdir, "bus")

    try:
        bus = SharedMemoryBus(bus_path)  # parent creates & initializes the region; raises if unbuilt
    except BaseException:
        if workdir is not None:
            os.rmdir(workdir)
        raise
    procs = [
        ctx.Process(
            target=_role_entry,
            args=(role, bus_path, duration + 30.0, follower, horizon, str(role_device),
                  cmd_topic, safety_stop if safety_stop is not None else 0.25),
            name=f"cuda-mpc-{role}",
            daemon=True,
        )
        for role in roles
    ]
    stats: dict = {}
    try:
        for p in procs:
            p.start()

        tasks, extras = build_role_tasks(
            "world", bus, params, start_pose=start_pose, device=role_device
        )
        sim = extras["sim"]
        publish_goal(bus, goal[0], goal[1])

        def stop():
            if bus.latest(STATUS_TOPIC)[0] == "goal_reached":
                return True
            # a crashed compute role can never reach the goal — don't burn
            # the whole duration discovering that
            return any(p.exitcode not in (None, 0) for p in procs)

        sched = RateScheduler(tasks)
        stats = sched.run(duration, stop=stop)
        stats["goal_reached"] = bus.latest(STATUS_TOPIC)[0] == "goal_reached"
        stats["final_pose"] = sim.pose.cpu().numpy().astype(float)
        stats["failed_roles"] = [p.name for p in procs if p.exitcode not in (None, 0)]
        if "safety" in roles:
            hb = bus.latest(SAFETY_STATUS_TOPIC)[0]
            # None heartbeat = the safety process never came up: the command
            # chain was severed (nothing forwarded cmd_vel_raw), so say so
            # instead of handing callers a silent None
            stats["safety"] = hb if hb is not None else {
                "blocked": 0, "passed": 0, "heartbeat_missing": True,
            }
    finally:
        bus.publish(SHUTDOWN_TOPIC, True)
        deadline = time.monotonic() + 15.0
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        role_stats = {role: bus.latest(ROLE_STATS_TOPIC + role)[0] for role in roles}
        bus.close()
        if workdir is not None:
            try:
                os.unlink(bus_path)
                os.rmdir(workdir)
            except OSError:
                pass
    stats["roles"] = role_stats
    return stats


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--follower", default="point", choices=["point", "tracking"])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--goal", type=float, nargs=2, default=(1.0, -1.0))
    ap.add_argument(
        "--safety-stop", type=float, default=None, metavar="DIST",
        help="add the safety-monitor role (own OS process) gating cmd_vel",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device of every role (default: the card, shared by the role "
             "processes; 'cpu' runs them on the host)",
    )
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    stats = run_multiprocess(
        args.follower, args.duration, tuple(args.goal),
        safety_stop=args.safety_stop, role_device=args.device,
    )
    for name, s in stats.get("tasks", {}).items():
        log.info(
            "%-14s %5.1f Hz  runs=%-5d misses=%-3d max_late=%.3fs",
            name, s["rate_hz"], s["runs"], s["misses"], s["max_lateness_s"],
        )
    log.info(
        "goal_reached=%s pose=%s",
        stats.get("goal_reached"), np.round(stats.get("final_pose", np.full(3, np.nan)), 3),
    )
    raise SystemExit(0 if stats.get("goal_reached") else 1)


if __name__ == "__main__":
    main()

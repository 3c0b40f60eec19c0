"""In-process message bus + tf registry: the deterministic stand-in for DDS.

The port's own copy of :mod:`ros2_mpc_tpu.nodes.bus` (NumPy only; the port
imports nothing of the JAX package).

The reference's only transport is ROS 2 DDS pub/sub wrapped by eight rclpy
Node classes (ros2_mpc/core/ros_topics.py) plus tf2 lookups/broadcasts
(core/robot_state_publisher.py:21-32, core/transform_publisher.py:14-29).
Subscribers there follow a *pull* idiom — ``get_X()`` spins the executor once
and returns the last cached callback value (ros_topics.py:38-40,83-86) — with
last-writer-wins shared state and no locks (SURVEY.md §5 "race detection:
none").

This bus keeps the same pull semantics but is single-process, lock-guarded,
and versioned: every publish increments a sequence number, so tests can
assert exactly which snapshot a consumer read.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import defaultdict
from typing import Any, Callable, Optional

import numpy as np


# --- message types (the subset of nav_msgs/geometry_msgs/sensor_msgs used) ---


@dataclasses.dataclass
class Twist:
    """geometry_msgs/Twist restricted to (linear.x, angular.z) — the only
    fields the reference writes (ros_topics.py:49-52)."""

    linear_x: float = 0.0
    angular_z: float = 0.0


@dataclasses.dataclass
class Quaternion:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    w: float = 1.0


@dataclasses.dataclass
class Pose:
    x: float = 0.0
    y: float = 0.0
    orientation: Quaternion = dataclasses.field(default_factory=Quaternion)


@dataclasses.dataclass
class PoseStamped:
    frame_id: str = "map"
    pose: Pose = dataclasses.field(default_factory=Pose)


@dataclasses.dataclass
class Odometry:
    pose: Pose = dataclasses.field(default_factory=Pose)
    twist: Twist = dataclasses.field(default_factory=Twist)


@dataclasses.dataclass
class LaserScan:
    ranges: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    angle_min: float = -np.pi
    angle_max: float = np.pi


@dataclasses.dataclass
class MapMetaData:
    resolution: float = 0.05
    width: int = 0
    height: int = 0
    origin_x: float = 0.0
    origin_y: float = 0.0


@dataclasses.dataclass
class OccupancyGrid:
    info: MapMetaData = dataclasses.field(default_factory=MapMetaData)
    data: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 0)))
    frame_id: str = "map"


@dataclasses.dataclass
class Path:
    frame_id: str = "map"
    poses: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Transform:
    """Minimal tf: 2D translation + yaw quaternion."""

    x: float = 0.0
    y: float = 0.0
    orientation: Quaternion = dataclasses.field(default_factory=Quaternion)


# --- the bus ---


class MessageBus:
    """Topic pub/sub + tf frames, versioned, thread-safe."""

    def __init__(self):
        self._lock = threading.RLock()
        self._latest: dict[str, Any] = {}
        self._seq: dict[str, int] = defaultdict(int)
        self._callbacks: dict[str, list[Callable[[Any], None]]] = defaultdict(list)
        self._tf: dict[tuple[str, str], Transform] = {}
        self._sub_counts: dict[str, int] = defaultdict(int)
        self._taps: list[Callable[[str, Any, int], None]] = []

    # pub/sub
    def publish(self, topic: str, msg: Any) -> int:
        with self._lock:
            self._latest[topic] = msg
            self._seq[topic] += 1
            seq = self._seq[topic]
            callbacks = list(self._callbacks[topic])
            taps = list(self._taps)
        for cb in callbacks:
            cb(msg)
        for tap in taps:
            tap(topic, msg, seq)
        return seq

    def tap(self, callback: Callable[[str, Any, int], None]):
        """Wildcard observer: ``callback(topic, msg, seq)`` on EVERY publish
        (the bag recorder's hook, nodes/bag.py). Taps see messages after
        per-topic callbacks and never block publishers holding the lock."""
        with self._lock:
            self._taps.append(callback)

    def untap(self, callback: Callable[[str, Any, int], None]):
        with self._lock:
            if callback in self._taps:
                self._taps.remove(callback)

    def subscribe(self, topic: str, callback: Optional[Callable[[Any], None]] = None):
        with self._lock:
            self._sub_counts[topic] += 1
            if callback is not None:
                self._callbacks[topic].append(callback)

    def latest(self, topic: str):
        """Pull idiom: last cached value (None before any publish) and its
        sequence number."""
        with self._lock:
            return self._latest.get(topic), self._seq[topic]

    def subscription_count(self, topic: str) -> int:
        with self._lock:
            return self._sub_counts[topic]

    # tf
    def set_transform(self, parent: str, child: str, tf: Transform):
        with self._lock:
            self._tf[(parent, child)] = tf

    def lookup_transform(self, target: str, source: str) -> Optional[Transform]:
        with self._lock:
            return self._tf.get((target, source))

"""Safety monitor (the port's own copy of :mod:`ros2_mpc_tpu.nodes.safety`):
a command-chain collision guard (nav2's collision-monitor
role; the reference ships nothing between its MPC output and the motors —
a bad solve's command goes straight to cmd_vel,
ros2_mpc/scripts/path_follower_local_planner.py:194-203).

The monitor sits between the follower and the robot: the follower publishes
to ``cmd_vel_raw``; every raw command is gated against the LATEST laser scan
and forwarded to ``cmd_vel`` — zeroed when the commanded motion direction
has a return closer than ``stop_distance`` inside a ``+/- fov_half_angle``
arc. Event-driven (a bus callback), so the gate adds zero scheduling
latency and needs no rate task; it fails CLOSED in the sense that motion
toward an imminent contact is suppressed while rotation in place (v = 0)
always passes — turning away is the escape the MPC will find next tick.

This is deliberately dumb and independent of the MPC stack: no costmaps, no
map, no solver state — just the raw scan and the command. Layered safety
means the LAST stage must not share failure modes with the planner it
guards.
"""

from __future__ import annotations

import numpy as np

from ..config import Params
from .bus import MessageBus, Twist
from .topics import LaserSubscriber


class SafetyMonitorNode:
    def __init__(
        self,
        bus: MessageBus,
        params: Params = Params(),
        stop_distance: float = 0.25,
        fov_half_angle: float = np.pi / 3,
        in_topic: str = "cmd_vel_raw",
        out_topic: str = "cmd_vel",
    ):
        self.bus = bus
        self.stop_distance = float(stop_distance)
        self.fov_half_angle = float(fov_half_angle)
        self.out_topic = out_topic
        self.laser = LaserSubscriber(bus)
        self.n_blocked = 0
        self.n_passed = 0
        self.last_clearance = np.inf
        bus.subscribe(in_topic, self._on_cmd)

    def _motion_clearance(self, v: float) -> float:
        """Min finite scan range inside the arc around the commanded motion
        direction (0 rad = robot forward; pi = reverse). inf when the scan
        is absent or the arc is empty — an absent sensor must not freeze
        rotation-only recovery, and the follower stack upstream already
        refuses to act without sensors."""
        scan, angle_span = self.laser.get_scan()
        if scan is None:
            return np.inf
        ranges = np.asarray(scan, dtype=float)
        # the codebase-wide beam convention (sim lidar, ops/grid, mapper):
        # angle_min + i * span / n, endpoint-EXCLUSIVE — an endpoint-
        # inclusive linspace would skew each beam by up to one spacing
        n = len(ranges)
        angles = angle_span[0] + np.arange(n) * (angle_span[1] - angle_span[0]) / n
        heading = 0.0 if v > 0 else np.pi
        d = np.abs((angles - heading + np.pi) % (2 * np.pi) - np.pi)
        arc = ranges[(d <= self.fov_half_angle) & np.isfinite(ranges) & (ranges > 0)]
        return float(arc.min()) if arc.size else np.inf

    def _on_cmd(self, msg: Twist):
        v = float(msg.linear_x)
        if v != 0.0:
            clearance = self._motion_clearance(v)
            self.last_clearance = clearance
            if clearance < self.stop_distance:
                self.n_blocked += 1
                self.bus.publish(self.out_topic, Twist(0.0, float(msg.angular_z)))
                return
        self.n_passed += 1
        self.bus.publish(self.out_topic, msg)

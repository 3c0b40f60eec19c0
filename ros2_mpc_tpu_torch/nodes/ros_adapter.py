"""Optional rclpy edge adapter — the port's own copy of
:mod:`ros2_mpc_tpu.nodes.ros_adapter`.

The BASELINE north star keeps the ROS 2 nodes as "a thin host shim calling
the solver". When rclpy is installed (a real robot / ROS 2 system),
:class:`RclpyBusBridge` mirrors the in-process bus topics onto DDS so the
node graph in this package drives a physical robot unchanged; without rclpy
everything runs on the in-process bus (tests, simulation, benchmarks).

This module is import-guarded: it must not be imported at package import
time (rclpy is absent in CI and on the GPU hosts). Its conversion and
spin-pacing contract is pinned without ROS by tests/test_torch_ros_adapter.py,
which injects a structural fake rclpy via sys.modules.
"""

from __future__ import annotations

import numpy as np

from .bus import LaserScan, MessageBus, Odometry, Pose, PoseStamped, Quaternion, Twist

try:
    import rclpy  # type: ignore
    from geometry_msgs.msg import PoseStamped as RosPoseStamped  # type: ignore
    from geometry_msgs.msg import Twist as RosTwist  # type: ignore
    from nav_msgs.msg import OccupancyGrid as RosOccupancyGrid  # type: ignore
    from nav_msgs.msg import Odometry as RosOdometry  # type: ignore
    from nav_msgs.msg import Path as RosPath  # type: ignore
    from sensor_msgs.msg import LaserScan as RosLaserScan  # type: ignore

    HAVE_RCLPY = True
except ImportError:  # pragma: no cover - rclpy genuinely absent
    HAVE_RCLPY = False


class RclpyBusBridge:
    """Bidirectional bridge: DDS sensor topics -> bus, bus outputs -> DDS.

    Topic map (the reference's live graph, ros2_mpc/core/ros_topics.py:11-194):
    ``/scan`` (LaserScan), ``/robot_position`` (Odometry), ``/goal_pose``
    (PoseStamped), and ``/map`` (OccupancyGrid — the ROS system owns the
    map server on a real robot) flow DDS -> bus; ``cmd_vel`` (Twist) flows
    bus -> DDS. With ``operator_topics=True`` (default) the operator
    cockpit's displays are mirrored out too: ``smoothed_plan`` (Path) and
    ``/my_local_costmap``/``/my_global_costmap`` (OccupancyGrid) — the
    topics config/rviz_tpu_mpc.rviz visualizes (reference counterpart
    config/rviz_config.rviz:56-295). ``/map`` is deliberately inbound-only:
    republishing it would echo the bridge's own subscription.
    """

    def __init__(
        self,
        bus: MessageBus,
        node_name: str = "cuda_mpc_bridge",
        operator_topics: bool = True,
    ):
        if not HAVE_RCLPY:
            raise ImportError("rclpy is not available; use the in-process bus instead")
        # idempotent init: a host process may own the rclpy context already
        # (launch files, test harnesses); double-init raises in rclpy.
        # Record ownership so close() only shuts down a context WE created.
        self._owns_context = not rclpy.ok()
        if self._owns_context:
            rclpy.init()
        self.bus = bus
        self.node = rclpy.create_node(node_name)
        self.node.create_subscription(RosLaserScan, "/scan", self._on_scan, 10)
        self.node.create_subscription(RosOdometry, "/robot_position", self._on_odom, 10)
        self.node.create_subscription(RosPoseStamped, "/goal_pose", self._on_goal, 10)
        self.node.create_subscription(RosOccupancyGrid, "/map", self._on_map, 10)
        self._cmd_pub = self.node.create_publisher(RosTwist, "cmd_vel", 10)
        bus.subscribe("cmd_vel", self._on_bus_cmd)
        if operator_topics:
            self._plan_pub = self.node.create_publisher(RosPath, "smoothed_plan", 10)
            bus.subscribe("smoothed_plan", self._on_bus_plan)
            self._grid_pubs = {}
            for topic in ("/my_local_costmap", "/my_global_costmap"):
                self._grid_pubs[topic] = self.node.create_publisher(
                    RosOccupancyGrid, topic, 10
                )
                bus.subscribe(topic, lambda msg, t=topic: self._on_bus_grid(t, msg))

    def _on_scan(self, msg):
        self.bus.publish(
            "/scan",
            LaserScan(ranges=np.asarray(msg.ranges), angle_min=msg.angle_min, angle_max=msg.angle_max),
        )

    def _on_odom(self, msg):
        q = msg.pose.pose.orientation
        self.bus.publish(
            "/robot_position",
            Odometry(
                pose=Pose(
                    x=msg.pose.pose.position.x,
                    y=msg.pose.pose.position.y,
                    orientation=Quaternion(x=q.x, y=q.y, z=q.z, w=q.w),
                )
            ),
        )

    def _on_goal(self, msg):
        q = msg.pose.orientation
        self.bus.publish(
            "/goal_pose",
            PoseStamped(
                pose=Pose(
                    x=msg.pose.position.x,
                    y=msg.pose.position.y,
                    orientation=Quaternion(x=q.x, y=q.y, z=q.z, w=q.w),
                )
            ),
        )

    def _on_map(self, msg):
        """DDS OccupancyGrid -> bus map (the global planner's input; the
        ROS system — nav2 map_server or the reference's — owns the map)."""
        from .bus import MapMetaData, OccupancyGrid

        h, w = int(msg.info.height), int(msg.info.width)
        self.bus.publish(
            "/map",
            OccupancyGrid(
                info=MapMetaData(
                    resolution=float(msg.info.resolution),
                    width=w,
                    height=h,
                    origin_x=float(msg.info.origin.position.x),
                    origin_y=float(msg.info.origin.position.y),
                ),
                data=np.asarray(msg.data).reshape(h, w),
                frame_id=getattr(msg.header, "frame_id", "map") or "map",
            ),
        )

    def _on_bus_cmd(self, msg: Twist):
        out = RosTwist()
        out.linear.x = float(msg.linear_x)
        out.angular.z = float(msg.angular_z)
        self._cmd_pub.publish(out)

    def _on_bus_plan(self, msg):
        """Bus Path -> nav_msgs/Path (the operator's plan display; pose
        layout mirrors scripts/global_path_publisher.py:33-50)."""
        out = RosPath()
        out.header.frame_id = msg.frame_id
        for ps in msg.poses:
            rp = RosPoseStamped()
            rp.pose.position.x = float(ps.pose.x)
            rp.pose.position.y = float(ps.pose.y)
            rp.pose.orientation.z = float(ps.pose.orientation.z)
            rp.pose.orientation.w = float(ps.pose.orientation.w)
            out.poses.append(rp)
        self._plan_pub.publish(out)

    def _on_bus_grid(self, topic: str, msg):
        """Bus OccupancyGrid -> nav_msgs/OccupancyGrid (row-major flatten,
        the reference's publisher layout, ros_topics.py:145-193)."""
        out = RosOccupancyGrid()
        out.header.frame_id = msg.frame_id
        out.info.resolution = float(msg.info.resolution)
        out.info.width = int(msg.info.width)
        out.info.height = int(msg.info.height)
        out.info.origin.position.x = float(msg.info.origin_x)
        out.info.origin.position.y = float(msg.info.origin_y)
        out.data = [int(v) for v in np.asarray(msg.data).flatten()]
        self._grid_pubs[topic].publish(out)

    def spin_once(self, timeout_sec: float = 0.05):
        """Drain pending DDS callbacks, blocking at most ``timeout_sec`` —
        the pacing knob the live rate scheduler calls once per tick (a
        missing topic simply yields no callbacks; the bus keeps its last
        values and the control loop degrades gracefully)."""
        rclpy.spin_once(self.node, timeout_sec=timeout_sec)

    def close(self):
        """Destroy the node and release the rclpy context (only if this
        bridge initialized it — an embedding host, or a second live bridge,
        keeps its own)."""
        self.node.destroy_node()
        if self._owns_context and rclpy.ok():
            rclpy.shutdown()

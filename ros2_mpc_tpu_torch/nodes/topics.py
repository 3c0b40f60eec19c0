"""Topic node classes — API-parity layer for ros2_mpc/core/ros_topics.py.

Each class wraps exactly one topic with the reference's pull-style accessors
(``get_X()`` returns the last cached value), backed by the in-process
:class:`~ros2_mpc_tpu_torch.nodes.bus.MessageBus` instead of rclpy/DDS. The
port's own copy of :mod:`ros2_mpc_tpu.nodes.topics`; its two NumPy helpers
come from the port's own ops. Ingestion
quirks are preserved: odometry and goal values round to 2 decimals
(ros_topics.py:67-80,118-126), the map subscriber thresholds/inverts/flips
the occupancy image (ros_topics.py:27-35).
"""

from __future__ import annotations

import numpy as np

from ..ops.costmap import threshold_map_message
from ..ops.grid import euler_from_quaternion
from .bus import (
    LaserScan,
    MapMetaData,
    MessageBus,
    OccupancyGrid,
    Odometry,
    Path,
    Pose,
    PoseStamped,
    Quaternion,
    Twist,
)


def _euler_np(q: Quaternion):
    r, p, y = euler_from_quaternion(q.x, q.y, q.z, q.w)
    return np.array([float(r), float(p), float(y)])


class BusNode:
    def __init__(self, bus: MessageBus, name: str):
        self.bus = bus
        self.name = name


class MapSubscriber(BusNode):
    """/map subscriber with grayscale thresholding (ros_topics.py:11-40)."""

    def __init__(self, bus: MessageBus):
        super().__init__(bus, "map_subscriber")
        self.map_image = None
        self.map_info = None
        bus.subscribe("/map", self._callback)

    def _callback(self, msg: OccupancyGrid):
        data = np.asarray(msg.data).reshape(msg.info.height, msg.info.width)
        self.map_image = threshold_map_message(data)
        self.map_info = {
            "resolution": msg.info.resolution,
            "origin": np.array([msg.info.origin_x, msg.info.origin_y]),
        }

    def get_map(self):
        return self.map_image, self.map_info


class CmdVelPublisher(BusNode):
    """cmd_vel publisher (ros_topics.py:43-53).

    ``topic`` redirects the output (e.g. to ``cmd_vel_raw`` when a
    SafetyMonitorNode gates the command chain, nodes/safety.py)."""

    def __init__(self, bus: MessageBus, topic: str = "cmd_vel"):
        super().__init__(bus, "cmd_vel_publisher")
        self.topic = topic

    def publish_cmd(self, v: float, w: float):
        self.bus.publish(self.topic, Twist(linear_x=float(v), angular_z=float(w)))


class OdomSubscriber(BusNode):
    """/robot_position subscriber; positions/orientations/velocities rounded
    to 2 decimals at ingestion (ros_topics.py:56-86, quirk #8)."""

    def __init__(self, bus: MessageBus):
        super().__init__(bus, "odom_subscriber")
        self.position = None
        self.orientation = None
        self.velocities = None
        bus.subscribe("/robot_position", self._callback)

    def _callback(self, msg: Odometry):
        self.position = np.array([msg.pose.x, msg.pose.y]).round(decimals=2)
        self.orientation = _euler_np(msg.pose.orientation).round(decimals=2)
        self.velocities = np.array([msg.twist.linear_x, msg.twist.angular_z]).round(decimals=2)

    def get_states(self):
        return self.position, self.orientation


class LaserSubscriber(BusNode):
    """/scan subscriber (ros_topics.py:89-106)."""

    def __init__(self, bus: MessageBus):
        super().__init__(bus, "laser_subscriber")
        self.laser_data = None
        self.angles = None
        bus.subscribe("/scan", self._callback)

    def _callback(self, msg: LaserScan):
        self.laser_data = np.asarray(msg.ranges)
        self.angles = np.array([msg.angle_min, msg.angle_max])

    def get_scan(self):
        return self.laser_data, self.angles


class GoalSubscriber(BusNode):
    """/goal_pose subscriber; goal = [x, y, roll, pitch, yaw] rounded to 2
    decimals (ros_topics.py:109-136)."""

    def __init__(self, bus: MessageBus):
        super().__init__(bus, "goal_subscriber")
        self.goal = None
        bus.subscribe("/goal_pose", self._callback)

    def _callback(self, msg: PoseStamped):
        goal_xy = np.array([msg.pose.x, msg.pose.y]).round(decimals=2)
        goal_euler = _euler_np(msg.pose.orientation).round(decimals=2)
        self.goal = np.concatenate((goal_xy, goal_euler))

    def get_goal(self):
        return self.goal


class LocalCostmapPublisher(BusNode):
    """/my_local_costmap publisher with origin at robot - size/2
    (ros_topics.py:139-155)."""

    def __init__(self, bus: MessageBus):
        super().__init__(bus, "local_costmap_publisher")

    def publish_costmap(self, costmap, costmap_size, robot_pos):
        costmap = np.asarray(costmap)
        msg = OccupancyGrid(
            info=MapMetaData(
                resolution=0.05,
                width=costmap.shape[1],
                height=costmap.shape[0],
                origin_x=float(robot_pos[0]) - costmap_size / 2,
                origin_y=float(robot_pos[1]) - costmap_size / 2,
            ),
            data=costmap,
        )
        self.bus.publish("/my_local_costmap", msg)


class GlobalCostmapPublisher(BusNode):
    """/my_global_costmap publisher (ros_topics.py:158-174)."""

    def __init__(self, bus: MessageBus):
        super().__init__(bus, "global_costmap_publisher")

    def publish_costmap(self, costmap, origin):
        costmap = np.asarray(costmap)
        msg = OccupancyGrid(
            info=MapMetaData(
                resolution=0.05,
                width=costmap.shape[1],
                height=costmap.shape[0],
                origin_x=float(origin[0]),
                origin_y=float(origin[1]),
            ),
            data=costmap,
        )
        self.bus.publish("/my_global_costmap", msg)


class MapServer(BusNode):
    """/map publisher (ros_topics.py:177-194)."""

    def __init__(self, bus: MessageBus):
        super().__init__(bus, "map_server")

    def publish_map(self, map_image, map_info):
        map_image = np.asarray(map_image)
        msg = OccupancyGrid(
            info=MapMetaData(
                resolution=float(map_info["resolution"]),
                width=map_image.shape[1],
                height=map_image.shape[0],
                origin_x=float(map_info["origin"][0]),
                origin_y=float(map_info["origin"][1]),
            ),
            data=map_image,
        )
        self.bus.publish("/map", msg)

    def subscription_count(self) -> int:
        return self.bus.subscription_count("/map")


class PathPublisher(BusNode):
    """'smoothed_plan' publisher with yaw quaternions
    (scripts/global_path_publisher.py:28-51)."""

    def __init__(self, bus: MessageBus):
        super().__init__(bus, "goal_publisher")

    def publish_path(self, path_xy, path_heading):
        msg = Path()
        for i in range(len(path_xy)):
            yaw = float(path_heading[i])
            ps = PoseStamped(
                pose=Pose(
                    x=float(path_xy[i, 0]),
                    y=float(path_xy[i, 1]),
                    orientation=Quaternion(z=np.sin(yaw / 2), w=np.cos(yaw / 2)),
                )
            )
            msg.poses.append(ps)
        self.bus.publish("smoothed_plan", msg)


class GoalPointPublisher(BusNode):
    """'goal_point' carrot publisher
    (scripts/point_follower_local_planner.py:44-60)."""

    def __init__(self, bus: MessageBus):
        super().__init__(bus, "goal_point_publisher")

    def publish_goal_point(self, goal_point):
        yaw = float(goal_point[2])
        self.bus.publish(
            "goal_point",
            PoseStamped(
                pose=Pose(
                    x=float(goal_point[0]),
                    y=float(goal_point[1]),
                    orientation=Quaternion(z=np.sin(yaw / 2), w=np.cos(yaw / 2)),
                )
            ),
        )


class RobotController(BusNode):
    """'smoothed_plan' subscriber caching (path_xy, path_heading)
    (scripts/path_follower_local_planner.py:76-98)."""

    def __init__(self, bus: MessageBus):
        super().__init__(bus, "robot_controller")
        self.path_xy = None
        self.path_heading = None
        bus.subscribe("smoothed_plan", self._callback)

    def _callback(self, msg: Path):
        n = len(msg.poses)
        path = np.zeros((n, 2))
        headings = np.zeros((n, 1))
        for i, ps in enumerate(msg.poses):
            path[i, 0] = ps.pose.x
            path[i, 1] = ps.pose.y
            headings[i] = _euler_np(ps.pose.orientation)[2]
        self.path_xy = path
        self.path_heading = headings

    def get_path(self):
        return self.path_xy, self.path_heading

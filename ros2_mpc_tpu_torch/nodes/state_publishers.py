"""State/tf publisher nodes — the port's own copy of
:mod:`ros2_mpc_tpu.nodes.state_publishers`, behavior-parity rebuilds of
ros2_mpc/core/robot_state_publisher.py:11-79 (tf map->base_footprint lookup
republished as /robot_position Odometry at 20 Hz) and
ros2_mpc/core/transform_publisher.py:11-39 (map->odom broadcast with the
reference's *negated* translation, quirk #7)."""

from __future__ import annotations

from .bus import MessageBus, Odometry, Pose, Transform


class RobotStatePublisherNode:
    """tf(map -> base_footprint) -> /robot_position. In the simulator stack
    the tf frame is set by whoever owns ground truth; a missing transform
    skips the tick exactly like the reference's TransformException handler
    (robot_state_publisher.py:29-32)."""

    def __init__(self, bus: MessageBus):
        self.bus = bus

    def tick(self) -> dict:
        trans = self.bus.lookup_transform("map", "base_footprint")
        if trans is None:
            return {"status": "no_transform"}
        self.bus.publish(
            "/robot_position",
            Odometry(pose=Pose(x=trans.x, y=trans.y, orientation=trans.orientation)),
        )
        return {"status": "published"}


class TransformPublisherNode:
    """/odom -> broadcast map->odom with negated translation
    (transform_publisher.py:25-28, preserved quirk #7)."""

    def __init__(self, bus: MessageBus):
        self.bus = bus
        self.broadcasts = 0
        bus.subscribe("/odom", self._odom_callback)

    def _odom_callback(self, msg: Odometry):
        self.broadcasts += 1
        self.bus.set_transform(
            "map",
            "odom",
            Transform(x=-msg.pose.x, y=-msg.pose.y, orientation=msg.pose.orientation),
        )

    def tick(self) -> dict:
        """Subscription-driven node; tick is a liveness probe (the reference
        runs it as rclpy.spin, transform_publisher.py:32-39)."""
        return {"status": "spinning", "broadcasts": self.broadcasts}


def robot_state_main(argv=None):
    """Console entry: the standalone 20 Hz robot state publisher process
    (reference console script 'robot_state_publisher', setup.py:33). The
    node is host code; the simulator it runs against lives on ``--device``."""
    from .live import single_node_main

    return single_node_main(
        lambda bus, params, device: RobotStatePublisherNode(bus),
        "robot_state_pub",
        lambda p: p.state_publish_period,
        # the scaffolding's own state publisher would double /robot_position
        exclude_source_tasks=frozenset({"robot_state"}),
        argv=argv,
    )


def transform_publisher_main(argv=None):
    """Console entry: the standalone map->odom tf publisher process
    (reference console script 'map_odom_tf_publisher', setup.py:38)."""
    from .live import single_node_main

    return single_node_main(
        lambda bus, params, device: TransformPublisherNode(bus),
        "map_odom_tf",
        lambda p: p.state_publish_period,
        argv=argv,
    )

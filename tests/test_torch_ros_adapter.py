"""Contract tests for the port's DDS edge
(``ros2_mpc_tpu_torch.nodes.ros_adapter.RclpyBusBridge``, its own copy of
the JAX package's) without a ROS installation, mirroring
tests/test_ros_adapter.py: a structural fake rclpy (+ message modules) is
injected via sys.modules, then the bridge's message conversions, spin
pacing, missing-topic behavior, and context lifecycle are pinned.

This is the one component standing between the framework and a physical
robot (reference counterpart: ros2_mpc/core/ros_topics.py:11-106). rclpy is
installed on no machine this repository runs on, so these tests are its
only check. Bus messages are NumPy in both packages, so the contract is the
same.
"""

import importlib
import sys
import types

import numpy as np
import pytest


# ---------------------------------------------------------------- fake rclpy
class _Vec3:
    def __init__(self):
        self.x = 0.0
        self.y = 0.0
        self.z = 0.0


class _Quat(_Vec3):
    def __init__(self):
        super().__init__()
        self.w = 1.0


class _RosPose:
    def __init__(self):
        self.position = _Vec3()
        self.orientation = _Quat()


class _RosPoseStamped:
    def __init__(self):
        self.pose = _RosPose()


class _RosPoseWithCov:
    def __init__(self):
        self.pose = _RosPose()


class _RosOdometry:
    def __init__(self):
        self.pose = _RosPoseWithCov()


class _RosLaserScan:
    def __init__(self):
        self.ranges = []
        self.angle_min = 0.0
        self.angle_max = 0.0


class _RosTwist:
    def __init__(self):
        self.linear = _Vec3()
        self.angular = _Vec3()


class _Header:
    def __init__(self):
        self.frame_id = ""


class _RosPath:
    def __init__(self):
        self.header = _Header()
        self.poses = []


class _MapInfo:
    def __init__(self):
        self.resolution = 0.0
        self.width = 0
        self.height = 0
        self.origin = _RosPose()


class _RosOccupancyGrid:
    def __init__(self):
        self.header = _Header()
        self.info = _MapInfo()
        self.data = []


class _FakeSubscription:
    def __init__(self, msg_type, topic, callback):
        self.msg_type = msg_type
        self.topic = topic
        self.callback = callback


class _FakePublisher:
    def __init__(self, topic):
        self.topic = topic
        self.published = []

    def publish(self, msg):
        self.published.append(msg)


class _FakeNode:
    def __init__(self, name):
        self.name = name
        self.subscriptions = {}
        self.publishers = {}
        self.destroyed = False
        self.pending = []  # (topic, msg) queue drained by spin_once

    def create_subscription(self, msg_type, topic, callback, depth):
        sub = _FakeSubscription(msg_type, topic, callback)
        self.subscriptions[topic] = sub
        return sub

    def create_publisher(self, msg_type, topic, depth):
        pub = _FakePublisher(topic)
        self.publishers[topic] = pub
        return pub

    def destroy_node(self):
        self.destroyed = True


def _make_fake_rclpy():
    rclpy = types.ModuleType("rclpy")
    state = {"ok": False, "nodes": [], "spin_calls": []}
    rclpy._state = state

    def init():
        if state["ok"]:
            raise RuntimeError("rclpy.init() called on an initialized context")
        state["ok"] = True

    def ok():
        return state["ok"]

    def shutdown():
        if not state["ok"]:
            raise RuntimeError("shutdown on uninitialized context")
        state["ok"] = False

    def create_node(name):
        node = _FakeNode(name)
        state["nodes"].append(node)
        return node

    def spin_once(node, timeout_sec=None):
        state["spin_calls"].append((node, timeout_sec))
        if node.pending:
            topic, msg = node.pending.pop(0)
            node.subscriptions[topic].callback(msg)

    rclpy.init = init
    rclpy.ok = ok
    rclpy.shutdown = shutdown
    rclpy.create_node = create_node
    rclpy.spin_once = spin_once

    geometry = types.ModuleType("geometry_msgs")
    geometry_msg = types.ModuleType("geometry_msgs.msg")
    geometry_msg.PoseStamped = _RosPoseStamped
    geometry_msg.Twist = _RosTwist
    geometry.msg = geometry_msg
    nav = types.ModuleType("nav_msgs")
    nav_msg = types.ModuleType("nav_msgs.msg")
    nav_msg.Odometry = _RosOdometry
    nav_msg.Path = _RosPath
    nav_msg.OccupancyGrid = _RosOccupancyGrid
    nav.msg = nav_msg
    sensor = types.ModuleType("sensor_msgs")
    sensor_msg = types.ModuleType("sensor_msgs.msg")
    sensor_msg.LaserScan = _RosLaserScan
    sensor.msg = sensor_msg

    return {
        "rclpy": rclpy,
        "geometry_msgs": geometry,
        "geometry_msgs.msg": geometry_msg,
        "nav_msgs": nav,
        "nav_msgs.msg": nav_msg,
        "sensor_msgs": sensor,
        "sensor_msgs.msg": sensor_msg,
    }


@pytest.fixture()
def adapter():
    """ros_adapter imported against the fake rclpy; restores sys.modules."""
    fakes = _make_fake_rclpy()
    saved = {k: sys.modules.get(k) for k in fakes}
    saved_adapter = sys.modules.pop("ros2_mpc_tpu_torch.nodes.ros_adapter", None)
    sys.modules.update(fakes)
    try:
        mod = importlib.import_module("ros2_mpc_tpu_torch.nodes.ros_adapter")
        mod = importlib.reload(mod)
        assert mod.HAVE_RCLPY
        yield mod, fakes["rclpy"]
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        if saved_adapter is not None:
            sys.modules["ros2_mpc_tpu_torch.nodes.ros_adapter"] = saved_adapter
        else:
            sys.modules.pop("ros2_mpc_tpu_torch.nodes.ros_adapter", None)


def _bridge(mod):
    from ros2_mpc_tpu_torch.nodes.bus import MessageBus

    bus = MessageBus()
    return bus, mod.RclpyBusBridge(bus)


def test_scan_odom_goal_flow_dds_to_bus(adapter):
    """LaserScan/Odometry/PoseStamped DDS messages must land on the bus
    with every field converted (ranges, angle window, position, quaternion)."""
    mod, rclpy = adapter
    bus, bridge = _bridge(mod)
    node = bridge.node
    assert set(node.subscriptions) == {"/scan", "/robot_position", "/goal_pose", "/map"}

    scan = _RosLaserScan()
    scan.ranges = [1.0, 2.5, float("inf")]
    scan.angle_min = -3.14
    scan.angle_max = 3.14
    node.pending.append(("/scan", scan))

    odom = _RosOdometry()
    odom.pose.pose.position.x = 1.25
    odom.pose.pose.position.y = -0.5
    odom.pose.pose.orientation.z = 0.7071
    odom.pose.pose.orientation.w = 0.7071
    node.pending.append(("/robot_position", odom))

    goal = _RosPoseStamped()
    goal.pose.position.x = 2.0
    goal.pose.position.y = 3.0
    goal.pose.orientation.w = 1.0
    node.pending.append(("/goal_pose", goal))

    for _ in range(3):
        bridge.spin_once()

    got_scan, _ = bus.latest("/scan")
    np.testing.assert_allclose(got_scan.ranges, [1.0, 2.5, np.inf])
    assert got_scan.angle_min == -3.14 and got_scan.angle_max == 3.14

    got_odom, _ = bus.latest("/robot_position")
    assert got_odom.pose.x == 1.25 and got_odom.pose.y == -0.5
    assert got_odom.pose.orientation.z == 0.7071
    assert got_odom.pose.orientation.w == 0.7071

    got_goal, _ = bus.latest("/goal_pose")
    assert got_goal.pose.x == 2.0 and got_goal.pose.y == 3.0
    assert got_goal.pose.orientation.w == 1.0


def test_cmd_vel_flows_bus_to_dds(adapter):
    """A Twist published on the bus must appear on the DDS cmd_vel publisher
    with linear.x / angular.z mapped (the differential-drive channels the
    reference publishes, ros_topics.py:49-52)."""
    mod, rclpy = adapter
    from ros2_mpc_tpu_torch.nodes.bus import Twist

    bus, bridge = _bridge(mod)
    bus.publish("cmd_vel", Twist(linear_x=0.15, angular_z=-0.2))
    pub = bridge.node.publishers["cmd_vel"]
    assert len(pub.published) == 1
    out = pub.published[0]
    assert out.linear.x == pytest.approx(0.15)
    assert out.angular.z == pytest.approx(-0.2)
    # y/z linear channels stay zero: a unicycle cannot strafe
    assert out.linear.y == 0.0 and out.angular.x == 0.0


def test_operator_topics_flow_bus_to_dds(adapter):
    """The operator cockpit's displays (smoothed_plan Path, /map and the
    two costmap OccupancyGrids) must mirror from the bus onto DDS with the
    reference's row-major layout (ros_topics.py:145-193) so
    config/rviz_tpu_mpc.rviz renders them."""
    mod, rclpy = adapter
    from ros2_mpc_tpu_torch.nodes.bus import (
        MapMetaData,
        MessageBus,
        OccupancyGrid,
        Pose,
        PoseStamped,
        Quaternion,
    )
    from ros2_mpc_tpu_torch.nodes.bus import Path as BusPath

    bus = MessageBus()
    bridge = mod.RclpyBusBridge(bus)

    plan = BusPath(
        poses=[
            PoseStamped(pose=Pose(x=1.0, y=2.0, orientation=Quaternion(z=0.5, w=0.866))),
            PoseStamped(pose=Pose(x=1.5, y=2.5)),
        ]
    )
    bus.publish("smoothed_plan", plan)
    out = bridge.node.publishers["smoothed_plan"].published[-1]
    assert out.header.frame_id == "map"
    assert len(out.poses) == 2
    assert out.poses[0].pose.position.x == 1.0
    assert out.poses[0].pose.orientation.z == 0.5
    assert out.poses[1].pose.position.y == 2.5

    grid = OccupancyGrid(
        info=MapMetaData(resolution=0.05, width=3, height=2, origin_x=-1.0, origin_y=2.0),
        data=np.array([[0, 100, 0], [100, 0, 100]]),
    )
    for topic in ("/my_local_costmap", "/my_global_costmap"):
        bus.publish(topic, grid)
        got = bridge.node.publishers[topic].published[-1]
        assert got.info.width == 3 and got.info.height == 2
        assert got.info.resolution == 0.05
        assert got.info.origin.position.x == -1.0
        assert got.info.origin.position.y == 2.0
        assert got.data == [0, 100, 0, 100, 0, 100]  # row-major flatten
    # /map is inbound-only: republishing would echo the bridge's own
    # subscription back to DDS
    assert "/map" not in bridge.node.publishers

    # operator_topics=False: a lean robot-only bridge
    bridge2 = mod.RclpyBusBridge(MessageBus(), node_name="lean", operator_topics=False)
    assert set(bridge2.node.publishers) == {"cmd_vel"}


def test_map_flows_dds_to_bus(adapter):
    """A nav2/reference map server's /map OccupancyGrid must land on the
    bus reshaped (h, w) with its metadata — the global planner's input in
    --source ros mode."""
    mod, rclpy = adapter
    bus, bridge = _bridge(mod)
    msg = _RosOccupancyGrid()
    msg.header.frame_id = "map"
    msg.info.resolution = 0.1
    msg.info.width = 3
    msg.info.height = 2
    msg.info.origin.position.x = -4.84
    msg.info.origin.position.y = -6.61
    msg.data = [0, 100, 0, 100, 0, 100]
    bridge.node.pending.append(("/map", msg))
    bridge.spin_once()
    got, _ = bus.latest("/map")
    assert got.info.width == 3 and got.info.height == 2
    assert got.info.resolution == 0.1
    assert got.info.origin_x == -4.84 and got.info.origin_y == -6.61
    np.testing.assert_array_equal(got.data, [[0, 100, 0], [100, 0, 100]])


def test_spin_once_paces_and_tolerates_missing_topics(adapter):
    """spin_once must forward the timeout to rclpy (the live scheduler's
    pacing contract) and be a no-op when no DDS traffic exists."""
    mod, rclpy = adapter
    bus, bridge = _bridge(mod)
    bridge.spin_once(timeout_sec=0.25)
    assert rclpy._state["spin_calls"][-1] == (bridge.node, 0.25)
    # no traffic: nothing lands on the bus, nothing raises
    assert bus.latest("/scan")[0] is None
    assert bus.latest("/robot_position")[0] is None


def test_context_lifecycle_idempotent_init_and_close(adapter):
    """Init must be idempotent (an embedding host may own the context) and
    close() must destroy the node and release the context exactly once."""
    mod, rclpy = adapter
    from ros2_mpc_tpu_torch.nodes.bus import MessageBus

    bus = MessageBus()
    bridge = mod.RclpyBusBridge(bus)
    # second bridge over the SAME initialized context must not raise
    bridge2 = mod.RclpyBusBridge(MessageBus(), node_name="second")
    assert rclpy.ok()
    bridge.close()
    assert bridge.node.destroyed
    assert not rclpy.ok()
    # closing the second after the context is gone must not raise
    bridge2.close()
    assert bridge2.node.destroyed

"""The port's host layer of the node graph held against the JAX package's
(``tests/test_nodes.py``): the bus, the topic ingestion quirks, the
reference-generation helpers in corrected and parity mode, the state
publishers and the safety monitor, each fed the same seeded inputs in both
packages, on the CPU.

Bands: NumPy host code (bus, topics, reference windows, carrots, the
corrected obstacle extraction, the slew limiter, the safety gate) exactly
equal; the path subscriber's headings (float32 quaternion-to-yaw, whose
atan2 may differ by an ulp) and the parity-mode obstacle extraction, which
runs the grid ops, within 1e-6.
"""

import numpy as np
import pytest

from ros2_mpc_tpu.nodes import bus as jbus
from ros2_mpc_tpu.nodes import reference_gen as jref
from ros2_mpc_tpu.nodes import safety as jsafety
from ros2_mpc_tpu.nodes import state_publishers as jstate
from ros2_mpc_tpu.nodes import topics as jtopics
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.nodes import bus as tbus
from ros2_mpc_tpu_torch.nodes import reference_gen as tref
from ros2_mpc_tpu_torch.nodes import safety as tsafety
from ros2_mpc_tpu_torch.nodes import state_publishers as tstate
from ros2_mpc_tpu_torch.nodes import topics as ttopics

PARAMS = Params()
PKGS = {"jax": (jbus, jtopics, jstate, jsafety), "port": (tbus, ttopics, tstate, tsafety)}


def yaw_quat(b, yaw):
    return b.Quaternion(z=np.sin(yaw / 2), w=np.cos(yaw / 2))


def test_bus_pull_semantics_match():
    seen = {}
    for name, (b, *_) in PKGS.items():
        bus = b.MessageBus()
        log = []
        bus.subscribe("/x", log.append)
        bus.tap(lambda topic, msg, seq: log.append((topic, seq)))
        first = bus.latest("/x")
        bus.publish("/x", 41)
        bus.publish("/x", 42)
        bus.set_transform("map", "odom", b.Transform(x=1.0))
        seen[name] = (first, bus.latest("/x"), log, bus.subscription_count("/x"), bus.lookup_transform("map", "odom").x)
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == (42, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topic_quirks_match(seed):
    """Odometry and goal rounding to 2 decimals (quirk #8), the goal's
    five-vector, the map subscriber's threshold-invert-flip, the path
    subscriber's headings and the negated map->odom transform (quirk #7)."""
    rng = np.random.default_rng(seed)
    x, y, yaw, gyaw = rng.uniform(-3, 3), rng.uniform(-3, 3), rng.uniform(-np.pi, np.pi), rng.uniform(-np.pi, np.pi)
    grid = rng.integers(-1, 101, size=(20, 30)).astype(np.int8)
    path = rng.uniform(-2, 2, size=(12, 2))
    heading = rng.uniform(-np.pi, np.pi, size=12)
    out = {}
    for name, (b, tp, st, _) in PKGS.items():
        bus = b.MessageBus()
        odom, goal, mp, ctrl = tp.OdomSubscriber(bus), tp.GoalSubscriber(bus), tp.MapSubscriber(bus), tp.RobotController(bus)
        tf = st.TransformPublisherNode(bus)
        bus.publish("/robot_position", b.Odometry(pose=b.Pose(x=x, y=y, orientation=yaw_quat(b, yaw))))
        bus.publish("/goal_pose", b.PoseStamped(pose=b.Pose(x=-x, y=y / 3, orientation=yaw_quat(b, gyaw))))
        tp.MapServer(bus).publish_map(grid, {"resolution": 0.05, "origin": [-1.0, -0.5]})
        tp.PathPublisher(bus).publish_path(path, heading)
        bus.publish("/odom", b.Odometry(pose=b.Pose(x=x, y=-y)))
        t = bus.lookup_transform("map", "odom")
        out[name] = (*odom.get_states(), goal.get_goal(), mp.get_map()[0], *ctrl.get_path(), (t.x, t.y), tf.tick())
    for i, (got, want) in enumerate(zip(out["port"], out["jax"])):
        if i == 5:  # path headings: float32 atan2, one ulp apart at most
            np.testing.assert_allclose(got, want, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    assert out["port"][2].shape == (5,)


def test_reference_windows_and_carrot_match():
    """Motion profile quirks (v doubled, omega halved), the tracking window
    with its goal tiling and end padding, and the carrot."""
    path = np.stack([np.linspace(0, 2, 50), 0.3 * np.sin(np.linspace(0, 3, 50))], axis=1)
    goal = np.array([2.0, 0.1, 0.0, 0.0, 0.7])
    for ref in (jref, tref):
        assert ref.get_headings is ref.path_motion_profile
    prof = tref.get_headings(path, 0.2)
    for got, want in zip(prof, jref.get_headings(path, 0.2)):
        np.testing.assert_array_equal(got, want)
    for x0 in ([0.0, 0.0, 0.0], [1.9, 0.1, 0.0], [5.0, 3.0, 0.0], [0.7, 0.2, 1.0]):
        got = tref.get_reference_trajectory(np.array(x0), goal, path, *prof, 10)
        want = jref.get_reference_trajectory(np.array(x0), goal, path, *prof, 10)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            tref.get_goal_for_mpc(path, prof[0], goal, np.array(x0[:2]), 0.5),
            jref.get_goal_for_mpc(path, prof[0], goal, np.array(x0[:2]), 0.5),
        )
    np.testing.assert_array_equal(tref.path_yaw_profile(path), jref.path_yaw_profile(path))


@pytest.mark.parametrize("normalized", [True, False])
def test_parity_obstacle_extraction_matches(normalized):
    """get_obstacles through the grid ops: the point follower's normalized
    variant finds the (transposed) cloud, the tracking node's quirk always
    degenerates to the 100 m sentinels; an all-inf scan rasterizes the
    phantom self-obstacle (quirk #10)."""
    n = PARAMS.n_obstacle_points
    rng = np.random.default_rng(11)
    scan = np.full(360, np.inf)
    scan[rng.integers(0, 360, size=40)] = rng.uniform(0.2, 1.9, size=40)
    angles = np.array([-np.pi, np.pi])
    for s, pos, ori in ((scan, np.array([0.5, -0.3]), np.array([0.0, 0.0, 0.4])), (np.full(360, np.inf), np.zeros(2), np.zeros(3))):
        args = (s, angles, PARAMS.costmap_size, PARAMS.resolution, pos, ori, n)
        gx, gy = tref.get_obstacles(*args, normalized=normalized, device="cpu")
        wx, wy = jref.get_obstacles(*args, normalized=normalized)
        assert gx.shape == (n,)
        np.testing.assert_allclose(gx, wx, atol=1e-6)
        np.testing.assert_allclose(gy, wy, atol=1e-6)
    if not normalized:
        np.testing.assert_array_equal(gx, 100.0)


def test_corrected_obstacle_filter_matches():
    """mapped_structure_mask, scan_to_world_obstacles with and without the
    static mask (nearest-first truncation, far sentinels), the cached
    StaticStructureFilter, and the slew limiter's +slew quirk (#6)."""
    rng = np.random.default_rng(12)
    img = np.where(rng.uniform(size=(60, 70)) > 0.97, 255, 0).astype(np.uint8)
    for d in (0, 2, 3):
        np.testing.assert_array_equal(tref.mapped_structure_mask(img, d), jref.mapped_structure_mask(img, d))
    info = {"resolution": 0.05, "origin": (-1.5, -1.5)}
    scan = rng.uniform(0.1, 3.0, size=360)
    scan[rng.integers(0, 360, size=30)] = np.inf
    for mask in (None, jref.mapped_structure_mask(img, 3)):
        for n in (160, 20):
            args = (scan, (-np.pi, np.pi), 2.0, np.array([0.2, 0.1]), 0.3, n)
            got = tref.scan_to_world_obstacles(*args, static_mask=mask, map_info=info)
            want = jref.scan_to_world_obstacles(*args, static_mask=mask, map_info=info)
            np.testing.assert_array_equal(got, want)
    for u, last in (([0.1, -0.1], [0.0, 0.0]), ([0.01, 0.01], [0.0, 0.0]), ([0.12, 0.05], [0.1, 0.04])):
        assert tref.slew_limited_command(np.array(u), np.array(last), 0.03)[:2] == jref.slew_limited_command(
            np.array(u), np.array(last), 0.03
        )[:2]
    outs = []
    for b, tp, *_ in PKGS.values():
        bus = b.MessageBus()
        filt = (tref if b is tbus else jref).StaticStructureFilter(tp.MapSubscriber(bus))
        before = filt.current()
        tp.MapServer(bus).publish_map(np.where(img > 0, 100, 0), info)
        outs.append((before, *filt.current()))
    assert outs[0][0] == outs[1][0] == (None, None)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_safety_monitor_matches():
    """The command-chain guard: the same scans and raw commands give the
    same forwarded commands and counters."""
    cmds = [(0.1, 0.05), (-0.1, 0.0), (0.0, 0.2), (0.15, -0.1), (0.05, 0.0)]
    results = {}
    for name, (b, tp, _, sf) in PKGS.items():
        bus = b.MessageBus()
        mon = sf.SafetyMonitorNode(bus, PARAMS, stop_distance=0.25)
        out = []
        bus.subscribe("cmd_vel", lambda m, out=out: out.append((m.linear_x, m.angular_z)))
        bus.publish("cmd_vel_raw", b.Twist(0.1, 0.0))  # no scan yet: passes
        rng_k = np.random.default_rng(14)
        for v, w in cmds:
            ranges = rng_k.uniform(0.15, 3.0, size=360)
            bus.publish("/scan", b.LaserScan(ranges=ranges))
            bus.publish("cmd_vel_raw", b.Twist(v, w))
        results[name] = (out, mon.n_blocked, mon.n_passed, mon.last_clearance)
    assert results["port"] == results["jax"]
    assert results["port"][1] > 0 and results["port"][2] > 0

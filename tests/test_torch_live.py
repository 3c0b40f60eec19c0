"""The port's wall-clock live graph (``ros2_mpc_tpu_torch.nodes.live``), its
console mains and its viz node, held against the JAX package's
(tests/test_live.py) on the CPU.

No test here reads the wall clock: the scheduler runs on a virtual clock
(``monotonic`` returns it, ``sleep`` advances it, a task advances it by its
scripted runtime) patched into both packages' ``live`` modules, so the port's
and the JAX package's ``RateScheduler`` see the same times and must count
the same runs, misses and lateness exactly. Viz frames: the PNG bytes of
``utils.viz`` equal to the JAX package's."""

import numpy as np
import pytest
import torch

import ros2_mpc_tpu.nodes.live as jlive
from ros2_mpc_tpu.nodes.costmap_nodes import LocalCostmapNode as JLocalCostmapNode
import ros2_mpc_tpu_torch.nodes.live as live
from ros2_mpc_tpu.utils import viz as jviz
from ros2_mpc_tpu_torch.nodes import (
    costmap_nodes,
    global_path_publisher,
    launch,
    map_server,
    multiproc,
    path_follower,
    point_follower,
    state_publishers,
)
from ros2_mpc_tpu_torch.utils import viz


class VirtualClock:
    """``time.monotonic``/``time.sleep`` on a counter no wall clock moves."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


@pytest.fixture
def clocks(monkeypatch):
    """Separate virtual clocks in the port's and the JAX package's live modules."""
    port, ref = VirtualClock(), VirtualClock()
    monkeypatch.setattr(live, "time", port)
    monkeypatch.setattr(jlive, "time", ref)
    return port, ref


# (name, period, runtimes cycled through its runs)
SCHEDULES = {
    "ample budget": [("a", 0.01, [0.0]), ("b", 0.05, [0.0])],
    "slow task": [("slow", 0.01, [0.05])],
    "live graph": [
        ("robot_state", 0.05, [0.001]),
        ("local_costmap", 0.1, [0.02, 0.03]),
        ("control", 0.2, [0.05, 0.15, 0.32, 0.05, 0.04]),
        ("replan", 1.0, [0.12]),
    ],
}


def run_schedule(module, clock, schedule, duration):
    tasks = []
    for name, period, runtimes in schedule:
        it = iter(runtimes * 1000)
        tasks.append(module.Task(name, period, lambda it=it: clock.sleep(next(it))))
    return module.RateScheduler(tasks).run(duration, warmup=False)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_rate_scheduler_matches_jax_on_a_virtual_clock(clocks, schedule):
    port, ref = clocks
    got = run_schedule(live, port, SCHEDULES[schedule], 3.0)
    want = run_schedule(jlive, ref, SCHEDULES[schedule], 3.0)
    assert got == want
    tasks = got["tasks"]
    if schedule == "ample budget":  # nominal rates, no misses
        assert tasks["a"]["runs"] == 300 and tasks["b"]["runs"] == 60
        assert tasks["a"]["misses"] == tasks["b"]["misses"] == 0
    elif schedule == "slow task":  # no catch-up burst: the deadline grid skips ahead
        assert tasks["slow"]["runs"] == 60 and tasks["slow"]["misses"] == 0
    else:  # the 0.32 s control runs make the others late
        assert tasks["control"]["misses"] > 0 and tasks["robot_state"]["max_lateness_s"] > 0.025


def test_robot_state_publisher_on_live_data_path():
    """/robot_position comes from the tf chain through
    RobotStatePublisherNode (robot_state_publisher.py:21-32,57-65)."""
    stack = live.build_live_stack(follower="point", horizon=8, device="cpu")
    assert stack.robot_state.tick()["status"] in ("published", "no_transform")
    stack.sim.pose = torch.tensor([0.3, -0.7, 0.5])
    live.SimLocalization(stack.bus, stack.sim).tick()
    assert stack.robot_state.tick()["status"] == "published"
    msg, _ = stack.bus.latest("/robot_position")
    assert msg.pose.x == pytest.approx(0.3) and msg.pose.y == pytest.approx(-0.7)
    assert stack.follower.device.type == "cpu" and stack.sim.pose.device.type == "cpu"


def test_run_single_node_costmap_publishes(clocks):
    """A lone costmap node against the simulator source publishes real
    costmaps at 10 Hz of the virtual clock, as the JAX package's does."""
    stats = live.run_single_node(
        lambda bus, params, device: costmap_nodes.LocalCostmapNode(bus, params, device=device),
        "local_costmap", lambda p: p.local_costmap_period, duration=1.0, device="cpu",
    )
    want = jlive.run_single_node(
        JLocalCostmapNode, "local_costmap", lambda p: p.local_costmap_period, duration=1.0
    )
    assert stats["tasks"]["local_costmap"]["runs"] == want["tasks"]["local_costmap"]["runs"] >= 9
    assert set(stats["tasks"]) == set(want["tasks"])


def test_live_viz_renders_frames(clocks, tmp_path):
    """The viz task renders PNG frames of the running stack at 1 Hz (control
    ticks on K1's plain version here, 1.1 s of the virtual clock)."""
    stack = live.build_live_stack(follower="point", horizon=8, viz_dir=str(tmp_path), device="cpu")
    stack.publish_goal(1.0, -1.0)
    stats = stack.run(duration=1.1, stop_on_goal=False)
    assert stats["tasks"]["viz"]["runs"] == 1 and stats["tasks"]["control"]["runs"] == 5
    assert stats["final_pose"].shape == (3,) and not stats["goal_reached"]
    data = (tmp_path / "latest.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000


def test_render_world_png_bytes_equal_to_jax(tmp_path):
    rng = np.random.default_rng(4)
    img = np.full((60, 80), 254, np.uint8)
    img[rng.random(img.shape) < 0.1] = 0
    img[:10] = 205
    info = {"resolution": 0.05, "origin": np.array([-2.0, -1.5])}
    kw = dict(
        robot_trace=np.cumsum(rng.normal(0, 0.05, (30, 3)), axis=0),
        path_xy=rng.uniform(-1.5, 1.5, (20, 2)),
        goal_xy=(1.0, 0.5),
        scan_xy=rng.uniform(-2.5, 2.5, (90, 2)),  # some off the map
    )
    got = viz.render_world(img, info, out_path=str(tmp_path / "port.png"), **kw)
    want = jviz.render_world(img, info, out_path=str(tmp_path / "jax.png"), **kw)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


MAINS = {
    "point_follower": (point_follower.main, ["--duration", "0.3"]),
    "path_follower": (path_follower.main, ["--duration", "0.3"]),
    "live": (live.main, ["--duration", "0.3"]),
    "local_costmap": (costmap_nodes.local_main, ["--duration", "0.3"]),
    "global_costmap": (costmap_nodes.global_main, ["--duration", "0.3"]),
    "global_costmap_nav": (costmap_nodes.global_nav_main, ["--duration", "0.3"]),
    "robot_state": (state_publishers.robot_state_main, ["--duration", "0.3"]),
    "map_odom_tf": (state_publishers.transform_publisher_main, ["--duration", "0.3"]),
    "map_server": (map_server.main, ["--duration", "0.3"]),
    "path_publisher": (global_path_publisher.main, ["--duration", "0.3"]),
    "launch": (launch.main, []),
    "multiproc": (multiproc.main, ["--duration", "0.3"]),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_console_main_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the mains would run on it")
    main, argv = MAINS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_console_mains_run_with_device_cpu(clocks):
    """With ``--device cpu`` the mains run: a standalone node on the
    simulator source, and the point follower on the live graph (0.3 s of the
    virtual clock: the goal is not reached, so it exits 1)."""
    stats = state_publishers.robot_state_main(["--device", "cpu", "--duration", "0.5"])
    assert stats["tasks"]["robot_state_pub"]["runs"] >= 9 and "robot_state" not in stats["tasks"]
    stats = map_server.main(["--device", "cpu", "--duration", "0.5"])
    assert "map_server" not in stats["tasks"] and stats["tasks"]["map_server_node"]["runs"] == 0
    with pytest.raises(SystemExit) as exc:
        point_follower.main(["--device", "cpu", "--duration", "0.3"])
    assert exc.value.code == 1

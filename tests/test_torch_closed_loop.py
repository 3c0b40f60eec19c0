"""The port's closed loop (``ros2_mpc_tpu_torch.nodes.launch``) held against
the JAX package's (``tests/test_closed_loop.py``) on the CPU: simulator,
map server, global A* planner, costmaps and both followers over the
in-process bus, the followers ticking K1 and K2 at B=1 through their plain
versions.

Bands, each tick of the stacks run side by side: the published command
within 5e-4 (the live band on U), the simulated pose within 1e-3 m (five
ticks of a 5e-4 command at dt 0.2 s), and the lidar at most one march step
(resolution/2 = 0.025 m) apart on at most 1% of the beams (XLA's and
PyTorch's sin/cos may put a ray into the neighbouring cell). The map
server's map, the planner's path and the costmaps exactly equal.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ros2_mpc_tpu.nodes.launch import build_sim_stack as jax_stack
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.nodes.costmap_nodes import GlobalCostmapNode
from ros2_mpc_tpu_torch.nodes.launch import build_sim_stack
from ros2_mpc_tpu_torch.nodes.path_follower import PathFollowerNode
from ros2_mpc_tpu_torch.nodes.point_follower import PointFollowerNode
from ros2_mpc_tpu_torch.utils import pgm

ROOT = Path(__file__).resolve().parent.parent
HORIZON = 12  # tests/test_closed_loop.py
START, GOAL = (-1.0, -1.0, 0.0), (1.0, -1.0)
CMD_ATOL, POSE_ATOL = 5e-4, 1e-3
MARCH_STEP = 0.025
MAX_BEAM_FRAC = 0.01
# ticks to the goal of the JAX package's flagship flow (run_sim_stack's
# scenario: horizon 20, start (-1, -1, 0), goal (1, -1)) on the CPU
JAX_TICKS = {"point": 62, "tracking": 53}


def stack(follower="tracking", **kw):
    kw.setdefault("horizon", HORIZON)
    return build_sim_stack(follower=follower, start_pose=START, device="cpu", **kw)


def scan_of(s):
    return np.asarray(s.bus.latest("/scan")[0].ranges, dtype=np.float64)


def assert_lidar_close(got, want):
    both = np.isfinite(got) & np.isfinite(want)
    assert np.array_equal(np.isfinite(got), np.isfinite(want)) or (
        (np.isfinite(got) != np.isfinite(want)).mean() <= MAX_BEAM_FRAC
    )
    apart = np.abs(got[both] - want[both])
    assert apart.max(initial=0.0) <= MARCH_STEP + 1e-6
    assert (apart > 0).mean() <= MAX_BEAM_FRAC


@pytest.mark.parametrize("follower", ["point", "tracking"])
def test_stack_matches_jax_tick_by_tick(follower):
    js, ts = jax_stack(follower=follower, start_pose=START, horizon=HORIZON), stack(follower)
    assert_lidar_close(scan_of(ts), scan_of(js))
    for s in (js, ts):
        s.publish_goal(*GOAL)
    for _ in range(5):
        oj, ot = js.tick(), ts.tick()
        assert ot["control"]["status"] == oj["control"]["status"]
        assert ot["plan"]["status"] == oj["plan"]["status"]
        cj, ct = js.bus.latest("cmd_vel")[0], ts.bus.latest("cmd_vel")[0]
        np.testing.assert_allclose([ct.linear_x, ct.angular_z], [cj.linear_x, cj.angular_z], atol=CMD_ATOL)
        np.testing.assert_allclose(ot["pose"], np.asarray(oj["pose"]), atol=POSE_ATOL)
        assert_lidar_close(scan_of(ts), scan_of(js))
    assert ot["pose"][0] > START[0] + 0.05  # it drove toward the goal
    assert len(ts.follower.telemetry.series["solve_s"]) == 5 and len(ts.telemetry.series["tick_s"]) == 5


def test_global_planner_publishes_path():
    """The map server's /map and the planner's smoothed path (dilation on
    the device, scan stamping and A* on the host) equal the JAX package's."""
    s, js = stack(), jax_stack(follower="tracking", start_pose=START, horizon=HORIZON)
    np.testing.assert_array_equal(s.map_server.map_image, js.map_server.map_image)
    for st in (s, js):
        st.publish_goal(*GOAL)
    out, jout = s.global_planner.tick(), js.global_planner.tick()
    assert out["status"] == jout["status"] and out["status"] in ("published", "goal_reached")
    np.testing.assert_array_equal(out["path_xy"], jout["path_xy"])
    path_xy, _ = s.follower.robot_controller.get_path()
    assert path_xy is not None and len(path_xy) > 5
    assert np.linalg.norm(path_xy[0] - np.array(START[:2])) < 0.5
    assert np.linalg.norm(path_xy[-1] - np.array(GOAL)) < 0.5


def test_costmap_nodes_publish_and_match_jax():
    s, js = stack(), jax_stack(follower="tracking", start_pose=START, horizon=HORIZON)
    out, jout = s.local_costmap.tick(), js.local_costmap.tick()
    assert out["status"] == "published"
    cells = Params().costmap_cells
    msg, _ = s.bus.latest("/my_local_costmap")
    assert msg.data.shape == (cells, cells) and out["costmap"].dtype == np.uint8
    np.testing.assert_array_equal(out["costmap"], jout["costmap"])
    out2, jout2 = s.global_costmap.tick(), js.global_costmap.tick()
    assert out2["status"] == "published"
    assert s.bus.latest("/my_global_costmap")[0].data.shape == pgm.synthetic_indoor_map().shape
    np.testing.assert_array_equal(out2["costmap"], jout2["costmap"])


def test_simulator_lidar_sees_walls():
    ranges = scan_of(stack())
    assert ranges.shape == (360,)
    finite = ranges[np.isfinite(ranges)]
    assert len(finite) > 10 and finite.min() > 0.1
    assert not stack().sim.in_collision()


@pytest.mark.parametrize("follower", ["point", "tracking"])
def test_failed_solve_degrades_gracefully(follower):
    """A NaN goal does not raise, and a solve that comes back non-finite
    leaves the previous command in place instead of crashing (the
    reference raises, local_planner_tracking.py:74)."""
    s = stack(follower)
    s.publish_goal(*GOAL)
    s.global_planner.tick()
    f = s.follower
    assert f.tick()["status"] in ("tracking", "chasing")
    s.publish_goal(float("nan"), 0.0)
    out = f.tick()
    assert np.isfinite(out["u"]).all()
    s.publish_goal(*GOAL)
    u_last = f.u_last.copy()
    solve = f._solve

    def poisoned(vec, U0):
        sol, nxt = solve(vec, U0)
        return sol._replace(U=torch.full_like(sol.U, float("nan"))), nxt

    f._solve = poisoned
    out = f.tick()
    np.testing.assert_array_equal(out["u"], u_last)
    cmd = s.bus.latest("cmd_vel")[0]
    assert np.isfinite([cmd.linear_x, cmd.angular_z]).all()


def test_unreachable_goal_leaves_the_robot_in_place():
    """A goal off the map: the planner reports it unreachable, the follower
    waits for a path and the robot stays put, as in the JAX package."""
    s, js = stack("point"), jax_stack(follower="point", start_pose=START, horizon=HORIZON)
    for st in (s, js):
        st.publish_goal(20.0, 20.0)
    for _ in range(2):
        out, jout = s.tick(), js.tick()
        assert out["plan"]["status"] == jout["plan"]["status"] == "unreachable"
        assert out["control"]["status"] == jout["control"]["status"] == "waiting_for_path"
    np.testing.assert_allclose(out["pose"], START, atol=1e-6)


def test_safety_stop_gates_the_command_chain():
    """safety_stop puts the monitor between the follower (cmd_vel_raw) and
    the robot (cmd_vel), as in the JAX package."""
    s, js = stack("point", safety_stop=0.3), jax_stack(follower="point", start_pose=START, horizon=HORIZON, safety_stop=0.3)
    for st in (s, js):
        st.publish_goal(*GOAL)
        st.tick()
    assert s.follower.cmd_vel_publisher.topic == "cmd_vel_raw"
    assert (s.safety.n_passed, s.safety.n_blocked) == (js.safety.n_passed, js.safety.n_blocked) == (1, 0)
    cmd, jcmd = s.bus.latest("cmd_vel")[0], js.bus.latest("cmd_vel")[0]
    np.testing.assert_allclose([cmd.linear_x, cmd.angular_z], [jcmd.linear_x, jcmd.angular_z], atol=CMD_ATOL)


def test_global_costmap_file_reload_variant():
    s = stack()
    node = GlobalCostmapNode(
        s.bus,
        Params(),
        map_pgm_path=str(ROOT / "maps" / "map_synthetic.pgm"),
        map_yaml_path=str(ROOT / "maps" / "map_synthetic.yaml"),
        reload_map_every_tick=True,
        device="cpu",
    )
    s.sim.publish_scan()  # node subscribed after the stack's priming
    s.sim.publish_state()
    out = node.tick()
    assert out["status"] == "published" and out["costmap"].shape == (250, 250)
    assert out["costmap"].max() > 0
    assert node.tick()["status"] == "published"


def test_mapper_source_and_escape_options_build():
    """The mapper map source builds, its /map fully unknown at the start, and
    an unknown map source raises ValueError. With ``escape_after`` each
    follower builds, and a forced stall makes exactly one escape tick, on the multistart engine (K1 for
    the point follower, K2 for the path follower, their plain versions
    here), whose generator advances; the command stays finite."""
    mapped = stack(map_source="mapper")
    assert mapped.mapper is not None and mapped.mapper.L.device.type == "cpu"
    assert float((mapped.mapper.occupancy() == -1).mean()) > 0.95
    with pytest.raises(ValueError):
        stack(map_source="cartographer")
    for follower, kind in (("point", "point_stab"), ("tracking", "tracking")):
        s = stack(follower, follower_kwargs=dict(escape_after=3))
        node = s.follower
        assert node.escape_engine.kind == kind
        s.publish_goal(*GOAL)
        s.global_planner.tick()
        assert s.tick()["control"]["escaped"] is False
        state = node._escape_gen.get_state().clone()
        node._stall = 99  # force the stall detector past the threshold
        out = s.tick()["control"]
        assert out["escaped"] is True and node.n_escapes == 1
        assert np.all(np.isfinite(out["u"]))
        assert node._stall == 0  # reset by the escape
        assert not torch.equal(node._escape_gen.get_state(), state)  # the generator moved on
        assert s.tick()["control"]["escaped"] is False


@pytest.mark.slow
@pytest.mark.parametrize("follower", ["point", "tracking"])
def test_follower_escape_recovery_reaches_the_goal(follower):
    """tests/test_mppi.py's escape runs: a forced stall triggers one escape
    tick, the command stays finite, and the robot still reaches the goal
    (point: goal (0.4, -1.6), at most 250 ticks; tracking: (1, -1), at most
    300; horizon 12). 45-60 plain ticks each: 36-51 s alone on a CPU and
    70-85 s beside three other test workers, hence slow."""
    s = stack(follower, follower_kwargs=dict(escape_after=3))
    node = s.follower
    s.publish_goal(*((0.4, -1.6) if follower == "point" else GOAL))
    s.global_planner.tick()
    assert s.tick()["control"].get("escaped") is False
    node._stall = 99
    out = s.tick()["control"]
    assert out["escaped"] is True and node.n_escapes == 1
    assert np.all(np.isfinite(out["u"]))
    assert node._stall in (0, 1)
    reached = any(
        s.tick()["control"].get("status") == "goal_reached" for _ in range(250 if follower == "point" else 300)
    )
    assert reached


def test_stack_runs_on_the_card_by_default(monkeypatch):
    """device=None is the card: without one, build_sim_stack raises rather
    than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sim_stack(follower="point", start_pose=START, horizon=HORIZON)
    s = stack()
    assert s.sim.pose.device.type == "cpu" and s.follower.u_warm.device.type == "cpu"


@pytest.mark.slow
@pytest.mark.parametrize("follower", ["point", "tracking"])
def test_followers_reach_goal_like_jax(follower):
    """run_sim_stack's scenario to the goal: reached, in a tick count within
    10% of the JAX package's."""
    s = stack(follower, horizon=20)
    reached, ticks, pose = s.run_to_goal(GOAL, max_ticks=200)
    assert reached, f"not reached after {ticks} ticks, pose {pose}"
    assert abs(ticks - JAX_TICKS[follower]) <= 0.1 * JAX_TICKS[follower]
    assert np.linalg.norm(pose[:2] - np.array(GOAL)) < Params().goal_threshold + 0.1
    assert not s.sim.in_collision()


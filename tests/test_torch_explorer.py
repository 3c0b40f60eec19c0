"""The port's frontier exploration (``ros2_mpc_tpu_torch.planner.frontier``,
``nodes.explorer``) and its navigate-while-mapping stack held against the
JAX package's (tests/test_explorer.py, tests/test_mapper.py) on the CPU.

Bands: the frontier functions and the explorer are host code, copied, so
their outputs must be equal. The mapper stack ticks K1's plain version here
(~1 s a tick), so it runs 3 ticks beside the JAX stack: poses within 1e-4 m.
The full runs (exploration to completion, navigate-while-mapping to the
goal) are ``cuda``-marked: on the card they hold the JAX test's own bounds.
"""

import numpy as np
import pytest
import torch

from ros2_mpc_tpu.nodes.bus import MessageBus as JBus
from ros2_mpc_tpu.nodes.bus import Odometry as JOdometry
from ros2_mpc_tpu.nodes.bus import Pose as JPose
from ros2_mpc_tpu.nodes.explorer import ExplorerNode as JExplorerNode
from ros2_mpc_tpu.nodes.launch import build_sim_stack as jax_stack
from ros2_mpc_tpu.planner import frontier as jfr
from ros2_mpc_tpu_torch.nodes.bus import MessageBus, Odometry, Pose
from ros2_mpc_tpu_torch.nodes.explorer import ExplorerNode
from ros2_mpc_tpu_torch.nodes.launch import build_sim_stack
from ros2_mpc_tpu_torch.planner import frontier as fr

POSE_ATOL = 1e-4
START = (-1.0, -1.0, 0.0)
# tests/test_explorer.py's and tests/test_mapper.py's scenarios on the JAX
# package (its build_sim_stack on the CPU): navigate-while-mapping reaches
# (3.5, -1.8) in 150 ticks; the exploration completes after 1640 ticks with
# 7 goals, unknown share 0.452 and free share 0.535
JAX_NWM_TICKS = 150
JAX_EXPLORE = {"ticks": 1640, "goals": 7, "unknown": 0.4524, "free": 0.5353}


def trinary(seed, shape=(40, 48)):
    """A seeded trinary grid: unknown outside a few known rectangles."""
    rng = np.random.default_rng(seed)
    occ = np.full(shape, -1, dtype=np.int8)
    for _ in range(4):
        r, c = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        h, w = rng.integers(4, 14, 2)
        occ[r : r + h, c : c + w] = 0
    occ[rng.random(shape) < 0.05] = 100
    return occ


@pytest.mark.parametrize("seed", range(4))
def test_frontier_functions_equal_to_jax(seed):
    occ = trinary(seed)
    np.testing.assert_array_equal(fr.frontier_cells(occ), jfr.frontier_cells(occ))
    mask = fr.frontier_cells(occ)
    got, want = fr.cluster_frontiers(mask, min_size=3), jfr.cluster_frontiers(mask, min_size=3)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["size"] == b["size"]
        np.testing.assert_array_equal(a["cells"], b["cells"])
        np.testing.assert_array_equal(a["centroid"], b["centroid"])
    args = (occ, (0.1, -0.2), (-1.2, -1.0), 0.05)
    kw = dict(min_size=3, min_distance=0.1)
    got_c, want_c = fr.frontier_goal_candidates(*args, **kw), jfr.frontier_goal_candidates(*args, **kw)
    assert len(got_c) == len(want_c)
    for a, b in zip(got_c, want_c):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fr.pick_frontier_goal(*args, **kw), jfr.pick_frontier_goal(*args, **kw))
    assert fr.pick_frontier_goal(np.zeros((20, 20), np.int8), (0.0, 0.0), (-0.5, -0.5), 0.05) is None


class ScriptedMapper:
    """A mapper stand-in whose map grows on a script: one more known band a call."""

    def __init__(self, seed):
        self.origin, self.resolution = np.array([-1.2, -1.0]), 0.05
        self.grids = [trinary(seed + k) for k in range(6)]
        for k in range(1, 6):  # known space only grows
            known = self.grids[k - 1] != -1
            self.grids[k][known] = self.grids[k - 1][known]
        self.calls = 0

    def occupancy(self):
        self.calls += 1
        return self.grids[min(self.calls // 7, 5)]


def test_explorer_publishes_the_same_goals_as_jax():
    bt, bj = MessageBus(), JBus()
    nt = ExplorerNode(bt, ScriptedMapper(10), stall_ticks=6, coverage_every=3)
    nj = JExplorerNode(bj, ScriptedMapper(10), stall_ticks=6, coverage_every=3)
    assert nt.tick() == nj.tick() == {"status": "waiting_for_odom"}
    goals_t, goals_j = [], []
    bt.subscribe("/goal_pose", lambda m: goals_t.append((m.pose.x, m.pose.y, m.pose.orientation.z)))
    bj.subscribe("/goal_pose", lambda m: goals_j.append((m.pose.x, m.pose.y, m.pose.orientation.z)))
    rng = np.random.default_rng(5)
    for k in range(60):
        xy = rng.uniform(-0.5, 0.8, 2) if k % 9 else (nt.goal if nt.goal is not None else (0.0, 0.0))
        bt.publish("/robot_position", Odometry(pose=Pose(x=float(xy[0]), y=float(xy[1]))))
        bj.publish("/robot_position", JOdometry(pose=JPose(x=float(xy[0]), y=float(xy[1]))))
        ot, oj = nt.tick(), nj.tick()
        assert ot["status"] == oj["status"] and ot["n_goals"] == oj["n_goals"]
    assert goals_t == goals_j and len(goals_t) >= 3
    st, sj = nt.summary(), nj.summary()
    assert st["decisions"] == sj["decisions"] and st["coverage_log"] == sj["coverage_log"]
    assert st["n_abandoned"] == sj["n_abandoned"] > 0
    assert st["coverage_m2"] == sj["coverage_m2"]


def test_mapper_stack_matches_jax_for_three_ticks():
    """build_sim_stack(map_source='mapper') on the CPU beside the JAX stack:
    /map fully unknown at first, the same statuses, poses within 1e-4 m."""
    kw = dict(follower="point", start_pose=START, horizon=12, map_source="mapper")
    js, ts = jax_stack(**kw), build_sim_stack(device="cpu", **kw)
    assert ts.mapper.L.shape == (240, 240)  # size_m 12, resolution 0.05
    assert float((ts.mapper.occupancy() == -1).mean()) > 0.95
    for s in (js, ts):
        s.publish_goal(3.5, -1.8)
    for _ in range(3):
        oj, ot = js.tick(), ts.tick()
        assert ot["control"]["status"] == oj["control"]["status"]
        assert ot["plan"]["status"] == oj["plan"]["status"]
        np.testing.assert_allclose(ot["pose"], np.asarray(oj["pose"]), atol=POSE_ATOL)
    assert ts.mapper.n_scans == js.mapper.n_scans == 3
    assert float((ts.mapper.occupancy() == js.mapper.occupancy()).mean()) >= 0.999


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the full runs tick K1 on the card (python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_navigate_while_mapping_on_the_card(card):
    """tests/test_mapper.py::test_navigate_while_mapping on the card."""
    stack = build_sim_stack(follower="point", start_pose=START, horizon=12, map_source="mapper", device=card)
    reached, ticks, pose = stack.run_to_goal((3.5, -1.8), max_ticks=500)
    assert reached and not stack.sim.in_collision(), (ticks, pose)
    assert ticks <= 1.25 * JAX_NWM_TICKS
    assert float((stack.mapper.occupancy() == -1).mean()) < 0.8
    assert (np.asarray(stack.bus.latest("/map")[0].data) == 100).sum() > 50


@pytest.mark.cuda
def test_autonomous_exploration_on_the_card(card):
    """tests/test_explorer.py::test_autonomous_exploration_maps_the_room on the card."""
    stack = build_sim_stack(
        follower="point", start_pose=START, horizon=12, map_source="mapper", safety_stop=0.22, device=card
    )
    explorer = ExplorerNode(stack.bus, stack.mapper, stack.params)
    complete = False
    for i in range(2500):
        if explorer.tick()["status"] == "complete":
            complete = True
            break
        stack.tick()
        assert not stack.sim.in_collision(), f"collided at tick {i}"
    occ = stack.mapper.occupancy()
    assert complete and explorer.n_goals >= 3
    assert float((occ == -1).mean()) < 0.6 and float((occ == 0).mean()) > 0.25

"""The graph arguments that the port restores, held against the JAX
package's on the CPU: ``build_live_stack``'s ``params``, ``map_image``,
``map_info``, ``start_pose``, ``global_costmap`` and ``viz_period``;
``build_role_tasks``'s map, ``run_role``'s and ``run_multiprocess``'s
``params``, ``start_pose`` and ``roles``; ``MultiRobotSim``'s ``params`` and
map.

``P`` is ``Params.load`` of a YAML that differs from the defaults in
``goal_threshold`` (0.25 against 0.2), so each node that keeps ``params``
shows that the caller's values reached it. The map is ``maps/map_home.pgm``,
314 x 224 cells: a swapped height and width would show as a shape or a
costmap apart. Bands: the command within 5e-4 (the live band on U), the
pose within 1e-3 m, the costmaps bit for bit. No test reads the wall clock:
the schedulers run on a virtual clock (``tests/test_torch_live.py``'s).

The home map's origin (-5.6, -7.85) is not a multiple of its resolution, so
a few occupied cells' world coordinates ``col * res + origin`` sit within
one float32 rounding of a cell boundary. XLA's CPU backend contracts that
multiply-add into one FMA (one rounding), PyTorch rounds twice, and the
global costmap's scatter then puts such a point into the neighbouring cell
(41 of 70,336 cells apart after the dilation). The global-costmap test
therefore gives the JAX node the twice-rounded coordinates (the float32
expression as written) and holds that they are the only difference."""

from pathlib import Path

import numpy as np
import pytest
import torch

import ros2_mpc_tpu.nodes.live as jlive
import ros2_mpc_tpu.ops.grid as jgridops
import ros2_mpc_tpu.nodes.multiproc as jmultiproc
import ros2_mpc_tpu_torch.nodes.live as live
import ros2_mpc_tpu_torch.nodes.multiproc as multiproc
import ros2_mpc_tpu_torch.ops.grid as gridops
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.nodes.bus import MessageBus as JMessageBus
from ros2_mpc_tpu.nodes.multi_robot import MultiRobotSim as JMultiRobotSim
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.nodes.bus import MessageBus
from ros2_mpc_tpu_torch.nodes.multi_robot import MultiRobotSim
from ros2_mpc_tpu_torch.utils import pgm

ROOT = Path(__file__).resolve().parent.parent
HOME_START, HOME_GOAL = (-2.6, -3.4, 0.0), (2.4, -3.4)  # tests/test_carto_map.py's first route
HORIZON = 8
CMD_ATOL, POSE_ATOL = 5e-4, 1e-3
GOAL_THRESHOLD = 0.25  # Params() has 0.2


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
    port, ref = VirtualClock(), VirtualClock()
    monkeypatch.setattr(live, "time", port)
    monkeypatch.setattr(jlive, "time", ref)
    return port, ref


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """(port Params, JAX Params) loaded from one YAML with a non-default
    goal_threshold."""
    path = tmp_path_factory.mktemp("params") / "params.yaml"
    d = Params().to_yaml_dict()
    d["goal_threshold"] = GOAL_THRESHOLD
    import yaml

    path.write_text(yaml.safe_dump(d))
    P, JP = Params.load(str(path)), JParams.load(str(path))
    assert P.goal_threshold == JP.goal_threshold == GOAL_THRESHOLD != Params().goal_threshold
    return P, JP


@pytest.fixture(scope="module")
def home():
    img = pgm.read_pgm(str(ROOT / "maps" / "map_home.pgm"))
    meta = pgm.load_map_yaml(str(ROOT / "maps" / "map_home.yaml"))
    assert img.shape == (314, 224)  # taller than wide
    return img, {"resolution": meta["resolution"], "origin": meta["origin"]}


def _occupied_xy_rounded_twice(occ_grid, map_resolution, map_origin):
    """``convert_occ_grid_to_xy_coordinates`` in float32 numpy, the multiply
    and the add each rounded (the port's arithmetic)."""
    g = np.flipud(np.asarray(occ_grid, dtype=np.float32))
    rows, cols = np.nonzero(g == 255.0)
    res, origin = np.float32(map_resolution), np.asarray(map_origin, dtype=np.float32)
    return list(cols.astype(np.float32) * res + origin[0]), list(rows.astype(np.float32) * res + origin[1])


@pytest.fixture
def jax_occupied_xy_rounded_twice(monkeypatch, home):
    """The JAX package's global costmap node on the twice-rounded occupied
    coordinates, after checking that the port's are exactly those and that
    the JAX package's are the FMA-rounded ones."""
    img, info = home
    binary = np.where(img == 0, 255, 0).astype(np.uint8)  # the /map convention of MapSubscriber
    want_x, want_y = _occupied_xy_rounded_twice(binary, info["resolution"], info["origin"])
    got_x, got_y = gridops.convert_occ_grid_to_xy_coordinates(binary, info["resolution"], info["origin"], device="cpu")
    assert np.array_equal(np.float32(got_x), want_x) and np.array_equal(np.float32(got_y), want_y)
    jx, _ = jgridops.convert_occ_grid_to_xy_coordinates(binary, info["resolution"], info["origin"])
    g = np.flipud(binary.astype(np.float64))
    _, cols = np.nonzero(g == 255.0)
    fma_x = (cols * np.float64(np.float32(info["resolution"])) + np.float64(np.float32(info["origin"][0])))
    assert np.array_equal(np.float32(jx), fma_x.astype(np.float32)) and not np.array_equal(np.float32(jx), want_x)
    monkeypatch.setattr(jgridops, "convert_occ_grid_to_xy_coordinates", _occupied_xy_rounded_twice)


def _nodes_with_params(stack):
    """Every node of a live stack that keeps ``params``."""
    nodes = [stack.sim, stack.follower, stack.global_planner]
    nodes += [t.fn.__self__ for t in stack.scheduler.tasks if hasattr(getattr(t.fn, "__self__", None), "params")]
    return nodes


@pytest.mark.parametrize("global_costmap", [True, False], ids=["global_costmap", "no_global_costmap"])
def test_live_stack_on_the_home_map_matches_jax(
    clocks, params, home, tmp_path, jax_occupied_xy_rounded_twice, global_costmap
):
    """The live graph on the home map from HOME_START with P: the same tasks
    and periods as the JAX package's (no global costmap task when asked;
    the viz task at ``viz_period``), P in every node, and the first three
    control ticks' commands, poses and both costmaps as the JAX package's."""
    P, JP = params
    img, info = home
    kw = dict(follower="point", map_image=img, map_info=info, start_pose=HOME_START, horizon=HORIZON,
              global_costmap=global_costmap)
    if not global_costmap:
        kw.update(viz_dir=str(tmp_path), viz_period=0.2)
    ts = live.build_live_stack(params=P, device="cpu", **kw)
    js = jlive.build_live_stack(params=JP, **kw)
    assert [(t.name, t.period) for t in ts.scheduler.tasks] == [(t.name, t.period) for t in js.scheduler.tasks]
    names = {t.name for t in ts.scheduler.tasks}
    assert ("global_costmap" in names) == global_costmap and ("viz" in names) == (not global_costmap)
    assert ts.params is P
    for node in _nodes_with_params(ts):
        assert node.params.goal_threshold == GOAL_THRESHOLD, type(node).__name__
    assert tuple(ts.sim.occupied.shape) == tuple(np.asarray(js.sim.occupied).shape) == img.shape
    np.testing.assert_allclose(ts.sim.pose.numpy(), np.asarray(js.sim.pose), atol=1e-6)
    np.testing.assert_allclose(ts.sim.pose.numpy(), HOME_START, atol=1e-6)

    kept = {}
    for name, stack in (("port", ts), ("jax", js)):
        control = next(t for t in stack.scheduler.tasks if t.name == "control")
        tick, kept[name] = control.fn, []

        def logged(tick=tick, stack=stack, log=kept[name]):
            out = tick()
            msg = stack.bus.latest("cmd_vel")[0]
            log.append((out["status"], msg.linear_x, msg.angular_z, np.asarray(stack.sim.pose, dtype=float)))
            return out

        control.fn = logged
        stack.publish_goal(*HOME_GOAL)
    # the warm-up ticks every task once, then control at 0.2 and 0.4 s
    got, want = ts.run(duration=0.5, stop_on_goal=False), js.run(duration=0.5, stop_on_goal=False)
    assert {k: v["runs"] for k, v in got["tasks"].items()} == {k: v["runs"] for k, v in want["tasks"].items()}
    assert len(kept["port"]) == len(kept["jax"]) == 3
    for (s, v, w, pose), (js_, jv, jw, jpose) in zip(kept["port"], kept["jax"]):
        assert s == js_ and s not in ("waiting_for_path", "waiting_for_odom")
        np.testing.assert_allclose([v, w], [jv, jw], atol=CMD_ATOL)
        np.testing.assert_allclose(pose, jpose, atol=POSE_ATOL)
    assert kept["port"][-1][1] > 0.01  # it drives off toward the goal
    topics = ["/my_local_costmap"] + (["/my_global_costmap"] if global_costmap else [])
    for topic in topics:
        mine, ref = ts.bus.latest(topic)[0], js.bus.latest(topic)[0]
        np.testing.assert_array_equal(np.asarray(mine.data), np.asarray(ref.data))
    if global_costmap:
        assert np.asarray(ts.bus.latest("/my_global_costmap")[0].data).shape == img.shape
    else:
        assert ts.bus.latest("/my_global_costmap")[0] is None
        assert got["tasks"]["viz"]["runs"] == want["tasks"]["viz"]["runs"] == 2  # 0.2 and 0.4 s, warm-up aside
        assert (tmp_path / "latest.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


class _SpinBus(MessageBus):
    """The in-process bus with the shared-memory bus's ``spin_once``."""

    def spin_once(self):
        return 0

    def close(self):
        pass


class _JSpinBus(JMessageBus):
    def spin_once(self):
        return 0

    def close(self):
        pass


def test_build_role_tasks_world_on_the_home_map(params, home):
    """The world role on the caller's map, pose and Params, as the JAX
    package builds it: the same tasks, the home map in the simulator and on
    /map, P in the simulator."""
    P, JP = params
    img, info = home
    tasks, extras = multiproc.build_role_tasks(
        "world", _SpinBus(), P, start_pose=HOME_START, map_image=img, map_info=info, device="cpu"
    )
    jtasks, jextras = jmultiproc.build_role_tasks(
        "world", _JSpinBus(), JP, start_pose=HOME_START, map_image=img, map_info=info
    )
    assert [(t.name, t.period) for t in tasks] == [(t.name, t.period) for t in jtasks]
    sim, jsim = extras["sim"], jextras["sim"]
    assert sim.params.goal_threshold == GOAL_THRESHOLD
    assert tuple(sim.occupied.shape) == tuple(np.asarray(jsim.occupied).shape) == img.shape
    np.testing.assert_allclose(sim.pose.numpy(), HOME_START, atol=1e-6)
    for t in tasks:
        t.fn()
    for t in jtasks:
        t.fn()
    np.testing.assert_array_equal(np.asarray(sim.bus.latest("/map")[0].data), np.asarray(jsim.bus.latest("/map")[0].data))
    assert np.asarray(sim.bus.latest("/map")[0].data).shape == img.shape


@pytest.mark.parametrize("roles", [("planner", "nope"), ("world", "follower")], ids=["unknown", "world"])
def test_run_multiprocess_refuses_roles_before_starting_anything(monkeypatch, roles):
    """A role outside ROLES, or the world (it runs in the supervisor),
    raises before any bus file, process or device is touched."""

    def untouched(*a, **k):
        raise AssertionError("touched before the roles were checked")

    monkeypatch.setattr(multiproc, "SharedMemoryBus", untouched)
    monkeypatch.setattr(multiproc, "resolve_device", untouched)
    with pytest.raises(ValueError, match="unknown child roles"):
        multiproc.run_multiprocess(roles=roles, duration=1.0)


def test_run_multiprocess_hands_params_and_start_pose_to_the_world_role(monkeypatch, params):
    """``params`` and ``start_pose`` reach the world role; the children get
    the roles asked for (the safety role appended by ``safety_stop``), the
    safety chain's command topic, and no ``params``, as in the JAX package.
    The bus and the processes are stand-ins; the world runs 0.5 s of a
    virtual clock with no command, so the robot stays where it started."""
    P, _ = params
    started, worlds = [], []

    class Proc:
        exitcode = None

        def __init__(self, target, args, name, daemon):
            self.target, self.args, self.name = target, args, name

        def start(self):
            started.append(self)

        def join(self, timeout=None):
            self.exitcode = 0

        def is_alive(self):
            return False

    class Ctx:
        Process = Proc

    build = multiproc.build_role_tasks

    def world(role, bus, p, **kw):
        worlds.append((p, kw))
        return build(role, bus, p, **kw)

    monkeypatch.setattr(multiproc.multiprocessing, "get_context", lambda method: Ctx)
    monkeypatch.setattr(multiproc, "SharedMemoryBus", lambda path: _SpinBus())
    monkeypatch.setattr(multiproc, "build_role_tasks", world)
    monkeypatch.setattr(live, "time", VirtualClock())
    start = (-0.8, -1.1, 0.3)
    stats = multiproc.run_multiprocess(
        duration=0.5, start_pose=start, params=P, roles=("planner", "follower"),
        safety_stop=0.3, role_device="cpu", bus_path="unused",
    )
    assert [p.args[0] for p in started] == ["planner", "follower", "safety"]
    for p in started:
        assert p.target is multiproc._role_entry and P not in p.args
        assert p.args[6:] == ("cmd_vel_raw", 0.3)
    (p, kw), = worlds
    assert p is P and kw["start_pose"] == start
    np.testing.assert_allclose(stats["final_pose"], start, atol=1e-6)
    assert stats["goal_reached"] is False and stats["failed_roles"] == []


def test_run_role_takes_params(monkeypatch, params):
    """``run_role(params=P)`` builds its role with P (``None``: Params())."""
    P, _ = params
    seen = []

    def build(role, bus, p, **kw):
        seen.append(p)
        return [live.Task("idle", 0.05, lambda: None)], {}

    monkeypatch.setattr(multiproc, "SharedMemoryBus", lambda path: _SpinBus())
    monkeypatch.setattr(multiproc, "build_role_tasks", build)
    monkeypatch.setattr(live, "time", VirtualClock())
    multiproc.run_role("planner", "unused", 0.1, params=P, device="cpu")
    multiproc.run_role("planner", "unused", 0.1, device="cpu")
    assert seen[0] is P and seen[1] == Params()


def test_multi_robot_sim_on_the_home_map_matches_jax(params, home):
    """Two robots on the home map with P: every robot's graph has P and the
    home map; one round of ticks moves both as the JAX package's do."""
    P, JP = params
    img, info = home
    starts = [HOME_START, (-3.3, 3.0, 0.0)]
    goals = [HOME_GOAL, (1.0, 3.85)]
    ts = MultiRobotSim(starts, P, follower="point", map_image=img, map_info=info, horizon=HORIZON, device="cpu")
    js = JMultiRobotSim(starts, JP, follower="point", map_image=img, map_info=info, horizon=HORIZON)
    for stack, jstack in zip(ts.stacks, js.stacks):
        assert stack.params is P and stack.follower.params.goal_threshold == GOAL_THRESHOLD
        assert tuple(stack.sim.occupied.shape) == tuple(np.asarray(jstack.sim.occupied).shape) == img.shape
    got, want = ts.run_to_goals(goals, max_ticks=1), js.run_to_goals(goals, max_ticks=1)
    assert got.ticks == want.ticks == 1 and not got.collided_static
    for tr, jtr in zip(got.traces, want.traces):
        np.testing.assert_allclose(tr, np.asarray(jtr), atol=POSE_ATOL)
    np.testing.assert_allclose(got.min_separation, want.min_separation, atol=POSE_ATOL)
    assert torch.is_tensor(ts.stacks[0].sim.pose) and ts.stacks[0].sim.pose.device.type == "cpu"

"""The port's closed loop under the JAX suite's other conditions, held
against the JAX package's on the CPU tick by tick: the unmapped pillar in
corrected and in parity mode (``tests/test_closed_loop.py:89``), the
tracking follower beside it (:129), the safety monitor (``tests/test_safety.py:69``),
sensor and actuation noise (:180), a kidnap (:194), a retask (:220) and a
patrolling pedestrian (``tests/test_dynamic_obstacles.py:17``).

Each case starts where its condition acts and runs a few ticks of both
stacks side by side (the runs to the goal are ``chip_smoke.py``'s, on the
card). Bands, those of ``tests/test_torch_closed_loop.py``: the published
command within 5e-4, the simulated pose within 1e-3 m, the lidar at most
one march step (0.025 m) apart on at most 1% of the beams; the planner's
path exactly equal; the obstacle points the follower packs for K1/K2 in
the same slots, within the pose band.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu.nodes.launch import build_sim_stack as jax_stack
from ros2_mpc_tpu_torch.nodes.launch import build_sim_stack
from ros2_mpc_tpu_torch.utils import pgm

from test_torch_closed_loop import CMD_ATOL, POSE_ATOL, assert_lidar_close, scan_of

GOAL = (1.0, -1.0)
PILLAR = (0.0, -1.0)  # world[143:147, 123:127], on the straight line from (-1, -1)
NOISE = {"odom_xy": 0.01, "odom_yaw": 0.01, "scan": 0.01, "cmd": 0.05}
KIDNAP = (-1.6, -1.6, 0.3)
RETASK = ((0.2, -1.0), (1.2, -1.4))


def pillar_maps():
    """(world with the pillar, the clean map the planner is given)."""
    world = pgm.synthetic_indoor_map()
    clean = world.copy()
    world[143:147, 123:127] = 0
    return world, clean


def pillar_kwargs(**kw):
    world, clean = pillar_maps()
    return dict(map_image=world, map_info=dict(pgm.DEFAULT_MAP_INFO), planner_map_image=clean, **kw)


def pair(follower, start, horizon=20, **kw):
    """The JAX and the port stack on the same arguments, each follower's
    packed obstacle points recorded tick by tick."""
    js = jax_stack(follower=follower, start_pose=start, horizon=horizon, **kw)
    ts = build_sim_stack(follower=follower, start_pose=start, horizon=horizon, device="cpu", **kw)
    for s in (js, ts):
        s.packed_obstacles = []
        pack = s.follower._pack

        def spy(*args, pack=pack, seen=s.packed_obstacles):
            seen.append(np.stack([np.asarray(args[-2], float), np.asarray(args[-1], float)]))
            return pack(*args)

        s.follower._pack = spy
    assert_lidar_close(scan_of(ts), scan_of(js))
    return js, ts


def tick_both(js, ts, n, before=None, lidar=assert_lidar_close):
    """``n`` ticks of both stacks, each held to the bands (the scans by
    ``lidar(port's, JAX's)``); returns the last pair of tick outputs."""
    for i in range(n):
        if before is not None:
            before(i)
        oj, ot = js.tick(), ts.tick()
        assert ot["plan"]["status"] == oj["plan"]["status"]
        assert ot["control"]["status"] == oj["control"]["status"]
        if "path_xy" in oj["plan"]:
            np.testing.assert_array_equal(ot["plan"]["path_xy"], oj["plan"]["path_xy"])
        cj, ct = js.bus.latest("cmd_vel")[0], ts.bus.latest("cmd_vel")[0]
        np.testing.assert_allclose([ct.linear_x, ct.angular_z], [cj.linear_x, cj.angular_z], atol=CMD_ATOL)
        np.testing.assert_allclose(ot["pose"], np.asarray(oj["pose"]), atol=POSE_ATOL)
        lidar(scan_of(ts), scan_of(js))
    return oj, ot


def assert_obstacles_match(js, ts):
    """The obstacle points packed for the kernel on every tick: the same
    live slots (a real point below 50 m, the far sentinels 100 m), within
    the pose band. Returns the live points of each tick."""
    assert len(ts.packed_obstacles) == len(js.packed_obstacles) > 0
    live = []
    for got, want in zip(ts.packed_obstacles, js.packed_obstacles):
        real = np.abs(want[0]) < 50
        np.testing.assert_array_equal(np.abs(got[0]) < 50, real)
        np.testing.assert_allclose(got, want, atol=POSE_ATOL)
        live.append(got[:, real])
    return live


def min_dist(points, xy):
    return float(np.hypot(points[..., 0] - xy[0], points[..., 1] - xy[1]).min())


@pytest.mark.parametrize("parity", [False, True], ids=["corrected", "parity"])
def test_unmapped_pillar_path_and_first_ticks(parity):
    """Corrected mode stamps the scan's pillar into the planner's map, so
    the first global path bends around (0, -1), and K1 sums the pillar's
    live obstacle points; parity mode's planner is blind to the scan, its
    path runs straight through the pillar and no point goes live."""
    js, ts = pair("point", (-1.0, -1.0, 0.0), **pillar_kwargs(reference_parity=parity))
    for s in (js, ts):
        s.publish_goal(*GOAL)
    plans = ts.global_planner.tick(), js.global_planner.tick()
    np.testing.assert_array_equal(plans[0]["path_xy"], plans[1]["path_xy"])
    clearance = min_dist(plans[0]["path_xy"], PILLAR)
    if parity:
        assert clearance < 0.1, f"the parity path passes {clearance:.3f} m from the pillar"
    else:
        assert clearance > 0.2, f"the corrected path passes {clearance:.3f} m from the pillar"
    # parity runs the full schedule, ~4.5 s a plain tick here: two ticks
    tick_both(js, ts, 2 if parity else 3)
    live = assert_obstacles_match(js, ts)
    if parity:
        # the reference's grid variant: 160 slots of one transposed cloud
        assert all(p.shape[1] == 160 for p in live)
    else:
        assert all(p.shape[1] > 0 and min_dist(p.T, PILLAR) < 0.15 for p in live)


def test_tracking_follower_beside_the_pillar():
    """The path follower from 0.5 m short of the pillar: K2 at B=1 with the
    pillar's live points, on the detour the scan-aware planner draws."""
    js, ts = pair("tracking", (-0.5, -1.05, 0.0), **pillar_kwargs())
    for s in (js, ts):
        s.publish_goal(*GOAL)
    tick_both(js, ts, 3)
    live = assert_obstacles_match(js, ts)
    assert all(p.shape[1] > 0 and min_dist(p.T, PILLAR) < 0.15 for p in live)
    assert ts.follower.engine.kind == "tracking"


def test_safety_monitor_halts_parity_short_of_the_pillar():
    """Parity mode drives at the pillar; from 0.35 m short of it the
    monitor (stop 0.3 m) zeroes the linear command on every tick and
    passes the rotation, as the JAX package's does."""
    js, ts = pair("point", (-0.35, -1.0, 0.0), **pillar_kwargs(reference_parity=True, safety_stop=0.3))
    for s in (js, ts):
        s.publish_goal(*GOAL)
    tick_both(js, ts, 2)
    assert (ts.safety.n_blocked, ts.safety.n_passed) == (js.safety.n_blocked, js.safety.n_passed)
    assert ts.safety.n_blocked == 2
    assert ts.safety.last_clearance == pytest.approx(js.safety.last_clearance, abs=0.025)
    raw = ts.bus.latest("cmd_vel_raw")[0]
    assert raw.linear_x > 0 and ts.bus.latest("cmd_vel")[0].linear_x == 0.0
    assert not ts.sim.in_collision()


def test_noisy_ticks_draw_as_jax():
    """tests/test_closed_loop.py:180's noise with noise_seed 3: the port's
    simulator draws odometry, scan and actuation noise from the same
    generator in the same order, so five noisy ticks stay in the bands."""
    js, ts = pair("point", (-1.0, -1.0, 0.0), noise=NOISE, noise_seed=3)
    np.testing.assert_array_equal(scan_of(ts)[np.isinf(scan_of(ts))], scan_of(js)[np.isinf(scan_of(js))])
    for s in (js, ts):
        s.publish_goal(*GOAL)
    tick_both(js, ts, 5)
    # the same draws: both generators stand at the same state
    assert ts.sim._rng.bit_generator.state == js.sim._rng.bit_generator.state
    odom = [np.array([s.bus.latest("/robot_position")[0].pose.x, s.bus.latest("/robot_position")[0].pose.y]) for s in (ts, js)]
    np.testing.assert_allclose(odom[0], odom[1], atol=POSE_ATOL)
    assert np.abs(odom[0] - ts.sim.pose[:2].numpy()).max() > 1e-4  # the odometry is noisy


def test_kidnap_replans_from_the_new_pose():
    """Three ticks, then the pose written from outside as a float64 array:
    the simulator keeps it float32 on its device, as the JAX package's
    ``jnp.asarray`` does; three more ticks re-plan from there."""
    js, ts = pair("point", (-1.0, -1.0, 0.0))
    for s in (js, ts):
        s.publish_goal(*GOAL)
    tick_both(js, ts, 3)
    js.sim.pose = jnp.asarray(KIDNAP)
    ts.sim.pose = np.asarray(KIDNAP)
    assert torch.equal(ts.sim.pose, torch.tensor(KIDNAP, dtype=torch.float32))
    assert ts.sim.pose.device == ts.sim.device
    oj, ot = tick_both(js, ts, 3)
    assert ts.sim.pose.dtype == torch.float32
    path = ts.follower.robot_controller.get_path()[0]
    assert np.linalg.norm(path[0] - np.array(KIDNAP[:2])) < 0.3  # planned from the new pose
    assert np.linalg.norm(ot["pose"][:2] - np.array(KIDNAP[:2])) < 0.2


def test_retask_unlatches_the_follower():
    """A start inside the first goal's threshold latches within a tick;
    the second goal lets the latch go and the robot drives again. The start
    lies off the 0.05 m cell grid: from x=0.1, on a column edge, the beam
    straight up runs along that edge, and XLA's contracted float32 and
    PyTorch's put its samples in different columns (a wall at 1 m against
    3 m), a knife edge of the two packages' rounding, not of the loop."""
    js, ts = pair("point", (0.08, -1.0, 0.0))
    for s in (js, ts):
        s.publish_goal(*RETASK[0])
    oj, ot = tick_both(js, ts, 2)
    assert ot["control"]["status"] == "goal_reached" and ts.follower.goal_flag
    for s in (js, ts):
        s.publish_goal(*RETASK[1])
    oj, ot = tick_both(js, ts, 3)
    assert ot["control"]["status"] == "chasing" and not ts.follower.goal_flag
    assert ts.bus.latest("cmd_vel")[0].linear_x > 0


def test_patrolling_pedestrian_obstacle_points():
    """tests/test_dynamic_obstacles.py:17's pedestrian (0.15 m, patrolling
    x=0.2 across y=-1 with a 12 s period), horizon 16, from 0.6 m short of
    its line: the scan sees the moving disc, which no map holds, and K1's
    obstacle points are the JAX package's on every tick. The beams that end
    on the disc are analytic in the pose (``Simulator._circle_ranges``), so
    they are held to the pose band; the rest to the march rule."""
    js, ts = pair("point", (-0.4, -1.0, 0.0), horizon=16)
    tick = {"i": 0}

    def ped_pos():
        t = tick["i"] * ts.params.dt
        return [(0.2, -1.1 + 0.35 * np.sin(2 * np.pi * t / 12.0))]

    def lidar(got, want):
        on_disc = np.isfinite(ts.sim._circle_ranges(ped_pos()))
        assert on_disc.any()
        np.testing.assert_allclose(got[on_disc], want[on_disc], atol=POSE_ATOL)
        assert_lidar_close(got[~on_disc], want[~on_disc])

    for s in (js, ts):
        s.sim.moving_obstacles = ped_pos
        s.sim.publish_scan()
        s.publish_goal(*GOAL)
    tick_both(js, ts, 5, before=lambda i: tick.update(i=i), lidar=lidar)
    live = assert_obstacles_match(js, ts)
    np.testing.assert_array_equal(ts.packed_obstacles[0], js.packed_obstacles[0])  # same pose, same draws
    for i, p in enumerate(live):
        assert p.shape[1] > 0
        tick["i"] = i
        assert min_dist(p.T, ped_pos()[0]) < 0.2  # the disc's returns

"""The port's shared-world multi-robot runner
(``ros2_mpc_tpu_torch.nodes.multi_robot``), mirroring
tests/test_multi_robot.py. The scan test runs on the CPU beside the JAX
package's: a moving disc seen by the lidar at the analytic distance, the
two scans equal beam for beam but at most 1% of the beams, each at most one
march step (0.025 m) apart (tests/test_torch_closed_loop.py's lidar band).
The head-on swap is ``cuda``-marked: both robots tick K1 on the card."""

import numpy as np
import pytest
import torch

from ros2_mpc_tpu.nodes.multi_robot import MultiRobotSim as JMultiRobotSim
from ros2_mpc_tpu_torch.nodes.multi_robot import MultiRobotSim

MARCH_STEP = 0.025
MAX_BEAM_FRAC = 0.01


def test_moving_obstacle_appears_in_scan():
    sims = [
        MultiRobotSim([(-1.0, -1.0, 0.0)], follower="point", horizon=8, device="cpu").stacks[0].sim,
        JMultiRobotSim([(-1.0, -1.0, 0.0)], follower="point", horizon=8).stacks[0].sim,
    ]
    scans = []
    for sim in sims:
        sim.moving_obstacles = lambda: [np.array([0.0, -1.0])]  # 1 m dead ahead
        sim.obstacle_radius = 0.2
        sim.publish_scan()
        scans.append(np.asarray(sim.bus.latest("/scan")[0].ranges, dtype=np.float64))
    got, want = scans
    fwd = got[len(got) // 2]  # beam 0 points along -pi
    assert np.isfinite(fwd) and abs(fwd - 0.8) < 0.05, f"forward return {fwd:.3f}, expected ~0.8"
    assert got[len(got) // 2] == want[len(want) // 2]  # the disc's return is analytic, on the host
    both = np.isfinite(got) & np.isfinite(want)
    assert (np.isfinite(got) != np.isfinite(want)).mean() <= MAX_BEAM_FRAC
    apart = np.abs(got[both] - want[both])
    assert apart.max(initial=0.0) <= MARCH_STEP + 1e-6 and (apart > 0).mean() <= MAX_BEAM_FRAC


def test_other_robots_are_discs_in_each_scan():
    """Two robots: each one's lidar sees the other where it stands."""
    sim = MultiRobotSim([(-1.2, -1.0, 0.0), (-0.2, -1.0, np.pi)], follower="point", horizon=8, device="cpu")
    for i, stack in enumerate(sim.stacks):
        others = stack.sim.moving_obstacles()
        assert len(others) == 1 and isinstance(others[0], np.ndarray)
        np.testing.assert_allclose(others[0], sim.stacks[1 - i].sim.pose[:2].numpy())
        ranges = np.asarray(stack.bus.latest("/scan")[0].ranges)
        assert abs(ranges[len(ranges) // 2] - 0.85) < 0.05  # 1 m apart, disc radius 0.15


@pytest.mark.cuda
def test_two_robots_swap_positions_without_colliding_on_the_card():
    """tests/test_multi_robot.py's head-on swap with both graphs on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the followers tick K1 on the card (python3 chip_smoke.py)")
    starts = [(-1.2, -1.0, 0.0), (1.2, -1.2, np.pi)]
    goals = [(1.2, -1.0), (-1.2, -1.2)]
    sim = MultiRobotSim(starts, follower="point", robot_radius=0.15)
    out = sim.run_to_goals(goals, max_ticks=500)
    assert all(out.reached), (out.reached, out.ticks)
    assert not out.collided_static
    assert out.min_separation > 0.30, f"min separation {out.min_separation:.3f}"

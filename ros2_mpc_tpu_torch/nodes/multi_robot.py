"""Shared-world multi-robot simulation — port of
:mod:`ros2_mpc_tpu.nodes.multi_robot`.

The reference is strictly one robot per deployment; this runner puts K
independent node graphs (each with its own bus, planner, follower, and
costmaps — the honest analogue of K separate ROS domains) into ONE physical
world: every robot's lidar sees the other robots as moving discs
(Simulator.moving_obstacles), and because other robots are *not* in the
static map, the corrected-mode scan-minus-map obstacle extraction keeps
them in the MPC's live soft costs — mutual avoidance falls out of the
existing machinery with no robot-to-robot communication at all.

Every robot's graph runs on ``device`` (``None``: the card): its simulator,
costmaps and follower (K1 or K2 at B=1), with the caller's ``params`` and
map (``None``: the synthetic indoor map). The poses the runner compares are
read back once per robot a round.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import Params
from ..utils import pgm
from .launch import SimStack, build_sim_stack


@dataclasses.dataclass
class MultiRobotResult:
    reached: list
    ticks: int
    min_separation: float
    collided_static: bool
    traces: list  # per-robot (T, 3) pose arrays


class MultiRobotSim:
    """K robots, K node graphs, one world."""

    def __init__(
        self,
        starts,
        params: Params = Params(),
        follower: str = "point",
        map_image=None,
        map_info=None,
        horizon: int = 20,
        robot_radius: float = 0.15,
        device=None,
    ):
        if map_image is None:
            map_image = pgm.synthetic_indoor_map()
            map_info = dict(pgm.DEFAULT_MAP_INFO)
        self.robot_radius = robot_radius
        self.stacks: list[SimStack] = [
            build_sim_stack(
                follower=follower,
                params=params,
                map_image=map_image,
                map_info=map_info,
                start_pose=tuple(start),
                horizon=horizon,
                device=device,
            )
            for start in starts
        ]
        for i, stack in enumerate(self.stacks):
            stack.sim.obstacle_radius = robot_radius

            def others(i=i):
                return [
                    s.sim.pose[:2].cpu().numpy()
                    for j, s in enumerate(self.stacks)
                    if j != i
                ]

            stack.sim.moving_obstacles = others
            stack.sim.publish_scan()  # re-prime with the other robots visible

    def run_to_goals(self, goals, max_ticks: int = 400) -> MultiRobotResult:
        """Drive every robot to its goal concurrently (round-robin ticks)."""
        for stack, goal in zip(self.stacks, goals):
            stack.publish_goal(goal[0], goal[1])
        reached = [False] * len(self.stacks)
        traces = [[] for _ in self.stacks]
        min_sep = np.inf
        collided = False
        t = 0
        for t in range(max_ticks):
            for i, stack in enumerate(self.stacks):
                if not reached[i]:
                    out = stack.tick()
                    reached[i] = out["control"].get("status") == "goal_reached"
                    collided |= stack.sim.in_collision()
                traces[i].append(stack.sim.pose.cpu().numpy())
            poses = [tr[-1][:2] for tr in traces]
            for a in range(len(poses)):
                for b in range(a + 1, len(poses)):
                    min_sep = min(min_sep, float(np.linalg.norm(poses[a] - poses[b])))
            if all(reached):
                break
        return MultiRobotResult(
            reached=reached,
            ticks=t + 1,
            min_separation=min_sep,
            collided_static=collided,
            traces=[np.stack(tr) for tr in traces],
        )

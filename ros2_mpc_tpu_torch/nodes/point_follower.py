"""Point-stabilization (carrot-chasing) control-loop node — port of
:mod:`ros2_mpc_tpu.nodes.point_follower`, the behavior-parity rebuild of
ros2_mpc/scripts/point_follower_local_planner.py:121-231 (call stack
SURVEY.md §3.2).

The engine is K1 at B=1: every tick solves through
:func:`~ros2_mpc_tpu_torch.solver.cuda_kernel.make_cuda_point_stab_solver`
(on a CUDA device the kernel, on the CPU its plain version). The warm start
stays on the device; a tick reads back one small vector (the first control,
cost, KKT residual and convergence flag).

``escape_after`` arms the basin-escape recovery: after that many
consecutive non-converged solves toward one goal, one tick runs the
multistart engine (:func:`~ros2_mpc_tpu_torch.solver.mppi.make_multistart_solver`:
MPPI plus the arc seeds, polished as one K1 bank) and re-seeds the warm
start."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Params
from ..device import resolve_device
from ..solver import SolverSettings, make_point_stabilization
from ..solver.cuda_kernel import make_cuda_point_stab_solver, single_scenario
from ..solver.mppi import MppiSettings, make_multistart_solver
from ..solver.packed import make_packed_point_stab, read_tick
from ..utils.telemetry import Telemetry
from .bus import MessageBus
from .reference_gen import (
    StaticStructureFilter,
    get_goal_for_mpc,
    get_obstacles,
    scan_to_world_obstacles,
    slew_limited_command,
)
from .topics import (
    CmdVelPublisher,
    GoalPointPublisher,
    GoalSubscriber,
    LaserSubscriber,
    MapSubscriber,
    OdomSubscriber,
    RobotController,
)


class PointFollowerNode:
    def __init__(
        self,
        bus: MessageBus,
        params: Params = Params(),
        reference_parity: bool = False,
        horizon: int | None = None,
        settings: SolverSettings | None = None,
        escape_after: int | None = None,
        cmd_topic: str = "cmd_vel",
        device=None,
    ):
        """``device``: where the problem, the warm start and the solves live
        (``None``: the card). ``escape_after``: the opt-in basin-escape
        recovery (module docstring); its engine is built and run once here,
        so the first escaping tick pays no build."""
        self.device = resolve_device(device)
        self.params = params
        self.reference_parity = reference_parity
        self.robot_controller = RobotController(bus)
        self.odom_node = OdomSubscriber(bus)
        self.cmd_vel_publisher = CmdVelPublisher(bus, cmd_topic)
        self.goal_listener = GoalSubscriber(bus)
        self.laser_node = LaserSubscriber(bus)
        self.goal_point_publisher = GoalPointPublisher(bus)
        # corrected mode: live obstacle costs see only *unmapped* returns
        self.static_filter = None if reference_parity else StaticStructureFilter(MapSubscriber(bus))
        if settings is None:
            settings = SolverSettings() if reference_parity else SolverSettings.realtime()
        self.problem = make_point_stabilization(
            params, reference_parity=reference_parity, horizon=horizon, settings=settings, device=self.device
        )
        self.N = self.problem.ocp.horizon
        # Packed-theta path (solver/packed.py) with K1 at B=1 as its engine.
        self.engine = make_cuda_point_stab_solver(self.problem.ocp, settings)
        self._solve, self._pack = make_packed_point_stab(
            self.problem, params, solve_fn=single_scenario(self.engine)
        )
        self.escape_after = escape_after
        self._stall = 0
        self._stall_goal = None  # stall evidence is per goal
        self.n_escapes = 0
        if escape_after is not None:
            # The full iLQR schedule for the polish, not the follower's
            # realtime profile: the arc seeds start cold, and a 12-iteration
            # schedule cannot converge them, so every candidate would come
            # back non-converged and the escape would keep the warm start it
            # had. A rare recovery tick can afford it.
            escape = make_multistart_solver(
                self.problem.ocp, SolverSettings(), MppiSettings(n_samples=128, n_iters=8), device=self.device
            )
            self.escape_engine = escape.engines[0]  # K1 over the K+2 starts
            self._solve_escape = make_packed_point_stab(self.problem, params, solve_fn=single_scenario(escape))[0]
            self._escape_gen = torch.Generator(device=self.device).manual_seed(0)  # advances every escape
            far = np.full(params.n_obstacle_points, 100.0)
            self._solve_escape(
                self._pack(np.zeros(3), np.zeros(3), far, far),
                self.problem.default_u0,
                torch.Generator(device=self.device).manual_seed(1),
            )
        self.u_warm = self.problem.default_u0
        self.u_last = np.zeros(2)
        self.goal_flag = False
        self.telemetry = Telemetry("point_follower")

    def tick(self, now: float | None = None) -> dict:
        p = self.params
        goal = self.goal_listener.get_goal()
        if goal is None:
            return {"status": "waiting_for_goal"}
        if self.escape_after is not None:
            # a stale stall count from an earlier (perhaps unreachable) goal
            # must not trigger an escape on the first tick to a new one
            gk = (round(float(goal[0]), 3), round(float(goal[1]), 3))
            if gk != self._stall_goal:
                self._stall_goal = gk
                self._stall = 0
        scan_data, angles = self.laser_node.get_scan()
        pos, ori = self.odom_node.get_states()
        if scan_data is None or pos is None:
            return {"status": "waiting_for_sensors"}

        if self.reference_parity:
            # the point follower's normalized grid variant (point_follower:89)
            # finds cells but transposes the cloud (see reference_gen doc).
            x_obs, y_obs = get_obstacles(
                scan_data, angles, p.costmap_size, p.resolution, pos, ori,
                p.n_obstacle_points, normalized=True, device=self.device,
            )
        else:
            mask, map_info = self.static_filter.current()
            x_obs, y_obs = scan_to_world_obstacles(
                scan_data, angles, p.costmap_size, pos, ori[2], p.n_obstacle_points,
                static_mask=mask, map_info=map_info,
            )
        path_xy, path_headings = self.robot_controller.get_path()
        if path_xy is None or len(path_xy) < 1:
            return {"status": "waiting_for_path"}

        # quirk: yaw folded into [0, 2pi) here (point_follower:172)
        x0 = np.array([pos[0], pos[1], ori[2] % (2 * np.pi)])
        goal_mpc = get_goal_for_mpc(path_xy, path_headings, goal, pos, p.look_ahead_distance)
        self.goal_point_publisher.publish_goal_point(goal_mpc)

        packed = self._pack(x0, goal_mpc, x_obs, y_obs)
        U0 = self.problem.default_u0 if self.reference_parity else self.u_warm
        escaping = self.escape_after is not None and self._stall >= self.escape_after
        t0 = time.perf_counter()
        if escaping:
            sol, u_warm_next = self._solve_escape(packed, U0, self._escape_gen)
            self.n_escapes += 1
            self._stall = 0
        else:
            sol, u_warm_next = self._solve(packed, U0)
        u, cost, kkt, converged = read_tick(sol)
        solve_s = time.perf_counter() - t0
        if not np.all(np.isfinite(u)):
            u = self.u_last
        else:
            self.u_warm = u_warm_next  # device-resident, shifted on the device
        if self.escape_after is not None and not escaping:
            self._stall = 0 if converged else self._stall + 1
        self.telemetry.record(solve_s=solve_s, kkt=kkt, cost=cost, converged=converged)

        if self.goal_flag:
            self.cmd_vel_publisher.publish_cmd(0.0, 0.0)
        else:
            v_cmd, w_cmd, self.u_last = slew_limited_command(u, self.u_last, p.slew_limit)
            self.cmd_vel_publisher.publish_cmd(v_cmd, w_cmd)

        if np.linalg.norm(x0[0:2] - goal[0:2]) > p.goal_threshold:
            self.goal_flag = False
        elif not self.goal_flag:
            self.cmd_vel_publisher.publish_cmd(0.0, 0.0)
            self.goal_flag = True
        return {
            "status": "goal_reached" if self.goal_flag else "chasing",
            "u": u,
            "carrot": goal_mpc,
            "solve_s": solve_s,
            "escaped": escaping,
        }


def main(argv=None):
    """Console entry: the carrot-chasing control loop on the wall-clock live
    graph (point_follower_local_planner.py:121-231 semantics at 5 Hz); the
    live graph's flags, ``--device`` included (default: the card)."""
    import sys

    from .live import main as live_main

    live_main(["--follower", "point", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()

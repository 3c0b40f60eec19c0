"""Trajectory-tracking control-loop node — the flagship tick. Port of
:mod:`ros2_mpc_tpu.nodes.path_follower` (behavior-parity rebuild of
ros2_mpc/scripts/path_follower_local_planner.py:134-223, call stack
SURVEY.md §3.1).

Differences from the reference, all deliberate (as in the JAX package):
* the CasADi/IPOPT solve is one interior-point iLQR call;
* warm start defaults to shift-and-hold of the previous solution instead of
  the reference's re-zeroed guess (quirk #3) — ``reference_parity=True``
  restores zeros;
* a failed solve degrades to the previous control instead of raising
  (the reference crashes the node, local_planner_tracking.py:74);
* per-tick telemetry (solve latency, KKT residual, cost) is recorded;
* corrected mode hands off to a point-stabilization solve inside the goal
  handoff radius: the tracking cost (reverse penalty + 1 m minimum turn
  radius) prefers *orbiting* a goal it reaches misaligned over stopping —
  the reference dodges this by only ever launching its point follower
  (launch/launch_all.launch.py:12-18); the handoff fixes the tracking
  follower itself.

The engines are K2 at B=1 for tracking and K1 at B=1, horizon 2N, for the
handoff (:mod:`ros2_mpc_tpu_torch.solver.cuda_kernel`: on a CUDA device the
kernels, on the CPU their plain versions). The warm start stays on the
device; a tick reads back one small vector.

``escape_after`` arms the basin-escape recovery, as the point follower's:
after that many consecutive non-converged warm-started tracking solves, one
tick runs the multistart engine on the tracking OCP (MPPI plus the arc
seeds, polished as one K2 bank) and re-seeds the warm start. Handoff solves
never escape: they are cold-started and short-lived by design.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Params
from ..device import resolve_device
from ..solver import SolverSettings, make_point_stabilization, make_tracking
from ..solver.cuda_kernel import make_cuda_point_stab_solver, make_cuda_tracking_solver, single_scenario
from ..solver.mppi import MppiSettings, make_multistart_solver
from ..solver.packed import make_packed_point_stab, make_packed_tracking, read_tick
from ..utils.telemetry import Telemetry
from .bus import MessageBus
from .reference_gen import (
    StaticStructureFilter,
    get_obstacles,
    path_motion_profile,
    scan_to_world_obstacles,
    slew_limited_command,
    tracking_reference_window,
)
from .topics import (
    CmdVelPublisher,
    GoalSubscriber,
    LaserSubscriber,
    MapSubscriber,
    OdomSubscriber,
    RobotController,
)


class PathFollowerNode:
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
        """``device``: where the problems, the warm start and the solves live
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
        # corrected mode: live obstacle costs see only *unmapped* returns
        self.static_filter = None if reference_parity else StaticStructureFilter(MapSubscriber(bus))
        if settings is None:
            # warm-started ticks converge on the short RTI-style schedule;
            # parity mode re-zeroes the guess each tick (quirk #3) and keeps
            # the full cold-start schedule
            settings = SolverSettings() if reference_parity else SolverSettings.realtime()
        self.problem = make_tracking(
            params, reference_parity=reference_parity, horizon=horizon, settings=settings, device=self.device
        )
        self.N = self.problem.ocp.horizon
        # Packed-theta path (solver/packed.py) with K2 at B=1 as its engine.
        self.engine = make_cuda_tracking_solver(self.problem.ocp, settings)
        self._solve, self._pack = make_packed_tracking(
            self.problem, params, solve_fn=single_scenario(self.engine)
        )
        # Goal-approach handoff problem (corrected mode): see module docstring.
        # Doubled horizon so a full low-omega turn fits inside the plan; its
        # own K1 instance.
        self.handoff_radius = 0.0 if reference_parity else 2.0 * params.look_ahead_distance
        self._point_problem = make_point_stabilization(
            params, reference_parity=reference_parity, horizon=2 * self.N, settings=settings,
            device=self.device,
        )
        self.handoff_engine = make_cuda_point_stab_solver(self._point_problem.ocp, settings)
        self._point_solve, self._point_pack = make_packed_point_stab(
            self._point_problem, params, solve_fn=single_scenario(self.handoff_engine)
        )
        # quirk #9: the reference hardcodes a 0.15 m latch, ignoring its own
        # goal_threshold param (0.2); corrected mode honors the param.
        self.goal_radius = params.tracking_goal_radius if reference_parity else params.goal_threshold
        self.escape_after = escape_after
        self._stall = 0
        self._stall_goal = None  # stall evidence is per goal
        self.n_escapes = 0
        if escape_after is not None:
            # the full schedule for the polish: cold arc seeds cannot
            # converge on the realtime profile (see point_follower.py)
            escape = make_multistart_solver(
                self.problem.ocp, SolverSettings(), MppiSettings(n_samples=128, n_iters=8),
                kind="tracking", device=self.device,
            )
            self.escape_engine = escape.engines[0]  # K2 over the K+2 starts
            self._solve_escape = make_packed_tracking(self.problem, params, solve_fn=single_scenario(escape))[0]
            self._escape_gen = torch.Generator(device=self.device).manual_seed(0)  # advances every escape
            far = np.full(params.n_obstacle_points, 100.0)
            self._solve_escape(
                self._pack(np.zeros(3), np.zeros((self.N, 3)), np.zeros((self.N, 2)), far, far),
                self.problem.default_u0,
                torch.Generator(device=self.device).manual_seed(1),
            )
        self.u_warm = self.problem.default_u0
        self.u_last = np.zeros(2)
        self.goal_flag = False
        self.telemetry = Telemetry("path_follower")
        self._path_fetch_time = -np.inf
        self._path_cache = (None, None)

    def tick(self, now: float | None = None) -> dict:
        """One control tick. Returns a status dict; publishes cmd_vel."""
        p = self.params
        now = time.monotonic() if now is None else now
        goal = self.goal_listener.get_goal()
        if goal is None:
            return {"status": "waiting_for_goal"}
        if self.escape_after is not None:
            # per-goal stall evidence (see point_follower.py)
            gk = (round(float(goal[0]), 3), round(float(goal[1]), 3))
            if gk != self._stall_goal:
                self._stall_goal = gk
                self._stall = 0
        scan_data, angles = self.laser_node.get_scan()
        pos, ori = self.odom_node.get_states()
        if scan_data is None or pos is None:
            return {"status": "waiting_for_sensors"}

        if self.reference_parity:
            # quirk: the reference tracking node's un-normalized grid never
            # yields obstacles (always 100 m sentinels).
            x_obs, y_obs = get_obstacles(
                scan_data, angles, p.costmap_size, p.resolution, pos, ori,
                p.n_obstacle_points, normalized=False, device=self.device,
            )
        else:
            mask, map_info = self.static_filter.current()
            x_obs, y_obs = scan_to_world_obstacles(
                scan_data, angles, p.costmap_size, pos, ori[2], p.n_obstacle_points,
                static_mask=mask, map_info=map_info,
            )
        # Path refresh is rate-limited to the reference's 1 s REFRESH_TIME
        # (path_follower_local_planner.py:157,175-178); until the first path
        # arrives the fetch retries every tick.
        if now - self._path_fetch_time > p.path_refresh_period or self._path_cache[0] is None:
            self._path_fetch_time = now
            self._path_cache = self.robot_controller.get_path()
        path_xy, path_heading = self._path_cache
        if path_xy is None or len(path_xy) < 2:
            return {"status": "waiting_for_path"}

        _, path_velocity, path_omega = path_motion_profile(path_xy, p.dt)
        x0 = np.array([pos[0], pos[1], ori[2]])
        goal_dist = float(np.linalg.norm(x0[:2] - goal[:2]))
        escaping = tracked = False
        t0 = time.perf_counter()
        if goal_dist < self.handoff_radius:
            # point-stabilization handoff on the exact goal pose
            packed = self._point_pack(
                np.array([x0[0], x0[1], x0[2] % (2 * np.pi)]),
                np.array([goal[0], goal[1], goal[4] % (2 * np.pi)]),
                x_obs, y_obs,
            )
            sol, u_warm_next = self._point_solve(packed, self._point_problem.default_u0)
        else:
            pxf, puf = tracking_reference_window(
                x0, goal, path_xy, path_heading, path_velocity, path_omega, self.N
            )
            packed = self._pack(x0, pxf, puf, x_obs, y_obs)
            U0 = self.problem.default_u0 if self.reference_parity else self.u_warm
            escaping = self.escape_after is not None and self._stall >= self.escape_after
            if escaping:
                sol, u_warm_next = self._solve_escape(packed, U0, self._escape_gen)
                self.n_escapes += 1
                self._stall = 0
            else:
                sol, u_warm_next = self._solve(packed, U0)
                tracked = True
        u, cost, kkt, converged = read_tick(sol)
        solve_s = time.perf_counter() - t0
        if self.escape_after is not None and tracked:
            self._stall = 0 if converged else self._stall + 1
        if not np.all(np.isfinite(u)):
            u = self.u_last  # graceful degradation, not a crash
        else:
            # device-resident warm start, shifted on the device; handoff
            # solves carry a 2N-horizon, so keep the first N
            self.u_warm = u_warm_next[: self.N]
        self.telemetry.record(solve_s=solve_s, kkt=kkt, cost=cost, converged=converged)

        if self.goal_flag:
            self.cmd_vel_publisher.publish_cmd(0.0, 0.0)
        else:
            v_cmd, w_cmd, self.u_last = slew_limited_command(u, self.u_last, p.slew_limit)
            self.cmd_vel_publisher.publish_cmd(v_cmd, w_cmd)

        # goal latch: hardcoded 0.15 m under parity (quirk #9), goal_threshold
        # param otherwise
        if np.linalg.norm(x0[0:2] - goal[0:2]) > self.goal_radius:
            self.goal_flag = False
        elif not self.goal_flag:
            self.cmd_vel_publisher.publish_cmd(0.0, 0.0)
            self.goal_flag = True
        return {
            "status": "goal_reached" if self.goal_flag else "tracking",
            "u": u,
            "solve_s": solve_s,
            "kkt": kkt,
            "escaped": escaping,
        }


def main(argv=None):
    """Console entry: the flagship tracking control loop on the wall-clock
    live graph (path_follower_local_planner.py:134-223 semantics at 5 Hz);
    the live graph's flags, ``--device`` included (default: the card)."""
    import sys

    from .live import main as live_main

    live_main(["--follower", "tracking", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()

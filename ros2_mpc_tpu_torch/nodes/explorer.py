"""Autonomous exploration node: frontier goals over the live mapper — the
port's own copy of :mod:`ros2_mpc_tpu.nodes.explorer` (host code; it reads
the mapper's grid back through ``mapper.occupancy()``).

Closes the autonomy loop the reference cannot even start: with the
occupancy mapper building /map live (nodes/mapper.py) and the frontier
extractor ranking the boundary between known-free and unknown space
(planner/frontier.py), this node publishes its OWN navigation goals — drive
to the nearest frontier, map what the lidar reveals, repeat until the
reachable world is closed. No human goal, no prior map.

Policy: a new frontier goal is picked when (a) there is none yet, (b) the
current one is reached, or (c) progress stalls for ``stall_ticks`` control
ticks (an unreachable frontier — e.g. behind a doorway the planner's
inflation seals — is abandoned and excluded from re-selection).

Telemetry: every goal decision is recorded (tick, goal, candidate count,
reason) and mapped-area coverage is sampled every ``coverage_every`` ticks,
so exploration *quality* — coverage over time, not just termination — is a
numeric, regression-gateable artifact (``summary()``)."""

from __future__ import annotations

import numpy as np

from ..config import Params
from ..planner.frontier import frontier_goal_candidates
from .bus import MessageBus, Pose, PoseStamped, Quaternion
from .topics import OdomSubscriber


class ExplorerNode:
    def __init__(
        self,
        bus: MessageBus,
        mapper,
        params: Params = Params(),
        min_cluster: int = 8,
        min_distance: float = 0.4,
        stall_ticks: int = 150,
        exclusion_radius: float = 0.5,
        coverage_every: int = 20,
    ):
        self.bus = bus
        self.mapper = mapper
        self.params = params
        self.min_cluster = min_cluster
        self.min_distance = min_distance
        self.stall_ticks = stall_ticks
        self.exclusion_radius = exclusion_radius
        self.coverage_every = coverage_every
        self.odom = OdomSubscriber(bus)
        self.goal: np.ndarray | None = None
        self.done = False
        self.n_goals = 0
        self.abandoned: list[np.ndarray] = []
        self._best_d = np.inf
        self._since_progress = 0
        self._tick = 0
        self.decisions: list[dict] = []  # every goal pick / abandonment
        self.coverage_log: list[tuple[int, float]] = []  # (tick, known m^2)

    def coverage_m2(self) -> float:
        """Mapped (known: free or occupied) area in square meters."""
        occ = self.mapper.occupancy()
        return float((occ != -1).sum()) * self.mapper.resolution**2

    def summary(self) -> dict:
        """Exploration-quality telemetry: final coverage, coverage rate
        (m^2 per 100 ticks over the active phase), and the decision log."""
        cov = self.coverage_m2()
        rate = 0.0
        if len(self.coverage_log) >= 2:
            t0, c0 = self.coverage_log[0]
            t1, c1 = self.coverage_log[-1]
            if t1 > t0:
                rate = (c1 - c0) / (t1 - t0) * 100.0
        return {
            "coverage_m2": cov,
            "coverage_rate_m2_per_100ticks": rate,
            "n_goals": self.n_goals,
            "n_abandoned": len(self.abandoned),
            "n_ticks": self._tick,
            "decisions": self.decisions,
            "coverage_log": self.coverage_log,
        }

    def _frontier_goals(self, robot_xy) -> list[np.ndarray]:
        """Cluster centroids in world XY, nearest first, exclusions applied."""
        cands = frontier_goal_candidates(
            self.mapper.occupancy(), robot_xy,
            self.mapper.origin, self.mapper.resolution,
            min_size=self.min_cluster, min_distance=self.min_distance,
        )
        return [
            xy for xy in cands
            if not any(
                np.linalg.norm(xy - a) < self.exclusion_radius for a in self.abandoned
            )
        ]

    def _publish_goal(self, xy, robot_xy):
        yaw = float(np.arctan2(xy[1] - robot_xy[1], xy[0] - robot_xy[0]))
        self.bus.publish(
            "/goal_pose",
            PoseStamped(
                pose=Pose(
                    x=float(xy[0]), y=float(xy[1]),
                    orientation=Quaternion(
                        z=float(np.sin(yaw / 2)), w=float(np.cos(yaw / 2))
                    ),
                )
            ),
        )

    def tick(self) -> dict:
        if self.done:
            return {"status": "complete", "n_goals": self.n_goals}
        pos, _ = self.odom.get_states()
        if pos is None:
            return {"status": "waiting_for_odom"}
        robot_xy = np.asarray(pos[:2], dtype=float)
        self._tick += 1
        # sample on ticks 1, 1+every, ... (a plain `% == 1` never fires at
        # coverage_every=1, the most frequent setting)
        if (self._tick - 1) % self.coverage_every == 0:
            self.coverage_log.append((self._tick, self.coverage_m2()))

        need_new = self.goal is None
        reason = "init"
        if self.goal is not None:
            d = float(np.linalg.norm(robot_xy - self.goal))
            if d < self.params.goal_threshold + 0.1:
                need_new = True  # frontier reached; the map has grown
                reason = "reached"
            elif d < self._best_d - 0.02:
                self._best_d = d
                self._since_progress = 0
            else:
                self._since_progress += 1
                if self._since_progress > self.stall_ticks:
                    self.abandoned.append(self.goal)
                    self.decisions.append(
                        {
                            "tick": self._tick,
                            "event": "abandoned",
                            "goal": [float(v) for v in self.goal],
                        }
                    )
                    need_new = True
                    reason = "stalled"

        if need_new:
            goals = self._frontier_goals(robot_xy)
            if not goals:
                self.done = True
                self.goal = None
                self.coverage_log.append((self._tick, self.coverage_m2()))
                self.decisions.append({"tick": self._tick, "event": "complete"})
                return {"status": "complete", "n_goals": self.n_goals}
            self.goal = goals[0]
            self._best_d = np.inf
            self._since_progress = 0
            self.n_goals += 1
            self.decisions.append(
                {
                    "tick": self._tick,
                    "event": "picked",
                    "reason": reason,
                    "goal": [float(v) for v in self.goal],
                    "n_candidates": len(goals),
                }
            )
            self._publish_goal(self.goal, robot_xy)
        return {"status": "exploring", "goal": self.goal, "n_goals": self.n_goals}

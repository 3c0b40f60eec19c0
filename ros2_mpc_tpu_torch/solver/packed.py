"""Packed-theta solve paths: one host-to-device transfer per control tick.

Port of :mod:`ros2_mpc_tpu.solver.packed`. For the single-robot tick path
the weights are fixed when the node is built and only the sensor-derived
fields change, so the constant leaves are made once on the problem's device
and the dynamic fields arrive as one flat float32 vector.

Layout (point stabilization, n = n_obstacle_points):
    [x0(3) | goal(3) | obs_x(n) | obs_y(n)]
Layout (tracking, horizon N):
    [x0(3) | x_ref(N*3) | u_ref(N*2) | obs_x(n) | obs_y(n)]
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Params
from .problems import Problem
from .warmstart import shift_controls


def _to_device(vec: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(vec).to(like.device)


def make_packed_point_stab(problem: Problem, params: Params = Params(), solve_fn=None):
    """(solve_packed, pack) for a point-stabilization problem.

    ``solve_packed(vec, U0) -> (Solution, U_warm_next)`` also returns the
    shift-and-hold warm start for the next tick. ``pack`` encodes on the host
    (NumPy) and makes the one transfer to the problem's device.

    ``solve_fn`` swaps the engine: any ``f(theta, U0, *extra) -> Solution``
    on the same OCP, for one scenario (e.g. a CUDA bank solver wrapped with
    :func:`~ros2_mpc_tpu_torch.solver.cuda_kernel.single_scenario`);
    ``*extra`` is forwarded."""
    n = params.n_obstacle_points
    const = problem.make_theta(np.zeros(3), np.zeros(3))
    solve = solve_fn if solve_fn is not None else problem.solve

    def solve_packed(vec, U0, *extra):
        theta = dict(const)
        theta["x0"] = vec[0:3]
        theta["goal"] = vec[3:6]
        theta["obs_x"] = vec[6 : 6 + n]
        theta["obs_y"] = vec[6 + n : 6 + 2 * n]
        sol = solve(theta, U0, *extra)
        return sol, shift_controls(sol.U)

    def pack(x0, goal, obs_x, obs_y) -> torch.Tensor:
        vec = np.concatenate(
            [
                np.asarray(x0, dtype=np.float32).reshape(3),
                np.asarray(goal, dtype=np.float32).reshape(3),
                np.asarray(obs_x, dtype=np.float32).reshape(n),
                np.asarray(obs_y, dtype=np.float32).reshape(n),
            ]
        )
        return _to_device(vec, const["x0"])

    return solve_packed, pack


def make_packed_tracking(problem: Problem, params: Params = Params(), solve_fn=None):
    """(solve_packed, pack) for a tracking problem; same contract as
    :func:`make_packed_point_stab`."""
    n = params.n_obstacle_points
    N = problem.ocp.horizon
    const = problem.make_theta(np.zeros(3), np.zeros((N, 3)), np.zeros((N, 2)))
    solve = solve_fn if solve_fn is not None else problem.solve

    def solve_packed(vec, U0, *extra):
        theta = dict(const)
        theta["x0"] = vec[0:3]
        theta["x_ref"] = vec[3 : 3 + 3 * N].reshape(N, 3)
        theta["u_ref"] = vec[3 + 3 * N : 3 + 5 * N].reshape(N, 2)
        theta["obs_x"] = vec[3 + 5 * N : 3 + 5 * N + n]
        theta["obs_y"] = vec[3 + 5 * N + n : 3 + 5 * N + 2 * n]
        sol = solve(theta, U0, *extra)
        return sol, shift_controls(sol.U)

    def pack(x0, x_ref, u_ref, obs_x, obs_y) -> torch.Tensor:
        vec = np.concatenate(
            [
                np.asarray(x0, dtype=np.float32).reshape(3),
                np.asarray(x_ref, dtype=np.float32).reshape(3 * N),
                np.asarray(u_ref, dtype=np.float32).reshape(2 * N),
                np.asarray(obs_x, dtype=np.float32).reshape(n),
                np.asarray(obs_y, dtype=np.float32).reshape(n),
            ]
        )
        return _to_device(vec, const["x0"])

    return solve_packed, pack


def read_tick(sol):
    """A tick's one read from the device: ``(u0, cost, kkt_residual,
    converged)`` of a single-scenario Solution, with ``u0 = U[0]`` as a
    NumPy (2,) array, in one transfer."""
    f = sol.cost.dtype
    head = torch.cat([sol.U[0], torch.stack([sol.cost, sol.kkt_residual, sol.converged.to(f)])])
    v = head.cpu().numpy()
    return v[:2], float(v[2]), float(v[3]), bool(v[4])


def device_tick_rate(problem, n_ticks: int = 64, dt: float = 0.2, *, device=None) -> float:
    """Seconds per warm control tick with the whole loop on the device: the
    fleet pattern (solve -> actuate -> shift, no read back inside the loop)
    on ``random_fleet(B=1024, seed=0)`` through K1
    (``make_fleet_rollout(..., engine="cuda")``), so the tick latency
    measured serves 1024 robots at once. The best of 5 timed rollouts after a
    warm-up, divided by ``n_ticks``; on the card timed with CUDA events.

    ``device=None`` is the card and raises without one; ``device="cpu"``
    runs K1's plain version on the host clock. Nothing falls back to another
    engine."""
    import time

    from ..device import resolve_device
    from ..parallel.fleet import make_fleet_rollout, random_fleet

    dev = resolve_device(device)
    rollout = make_fleet_rollout(problem, n_ticks=n_ticks, dt=dt, engine="cuda", device=dev)
    thetas, U0 = random_fleet(problem, B=1024, seed=0, device=dev)
    rollout(thetas, U0)  # warm-up: the first call builds the kernels
    reps = []
    for _ in range(5):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            rollout(thetas, U0)
            end.record()
            end.synchronize()
            reps.append(start.elapsed_time(end) / 1e3 / n_ticks)
        else:
            t0 = time.perf_counter()
            rollout(thetas, U0)
            reps.append((time.perf_counter() - t0) / n_ticks)
    return float(np.min(reps))

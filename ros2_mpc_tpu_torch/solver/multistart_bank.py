"""Bank-scale multistart: basin escape at bank-engine throughput.

Port of :mod:`ros2_mpc_tpu.solver.multistart_bank`. K starts per scenario
over B scenarios is one (B*K)-scenario bank of the same OCP: the seeds are
tiled into the batch, the whole bank goes through one bank-engine call, and
each scenario keeps its best start by (converged, cost).

The seeds are the deterministic bang-bang arc seeds (drive channel at 0.75
of its upper bound, swing channel +/- for the first quarter of the horizon,
reversed for the second) plus the caller's warm start. On a symmetric
saddle (an obstacle dead-center on the start-goal line) the cost gradient
cannot break the left/right tie, so every gradient method from a zero start
stalls against the obstacle; the arc seeds break the symmetry.

Engines: ``"cuda"`` (K1, :func:`~.cuda_kernel.make_cuda_point_stab_solver`:
the kernel on CUDA tensors, its plain version on CPU tensors), ``"fast"``
(:func:`~.batched.make_bank_solver_fast`) and ``"vmap"``
(``torch.func.vmap(make_solver(...))``), or a callable
``engine(ocp, settings) -> solve_bank``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ilqr import OCP, Solution, SolverSettings, make_solver

ENGINES = ("cuda", "fast", "vmap")


def arc_seeds(ocp: OCP, swing_fracs: tuple = (1.0, 0.5), device=None) -> torch.Tensor:
    """(K_arc, N, m) float32 deterministic bang-bang symmetry-breaking seeds
    (box-only, so any 2+-control platform works)."""
    N, m = ocp.horizon, ocp.n_controls
    if m < 2:
        raise ValueError("arc seeds need a drive and a swing channel (n_controls >= 2)")
    u_lo = torch.tensor(ocp.u_lo, dtype=torch.float32, device=device)
    u_hi = torch.tensor(ocp.u_hi, dtype=torch.float32, device=device)
    fwd = 0.75 * u_hi[0]
    q = max(1, N // 4)
    seeds = []
    for frac in swing_fracs:
        for sgn in (1.0, -1.0):
            U = torch.zeros((N, m), dtype=torch.float32, device=device)
            U[:, 0] = fwd
            U[:q, -1] = sgn * frac * u_hi[-1]
            U[q : 2 * q, -1] = sgn * frac * u_lo[-1]
            seeds.append(torch.clamp(U, u_lo, u_hi))
    return torch.stack(seeds)


def bank_engine(engine, ocp: OCP, settings: SolverSettings, kind: str = "point_stabilization"):
    """The bank solve ``solve_bank(thetas, U0s) -> Solution`` of ``engine``:
    a name of :data:`ENGINES` or a callable ``engine(ocp, settings)``.
    ``"cuda"`` is K1 for a point-stabilization OCP and K2 for
    ``kind="tracking"``."""
    if callable(engine):
        return engine(ocp, settings)
    if engine == "cuda":
        from .cuda_kernel import make_cuda_point_stab_solver, make_cuda_tracking_solver

        if kind == "tracking":
            return make_cuda_tracking_solver(ocp, settings)
        if kind != "point_stabilization":
            raise ValueError(f"engine='cuda' runs K1 (point stabilization) or K2 (tracking), not {kind!r}")
        return make_cuda_point_stab_solver(ocp, settings)
    if engine == "fast":
        from .batched import make_bank_solver_fast

        return make_bank_solver_fast(ocp, settings)
    if engine == "vmap":
        return torch.func.vmap(make_solver(ocp, settings))
    raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES} or a callable")


def make_bank_multistart_solver(
    ocp: OCP,
    settings: SolverSettings = SolverSettings(),
    *,
    swing_fracs: tuple = (1.0, 0.5),
    engine="cuda",
):
    """Build ``solve(thetas, U0s) -> Solution`` (B-leading) that solves
    K = 1 + 2*len(swing_fracs) starts per scenario in one bank-engine call
    and keeps the per-scenario best by (converged, cost). ``solve.engines``
    holds the bank solve it calls."""
    bank_solve = bank_engine(engine, ocp, settings)
    K = 1 + 2 * len(swing_fracs)

    def solve(thetas, U0s):
        B = U0s.shape[0]
        arc = arc_seeds(ocp, swing_fracs, device=U0s.device)
        # scenario-major tiling: each scenario's K starts are adjacent rows,
        # so the (B, K) reshape below is a pure relabeling
        big = {k: torch.repeat_interleave(v, K, dim=0) for k, v in thetas.items()}
        starts = torch.cat([U0s[:, None], arc[None].expand(B, *arc.shape)], dim=1)
        sols = bank_solve(big, starts.reshape(B * K, *U0s.shape[1:]))

        cost = torch.where(torch.isnan(sols.cost), torch.inf, sols.cost).reshape(B, K)
        conv = sols.converged.reshape(B, K)
        masked = torch.where(conv, cost, torch.inf)
        i = torch.where(conv.any(dim=1), torch.argmin(masked, dim=1), torch.argmin(cost, dim=1))
        flat = torch.arange(B, device=U0s.device) * K + i

        def take(leaf):
            return leaf[flat]

        return Solution(
            U=take(sols.U),
            X=take(sols.X),
            cost=take(sols.cost),
            kkt_residual=take(sols.kkt_residual),
            converged=take(sols.converged),
            n_iters=sols.n_iters if sols.n_iters.dim() == 0 else take(sols.n_iters),
            reg=take(sols.reg),
        )

    solve.engines = (bank_solve,)
    return solve


def adversarial_saddle_bank(prob, B: int, seed: int = 0, q_boost=(5.0, 5.0, 0.05)):
    """A saddle-heavy (start, goal, obstacle) bank where single-start
    gradient solves fail: each scenario puts one obstacle dead-center on its
    start-goal line. Build ``prob`` at a horizon that reaches the ~1 m goal
    (N=40 at the reference dt). ``q_boost`` replaces the theta Q so reaching
    pays; None keeps the problem's own. The draws are the JAX package's,
    call for call, so one seed gives both packages one bank. Returns
    ``(thetas, U0)`` on the problem's device."""
    rng = np.random.default_rng(seed)
    dev = prob.default_u0.device
    n_obs = prob.make_theta(np.zeros(3), np.zeros(3))["obs_x"].shape[0]
    x0 = np.concatenate(
        [rng.uniform(-0.05, 0.05, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))],
        axis=1,
    )
    ang = rng.uniform(-np.pi, np.pi, size=B)
    dist = rng.uniform(0.9, 1.1, size=B)
    goal = np.stack(
        [
            x0[:, 0] + dist * np.cos(ang),
            x0[:, 1] + dist * np.sin(ang),
            rng.uniform(-np.pi, np.pi, size=B),
        ],
        axis=1,
    )
    mid = x0[:, :2] + 0.5 * dist[:, None] * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    obs_x = np.full((B, n_obs), 100.0)
    obs_y = np.full((B, n_obs), 100.0)
    obs_x[:, 0] = mid[:, 0]
    obs_y[:, 0] = mid[:, 1]
    tens = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    thetas = torch.func.vmap(prob.make_theta)(tens(x0), tens(goal), tens(obs_x), tens(obs_y))
    thetas = {k: v.contiguous() for k, v in thetas.items()}
    if q_boost is not None:
        thetas["Q"] = tens(q_boost).repeat(B, 1)
    U0 = torch.zeros((B, prob.ocp.horizon, prob.ocp.n_controls), dtype=torch.float32, device=dev)
    return thetas, U0

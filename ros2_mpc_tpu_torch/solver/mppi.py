"""MPPI: the sampling-based NMPC engine, and the hybrid and multistart solves
that seed the interior-point iLQR with it.

Port of :mod:`ros2_mpc_tpu.solver.mppi`. Model-Predictive Path Integral
control is the derivative-free complement of the iLQR: a softmin-weighted
average over perturbed control rollouts,

    U <- sum_i w_i (U + eps_i) / sum_i w_i,   w_i = exp(-(J_i - min J) / T)

It needs only the cost, explores globally, and every candidate is
independent. Written B-leading: every iteration rolls the B x
(n_samples + 1) candidates of a bank (the current mean of each scenario
competes with its samples) as one batched tensor program, candidates
leading, ``(S+1, B, N, m)``; nothing is vmapped over a per-scenario
function.

Sampling uses AR(1)-filtered Gaussian noise along the horizon (white noise
in the control sequence excites chatter the unicycle cannot execute). An
explicit ``torch.Generator`` takes the place of the JAX PRNG key, or a
:class:`ScenarioStreams`, whose draws for a scenario depend on its global
index only (the device mesh's engines use it, so that a sharded bank draws
what the whole bank draws); the white draws come from one helper,
:func:`_white_noise`, which a test can replace to feed the JAX package's own
draws. The KKT residual's gradient is
``torch.func.grad`` of the summed bank cost (the costs are separable over
scenarios).

Entry points, each ``solve(thetas, U0s, generator) -> Solution`` over a
B-leading bank:

* :func:`make_mppi_solver`: standalone MPPI on any :class:`~.ilqr.OCP`;
* :func:`make_hybrid_solver`: MPPI exploration, then the iLQR polishes its
  answer, kept only where it beats the plain iLQR from ``U0`` on
  (converged, cost);
* :func:`make_multistart_solver`: one iLQR bank call over each scenario's
  {warm start, MPPI answer, arc seeds}, best of by (converged, cost).

The iLQR polishes take the bank engines of
:func:`~.multistart_bank.bank_engine`: ``"cuda"`` (K1, or K2 for
``kind="tracking"``: the kernel on CUDA tensors, its plain version on CPU
tensors), ``"fast"``, ``"vmap"`` or a callable. With ``"cuda"`` the K+2
starts of every scenario are rows of one K1/K2 call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import grad

from ..device import resolve_device
from .batched import _BankTerms, _probe_batch_semantics
from .ilqr import OCP, Solution, SolverSettings
from .multistart_bank import arc_seeds, bank_engine

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MppiSettings:
    """Fixed-shape MPPI schedule."""

    n_samples: int = 256  # rollouts per iteration
    n_iters: int = 16  # mean-update iterations
    temperature: float = 0.02  # softmin temperature on (J - J_min)
    sigma_frac: float = 0.25  # exploration std as a fraction of (hi - lo)
    smooth_beta: float = 0.6  # AR(1) noise correlation along the horizon
    sigma_decay: float = 0.92  # per-iteration annealing of the exploration std
    # Solution.converged: MPPI is a global-search engine, not a KKT
    # polisher; "converged" means the projected-gradient residual reached
    # this loose sampling tolerance. The hybrid solver gives tight KKT.
    kkt_tol: float = 1e-2


_U32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """``a * c mod 2**32`` for ``a`` in [0, 2**32) (an int64 tensor or an
    int), in 16-bit halves so that no product leaves int64."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _mix32(x):
    """A 32-bit integer hash (lowbias32: two xor-shift-multiply rounds),
    on an int64 tensor of values in [0, 2**32) or on an int."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class ScenarioStreams:
    """A noise source for a bank whose rows are global scenarios
    ``offset .. offset + B - 1``: pass it to a solve in place of a
    ``torch.Generator``. Every draw is a hash of ``(seed, global scenario,
    iteration, element)`` turned into a standard normal (23 bits of the hash
    as a uniform in (0, 1), then the inverse normal CDF), so a scenario's
    noise depends on the seed and its global index only: a bank split into
    shards draws what the whole bank draws, row for row, as the JAX
    package's ``fold_in(key, global index)`` keys do."""

    def __init__(self, seed: int = 0, offset: int = 0):
        self.seed, self.offset = int(seed), int(offset)

    def normal(self, t: int, shape: tuple, device) -> torch.Tensor:
        """Iteration ``t``'s draws, ``shape = (N, B, S, m)``."""
        N, B, S, m = shape
        rows = torch.arange(self.offset, self.offset + B, dtype=torch.int64, device=device)
        key = _mix32(_mix32(_mix32(self.seed & _U32) ^ rows) ^ (t & _U32))  # (B,)
        elem = _mix32(torch.arange(N * S * m, dtype=torch.int64, device=device) + 1).reshape(N, 1, S, m)
        bits = _mix32(key[None, :, None, None] ^ elem) >> 9  # 23 bits: bits + 0.5 exact in float32
        return torch.special.ndtri((bits.to(_F32) + 0.5) * 2.0**-23)


def _white_noise(generator, t: int, shape: tuple, device) -> torch.Tensor:
    """Iteration ``t``'s standard-normal draws, ``shape = (N, B, S, m)``: the
    one place MPPI draws randomness, from a ``torch.Generator`` or a
    :class:`ScenarioStreams` (the JAX package draws ``(N, S, m)`` per
    scenario from ``split(key, n_iters)[t]``)."""
    if isinstance(generator, ScenarioStreams):
        return generator.normal(t, shape, device)
    return torch.randn(shape, generator=generator, dtype=_F32, device=device)


def _ar1_noise(white: torch.Tensor, beta: float) -> torch.Tensor:
    """AR(1)-correlated noise along the horizon with unit marginal variance,
    ``e_0 = n_0``, ``e_k = beta e_{k-1} + sqrt(1-beta^2) n_k``, from white
    draws ``(N, B, S, m)``; returned candidates-leading, ``(S, B, N, m)``."""
    # sqrt in float32 of the float32-rounded argument, as jnp.sqrt of a
    # Python float
    gain = float(np.sqrt(np.float32(1.0 - beta * beta)))
    eps = [white[0]]
    for k in range(1, white.shape[0]):
        eps.append(beta * eps[-1] + gain * white[k])
    return torch.stack(eps).permute(2, 1, 0, 3)


def make_mppi_solver(ocp: OCP, settings: MppiSettings = MppiSettings(), *, device=None):
    """Build ``solve(thetas, U0s, generator) -> Solution`` over a B-leading
    bank: ``thetas`` a dict of (B, ...) tensors, ``U0s`` (B, N, m), both on
    ``device`` (``None``: the card, which raises without one), and
    ``generator`` a ``torch.Generator`` on that device. Any OCP whose
    transition has batched ``(..., n)`` semantics (every model of the
    port). The Solution reports the true objective and the iLQR engines'
    projected-gradient KKT residual, so engines compare on one scale."""
    dev = resolve_device(device)
    N, m = ocp.horizon, ocp.n_controls
    _probe_batch_semantics(ocp.transition, ocp.n_states, m)
    t = _BankTerms(ocp)
    lo = torch.tensor(ocp.u_lo, dtype=_F32, device=dev)
    hi = torch.tensor(ocp.u_hi, dtype=_F32, device=dev)
    sigma0 = settings.sigma_frac * (hi - lo)
    S = settings.n_samples

    def cand_costs(C, thetas):
        """True costs (A, B) of candidate controls C (A, B, N, m)."""
        x = thetas["x0"].expand(C.shape[0], *thetas["x0"].shape)
        J = 0.0
        for k in range(N):
            J = J + t.stage2[k](x, C[:, :, k], thetas)
            x = t.F(x, C[:, :, k])
        return J + t.terminal2(x, thetas)

    def solve(thetas, U0s, generator):
        B = U0s.shape[0]
        U = torch.clamp(U0s.to(_F32), lo, hi)
        J_best, U_best = cand_costs(U[None], thetas)[0], U
        rows = torch.arange(B, device=dev)
        for it in range(settings.n_iters):
            sigma = sigma0 * settings.sigma_decay**it
            eps = _ar1_noise(_white_noise(generator, it, (N, B, S, m), dev), settings.smooth_beta)
            # the current mean always competes (guards the weighted update
            # against a round where every perturbation is worse)
            cands = torch.cat([U[None], torch.clamp(U[None] + sigma * eps, lo, hi)])
            Js = cand_costs(cands, thetas)
            Js = torch.where(torch.isnan(Js), torch.inf, Js)
            J_min, i_min = torch.min(Js, dim=0)
            w = torch.exp(-(Js - J_min) / settings.temperature)
            w = w / w.sum(0)
            U = torch.clamp(torch.einsum("sb,sbnm->bnm", w, cands), lo, hi)
            # running elite: the single best sampled sequence ever seen
            better = J_min < J_best
            U_best = torch.where(better[:, None, None], cands[i_min, rows], U_best)
            J_best = torch.where(better, J_min, J_best)
        # the better of the weighted mean and the running elite
        take_mean = t.true_cost(U, thetas) <= J_best
        U_fin = torch.where(take_mean[:, None, None], U, U_best)
        X, J = t.rollout(U_fin, thetas)
        g = grad(lambda UU: t.true_cost(UU, thetas).sum())(U_fin)
        kkt = (U_fin - torch.clamp(U_fin - g, lo, hi)).abs().amax(dim=(1, 2))
        return Solution(
            U=U_fin,
            X=X,
            cost=J,
            kkt_residual=kkt,
            converged=kkt < settings.kkt_tol,
            n_iters=torch.full((B,), settings.n_iters, dtype=torch.int32, device=dev),
            reg=torch.zeros(B, dtype=_F32, device=dev),
        )

    return solve


def _sanitize_cost(cost):
    """NaN costs lose to everything (argmin/min would pick NaN)."""
    return torch.where(torch.isnan(cost), torch.inf, cost)


def _prefer_first(sol_a: Solution, sol_b: Solution) -> torch.Tensor:
    """Lexicographic (converged, cost) preference for ``sol_a`` over
    ``sol_b``, elementwise; ties go to ``sol_b``. No big-penalty arithmetic:
    a 1e30 offset swamps the cost term in float32."""
    c_a, c_b = _sanitize_cost(sol_a.cost), _sanitize_cost(sol_b.cost)
    return torch.where(sol_a.converged == sol_b.converged, c_a < c_b, sol_a.converged)


def _select_best(sols: Solution) -> torch.Tensor:
    """Index along the leading (candidate) axis of the lexicographically best
    candidate: the lowest NaN-safe cost among the converged, else the lowest
    cost overall (the first of equals, as ``jnp.argmin``). Extra trailing
    axes (a bank of scenarios) give one index each."""
    cost = _sanitize_cost(sols.cost)
    masked = torch.where(sols.converged, cost, torch.inf)
    return torch.where(sols.converged.any(dim=0), torch.argmin(masked, dim=0), torch.argmin(cost, dim=0))


def _take(sols: Solution, pick) -> Solution:
    return Solution(*(pick(f) for f in sols))


def make_multistart_solver(
    ocp: OCP,
    ilqr_settings: SolverSettings = SolverSettings(),
    mppi_settings: MppiSettings | None = None,
    swing_fracs: tuple = (1.0, 0.5),
    include_mppi: bool = True,
    *,
    engine="cuda",
    kind: str = "point_stabilization",
    device=None,
):
    """Multi-start global/local solve: one iLQR bank call over each
    scenario's {warm start, MPPI answer, deterministic arc seeds}, best of by
    (converged, cost). ``solve(thetas, U0s, generator) -> Solution``.
    ``include_mppi=False`` drops the MPPI answer: the starts are the warm
    start and the arc seeds, and ``generator`` is not drawn from.

    On a symmetric saddle (an obstacle dead-center on the start-goal line)
    the gradient cannot break the tie and MPPI's exploration is far smaller
    than the goal distance; the bang-bang arc seeds (drive channel at 0.75
    of its upper bound, swing channel +/- for the first quarter of the
    horizon, reversed for the second) break the symmetry structurally and
    the Newton polish does the rest. Seeds come from the control box alone.

    The K+2 starts of B scenarios are one bank of B*(K+2) rows: with
    ``engine="cuda"`` one K1 launch (K2 for ``kind="tracking"``), the same
    lanes a scenario bank rides. ``solve.engines`` holds that bank solve."""
    dev = resolve_device(device)
    polish = bank_engine(engine, ocp, ilqr_settings, kind=kind)
    mppi_settings = mppi_settings or MppiSettings(n_samples=128, n_iters=8)
    mppi = make_mppi_solver(ocp, mppi_settings, device=dev) if include_mppi else None
    n_iters = ilqr_settings.total_iters + (mppi_settings.n_iters if include_mppi else 0)
    N, m = ocp.horizon, ocp.n_controls
    seeds = arc_seeds(ocp, swing_fracs, device=dev)  # (K, N, m); raises for m < 2
    lo = torch.tensor(ocp.u_lo, dtype=_F32, device=dev)
    hi = torch.tensor(ocp.u_hi, dtype=_F32, device=dev)

    def solve(thetas, U0s, generator):
        B = U0s.shape[0]
        warm = torch.clamp(U0s.to(_F32), lo, hi)
        starts = [warm] if mppi is None else [warm, mppi(thetas, warm, generator).U]
        starts = torch.stack(starts, dim=1)
        cands = torch.cat([starts, seeds[None].expand(B, *seeds.shape)], dim=1)
        S = cands.shape[1]
        # scenario-major rows: each scenario's S starts are adjacent
        big = {k: torch.repeat_interleave(v, S, dim=0) for k, v in thetas.items()}
        sols = polish(big, cands.reshape(B * S, N, m))
        per = _take(sols, lambda f: f.reshape(B, S, *f.shape[1:]).transpose(0, 1))  # (S, B, ...)
        i = _select_best(per)
        best = _take(per, lambda f: f[i, torch.arange(B, device=i.device)])
        return best._replace(
            n_iters=torch.full((B,), n_iters, dtype=torch.int32, device=i.device)
        )

    solve.engines = (polish,)
    return solve


def make_hybrid_solver(
    ocp: OCP,
    ilqr_settings: SolverSettings = SolverSettings(),
    mppi_settings: MppiSettings | None = None,
    *,
    engine="cuda",
    kind: str = "point_stabilization",
    device=None,
):
    """Global then local: MPPI exploration seeds the interior-point iLQR.
    ``solve(thetas, U0s, generator) -> Solution``.

    MPPI runs a short schedule from ``U0s`` (128 samples x 8 iterations by
    default), the iLQR polishes its answer, and the polished row is kept
    only where it beats the plain iLQR from ``U0s`` on (converged, cost),
    so the hybrid is never worse than the local engine it wraps. The two
    iLQR bank calls (polish, plain) are K1 launches with ``engine="cuda"``;
    ``solve.engines`` holds that bank solve."""
    dev = resolve_device(device)
    mppi = make_mppi_solver(ocp, mppi_settings or MppiSettings(n_samples=128, n_iters=8), device=dev)
    ilqr = bank_engine(engine, ocp, ilqr_settings, kind=kind)

    def solve(thetas, U0s, generator):
        sol_m = mppi(thetas, U0s, generator)
        sol_a = ilqr(thetas, sol_m.U)  # polish the explored basin
        sol_b = ilqr(thetas, U0s)  # the plain local solve
        # prefer converged; among equals prefer lower cost; ties -> plain
        take_a = _prefer_first(sol_a, sol_b)

        def pick(a, b):
            return torch.where(take_a.reshape(take_a.shape + (1,) * (a.dim() - 1)), a, b)

        return Solution(
            U=pick(sol_a.U, sol_b.U),
            X=pick(sol_a.X, sol_b.X),
            cost=pick(sol_a.cost, sol_b.cost),
            kkt_residual=pick(sol_a.kkt_residual, sol_b.kkt_residual),
            converged=pick(sol_a.converged, sol_b.converged),
            n_iters=sol_a.n_iters + sol_b.n_iters,
            reg=pick(sol_a.reg, sol_b.reg),
        )

    solve.engines = (ilqr,)
    return solve

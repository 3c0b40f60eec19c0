"""Two-pass straggler rescue, the compacted polish stage, and the composites
built from them.

Port of :mod:`ros2_mpc_tpu.solver.rescue`. On obstacle-active banks a fixed
schedule leaves a few percent of scenarios above the KKT tolerance. Rather
than re-run the whole bank on a longer schedule, a second compacted pass
takes only those:

1. **first pass**: the bank solve (any engine);
2. **compaction**: the non-converged indices, at a fixed capacity ``C``
   (``torch.topk`` on the converged mask, lowest indices first);
3. **rescue bank**: each straggler enters twice, cold-started and
   warm-started from its first-pass iterate, and the ``2C`` bank is solved
   once on a longer schedule;
4. **scatter-back**: per straggler the best of {first pass, cold, warm} by
   KKT residual; converged rows are untouched.

Every pass runs whatever its engine does with the tensors' device: K1 and K2
(``make_cuda_*_solver``) launch their kernels on CUDA tensors and run their
plain versions on CPU tensors. The rescue pass always runs, on ``2C`` rows,
whether or not the first pass left stragglers, as in the JAX package.

Each composite carries ``solve.engines``, the bank solves it calls (in call
order), so a caller can read their launch counters.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .ilqr import OCP, Solution, SolverSettings


def rescue_schedule() -> SolverSettings:
    """The rescue schedule: 16 barrier stages x 10 iterations, 12 line-search
    step sizes (~3.2x a standard solve per scenario, paid only by the
    stragglers)."""
    return SolverSettings(barrier_stages=16, iters_per_stage=10, n_alphas=12)


def _engines(*fns):
    """The bank solves under ``fns``, flattened through nested composites."""
    out = []
    for f in fns:
        out.extend(getattr(f, "engines", (f,)))
    return tuple(out)


def _check_capacity(capacity: int):
    if int(capacity) < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")


def _top_failed(sols: Solution, capacity: int, what: str):
    """Indices of the top-``capacity`` non-converged rows (failed rows score
    above every converged row; ties toward the low index), and the failed
    mask. Raises where ``capacity`` exceeds the bank."""
    B = sols.kkt_residual.shape[0]
    if capacity > B:
        raise ValueError(f"{what} capacity {capacity} exceeds the bank of {B} scenarios")
    fail = torch.logical_not(sols.converged)
    score = fail.to(torch.float32) * 2.0 - torch.arange(B, device=fail.device) / B
    _, idx = torch.topk(score, capacity, sorted=True)
    return idx, fail


def _merge_rows(old, idx, take, new):
    """``old`` with rows ``idx`` set to ``where(take, new, old[idx])``, out of
    place."""
    shape = (idx.shape[0],) + (1,) * (new.dim() - 1)
    return old.index_copy(0, idx, torch.where(take.reshape(shape), new, old[idx]))


def make_two_pass_solver(
    first_solve: Callable,
    rescue_solve: Callable,
    capacity: int,
    kkt_tol: Optional[float] = None,
):
    """Compose ``first_solve`` and a compacted straggler ``rescue_solve`` into
    one ``solve(thetas, U0s) -> Solution``.

    ``rescue_solve`` gets a bank of ``2 * capacity`` scenarios (cold seeds,
    then warm). If more than ``capacity`` rows fail the first pass, the
    lowest-indexed are rescued and the rest keep their first-pass iterates;
    a ``capacity`` above the bank raises ``ValueError``. ``kkt_tol`` (default
    ``SolverSettings().kkt_tol``) is the tolerance at which the merged
    ``converged`` flags are recomputed."""
    _check_capacity(capacity)
    tol = SolverSettings().kkt_tol if kkt_tol is None else kkt_tol

    def solve(thetas, U0s):
        sols = first_solve(thetas, U0s)
        sub, seeds, idx, fail = _select_stragglers(sols, thetas, U0s, capacity)
        rsols = rescue_solve(sub, seeds)
        return _merge_rescue(sols, rsols, idx, fail, capacity, tol)

    solve.engines = _engines(first_solve, rescue_solve)
    return solve


def _select_stragglers(sols, thetas, U0s, capacity):
    """Gather the top-``capacity`` non-converged rows into a cold+warm rescue
    bank: ``(thetas_sub, seeds, idx, fail)``."""
    idx, fail = _top_failed(sols, capacity, "rescue")
    sub = {k: torch.cat([v[idx], v[idx]]) for k, v in thetas.items()}
    seeds = torch.cat([torch.zeros_like(U0s[idx]), sols.U[idx]])
    return sub, seeds, idx, fail


def _merge_rescue(sols, rsols, idx, fail, capacity, tol):
    """Scatter the better of {cold, warm} rescue rows back, only where the
    rescue lowered the residual of a row that had failed (converged rows
    drawn in as padding keep their iterates); ``converged`` is recomputed at
    ``tol``."""
    k_c, k_w = rsols.kkt_residual[:capacity], rsols.kkt_residual[capacity:]
    take_cold = k_c <= k_w

    def best(f):
        cold, warm = f[:capacity], f[capacity:]
        return torch.where(take_cold.reshape((capacity,) + (1,) * (cold.dim() - 1)), cold, warm)

    k_r = best(rsols.kkt_residual)
    improved = (k_r < sols.kkt_residual[idx]) & fail[idx]
    kkt = _merge_rows(sols.kkt_residual, idx, improved, k_r)
    return Solution(
        U=_merge_rows(sols.U, idx, improved, best(rsols.U)),
        X=_merge_rows(sols.X, idx, improved, best(rsols.X)),
        cost=_merge_rows(sols.cost, idx, improved, best(rsols.cost)),
        kkt_residual=kkt,
        converged=kkt < tol,
        n_iters=sols.n_iters,
        reg=sols.reg,
    )


def make_cuda_two_pass_point_stab(
    ocp: OCP,
    settings: SolverSettings = SolverSettings(),
    *,
    capacity: int = 512,
    rescue_settings: Optional[SolverSettings] = None,
):
    """Two-pass point-stabilization bank on K1: a first pass at ``settings``
    and a rescue pass of ``2 * capacity`` rows at ``rescue_settings``
    (default :func:`rescue_schedule`), both
    :func:`~.cuda_kernel.make_cuda_point_stab_solver`. Pair
    ``SolverSettings.fast()`` with the default capacity."""
    from .cuda_kernel import make_cuda_point_stab_solver

    rescue_settings = rescue_settings or rescue_schedule()
    first = make_cuda_point_stab_solver(ocp, settings)
    rescue = make_cuda_point_stab_solver(ocp, rescue_settings)
    return make_two_pass_solver(first, rescue, capacity, kkt_tol=settings.kkt_tol)


def make_cuda_two_pass_tracking(
    ocp: OCP,
    settings: SolverSettings = SolverSettings(),
    *,
    capacity: int = 512,
    rescue_settings: Optional[SolverSettings] = None,
):
    """The tracking twin of :func:`make_cuda_two_pass_point_stab`, both passes
    on K2 (:func:`~.cuda_kernel.make_cuda_tracking_solver`)."""
    from .cuda_kernel import make_cuda_tracking_solver

    rescue_settings = rescue_settings or rescue_schedule()
    first = make_cuda_tracking_solver(ocp, settings)
    rescue = make_cuda_tracking_solver(ocp, rescue_settings)
    return make_two_pass_solver(first, rescue, capacity, kkt_tol=settings.kkt_tol)


def make_polish_stage(
    first_solve: Callable,
    polish_solve: Callable,
    capacity: int,
    kkt_tol: Optional[float] = None,
):
    """Compacted warm-only stage: run ``first_solve``, gather the top
    ``capacity`` non-converged rows, polish them from their own iterates
    (``polish_solve(thetas_sub, U_sub)``), and merge back wherever the KKT
    residual strictly improved."""
    _check_capacity(capacity)
    tol = SolverSettings().kkt_tol if kkt_tol is None else kkt_tol

    def solve(thetas, U0s):
        sols = first_solve(thetas, U0s)
        sub, warm, idx, fail = _select_polish(sols, thetas, capacity)
        psols = polish_solve(sub, warm)
        return _merge_polish(sols, psols, idx, fail, capacity, tol)

    solve.engines = _engines(first_solve, polish_solve)
    return solve


def _select_polish(sols, thetas, capacity):
    idx, fail = _top_failed(sols, capacity, "polish")
    return {k: v[idx] for k, v in thetas.items()}, sols.U[idx], idx, fail


def _merge_polish(sols, psols, idx, fail, capacity, tol):
    improved = (psols.kkt_residual < sols.kkt_residual[idx]) & fail[idx]
    kkt = _merge_rows(sols.kkt_residual, idx, improved, psols.kkt_residual)
    return Solution(
        U=_merge_rows(sols.U, idx, improved, psols.U),
        X=_merge_rows(sols.X, idx, improved, psols.X),
        cost=_merge_rows(sols.cost, idx, improved, psols.cost),
        kkt_residual=kkt,
        converged=kkt < tol,
        n_iters=sols.n_iters,
        reg=sols.reg,
    )


def make_fast_polish_solver(
    ocp: OCP,
    settings: SolverSettings = SolverSettings(),
    *,
    capacity: int = 1536,
    polish_iters: int = 12,
):
    """Model-generic bank composite: the fast bank engine's first pass plus a
    compacted box-DDP KKT polish of ``capacity`` rows. For the extra model
    families, whose straggler tail is control-saturated rows where the
    clipped-feedback Riccati direction stalls. Any small-(n, m) OCP with a
    batch-safe transition works."""
    from .batched import make_bank_kkt_polish, make_bank_solver_fast

    first = make_bank_solver_fast(ocp, settings)
    polish = make_bank_kkt_polish(ocp, n_iters=polish_iters, kkt_tol=settings.kkt_tol)
    return make_polish_stage(first, polish, capacity, kkt_tol=settings.kkt_tol)


def make_multistart_two_pass_solver(
    ocp: OCP,
    settings: SolverSettings = SolverSettings(),
    *,
    capacity: int = 768,
    swing_fracs: tuple = (1.0,),
    rescue_settings: Optional[SolverSettings] = None,
    rescue_swing_fracs: Optional[tuple] = None,
    polish_iters: int = 12,
    polish_capacity: Optional[int] = None,
    engine="cuda",
):
    """Basin escape x straggler rescue x KKT polish:

    1. **first pass**: K = 1 + 2*len(swing_fracs) arc-seeded starts per
       scenario at ``settings``, best-of per scenario
       (:func:`~.multistart_bank.make_bank_multistart_solver`);
    2. **rescue pass**: the non-converged rows re-enter (cold + warm) on
       ``rescue_settings`` (``None``: :func:`rescue_schedule`) with the arc
       seeds of ``rescue_swing_fracs`` (``None``: ``swing_fracs``),
       ``2 * capacity * K_rescue`` engine rows, K_rescue =
       1 + 2*len(rescue_swing_fracs);
    3. **KKT polish**: ``polish_iters`` box-DDP steps on ``polish_capacity``
       rows (``None``: ``capacity``), :func:`~.batched.make_bank_kkt_polish`.

    ``engine`` is the bank engine of both multistart passes: ``"cuda"`` (K1)
    by default, ``"fast"``, ``"vmap"``, or a callable
    ``engine(ocp, settings) -> solve_bank``."""
    from .batched import make_bank_kkt_polish
    from .multistart_bank import make_bank_multistart_solver

    first = make_bank_multistart_solver(ocp, settings, swing_fracs=swing_fracs, engine=engine)
    rescue = make_bank_multistart_solver(
        ocp,
        rescue_settings or rescue_schedule(),
        swing_fracs=rescue_swing_fracs or swing_fracs,
        engine=engine,
    )
    base = make_two_pass_solver(first, rescue, capacity, kkt_tol=settings.kkt_tol)

    polish = make_bank_kkt_polish(ocp, n_iters=polish_iters, kkt_tol=settings.kkt_tol)
    return make_polish_stage(base, polish, polish_capacity or capacity, kkt_tol=settings.kkt_tol)

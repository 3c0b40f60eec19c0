"""The numbers that decide ``correct``: what the program's outputs say,
held against the reference on the same raw inputs.

Every number is a gap that sound outputs keep small; each has its limit in
``limits/<cell>.json``. ``claims`` re-derives what a solve's controls mean
(the trajectory, the true cost, the KKT residual) and compares the
program's own statements; ``kkt_rel_gap`` holds the reported residual
that a bank's rate counts, near the tolerance; ``solve_gap`` and
``conv_gap`` compare the program's solution with the reference's solve from
the same start.
"""

from __future__ import annotations

import torch

from . import reference as R


def _max(t) -> float:
    t = t.float()
    if t.numel() == 0:
        return 0.0
    bad = ~torch.isfinite(t)
    return float("inf") if bool(bad.any()) else float(t.max())


def claims(rows: R.Rows, U, X, cost, kkt) -> dict:
    """``x_gap``: widest gap between the program's states and the rollout
    of its controls (m, rad); ``cost_gap``: widest gap of its cost against
    the true cost of its controls, over 1 + |cost|; ``kkt_gap``: widest
    gap of its KKT residual against the residual of its controls. Inputs
    are float32, scenario axis last: U (N, 2, S), X (N+1, 3, S)."""
    Xr, Jr, kr = R.evaluate(rows, U.float())
    return {
        "x_gap": _max((X.float() - Xr).abs()),
        "cost_gap": _max((cost.float() - Jr).abs() / (1.0 + Jr.abs())),
        "kkt_gap": _max((kkt.float() - kr).abs()),
    }, kr, Jr


def kkt_rel_gap(kkt_reported, kkt_true, tol: float) -> float:
    """Widest ratio, less 1, of the larger to the smaller of the program's
    reported KKT residual and the residual of its controls, each with
    ``tol`` added. The banks' rate counts the rows reported under ``tol``:
    under a limit of L a row is counted on the wrong side only where both
    residuals lie under (1 + 2L) ``tol``."""
    rep, true = kkt_reported.float().abs(), kkt_true.abs()
    return _max((rep - true).abs() / (tol + torch.minimum(rep, true)))


def conv_gap(ref_kkt, prog_kkt_true, tol: float) -> float:
    """Share of the rows the reference's solve converges on, less the share
    the program's controls converge on (both judged by the reference's
    KKT residual)."""
    return float((ref_kkt < tol).float().mean() - (prog_kkt_true < tol).float().mean())


def solve_gap(ref_cost, prog_cost_true) -> float:
    """Widest excess of the true cost of the program's controls over the
    reference solve's, over 1 + |reference cost|."""
    return _max(torch.clamp(prog_cost_true - ref_cost, min=0.0) / (1.0 + ref_cost.abs()))


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number that is not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        out[name] = {"value": v, "limit": limit}
        if not (v <= limit):
            ok = False
    return ok, out

"""The path follower on K2: the program's problem and bank engine, its
thetas from the raw inputs, the reference's rows, and the frozen ledger of
one solve. Raw inputs: ``x0`` (S, 3), ``x_ref`` (S, N, 3), ``u_ref``
(S, N, 2), ``ox``, ``oy`` (S, n_obs), and optionally per-row ``Q`` and
``TW`` (S, 3), the handoff's gains."""

import torch

from yardstick import cells, ledger

ENGINE_KIND = "tracking"  # multistart_bank.bank_engine's kind


def make_problem(P, params, config, settings, device):
    return P.problems.make_tracking(
        params, reference_parity=False, horizon=params.N, settings=settings,
        terminal_weight=tuple(config["formulation"]["terminal_weight"]), device=device,
    )  # fmt: skip


def thetas(problem, raw):
    th = torch.func.vmap(problem.make_theta)(raw["x0"], raw["x_ref"], raw["u_ref"], raw["ox"], raw["oy"])
    return {k: v.contiguous() for k, v in th.items()}


def rows(config, raw):
    S = raw["x0"].shape[0]
    tw = raw["TW"].T.contiguous() if "TW" in raw else cells.column(config["formulation"]["terminal_weight"], S, raw)
    return cells.reference_rows(
        config, "tracking", raw, xref=raw["x_ref"].permute(1, 2, 0).contiguous(),
        uref=raw["u_ref"].permute(1, 2, 0).contiguous(), TW=tw,
    )  # fmt: skip


def work(N, n_obs, P, iters, ls_rollouts):
    """(operations of each solve, bytes of one solve)."""
    return ledger.tracking_flops(N, P, iters, ls_rollouts), ledger.tracking_bytes(N, n_obs)

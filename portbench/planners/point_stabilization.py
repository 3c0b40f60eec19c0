"""The point-stabilization planner on K1: the program's problem and bank
engine, its thetas from the raw inputs, the reference's rows, and the
frozen ledger of one solve. Raw inputs: ``x0``, ``goal`` (S, 3), ``ox``,
``oy`` (S, n_obs)."""

import torch

from yardstick import cells, ledger

ENGINE_KIND = "point_stabilization"  # multistart_bank.bank_engine's kind


def make_problem(P, params, config, settings, device):
    return P.problems.make_point_stabilization(
        params, reference_parity=False, horizon=params.N, settings=settings, device=device
    )


def thetas(problem, raw):
    th = torch.func.vmap(problem.make_theta)(raw["x0"], raw["goal"], raw["ox"], raw["oy"])
    return {k: v.contiguous() for k, v in th.items()}


def rows(config, raw):
    return cells.reference_rows(config, "point_stab", raw, goal=raw["goal"].T.contiguous())


def work(N, n_obs, P, iters, ls_rollouts):
    """(operations of each solve, bytes of one solve)."""
    return ledger.point_stab_flops(N, P, iters, ls_rollouts), ledger.point_stab_bytes(N, n_obs)

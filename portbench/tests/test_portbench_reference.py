"""The frozen reference against the program's plain versions on the CPU at
a tiny size: the same problem (a rollout, cost and KKT residual of the same
controls agree to rounding) and the same solver (the same controls)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import tiny

from yardstick import cells, judge, spec, traffic
from yardstick import reference as R


def _point_bank(seed, B=12):
    s = tiny("point_stab.bank_open")
    mix = dict(s["traffic"], B=B, pool=1)
    return s, traffic.pool(mix, s["config"], seed, "cpu")[0]


@pytest.mark.parametrize("seed", [1, 2])
def test_point_stab_reference_agrees_with_the_plain_K1(seed):
    s, raw = _point_bank(seed)
    P = cells.port()
    params = cells.program_params(P, s["config"])
    prob = P.problems.make_point_stabilization(params, reference_parity=False, horizon=8, device="cpu")
    solver = P.cuda_kernel.make_cuda_point_stab_solver(prob.ocp, cells.program_settings(P, s["traffic"]))
    th = torch.func.vmap(prob.make_theta)(raw["x0"], raw["goal"], raw["ox"], raw["oy"])
    sol = solver(th, torch.zeros(12, 8, 2))
    rows = spec.planner("point_stabilization").rows(s["config"], raw)
    U, X = cells.planes(sol.U, sol.X)
    nums, kkt_true, _ = judge.claims(rows, U, X, sol.cost, sol.kkt_residual)
    assert nums["x_gap"] < 1e-5 and nums["cost_gap"] < 1e-5 and nums["kkt_gap"] < 1e-5
    ref = R.solve(rows, torch.zeros(8, 2, 12), cells.schedule(s["traffic"]))
    same = (ref["U"] - U).abs().amax(dim=(0, 1)) < 1e-3
    assert float(same.float().mean()) >= 0.75, "most rows reach the same controls"
    assert torch.equal(ref["converged"][same], (kkt_true < 1e-4)[same])


def test_tracking_reference_agrees_with_the_plain_K2():
    s = tiny("tracking.fleet_arc")
    P = cells.port()
    params = cells.program_params(P, s["config"])
    prob = P.problems.make_tracking(params, reference_parity=False, horizon=8, device="cpu")
    solver = P.cuda_kernel.make_cuda_tracking_solver(prob.ocp, cells.program_settings(P, s["traffic"]))
    ctx = traffic.context(s["config"], 5, "cpu", B=s["traffic"]["B"])
    raw = traffic.draw([dict(s["traffic"]["draws"][0], recipe="arc_windows"), s["traffic"]["draws"][1]], ctx)
    B = raw["x0"].shape[0]
    th = torch.func.vmap(prob.make_theta)(raw["x0"], raw["x_ref"], raw["u_ref"], raw["ox"], raw["oy"])
    sol = solver(th, torch.zeros(B, 8, 2))
    rows = spec.planner("tracking").rows(s["config"], raw)
    U, X = cells.planes(sol.U, sol.X)
    nums, _, cost_true = judge.claims(rows, U, X, sol.cost, sol.kkt_residual)
    assert nums["x_gap"] < 1e-5 and nums["cost_gap"] < 1e-5 and nums["kkt_gap"] < 1e-5
    ref = R.solve(rows, torch.zeros(8, 2, B), cells.schedule(s["traffic"]))
    assert judge.solve_gap(ref["cost"], cost_true) < 1e-3


def test_plant_is_the_programs_plant():
    P = cells.port()
    x = torch.tensor(np.random.default_rng(0).uniform(-3, 3, (64, 3)), dtype=torch.float32)
    u = torch.tensor(np.random.default_rng(1).uniform(-0.2, 0.2, (64, 2)), dtype=torch.float32)
    from ros2_mpc_tpu_torch.models import unicycle
    from ros2_mpc_tpu_torch.ops.integrators import rk4_step

    mine = R.plant(x, u, 0.2)
    theirs = rk4_step(unicycle.f, x, u, 0.2)
    assert torch.allclose(mine[:, :2], theirs[:, :2], atol=1e-6)
    assert torch.allclose(torch.cos(mine[:, 2]), torch.cos(theirs[:, 2]), atol=1e-5)
    assert P is not None

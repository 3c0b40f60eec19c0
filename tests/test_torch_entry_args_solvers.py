"""The solver arguments that the port restores, held against the JAX
package's on the CPU: the compat adapters' ``reference_parity``,
``make_multistart_solver``'s ``include_mppi``,
``make_multistart_two_pass_solver``'s ``rescue_settings``,
``rescue_swing_fracs`` and ``polish_capacity``, and the scaling harness's
``multistart_rescue`` options that carry the short rescue schedule.

Bands: the live band of tests/test_pallas.py (U within 5e-4, cost within
rtol 1e-3) on the rows the JAX package certifies converged, as
tests/test_torch_multistart.py holds the bank engines; the port's two
multistart forms against each other at tests/test_multistart_bank.py's
1e-5. (Split from ``test_torch_entry_args.py`` to keep each file under
~90 s of one worker: the port's ``make_solver`` takes ~20 s a solve on a CPU.)"""

import jax
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import compat as jcompat
from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.solver import multistart_bank as jm
from ros2_mpc_tpu_torch import compat
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.convert import solution_to_numpy, theta_from_numpy
from ros2_mpc_tpu_torch.parallel import mesh, scaling_bench
from ros2_mpc_tpu_torch.solver import batched as tbatched
from ros2_mpc_tpu_torch.solver import mppi as tmppi
from ros2_mpc_tpu_torch.solver import multistart_bank as tmb

COMPAT_N = 10
FAST = dict(barrier_stages=6, iters_per_stage=4, n_alphas=8)  # tests/test_multistart_bank.py
SHORT = dict(barrier_stages=3, iters_per_stage=2, n_alphas=4)  # the scaling harness's short schedule
LIVE = (5e-4, 1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors through many ops: under the suite's parallel workers
    PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _obstacles(n, pts):
    x, y = np.full(n, 100.0), np.full(n, 100.0)
    for i, (px, py) in enumerate(pts):
        x[i], y[i] = px, py
    return x, y


def _recorded(mpc):
    """Keep each (theta, Solution) of the adapter's solve."""
    solve, kept = mpc._solve, []

    def run(theta, U0):
        kept.append((theta, solve(theta, U0)))
        return kept[-1][1]

    mpc._solve = run
    return kept


@pytest.mark.parametrize("name", ["TrackingMpc", "PointStabilizationMpc"])
def test_compat_corrected_mode_matches_jax(name):
    """``reference_parity=False`` solves the corrected formulation: live
    obstacle costs (weight 1, where parity has 0), which move the JAX
    package's answer on these inputs, and the port's within the live band
    of the JAX package's corrected adapter."""
    n_obs = Params().n_obstacle_points
    if name == "TrackingMpc":
        dt = Params().dt
        ts_ = np.arange(1, COMPAT_N + 1) * dt
        pf = np.stack([0.15 * ts_, np.zeros(COMPAT_N), np.zeros(COMPAT_N)], axis=1).reshape(-1, 1)
        puf = np.tile([0.15, 0.0], (COMPAT_N, 1)).reshape(-1, 1)
        args = (np.zeros(3), pf, puf, *_obstacles(n_obs, [(0.2, 0.03)]))
    else:
        args = (np.zeros(3), np.array([1.0, 0.0, 0.0]), *_obstacles(n_obs, [(0.5, 0.04)]))
    mpc = getattr(compat, name)(Params(), reference_parity=False, horizon=COMPAT_N, device="cpu")
    jmpc = getattr(jcompat, name)(JParams(), reference_parity=False, horizon=COMPAT_N)
    jpar = getattr(jcompat, name)(JParams(), horizon=COMPAT_N)
    kept, jkept, jpkept = _recorded(mpc), _recorded(jmpc), _recorded(jpar)
    u0 = np.zeros((2, COMPAT_N))
    out, jout, jpout = mpc.perform_mpc(u0, *args), jmpc.perform_mpc(u0, *args), jpar.perform_mpc(u0, *args)
    (theta, sol), (jtheta, jsol), (_, jpsol) = kept[0], jkept[0], jpkept[0]
    assert float(theta["obstacle_weight"]) == float(jtheta["obstacle_weight"]) == 1.0
    assert np.abs(np.asarray(jsol.U) - np.asarray(jpsol.U)).max() > 10 * LIVE[0]  # corrected is not parity here
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(jsol.U), atol=LIVE[0])
    np.testing.assert_allclose(float(sol.cost), float(jsol.cost), rtol=LIVE[1])
    if name == "TrackingMpc":
        np.testing.assert_allclose(out[1], jout[1], atol=LIVE[0])
        assert out[0].shape == (3, COMPAT_N + 1)
    else:
        np.testing.assert_allclose(out, jout, atol=LIVE[0])


def _saddle(horizon, B, seed, settings):
    jp = js.make_point_stabilization(
        JParams(), horizon=horizon, settings=js.SolverSettings(**settings), reference_parity=False
    )
    tp = ts.make_point_stabilization(
        Params(), horizon=horizon, settings=ts.SolverSettings(**settings), reference_parity=False, device="cpu"
    )
    th, U0 = jm.adversarial_saddle_bank(jp, B, seed=seed)
    return jp, tp, th, U0


def test_multistart_without_mppi_matches_jax():
    """tests/test_multistart_bank.py:20-41 through the port: B=16, N=12, the
    saddle bank of seed 3. ``include_mppi=False`` polishes the warm start
    and the arc seeds only, so it equals the bank multistart (1e-5) and
    draws nothing from the generator; against the JAX package's
    ``make_multistart_solver(include_mppi=False)`` in the live band."""
    jp, tp, th, U0 = _saddle(12, 16, 3, FAST)
    per_ms = jax.jit(jax.vmap(js.make_multistart_solver(jp.ocp, jp.settings, include_mppi=False), in_axes=(0, 0, 0)))
    ref = per_ms(th, U0, jax.random.split(jax.random.PRNGKey(0), 16))
    tth, tU0 = theta_from_numpy(th, "cpu"), torch.as_tensor(np.asarray(U0))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    ms = tmppi.make_multistart_solver(tp.ocp, tp.settings, include_mppi=False, device="cpu")
    got = solution_to_numpy(ms(tth, tU0, gen))
    assert torch.equal(gen.get_state(), state)  # no MPPI, no draw
    bank = solution_to_numpy(tmb.make_bank_multistart_solver(tp.ocp, tp.settings)(tth, tU0))
    np.testing.assert_allclose(got.cost, bank.cost, rtol=1e-5)
    np.testing.assert_array_equal(got.converged, bank.converged)
    np.testing.assert_allclose(got.U, bank.U, atol=1e-5)
    assert (got.n_iters == tp.settings.total_iters).all()
    conv = np.asarray(ref.converged)
    assert conv.sum() >= 4
    np.testing.assert_allclose(got.U[conv], np.asarray(ref.U)[conv], atol=LIVE[0])
    np.testing.assert_allclose(got.cost[conv], np.asarray(ref.cost)[conv], rtol=LIVE[1])
    assert abs(got.converged.mean() - conv.mean()) <= 1.0 / 16


def test_multistart_two_pass_options_match_jax(monkeypatch):
    """B=16, N=6, FAST first pass, capacity 4, the short rescue schedule,
    rescue seeds (1.0, 0.5) (K_rescue 5) and a polish of 2 rows: the rescue
    engine runs the short schedule on 2 * 4 * 5 rows, the polish on 2, and
    the composite lands in the live band of the JAX package's with the same
    options on its ``vmap`` engine."""
    jp, tp, th, U0 = _saddle(6, 16, 0, FAST)
    kw = dict(capacity=4, swing_fracs=(1.0,), rescue_swing_fracs=(1.0, 0.5), polish_iters=4, polish_capacity=2)
    jcomp = jax.jit(js.make_multistart_two_pass_solver(
        jp.ocp, jp.settings, rescue_settings=js.SolverSettings(**SHORT), engine="vmap", **kw
    ))  # fmt: skip
    ref = jcomp(th, U0)
    banks, polished = [], []
    make_ms, make_polish = tmb.make_bank_multistart_solver, tbatched.make_bank_kkt_polish

    def counted_ms(ocp, settings, **k):
        solve = make_ms(ocp, settings, **k)

        def counted(t, U):
            banks.append((len(settings.mu_schedule()), U.shape[0]))
            return solve(t, U)

        counted.engines = solve.engines
        return counted

    def counted_polish(*a, **k):
        solve = make_polish(*a, **k)

        def counted(t, U):
            polished.append(U.shape[0])
            return solve(t, U)

        return counted

    monkeypatch.setattr(tmb, "make_bank_multistart_solver", counted_ms)
    monkeypatch.setattr(tbatched, "make_bank_kkt_polish", counted_polish)
    comp = ts.make_multistart_two_pass_solver(tp.ocp, tp.settings, rescue_settings=ts.SolverSettings(**SHORT), **kw)
    got = solution_to_numpy(comp(theta_from_numpy(th, "cpu"), torch.as_tensor(np.asarray(U0))))
    assert banks == [(tp.settings.total_iters, 16), (6, 2 * 4)]  # first pass; the rescue's cold + warm rows
    assert polished == [2]
    k1_rescue = comp.engines[1]
    assert len(k1_rescue.cfg.mus) == 6 and k1_rescue.cfg.n_alphas == SHORT["n_alphas"]
    conv = np.asarray(ref.converged)
    assert conv.sum() >= 4 and np.isfinite(got.U).all()
    np.testing.assert_allclose(got.U[conv], np.asarray(ref.U)[conv], atol=LIVE[0])
    np.testing.assert_allclose(got.cost[conv], np.asarray(ref.cost)[conv], rtol=LIVE[1])
    assert abs(got.converged.mean() - conv.mean()) <= 1.0 / 16


def test_scaling_harness_runs_multistart_rescue_on_the_short_rescue():
    """The harness's ``multistart_rescue`` options carry ``rescue_settings``,
    the short schedule of its ``two_pass`` entry (the JAX harness's
    options, ros2_mpc_tpu/parallel/scaling_bench.py:139-147), and the mesh
    engine hands it to the rescue pass."""
    opts = scaling_bench.engine_options(512)
    short = ts.SolverSettings(**SHORT)
    assert opts["multistart_rescue"]["rescue_settings"] == short == opts["two_pass"]["rescue_settings"]
    assert opts["multistart_rescue"]["capacity"] == 128
    prob = ts.make_point_stabilization(
        Params(), horizon=8, settings=opts["multistart_rescue"]["solver_settings"], device="cpu"
    )
    rest = {k: v for k, v in opts["multistart_rescue"].items() if k != "solver_settings"}
    step = mesh.make_bank_solver(prob, mesh.make_mesh(1, device="cpu"), engine="multistart_rescue", **rest)
    first, rescue, _ = step.engines
    assert len(first.cfg.mus) == len(rescue.cfg.mus) == short.total_iters

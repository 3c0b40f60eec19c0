"""Port parity: bank multistart (solver/multistart_bank.py) and the
multistart two-pass composite (solver/rescue.py) of ros2_mpc_tpu_torch
against ros2_mpc_tpu, on the CPU.

Inputs come from adversarial_saddle_bank, which draws the same bank from
one seed in both packages. Tolerances: the arc seeds bit-equal, the
saddle bank's thetas equal in float32; the multistart engines against the
JAX "vmap" engine in the live band (U atol 5e-4, cost rtol 1e-3) on the
rows JAX certifies converged, the converged fractions within one row (on
unconverged rows float32 rounding sends any two engines apart; see
tests/test_torch_batched.py).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.solver import multistart_bank as jm
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.convert import solution_to_numpy, theta_from_numpy
from ros2_mpc_tpu_torch.solver import multistart_bank as tm

PARAMS, T_PARAMS = JParams(), TParams()
FAST = dict(barrier_stages=6, iters_per_stage=4, n_alphas=8)
LIVE = (5e-4, 1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(horizon, settings=None, **kw):
    jset = js.SolverSettings(**settings) if settings else None
    tset = ts.SolverSettings(**settings) if settings else None
    jp = js.make_point_stabilization(PARAMS, horizon=horizon, settings=jset, reference_parity=False, **kw)
    tp = ts.make_point_stabilization(T_PARAMS, horizon=horizon, settings=tset, reference_parity=False, device="cpu", **kw)
    return jp, tp


@pytest.mark.parametrize(
    "family,horizon,swing", [("point", 12, (1.0, 0.5)), ("point", 40, (1.0,)), ("bicycle", 9, (0.7,))]
)
def test_arc_seeds_bit_equal_to_jax(family, horizon, swing):
    if family == "point":
        jp, tp = _problems(horizon)
    else:
        jp = js.make_bicycle_point_stabilization(PARAMS, horizon=horizon)
        tp = ts.make_bicycle_point_stabilization(T_PARAMS, horizon=horizon, device="cpu")
    got = tm.arc_seeds(tp.ocp, swing)
    ref = jm.arc_seeds(jp.ocp, swing)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2 * len(swing), horizon, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_arc_seeds_need_two_controls():
    ocp = ts.OCP(None, None, None, horizon=4, n_states=1, n_controls=1, u_lo=(-1.0,), u_hi=(1.0,))
    with pytest.raises(ValueError, match="n_controls >= 2"):
        tm.arc_seeds(ocp)


@pytest.mark.parametrize("horizon,B,seed", [(40, 16, 0), (12, 32, 3)])
def test_adversarial_saddle_bank_matches_jax(horizon, B, seed):
    jp, tp = _problems(horizon)
    j_th, j_U0 = jm.adversarial_saddle_bank(jp, B, seed=seed)
    t_th, t_U0 = tm.adversarial_saddle_bank(tp, B, seed=seed)
    assert set(t_th) == set(j_th)
    for k in j_th:
        assert t_th[k].dtype == torch.float32 and t_th[k].device.type == "cpu"
        np.testing.assert_array_equal(t_th[k].numpy(), np.asarray(j_th[k], dtype=np.float32), err_msg=k)
    np.testing.assert_array_equal(t_U0.numpy(), np.asarray(j_U0))


@functools.lru_cache(maxsize=None)
def _jax_vmap_multistart(horizon, B, seed):
    jp, _ = _problems(horizon, FAST)
    th, U0 = jm.adversarial_saddle_bank(jp, B, seed=seed)
    solve = jax.jit(jm.make_bank_multistart_solver(jp.ocp, jp.settings, engine="vmap"))
    return th, solve(th, U0)


@pytest.mark.parametrize("engine", ["cuda", "fast", "vmap"])
def test_bank_multistart_engines_match_jax_vmap(engine):
    """B=16, N=12, K=5 (swing 1.0 and 0.5): the port's three engines
    against the JAX "vmap" engine (test_multistart_bank.py's bank)."""
    th, ref = _jax_vmap_multistart(12, 16, 3)
    _, tp = _problems(12, FAST)
    solve = ts.make_bank_multistart_solver(tp.ocp, tp.settings, engine=engine)
    got = solution_to_numpy(solve(theta_from_numpy(th, "cpu"), torch.zeros(16, 12, 2)))
    assert got.U.shape == (16, 12, 2) and got.n_iters.shape == (16,)
    conv = np.asarray(ref.converged)
    assert conv.sum() >= 4
    np.testing.assert_allclose(got.U[conv], np.asarray(ref.U)[conv], atol=LIVE[0])
    np.testing.assert_allclose(got.cost[conv], np.asarray(ref.cost)[conv], rtol=LIVE[1])
    assert abs(got.converged.mean() - conv.mean()) <= 1.0 / 16
    if engine == "cuda":  # K1 counts each start's own iterations
        assert got.n_iters.max() <= tp.settings.total_iters and got.n_iters.min() >= 1


@pytest.mark.parametrize("engine", ["nope", "pallas"])
def test_bank_multistart_rejects_unknown_engine(engine):
    """Unknown names raise, the JAX package's "pallas" among them: the
    port's kernel engine is "cuda"."""
    _, tp = _problems(8, FAST)
    with pytest.raises(ValueError, match="unknown engine"):
        ts.make_bank_multistart_solver(tp.ocp, tp.settings, engine=engine)


def test_bank_multistart_takes_a_callable_engine():
    """A callable engine(ocp, settings) is the bank solve; the built solve
    carries it."""
    _, tp = _problems(8, FAST)
    built = []

    def engine(ocp, settings):
        built.append(torch.func.vmap(ts.make_solver(ocp, settings)))
        return built[-1]

    solve = ts.make_bank_multistart_solver(tp.ocp, tp.settings, swing_fracs=(1.0,), engine=engine)
    assert solve.engines == tuple(built) and len(built) == 1


def _composite_never_worse(horizon, B, capacity, settings, **kw):
    """The multistart two-pass composite (K1 engine: its plain version
    here) against its own first pass, the plain bank multistart: row-wise
    never worse, converged fraction at least as high, finite."""
    _, tp = _problems(horizon, settings)
    th, U0 = tm.adversarial_saddle_bank(tp, B, seed=0)
    comp = ts.make_multistart_two_pass_solver(tp.ocp, tp.settings, capacity=capacity, swing_fracs=(1.0,), **kw)
    first = ts.make_bank_multistart_solver(tp.ocp, tp.settings, swing_fracs=(1.0,))
    sm = solution_to_numpy(first(th, U0))
    sc = solution_to_numpy(comp(th, U0))
    assert np.all(sc.kkt_residual <= sm.kkt_residual + 1e-6)
    assert sc.converged.mean() >= sm.converged.mean()
    assert np.isfinite(sc.U).all()
    return sm, sc, comp


def test_multistart_two_pass_composite_never_worse():
    """N=12 (FAST first pass, default rescue schedule, 4 polish steps),
    B=16, capacity 4: never worse than the multistart first pass. Its bank
    solves are two K1 wrappers (first pass, rescue pass) and the polish."""
    sm, sc, comp = _composite_never_worse(12, 16, 4, FAST, polish_iters=4)
    k1_first, k1_rescue, polish = comp.engines
    assert (k1_first.kind, k1_rescue.kind) == ("point_stab", "point_stab")
    assert (len(k1_first.cfg.mus), len(k1_rescue.cfg.mus)) == (24, 160)
    assert callable(polish)


@pytest.mark.slow
def test_multistart_two_pass_composite_never_worse_saddle_n40():
    """The saddle bank at N=40 (where the ~1 m goal is reachable and the
    saddle binds), B=16, default schedule, capacity 4, 12 polish steps: the
    composite converges every row the plain multistart does and more.
    Slow: ~70 s on this CPU (the plain K1 runs 160 rescue iterations at
    N=40)."""
    sm, sc, _ = _composite_never_worse(40, 16, 4, None)
    assert sc.converged.mean() >= 0.9

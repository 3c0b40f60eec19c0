"""The port's sampling engines and composites on the device mesh
(``ros2_mpc_tpu_torch.parallel.mesh``) against the JAX package's
(``tests/test_parallel.py``'s mesh cases) on the CPU: eight CPU shards
against eight virtual JAX devices in the live band (U atol 5e-4, cost rtol
1e-3), and against the port's one shard at 1e-5. The sampling engines are
fed the draws the JAX mesh folds from each scenario's global index. The
helpers and the rest of the mesh's cases are in ``test_torch_mesh.py``.
"""

import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.solver import mppi as jm
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.convert import mppi_noise_from_numpy
from ros2_mpc_tpu_torch.solver import mppi as tm
from test_torch_mesh import (
    CPU,
    LIVE,
    SHARD_ATOL,
    SHORT,
    _bank,
    _close,
    _jax_fold_in_draws,
    _jax_step,
    _np,
    _point,
    _port_step,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "engine, opts",
    [
        ("mppi", dict(seed=3, settings=(24, 4))),
        ("hybrid", dict(seed=0, settings=(16, 3))),
        ("multistart", dict(seed=0, settings=(16, 2))),
    ],
)
def test_sampling_engines_match_jax_on_its_draws(monkeypatch, engine, opts):
    """test_sharded_mppi_engine, test_sharded_hybrid_engine_never_worse_than_vmap
    and test_sharded_multistart_engine: the sampling engines on eight shards,
    fed the draws JAX's mesh folds from each scenario's global index, against
    JAX's eight-device step (the live band) and the port's one shard (1e-5);
    the hybrid and the multistart never lose to the plain bank engine; MPPI
    stays in the control box."""
    jp, tp = _point()
    B, N = 16, 6
    jth, tth = _bank(jp, B, seed={"mppi": 9, "hybrid": 4, "multistart": 12}[engine])
    S, iters = opts["settings"]
    j_set, t_set = jm.MppiSettings(n_samples=S, n_iters=iters), tm.MppiSettings(n_samples=S, n_iters=iters)
    sol_j, _ = _jax_step(jp, engine, B, jth, seed=opts["seed"], settings=j_set)
    monkeypatch.setattr(tm, "_white_noise", mppi_noise_from_numpy(_jax_fold_in_draws(opts["seed"], B, j_set, N), device=CPU))
    sol_t, met_t = _port_step(tp, engine, B, tth, seed=opts["seed"], settings=t_set)
    _close(sol_t, sol_j, LIVE)
    one, _ = _port_step(tp, engine, B, tth, n_shards=1, seed=opts["seed"], settings=t_set)
    np.testing.assert_allclose(_np(sol_t.U), _np(one.U), atol=SHARD_ATOL)
    if engine == "mppi":
        lo, hi = np.asarray(tp.ocp.u_lo), np.asarray(tp.ocp.u_hi)
        assert (_np(sol_t.U) >= lo - 1e-6).all() and (_np(sol_t.U) <= hi + 1e-6).all()
    else:
        plain, met_p = _port_step(tp, "cuda", B, tth)
        assert float(met_t["frac_converged"]) >= float(met_p["frac_converged"]) - 1e-6
        both = _np(sol_t.converged) & _np(plain.converged)
        assert (_np(sol_t.cost)[both] <= _np(plain.cost)[both] + 1e-5).all()


def test_composite_engines_on_mesh_match_jax():
    """test_composite_engines_on_mesh: two-pass rescue and bank multistart per
    shard, against JAX's composites on eight devices (live band) and never
    worse than the plain K1 engine on the same shards; the two-pass with a
    capacity covering every row against one shard covering every row."""
    N = 6
    jp, tp = _point(horizon=N)
    B = 8 * 2
    jth, tth = _bank(jp, B, seed=3)
    ref, _ = _port_step(tp, "cuda", B, tth)
    short_j, short_t = js.SolverSettings(**SHORT), ts.SolverSettings(**SHORT)

    tp_j, _ = _jax_step(jp, "two_pass", B, jth, capacity=1, tile_s=1, tile_l=2, rescue_tile_s=1, rescue_settings=short_j)
    tp_t, _ = _port_step(tp, "two_pass", B, tth, capacity=1, rescue_settings=short_t)
    _close(tp_t, tp_j, LIVE)
    assert (_np(tp_t.kkt_residual) <= _np(ref.kkt_residual) + 1e-6).all()
    full, _ = _port_step(tp, "two_pass", B, tth, capacity=2, rescue_settings=short_t)
    one, _ = _port_step(tp, "two_pass", B, tth, n_shards=1, capacity=B, rescue_settings=short_t)
    np.testing.assert_allclose(_np(full.U), _np(one.U), atol=SHARD_ATOL)

    ms_j, _ = _jax_step(jp, "multistart_bank", B, jth, swing_fracs=(1.0,), tile_s=1, tile_l=2)
    ms_t, _ = _port_step(tp, "multistart_bank", B, tth, swing_fracs=(1.0,))
    _close(ms_t, ms_j, LIVE)
    ref_cost = np.where(np.isnan(_np(ref.cost)), np.inf, _np(ref.cost))
    assert (_np(ms_t.cost) <= ref_cost + 1e-4).all()
    one, _ = _port_step(tp, "multistart_bank", B, tth, n_shards=1, swing_fracs=(1.0,))
    np.testing.assert_allclose(_np(ms_t.U), _np(one.U), atol=SHARD_ATOL)


def test_multistart_rescue_engine_on_mesh():
    """The composed multistart + rescue + polish engine per shard (K1 inner
    engine) against JAX's on eight devices (its generic inner engine, as its
    scaling harness runs it), never worse than bank multistart alone, and
    with capacities covering every row equal to one shard."""
    N = 4
    jp, tp = _point(horizon=N, settings=SHORT)
    B = 8
    jth, tth = _bank(jp, B, seed=5)
    sol_j, _ = _jax_step(jp, "multistart_rescue", B, jth, capacity=1, swing_fracs=(1.0,), inner_engine="fast", lanes=1, polish_iters=2)
    sol_t, _ = _port_step(tp, "multistart_rescue", B, tth, capacity=1, swing_fracs=(1.0,), polish_iters=2)
    _close(sol_t, sol_j, LIVE)
    first, _ = _port_step(tp, "multistart_bank", B, tth, swing_fracs=(1.0,))
    assert (_np(sol_t.kkt_residual) <= _np(first.kkt_residual) + 1e-6).all()
    one, _ = _port_step(tp, "multistart_rescue", B, tth, n_shards=1, capacity=B, swing_fracs=(1.0,), polish_iters=2)
    np.testing.assert_allclose(_np(sol_t.U), _np(one.U), atol=SHARD_ATOL)

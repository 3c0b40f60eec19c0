"""The port's device mesh (``ros2_mpc_tpu_torch.parallel.mesh``) against the
JAX package's (``tests/test_parallel.py``'s mesh cases) on the CPU.

The port's mesh here is eight CPU shards (``make_mesh(device="cpu")``), the
counterpart of the JAX suite's eight virtual CPU devices. Each engine's
eight-shard step is held against the JAX package's eight-device step on one
seeded bank, at the North star's bands (inert U atol 1e-4 / cost rtol 1e-4,
the sampling engines and the composites in the live band 5e-4 / 1e-3), and
against the port's own one-shard step at the JAX suite's 1e-5. The
sampling engines are fed the JAX package's own draws (the keys its mesh
folds from the global scenario index), so both packages sample alike.

On the CPU, ``engine="cuda"`` runs K1's and K2's plain versions. PyTorch's
vectorised CPU kernels round a vector's tail elements apart from its body,
so a scenario's result may differ in the last bits between bank sizes here:
bit-equality across shard layouts is asked of the card only
(``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.parallel import mesh as jmesh
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.convert import theta_from_numpy
from ros2_mpc_tpu_torch.parallel import mesh as tmesh
from ros2_mpc_tpu_torch.solver import mppi as tm

J_PARAMS, T_PARAMS = JParams(), TParams()
FAST = dict(barrier_stages=3, iters_per_stage=3, n_alphas=6)
SHORT = dict(barrier_stages=2, iters_per_stage=2, n_alphas=4)
INERT, LIVE = (1e-4, 1e-4), (5e-4, 1e-3)
SHARD_ATOL = 1e-5
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _point(horizon=6, settings=FAST, corrected=False):
    kw = dict(horizon=horizon, reference_parity=not corrected)
    return (
        js.make_point_stabilization(J_PARAMS, settings=js.SolverSettings(**settings), **kw),
        ts.make_point_stabilization(T_PARAMS, settings=ts.SolverSettings(**settings), device=CPU, **kw),
    )


def _bank(jprob, B, seed=0):
    """test_parallel.py's bank: starts within 0.2 m, goals within 1 m."""
    rng = np.random.default_rng(seed)
    jth = jax.vmap(jprob.make_theta)(
        jnp.asarray(rng.uniform(-0.2, 0.2, size=(B, 3))), jnp.asarray(rng.uniform(-1.0, 1.0, size=(B, 3)))
    )
    return jth, theta_from_numpy({k: np.asarray(v) for k, v in jth.items()}, device=CPU)


def _jax_step(jprob, engine, B, jth, **opts):
    mesh = jmesh.make_mesh()
    U0 = jnp.zeros((B,) + jprob.default_u0.shape)
    step = jmesh.make_bank_solver(jprob, mesh, engine=engine, **opts)
    return step(jmesh.shard_bank(jth, mesh), jmesh.shard_bank(U0, mesh))


def _port_step(tprob, engine, B, tth, n_shards=8, **opts):
    mesh = tmesh.make_mesh(n_shards, device=CPU)
    U0 = torch.zeros((B,) + tuple(tprob.default_u0.shape))
    sols, metrics = tmesh.make_bank_solver(tprob, mesh, engine=engine, **opts)(
        tmesh.shard_bank(tth, mesh), tmesh.shard_bank(U0, mesh)
    )
    assert len(sols.shards) == n_shards
    return sols.gather(CPU), metrics


def _close(sol_t, sol_j, band):
    np.testing.assert_allclose(_np(sol_t.U), np.asarray(sol_j.U), atol=band[0])
    np.testing.assert_allclose(_np(sol_t.cost), np.asarray(sol_j.cost), rtol=band[1])


def _jax_fold_in_draws(seed, B, settings, N, m=2):
    """(n_iters, B, N, S, m): the draws of the JAX mesh's sampling engines,
    from ``fold_in(PRNGKey(seed), global index)`` per scenario."""
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jax.random.PRNGKey(seed), jnp.arange(B, dtype=jnp.uint32))
    per = []
    for key in keys:
        ks = jax.random.split(key, settings.n_iters)
        per.append([np.asarray(jax.random.normal(k, (N, settings.n_samples, m))) for k in ks])
    return np.stack(per, axis=1)


def test_mesh_layouts_and_shard_bank():
    """make_mesh's slots, the 2D host/chip mesh, shard_bank's contiguous
    pieces and gather's round trip; a bank that does not divide raises, as
    under JAX's in_shardings."""
    m8, m4 = tmesh.make_mesh(device=CPU), tmesh.make_mesh(4, device=CPU)
    assert (m8.size, m4.size, m8.shape, m8.axis_names) == (8, 4, (8,), ("scenario",))
    assert all(d == torch.device(CPU) for d in m8.devices)
    hc = tmesh.make_host_chip_mesh(2, 4, device=CPU)
    assert (hc.size, hc.shape, hc.axis_names) == (8, (2, 4), ("host", "chip"))
    bank = {"a": torch.arange(16.0).reshape(16, 1), "b": torch.arange(32).reshape(16, 2)}
    sh = tmesh.shard_bank(bank, m8)
    assert [int(s["a"][0, 0]) for s in sh.shards] == list(range(0, 16, 2))
    back = sh.gather(CPU)
    assert all(torch.equal(back[k], bank[k]) for k in bank)
    assert tmesh.shard_bank(sh, m8) is sh
    with pytest.raises(ValueError, match=r"B=12 .* mesh of 8 shards"):
        tmesh.shard_bank({"a": torch.zeros(12, 1)}, m8)
    with pytest.raises(ValueError, match="another mesh"):
        tmesh.shard_bank(sh, m4)


def test_sharded_bank_matches_unsharded_and_jax():
    """test_parallel.py::test_sharded_bank_matches_unsharded: the default
    engine (K1's plain version here) on eight shards against JAX's vmap
    engine on eight devices and against the port's one shard; the metrics
    reduce across shards to the gathered bank's."""
    jp, tp = _point(horizon=8)
    B = 16
    jth, tth = _bank(jp, B)
    sol_j, met_j = _jax_step(jp, "vmap", B, jth)
    sol_t, met_t = _port_step(tp, "cuda", B, tth)
    _close(sol_t, sol_j, INERT)
    one, _ = _port_step(tp, "cuda", B, tth, n_shards=1)
    np.testing.assert_allclose(_np(sol_t.U), _np(one.U), atol=SHARD_ATOL)
    np.testing.assert_allclose(float(met_t["mean_cost"]), float(sol_t.cost.mean()), rtol=1e-6)
    assert float(met_t["max_kkt"]) == float(sol_t.kkt_residual.max())
    assert float(met_t["frac_converged"]) == float(sol_t.converged.float().mean())
    np.testing.assert_allclose(float(met_t["mean_cost"]), float(met_j["mean_cost"]), rtol=1e-4)


@pytest.mark.parametrize(
    "engine, against",
    [
        ("vmap", [("vmap", {}, INERT)]),
        ("fast", [("fast", {"lanes": 2}, INERT)]),
        # JAX's Pallas kernel itself sits 1.03e-4 (U) off its vmap engine on
        # this bank's unconverged row; test_parallel.py holds that pair to
        # 1e-3, and K1 (which mirrors make_solver) to vmap's inert band
        ("cuda", [("vmap", {}, INERT), ("pallas", {"tile_s": 1, "tile_l": 2}, (1e-3, 1e-4))]),
    ],
)
def test_bank_engines_match_jax(engine, against):
    """test_sharded_fast_engine_matches / test_sharded_pallas_engine_matches:
    the plain bank engines per shard against the JAX engines on eight
    devices (its Pallas kernel in interpret mode), and against one shard."""
    jp, tp = _point()
    B = 16
    jth, tth = _bank(jp, B, seed=4)
    sol_t, _ = _port_step(tp, engine, B, tth)
    for jax_engine, jax_opts, band in against:
        sol_j, _ = _jax_step(jp, jax_engine, B, jth, **jax_opts)
        _close(sol_t, sol_j, band)
    one, _ = _port_step(tp, engine, B, tth, n_shards=1)
    np.testing.assert_allclose(_np(sol_t.U), _np(one.U), atol=SHARD_ATOL)


def _tracking_bank(jprob, B, N, seed, terminal=False):
    rng = np.random.default_rng(seed)
    ts_ = np.arange(1, N + 1) * J_PARAMS.dt
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    if terminal:  # test_pallas_engine_solves_terminal_cost_problems's references
        x_ref = np.stack([0.1 * np.tile(ts_, (B, 1)), np.zeros((B, N)), np.full((B, N), 0.5)], axis=2)
        u_ref = np.tile([0.1, 0.0], (B, N, 1))
    else:
        x_ref = np.stack([x0[:, 0:1] + 0.15 * ts_[None], np.zeros((B, N)), np.zeros((B, N))], axis=2)
        u_ref = np.tile([0.15, 0.0], (B, N, 1))
    jth = jax.vmap(jprob.make_theta)(jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_ref))
    return jth, theta_from_numpy({k: np.asarray(v) for k, v in jth.items()}, device=CPU)


@pytest.mark.parametrize("terminal", [False, True])
def test_tracking_engine_matches_jax(terminal):
    """test_sharded_pallas_tracking_engine_matches and
    test_pallas_engine_solves_terminal_cost_problems: engine="cuda" on a
    tracking problem is K2 (its plain version), per shard, against JAX's
    Pallas tracking kernel on eight devices and the port's one shard."""
    N, B = 6, 16
    if terminal:
        jp = js.make_tracking(J_PARAMS, horizon=N, terminal_weight=(10.0, 10.0, 1.0))
        tp = ts.make_tracking(T_PARAMS, horizon=N, terminal_weight=(10.0, 10.0, 1.0), device=CPU)
    else:
        jp = js.make_tracking(J_PARAMS, horizon=N, settings=js.SolverSettings(**FAST), reference_parity=False)
        tp = ts.make_tracking(T_PARAMS, horizon=N, settings=ts.SolverSettings(**FAST), reference_parity=False, device=CPU)
    jth, tth = _tracking_bank(jp, B, N, seed=11 if terminal else 7, terminal=terminal)
    sol_j, _ = _jax_step(jp, "pallas", B, jth, tile_s=1, tile_l=2)
    sol_t, _ = _port_step(tp, "cuda", B, tth)
    _close(sol_t, sol_j, LIVE)
    one, _ = _port_step(tp, "cuda", B, tth, n_shards=1)
    np.testing.assert_allclose(_np(sol_t.U), _np(one.U), atol=SHARD_ATOL)


def test_host_chip_mesh_2d():
    """test_host_chip_mesh_2d: a (2, 4) host/chip mesh solves like the 1D one."""
    jp, tp = _point(horizon=8)
    B = 16
    _, tth = _bank(jp, B, seed=1)
    mesh = tmesh.make_host_chip_mesh(2, 4, device=CPU)
    sols, metrics = tmesh.make_bank_solver(tp, mesh)(tth, torch.zeros(B, 8, 2))
    got = sols.gather(CPU)
    assert tuple(got.U.shape) == (B, 8, 2) and len(sols.shards) == 8
    assert np.isfinite(float(metrics["max_kkt"]))
    flat, _ = _port_step(tp, "cuda", B, tth)
    assert torch.equal(got.U, flat.U)


def test_mppi_draws_identical_for_1_2_and_8_shards():
    """A scenario's draws depend on the seed and its global index only
    (ScenarioStreams): the MPPI engine solves the same bank alike on 1, 2
    and 8 shards, each shard drawing its slice of the whole bank's draws."""
    _, tp = _point()
    B = 16
    jp = js.make_point_stabilization(J_PARAMS, horizon=6, settings=js.SolverSettings(**FAST))
    _, tth = _bank(jp, B, seed=9)
    whole = tm.ScenarioStreams(5, 0).normal(2, (6, B, 24, 2), CPU)
    for first in (0, 2, 8, 14):
        part = tm.ScenarioStreams(5, first).normal(2, (6, 2, 24, 2), CPU)
        assert torch.equal(part, whole[:, first : first + 2])
    assert abs(float(whole.mean())) < 0.1 and abs(float(whole.std()) - 1.0) < 0.1
    settings = tm.MppiSettings(n_samples=24, n_iters=4)
    sols = [_port_step(tp, "mppi", B, tth, n_shards=n, seed=5, settings=settings)[0] for n in (1, 2, 8)]
    for s in sols[1:]:
        np.testing.assert_allclose(_np(s.U), _np(sols[0].U), atol=SHARD_ATOL)
    other = _port_step(tp, "mppi", B, tth, n_shards=2, seed=6, settings=settings)[0]
    assert not torch.equal(other.U, sols[1].U)


def test_bank_solver_rejects_unknown_engine_and_stray_opts():
    """test_bank_solver_rejects_unknown_engine_and_stray_opts, with the same
    phrases, and the port's own refusals: the TPU tile options, K1/K2 on a
    model-generic family, the composites on tracking problems, and a
    capacity above a shard's bank (at the call)."""
    _, tp = _point(horizon=4)
    mesh = tmesh.make_mesh(1, device=CPU)
    with pytest.raises(ValueError, match="unknown engine"):
        tmesh.make_bank_solver(tp, mesh, engine="sqp")
    with pytest.raises(ValueError, match="no engine_opts"):
        tmesh.make_bank_solver(tp, mesh, engine="vmap", lanes=8)
    with pytest.raises(ValueError, match="seed=/settings="):
        tmesh.make_bank_solver(tp, mesh, engine="mppi", lanes=8)
    for engine, opt in (("cuda", "tile_s"), ("two_pass", "rescue_tile_s"), ("fast", "lanes"), ("multistart_bank", "interpret")):
        with pytest.raises(ValueError, match="TPU kernels' tile and lane options"):
            tmesh.make_bank_solver(tp, mesh, engine=engine, **{opt: 1})
    bicycle = ts.make_bicycle_point_stabilization(T_PARAMS, horizon=4, device=CPU)
    with pytest.raises(ValueError, match="hard-codes the reference unicycle structure"):
        tmesh.make_bank_solver(bicycle, mesh, engine="cuda")
    trk = ts.make_tracking(T_PARAMS, horizon=4, device=CPU)
    for engine in ("two_pass", "multistart_bank", "multistart_rescue"):
        with pytest.raises(ValueError, match="composes the point-stabilization bank kernels"):
            tmesh.make_bank_solver(trk, mesh, engine=engine)
    step = tmesh.make_bank_solver(tp, tmesh.make_mesh(4, device=CPU), engine="two_pass", capacity=3)
    jp = js.make_point_stabilization(J_PARAMS, horizon=4)
    _, tth = _bank(jp, 8)
    with pytest.raises(ValueError, match="capacity 3 exceeds the bank of 2"):
        step(tth, torch.zeros(8, 4, 2))


def test_mesh_runs_on_the_card_by_default(monkeypatch):
    """make_mesh() and make_host_chip_mesh() name the cards and raise without
    one; the CPU only where the caller names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_host_chip_mesh(1, 1)
    assert tmesh.make_mesh(2, device=CPU).size == 2


def test_parallel_exports_the_jax_package_names():
    """ros2_mpc_tpu_torch.parallel exports every name ros2_mpc_tpu.parallel
    does, the distributed module among them."""
    import ros2_mpc_tpu.parallel as jpar
    import ros2_mpc_tpu_torch.parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    assert all(hasattr(tpar, name) for name in tpar.__all__)
    assert tpar.distributed.initialize.__module__ == "ros2_mpc_tpu_torch.parallel.distributed"

"""The port's bank kernels K1 (point stabilization) and K2 (tracking).

On the CPU the wrappers run the kernels' plain PyTorch versions, held here
against the JAX package's Pallas kernels in interpret mode (tile_s=2,
tile_l=8) on the banks of tests/test_pallas.py, at its bands: inert banks
U atol 1e-4 / cost rtol 1e-4, live obstacles and tracking U atol 5e-4 /
cost rtol 1e-3, the chunk-edge bank 2e-4 / 2e-4. The TPU kernel exits per
(8, 128) tile and the port per scenario; the difference stays inside those
bands. The CUDA kernels themselves run only on the card (the `cuda`
marker): there they are held against the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.solver.pallas_kernel import (
    make_pallas_point_stab_solver,
    make_pallas_tracking_solver,
)
from ros2_mpc_tpu_torch import _build
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.convert import solution_to_numpy, theta_from_numpy
from ros2_mpc_tpu_torch.solver import cuda_kernel as ck

PARAMS = JParams()
T_PARAMS = TParams()
N = 10
B = 16
J_FAST = js.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
T_FAST = ts.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
N_OBS = PARAMS.n_obstacle_points


def _point_bank(seed, parity, obstacle_slots=()):
    """(jax thetas, numpy U0) on tests/test_pallas.py's point banks."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = rng.uniform(-1.2, 1.2, size=(B, 3))
    prob = js.make_point_stabilization(PARAMS, horizon=N, settings=J_FAST, reference_parity=parity)
    if obstacle_slots is None:
        thetas = jax.vmap(prob.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    else:
        ox, oy = np.full((B, N_OBS), 100.0), np.full((B, N_OBS), 100.0)
        for slot, (xlo, xhi, ylo, yhi) in obstacle_slots:
            ox[:, slot] = rng.uniform(xlo, xhi, size=B)
            oy[:, slot] = rng.uniform(ylo, yhi, size=B)
        thetas = jax.vmap(prob.make_theta)(*(jnp.asarray(a) for a in (x0, goal, ox, oy)))
    return prob, thetas


POINT_BANKS = {
    # name: (seed, parity, obstacle slots or None, (U atol, cost rtol))
    "inert": (0, True, None, (1e-4, 1e-4)),
    "active_obstacles": (1, False, [(0, (0.3, 0.7, -0.2, 0.2))], (5e-4, 1e-3)),
    # chunk straddle at 7/8 and a live point in the last slot
    "chunk_edges": (
        3,
        False,
        [(7, (0.3, 0.6, -0.2, 0.2)), (8, (-0.6, -0.3, -0.2, 0.2)), (N_OBS - 1, (0.2, 0.5, 0.2, 0.5))],
        (2e-4, 2e-4),
    ),
    # corrected mode on open floor: nonzero weight, only sentinels
    "all_sentinels": (3, False, [], (2e-4, 2e-4)),
}


def _assert_band(got, ref, band, X=False):
    got = solution_to_numpy(got)
    np.testing.assert_allclose(got.U, np.asarray(ref.U), atol=band[0])
    np.testing.assert_allclose(got.cost, np.asarray(ref.cost), rtol=band[1])
    if X:
        np.testing.assert_allclose(got.X, np.asarray(ref.X), atol=band[0])
    return got


@pytest.mark.parametrize("bank", sorted(POINT_BANKS))
def test_point_stab_plain_matches_pallas(bank):
    seed, parity, slots, band = POINT_BANKS[bank]
    jprob, thetas = _point_bank(seed, parity, slots)
    ref = make_pallas_point_stab_solver(jprob.ocp, J_FAST, interpret=True, tile_s=2, tile_l=8)(
        thetas, jnp.zeros((B, N, 2))
    )
    tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, reference_parity=parity, device="cpu")
    solver = ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST)
    got = _assert_band(solver(theta_from_numpy(thetas, "cpu"), torch.zeros(B, N, 2)), ref, band, X=bank == "inert")
    assert got.n_iters.dtype == np.int32 and got.U.shape == (B, N, 2)
    assert solver.launches == 0  # CPU tensors take the plain version


def _tracking_bank(seed, yaw_ref, terminal_weight):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    t = np.arange(1, N + 1) * PARAMS.dt
    x_ref = np.stack([x0[:, 0:1] + 0.15 * t[None], np.zeros((B, N)), np.full((B, N), yaw_ref)], axis=2)
    u_ref = np.tile([0.15, 0.0], (B, N, 1))
    ox, oy = np.full((B, N_OBS), 100.0), np.full((B, N_OBS), 100.0)
    ox[:, 0] = rng.uniform(0.3, 0.6, size=B)
    oy[:, 0] = rng.uniform(-0.15, 0.15, size=B)
    kw = dict(horizon=N, reference_parity=False, terminal_weight=terminal_weight)
    jprob = js.make_tracking(PARAMS, settings=J_FAST, **kw)
    tprob = ts.make_tracking(T_PARAMS, settings=T_FAST, device="cpu", **kw)
    thetas = jax.vmap(jprob.make_theta)(*(jnp.asarray(a) for a in (x0, x_ref, u_ref, ox, oy)))
    return jprob, tprob, thetas


@pytest.mark.parametrize(
    "seed,yaw_ref,terminal_weight",
    [(5, 0.0, (0.0, 0.0, 0.0)), (7, 0.9, (2.0, 2.0, 1.0))],
    ids=["live_obstacle", "terminal_weight"],
)
def test_tracking_plain_matches_pallas(seed, yaw_ref, terminal_weight):
    jprob, tprob, thetas = _tracking_bank(seed, yaw_ref, terminal_weight)
    ref = make_pallas_tracking_solver(jprob.ocp, J_FAST, interpret=True, tile_s=2, tile_l=8)(
        thetas, jnp.zeros((B, N, 2))
    )
    solver = ck.make_cuda_tracking_solver(tprob.ocp, T_FAST)
    assert solver.cfg.wrap_yaw  # read from OCP.meta in corrected mode
    _assert_band(solver(theta_from_numpy(thetas, "cpu"), torch.zeros(B, N, 2)), ref, (5e-4, 1e-3))
    # a theta without terminal_weight solves the zero-weight problem
    th = theta_from_numpy(thetas, "cpu")
    th0 = {k: v for k, v in th.items() if k != "terminal_weight"}
    zero = dict(th, terminal_weight=torch.zeros(B, 3))
    np.testing.assert_array_equal(solver(th0, torch.zeros(B, N, 2)).U.numpy(), solver(zero, torch.zeros(B, N, 2)).U.numpy())


def test_fast_sincos_accuracy():
    x = torch.linspace(-60.0, 60.0, 400001, dtype=torch.float32)
    c, s = ck.fast_sincos(x)
    x64 = x.numpy().astype(np.float64)
    assert float(np.max(np.abs(c.numpy() - np.cos(x64)))) < 5e-6
    assert float(np.max(np.abs(s.numpy() - np.sin(x64)))) < 5e-6


def test_fast_and_stock_sincos_agree_in_the_solver():
    _, thetas = _point_bank(9, True, None)
    tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, device="cpu")
    th, U0 = theta_from_numpy(thetas, "cpu"), torch.zeros(B, N, 2)
    fast = ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST, fast_sincos=True)(th, U0)
    stock = ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST, fast_sincos=False)(th, U0)
    np.testing.assert_allclose(fast.U.numpy(), stock.U.numpy(), atol=5e-4)
    np.testing.assert_allclose(fast.cost.numpy(), stock.cost.numpy(), rtol=1e-3)


def test_counters_count_executed_work():
    _, thetas = _point_bank(1, False, [(0, (0.3, 0.7, -0.2, 0.2))])
    tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, reference_parity=False, device="cpu")
    solver = ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST, with_counters=True)
    sol, counters = solver(theta_from_numpy(thetas, "cpu"), torch.zeros(B, N, 2))
    iters, ls = counters["iters"], counters["ls_rollouts"]
    assert iters.dtype == torch.int32 and iters.shape == (B,)
    assert bool(((iters > 0) & (iters <= T_FAST.total_iters)).all())
    torch.testing.assert_close(sol.n_iters, iters)
    # every executed iteration tries at least one and at most n_alphas steps
    assert bool(((ls >= iters) & (ls <= iters * T_FAST.n_alphas)).all())


def test_stage_exit_is_per_scenario():
    """A loose stage tolerance lets converged scenarios leave their stages
    early while others keep iterating: n_iters differs across the bank."""
    _, thetas = _point_bank(0, True, None)
    tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, device="cpu")
    sol = ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST, stage_tol=1e-3)(
        theta_from_numpy(thetas, "cpu"), torch.zeros(B, N, 2)
    )
    assert int(sol.n_iters.min()) < int(sol.n_iters.max()) <= T_FAST.total_iters


def test_single_scenario_matches_bank_row():
    _, thetas = _point_bank(1, False, [(0, (0.3, 0.7, -0.2, 0.2))])
    tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, reference_parity=False, device="cpu")
    solver = ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST)
    th = theta_from_numpy(thetas, "cpu")
    bank = solver(th, torch.zeros(B, N, 2))
    one = ck.single_scenario(solver)({k: v[3] for k, v in th.items()}, torch.zeros(N, 2))
    assert one.U.shape == (N, 2) and one.cost.shape == ()
    torch.testing.assert_close(one.U, bank.U[3])


def test_wrapper_rejects_bad_inputs_and_devices():
    tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, device="cpu")
    solver = ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST)
    th = torch.func.vmap(tprob.make_theta)(torch.zeros(2, 3), torch.ones(2, 3))
    with pytest.raises(ValueError):
        solver(th, torch.zeros(2, N + 1, 2))  # wrong horizon
    meta = {k: v.to("meta") for k, v in th.items()}
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        solver(meta, torch.zeros(2, N, 2, device="meta"))
    assert solver.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    with open(tmp_path / "tracking.cu", "a") as fh:
        fh.write("\n// edited\n")
    assert _build.library_path() != before
    assert before.parent == _build.BUILD_DIR


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card (python3 chip_smoke.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    """K1 and K2 launched on the card against their plain versions on the
    same CUDA tensors: built with -fmad=false, they agree bit for bit."""
    _, thetas = _point_bank(1, False, [(0, (0.3, 0.7, -0.2, 0.2))])
    tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, reference_parity=False, device="cpu")
    k1 = ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST)
    th, U0 = theta_from_numpy(thetas, cuda_device), torch.zeros(B, N, 2, device=cuda_device)
    torch.testing.assert_close(k1(th, U0).U, k1.plain(th, U0).U, atol=0.0, rtol=0.0)
    _, tprob2, thetas2 = _tracking_bank(7, 0.9, (2.0, 2.0, 1.0))
    k2 = ck.make_cuda_tracking_solver(tprob2.ocp, T_FAST)
    th2 = theta_from_numpy(thetas2, cuda_device)
    torch.testing.assert_close(k2(th2, U0).U, k2.plain(th2, U0).U, atol=0.0, rtol=0.0)
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches) == (1, 1)

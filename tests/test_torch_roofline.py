"""The port's roofline path against ros2_mpc_tpu.utils.roofline, on the CPU.

Tolerances: the ledgers, phases, bank sums, bytes, loop trips, phase model
seconds and reports are the same float64 NumPy arithmetic in both packages:
rtol 1e-12. ``computed_obstacle_points`` counts integers: exact. K3's plain
version, ``chain``, against the TPU kernel's maps iterated in jnp
(roofline.py:319-326) on the same float32 inputs: rel 1e-6 for fma, exp and
log (their chains agree to the last bit here), 1e-5 for sincos (two
transcendentals a step). The CUDA kernel K3 itself runs only on the card
(the ``cuda`` marker): there it is held against ``chain`` bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu.utils import roofline as jrl
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.convert import theta_from_numpy
from ros2_mpc_tpu_torch.solver import (
    make_legacy_point_stabilization,
    make_point_stabilization,
    make_tracking,
)
from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_point_stab_solver
from ros2_mpc_tpu_torch.utils import roofline as rl

N = 20
RTOL = 1e-12
PEAKS = {"fma_flops_per_s": 5.9e13, "exp_per_s": 3.1e12, "log_per_s": 2.7e12, "sincos_per_s": 1.9e12}


def _counters(kind):
    """(P, iters, ls_rollouts): scalars, or (B,) arrays from a seed."""
    if kind == "scalar":
        return 8.0, 60.0, 180.0
    rng = np.random.default_rng(11)
    B = 64
    return rng.integers(0, 17, B).astype(float), rng.integers(5, 61, B).astype(float), rng.integers(10, 301, B).astype(float)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(ref, dtype=float), rtol=RTOL, atol=0)


def _same_count(got, ref):
    for f in ("arith", "exp", "log", "sincos"):
        _close(getattr(got, f), getattr(ref, f))
    _close(got.total_flops, ref.total_flops)


@pytest.mark.parametrize("kind", ["scalar", "array"])
@pytest.mark.parametrize("fast", [False, True], ids=["stock_sincos", "fast_sincos"])
def test_solve_ledgers_match_jax(fast, kind):
    P, I, R = _counters(kind)
    _same_count(rl.point_stab_solve_flops(N, P, I, R, fast_sincos=fast), jrl.point_stab_solve_flops(N, P, I, R, fast_sincos=fast))
    for tq in (False, True):
        _same_count(
            rl.tracking_solve_flops(N, P, I, R, terminal_quad=tq, fast_sincos=fast),
            jrl.tracking_solve_flops(N, P, I, R, terminal_quad=tq, fast_sincos=fast),
        )
    # FlopCount's own arithmetic
    a, b = rl.FlopCount(1.0, 2.0, 3.0, 4.0), rl.FlopCount(0.5, 0.25, 0.125, 2.0)
    ja, jb = jrl.FlopCount(1.0, 2.0, 3.0, 4.0), jrl.FlopCount(0.5, 0.25, 0.125, 2.0)
    _same_count((a + b).scale(3.0), (ja + jb).scale(3.0))


@pytest.mark.parametrize("kind", ["scalar", "array"])
@pytest.mark.parametrize("fast", [False, True], ids=["stock_sincos", "fast_sincos"])
def test_phases_and_model_seconds_match_jax(fast, kind):
    P, I, R = _counters(kind)
    got = rl.point_stab_phase_flops(N, P, I, R, fast_sincos=fast)
    ref = jrl.point_stab_phase_flops(N, P, I, R, fast_sincos=fast)
    assert list(got) == list(ref) == ["rollout", "backward", "line_search", "final"]
    for k in ref:
        _same_count(got[k], ref[k])
    secs, jsecs = rl.phase_model_seconds(got, PEAKS), jrl.phase_model_seconds(ref, PEAKS)
    for k in jsecs:
        _close(secs[k], jsecs[k])
    # the phases sum to the whole-solve ledger
    agg = got["rollout"] + got["backward"] + got["line_search"] + got["final"]
    _same_count(agg, rl.point_stab_solve_flops(N, P, I, R, fast_sincos=fast))


@pytest.mark.parametrize("kind", ["scalar", "array"])
@pytest.mark.parametrize("fast", [False, True], ids=["stock_sincos", "fast_sincos"])
def test_bank_sums_bytes_trips_and_report_match_jax(fast, kind):
    P, I, R = _counters(kind)
    P, I, R = (np.broadcast_to(v, np.shape(I) or (1,)) for v in (P, I, R))
    for fn, jfn in ((rl.point_stab_solve_flops, jrl.point_stab_solve_flops), (rl.tracking_solve_flops, jrl.tracking_solve_flops)):
        _same_count(rl.bank_flops(fn, N, P, I, R, fast_sincos=fast), jrl.bank_flops(jfn, N, P, I, R, fast_sincos=fast))
    got, ref = rl.bank_phase_flops(N, P, I, R, fast_sincos=fast), jrl.bank_phase_flops(N, P, I, R, fast_sincos=fast)
    for k in ref:
        _same_count(got[k], ref[k])
    for n_obs in (1, 160):
        _close(rl.point_stab_hbm_bytes(N, n_obs), jrl.point_stab_hbm_bytes(N, n_obs))
    for chunks in (0.0, 3.0):
        _close(rl.solver_loop_trips(N, I, R, chunks), jrl.solver_loop_trips(N, I, R, chunks))
    # per-scenario obstacle chunks: the JAX function's scalar result for each
    per = np.array([jrl.solver_loop_trips(N, i, r, p) for i, r, p in zip(I, R, P)])
    _close(rl.solver_loop_trips(N, I, R, P), per)
    count = rl.bank_flops(rl.point_stab_solve_flops, N, P, I, R, fast_sincos=fast)
    jcount = jrl.bank_flops(jrl.point_stab_solve_flops, N, P, I, R, fast_sincos=fast)
    hbm = len(I) * rl.point_stab_hbm_bytes(N, 160)
    for nbytes in (0.0, hbm):
        rep, jrep = rl.roofline_report(count, 5.2e-3, PEAKS, nbytes), jrl.roofline_report(jcount, 5.2e-3, PEAKS, nbytes)
        assert set(rep) == set(jrep)
        for k in jrep:
            _close(rep[k], jrep[k])


@pytest.mark.parametrize("tile", [(8, 128), (2, 4), (1, 1), (1, 32)], ids=lambda t: f"{t[0]}x{t[1]}")
def test_computed_obstacle_points_match_jax(tile):
    B, n_obs = 256, 160
    rng = np.random.default_rng(7)
    ox, oy = np.full((B, n_obs), 100.0), np.full((B, n_obs), 100.0)
    for b in range(B):
        k = rng.integers(0, 6)
        slots = rng.choice(n_obs, size=k, replace=False)
        ox[b, slots] = rng.uniform(-2, 2, size=k)
        oy[b, slots] = rng.uniform(-2, 2, size=k)
    weight = (rng.uniform(size=B) < 0.7).astype(float)
    for chunk in (8, 1):
        got = rl.computed_obstacle_points(ox, oy, weight, tile_s=tile[0], tile_l=tile[1], chunk=chunk)
        ref = jrl.computed_obstacle_points(ox, oy, weight, tile_s=tile[0], tile_l=tile[1], chunk=chunk)
        np.testing.assert_array_equal(got, ref)
    if tile == (1, 1):  # the port's kernels: each scenario's exact live prefix
        live = (np.abs(ox) < 90) | (np.abs(oy) < 90)
        prefix = np.where(live.any(1), n_obs - np.argmax(live[:, ::-1], axis=1), 0)
        np.testing.assert_array_equal(got, np.where(weight > 0, prefix, 0))


JNP_MAPS = {  # ros2_mpc_tpu/utils/roofline.py:319-326
    "fma": lambda x: x * 1.0000001 + 1e-9,
    "exp": lambda x: jnp.exp(-x),
    "log": lambda x: jnp.log(x) + 2.0,
    "sincos": lambda x: jnp.cos(x) + 0.5 * jnp.sin(x),
}
CHAIN_RTOL = {"fma": 1e-6, "exp": 1e-6, "log": 1e-6, "sincos": 1e-5}


@pytest.mark.parametrize("op", sorted(JNP_MAPS))
def test_chain_matches_jnp_maps(op):
    x = np.random.default_rng(5).uniform(0.5, 0.6, size=(8, 128)).astype(np.float32)
    n_steps, unroll = 4, 16
    ref = jnp.asarray(x)
    for _ in range(n_steps * unroll):
        ref = JNP_MAPS[op](ref)
    ref = np.asarray(ref)
    got = rl.chain(torch.from_numpy(x), op, n_steps, unroll)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=CHAIN_RTOL[op], atol=0)
    # the same number of steps as one trip each
    torch.testing.assert_close(rl.chain(torch.from_numpy(x), op, n_steps * unroll, 1), got, atol=0, rtol=0)
    # the wrapper takes the plain version on a CPU tensor, and launches nothing
    k3 = rl.ChainKernel()
    torch.testing.assert_close(k3(torch.from_numpy(x), op, n_steps, unroll), got, atol=0, rtol=0)
    assert k3.launches == 0


def test_ulp_distance():
    a = torch.tensor([1.0, 1.0, -2.0, 0.0, -0.0, 1e-45, -1e-45, 3.0])
    b = torch.tensor([1.0, np.nextafter(np.float32(1), np.float32(2)), -2.0, -0.0, 1e-45, -1e-45, 1e-45, 3.0000002])
    assert rl.ulp_distance(a, b).tolist() == [0, 1, 0, 0, 1, 2, 2, 1]
    x = torch.from_numpy(np.random.default_rng(3).uniform(-5, 5, 64).astype(np.float32))
    up = torch.from_numpy(np.nextafter(x.numpy(), np.float32(np.inf)))
    assert torch.equal(rl.ulp_distance(x, up), torch.ones(64, dtype=torch.int64))


def test_chain_kernel_rejects_other_devices_and_bad_ops():
    k3 = rl.ChainKernel()
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        k3(torch.zeros(4, 4, device="meta"), "fma", 1, 16)
    with pytest.raises(ValueError):
        rl.chain(torch.zeros(4), "tanh", 1, 1)
    assert k3.launches == 0


def test_measure_vpu_peaks_cpu_smoke():
    before = rl.chain_kernel.launches
    peaks = rl.measure_vpu_peaks(rows=8, cols=128, device="cpu")
    assert list(peaks) == ["fma_flops_per_s", "exp_per_s", "log_per_s", "sincos_per_s"]
    for k in peaks:
        assert peaks[k] > 0
    assert rl.chain_kernel.launches == before  # the plain version launches nothing

    count = rl.point_stab_solve_flops(20, 8.0, 60, 180)
    rep = rl.roofline_report(count, 1e-6, peaks, hbm_bytes=rl.point_stab_hbm_bytes(20, 160))
    assert rep["achieved_gflops"] > 0
    assert 0 < rep["transcendental_frac"] < 1
    assert rep["arithmetic_intensity_flops_per_byte"] > 10  # compute-bound


def test_measure_loop_overhead_cpu_smoke():
    assert rl.measure_loop_overhead(rows=8, cols=128, device="cpu") >= 0.0


def test_kernel_counters_cpu():
    """test_roofline.py's counter invariants on the port's K1 wrapper."""
    params = Params()
    Nk, B = 8, 8
    prob = make_point_stabilization(params, horizon=Nk, device="cpu")
    solve = make_cuda_point_stab_solver(prob.ocp, prob.settings, with_counters=True)
    rng = np.random.default_rng(0)
    th = torch.func.vmap(prob.make_theta)(
        torch.tensor(rng.uniform(-0.3, 0.3, (B, 3))), torch.tensor(rng.uniform(-1.0, 1.0, (B, 3)))
    )
    sol, cnt = solve(th, torch.zeros(B, Nk, 2))
    iters, ls = cnt["iters"].numpy(), cnt["ls_rollouts"].numpy()
    assert iters.shape == (B,) and ls.shape == (B,)
    assert np.all(iters >= 1) and np.all(iters <= prob.settings.total_iters)
    # every executed iteration tries at least one line-search candidate
    assert np.all(ls >= iters)
    assert np.all(ls <= iters * prob.settings.n_alphas)
    np.testing.assert_array_equal(sol.n_iters.numpy(), iters)
    assert solve.launches == 0


BUILDERS = {
    "point_stabilization": lambda **kw: make_point_stabilization(Params(), horizon=5, **kw).default_u0,
    "tracking": lambda **kw: make_tracking(Params(), horizon=5, **kw).default_u0,
    "legacy": lambda **kw: make_legacy_point_stabilization(Params(), horizon=5, **kw).default_u0,
    "theta_from_numpy": lambda **kw: theta_from_numpy({"x0": np.zeros(3)}, **kw)["x0"],
}


@pytest.mark.parametrize("entry", sorted(BUILDERS))
def test_entry_points_default_to_the_card(entry):
    """Without ``device`` an entry point runs on the card: on a host with no
    CUDA device it raises, never falling back to the CPU."""
    build = BUILDERS[entry]
    assert build(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 runs only on the card (python3 chip_smoke.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_chain_kernel_matches_chain_on_card(cuda_device):
    """K3 launched on the card against ``chain`` on the same CUDA tensor, at
    the roofline path's two block sizes: bit-equal."""
    k3 = rl.ChainKernel()
    x = torch.full((32, 128), 0.2, device=cuda_device) + 0.02 * torch.arange(32, device=cuda_device)[:, None]
    for block in (rl.CHAIN_BLOCK, 64):
        for op in CHAIN_RTOL:
            for unroll in rl.CHAIN_UNROLLS:
                got = k3(x, op, 64 // unroll, unroll, block)
                assert int(rl.ulp_distance(got, rl.chain(x, op, 64 // unroll, unroll)).max()) == 0
    torch.cuda.synchronize()
    assert k3.launches == 2 * 2 * len(CHAIN_RTOL)

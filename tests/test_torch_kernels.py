"""The port's bank kernels K1 (point stabilization) and K2 (tracking).

On the CPU the wrappers run the kernels' plain PyTorch versions, held here
against the JAX package's Pallas kernels in interpret mode (tile_s=2,
tile_l=8) on the banks of tests/test_pallas.py, at its bands: inert banks
U atol 1e-4 / cost rtol 1e-4, live obstacles and tracking U atol 5e-4 /
cost rtol 1e-3, the chunk-edge bank 2e-4 / 2e-4. The TPU kernel exits per
(8, 128) tile and the port per scenario; the difference stays inside those
bands. The CUDA kernels themselves run only on the card (the `cuda`
marker): there they are held against the plain versions.

K1 and K2 run one scenario on a group of lanes with a speculative line
search (csrc/group_solve.cuh). Their launch geometry is plain Python,
tested here, and so is the equivalence their bit-equality rests on: a
transcription of the group schedule on the plain version's model classes
reproduces ``_bank_plain`` bit for bit.
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


def test_spill_stores_are_read_per_kernel(monkeypatch, tmp_path):
    lib = tmp_path / "libmpc_kernels_0.so"
    lib.with_suffix(".log").write_text(
        "ptxas info    : Function properties for _ZN3mpc15tracking_kernelEPKfS1_S1_S1_S1_iNS_9SolveArgsEi\n"
        "    128 bytes stack frame, 200 bytes spill stores, 256 bytes spill loads\n"
        "ptxas info    : Function properties for _ZN3mpc17point_stab_kernelEPKfS1_S1_iNS_9SolveArgsEii\n"
        "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    )
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    assert _build.spill_stores("tracking_kernel") == 200
    assert _build.spill_stores("point_stab_kernel") == 0
    with pytest.raises(RuntimeError, match="no ptxas report"):
        _build.spill_stores("chain_kernel")


# kind: (source, prefix of its geometry macros)
GROUP_KERNELS = {"point_stab": ("point_stab.cu", "MPC_K1"), "tracking": ("tracking.cu", "MPC_K2")}


@pytest.mark.parametrize("kind", sorted(GROUP_KERNELS))
def test_group_constants_mirror_the_kernel_source(kind):
    """The wrapper's pre-build check uses the kernel's own constants."""
    source, macro = GROUP_KERNELS[kind]
    group, spb, per_stage = ck.GROUP_GEOMETRY[kind]
    src = (_build.CSRC / source).read_text()
    assert f"#define {macro}_GROUP {group}\n" in src
    assert f"#define {macro}_SCENARIOS_PER_BLOCK {spb}\n" in src
    if kind == "tracking":  # the reference windows, 5 floats a stage
        assert f"kWindowFloats = {per_stage};" in src
        assert "geometry<mpc::kGroup, mpc::kScenariosPerBlock, mpc::kWindowFloats>(" in src
        assert "bank_solve_group<TrackingModel, kGroup>(m, a, b, s + kWindowFloats * a.N)" in src
    else:
        assert per_stage == 0 and "geometry<mpc::kGroup, mpc::kScenariosPerBlock>(" in src
        assert "bank_solve_group<PointStabModel, kGroup>" in src
    shared = (_build.CSRC / "group_solve.cuh").read_text()
    assert f"kMaxSmemBytes = {ck.SMEM_PER_BLOCK};" in shared
    assert "return (extra + 3 * (N + 1) + 11 * N + (recs > cands ? recs : cands)) | 1;" in shared
    assert "g.scratch = group_scratch_floats(N, n_alphas, G, PerStage * N);" in shared
    assert "recs = 17 * N, cands = 5 * N * slots;" in shared


@pytest.mark.parametrize("kind", sorted(GROUP_KERNELS))
@pytest.mark.parametrize(
    "B,N,n_alphas", [(1, 20, 10), (4096, 20, 10), (1, 30, 6), (4096, 30, 6), (13, 20, 10)],
    ids=["B1", "headline", "tick", "bank_N30", "ragged"],
)
def test_group_geometry_covers_bank_and_tick(kind, B, N, n_alphas):
    geo = ck.group_geometry(kind, B, N, n_alphas)
    spb, G = geo["scenarios_per_block"], geo["group"]
    group, most, per_stage = ck.GROUP_GEOMETRY[kind]
    assert (G, spb) == (group, min(most, B))
    assert geo["threads"] == spb * G <= 256  # the kernels' __launch_bounds__
    assert (geo["blocks"] - 1) * spb < B <= geo["blocks"] * spb  # every scenario, no empty block
    per = ck.group_scratch_floats(N, n_alphas, G, per_stage * N)
    assert per % 2 == 1  # odd stride: a warp's groups read different banks
    # the kernel's own floats, X, U, kff, kfb, stage terms, and the
    # candidates' slots or the records
    assert per >= per_stage * N + 3 * (N + 1) + 11 * N + max(17 * N, 5 * N * min(G, n_alphas))
    assert geo["smem_bytes"] == 4 * spb * per <= ck.SMEM_PER_BLOCK


@pytest.mark.parametrize("kind", sorted(GROUP_KERNELS))
def test_group_geometry_fits_scenarios_to_the_shared_memory_budget(kind):
    group, most, per_stage = ck.GROUP_GEOMETRY[kind]
    per = 4 * ck.group_scratch_floats(600, 10, group, per_stage * 600)
    geo = ck.group_geometry(kind, 4096, 600, 10)
    assert geo["scenarios_per_block"] == ck.SMEM_PER_BLOCK // per < most
    with pytest.raises(ValueError, match="shared memory"):
        ck.group_geometry(kind, 1, 2000, 10)


def _big_bank(kind):
    """A bank solver at N=2000, beyond the shared-memory budget, and its
    inputs for B=2."""
    if kind == "point_stab":
        tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, device="cpu")
        th = torch.func.vmap(tprob.make_theta)(torch.zeros(2, 3), torch.ones(2, 3))
        small = ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST)
    else:
        tprob = ts.make_tracking(T_PARAMS, horizon=N, settings=T_FAST, reference_parity=False, device="cpu")
        th = torch.func.vmap(tprob.make_theta)(torch.zeros(2, 3), torch.zeros(2, N, 3), torch.zeros(2, N, 2))
        th = dict(th, x_ref=torch.zeros(2, 2000, 3), u_ref=torch.zeros(2, 2000, 2))
        small = ck.make_cuda_tracking_solver(tprob.ocp, T_FAST)
    return ck.CudaBankSolver(kind, small.cfg._replace(N=2000), False), th


@pytest.mark.parametrize("kind", sorted(GROUP_KERNELS))
def test_group_wrapper_raises_beyond_shared_memory_before_any_build(monkeypatch, kind):
    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_build, "load_library", no_build)
    big, th = _big_bank(kind)
    with pytest.raises(ValueError, match="more than the 232448"):
        big._launch(big._pack(th, torch.zeros(2, 2000, 2)))
    with pytest.raises(ValueError, match="shared memory"):
        big.kernel_info(2)
    assert big.launches == 0


def _group_schedule(cfg, m, u0):
    """csrc/group_solve.cuh bank_solve_group on (B,) planes: the iterate is
    rolled out once, the barrier cost is summed from per-stage terms in k
    order, every line-search candidate is evaluated from the same U, X,
    kff and kfb and the lowest passing index wins (its states become the
    next iterate's X), and ls_rollouts counts the winner's index + 1, or
    n_alphas if none passes."""
    N, dt, A = cfg.N, cfg.dt, cfg.n_alphas
    f32 = np.float32
    lo, hi, eps, d = f32([cfg.lo_v, cfg.lo_w]), f32([cfg.hi_v, cfg.hi_w]), f32([cfg.eps_v, cfg.eps_w]), f32(1e-3)
    (il_v, il_w), (ih_v, ih_w) = (lo + eps).tolist(), (hi - eps).tolist()
    (sl_v, sl_w), (sh_v, sh_w) = (lo + d * (hi - lo)).tolist(), (hi - d * (hi - lo)).tolist()
    lo_v, hi_v, lo_w, hi_w = cfg.lo_v, cfg.hi_v, cfg.lo_w, cfg.hi_w
    B = u0.shape[-1]
    i32 = torch.int32

    def barrier(v, w):
        return torch.log(v - lo_v) + torch.log(hi_v - v) + torch.log(w - lo_w) + torch.log(hi_w - w)

    def cost(U, X, mu=None):  # per-stage terms, summed in k order
        J = torch.zeros(B)
        for k in range(N):
            c = m.stage_cost(k, *X[k], U[k, 0], U[k, 1])
            J = J + (c if mu is None else c - mu * barrier(U[k, 0], U[k, 1]))
        return J + m.terminal_cost(*X[N])

    U = torch.stack([torch.clamp(u0[:, 0], sl_v, sh_v), torch.clamp(u0[:, 1], sl_w, sh_w)], dim=1)
    px, py, th = m.x0
    X = [torch.stack([px, py, th])]
    for k in range(N):
        px, py, th = m.step(px, py, th, U[k, 0], U[k, 1])
        X.append(torch.stack([px, py, th]))
    X = torch.stack(X)
    reg = torch.full((B,), cfg.reg_init)
    done, iters, lsro = (torch.zeros(B, dtype=i32) for _ in range(3))
    for mu, st, first in zip(cfg.mus, cfg.stages, cfg.firsts):
        active = done <= st
        if not bool(active.any()):
            continue
        iters += active.to(i32)
        J = cost(U, X, mu)
        V = m.terminal_value(*X[N])
        dV1 = dV2 = torch.zeros(B)
        kff, kfb = [None] * N, [None] * N
        for k in reversed(range(N)):
            v, w = U[k, 0], U[k, 1]
            g = m.grad(k, *X[k], v, w)
            sv_lo, sv_hi, sw_lo, sw_hi = v - lo_v, hi_v - v, w - lo_w, hi_w - w
            g = g._replace(
                lu0=g.lu0 - mu * (1.0 / sv_lo - 1.0 / sv_hi),
                lu1=g.lu1 - mu * (1.0 / sw_lo - 1.0 / sw_hi),
                luu00=g.luu00 + mu * (1.0 / (sv_lo * sv_lo) + 1.0 / (sv_hi * sv_hi)),
                luu11=g.luu11 + mu * (1.0 / (sw_lo * sw_lo) + 1.0 / (sw_hi * sw_hi)),
            )
            V, kff[k], kfb[k], d1, d2 = ck._riccati_step(V, m.jac(*X[k], v, w), g, reg, dt)
            dV1, dV2 = dV1 + d1, dV2 + d2
        if not first:
            hit = active & (-(dV1 + dV2) - cfg.stage_tol * (1.0 + J.abs()) < 0.0)
            done = torch.where(hit, torch.full_like(done, st + 1), done)

        oks, Us, Xs = [], [], []
        for a in range(A):  # every candidate, speculatively
            alpha = 2.0**-a
            px, py, th = m.x0
            Jc = torch.zeros(B)
            cand, states = [], [X[0]]
            for k in range(N):
                dx0, dx1, dx2 = px - X[k, 0], py - X[k, 1], th - X[k, 2]
                (K00, K01, K02), (K10, K11, K12) = kfb[k]
                v = U[k, 0] + alpha * kff[k][0] + (K00 * dx0 + K01 * dx1 + K02 * dx2)
                w = U[k, 1] + alpha * kff[k][1] + (K10 * dx0 + K11 * dx1 + K12 * dx2)
                v, w = torch.clamp(v, il_v, ih_v), torch.clamp(w, il_w, ih_w)
                Jc = Jc + (m.stage_cost(k, px, py, th, v, w) - mu * barrier(v, w))
                cand.append(torch.stack([v, w]))
                px, py, th = m.step(px, py, th, v, w)
                states.append(torch.stack([px, py, th]))
            Jc = Jc + m.terminal_cost(px, py, th)
            expected = -(alpha * dV1 + alpha * alpha * dV2)
            Jc = torch.where(torch.isnan(Jc), torch.inf, Jc)
            oks.append(Jc <= J - cfg.c1 * torch.clamp(expected, min=0.0))
            Us.append(torch.stack(cand))
            Xs.append(torch.stack(states))
        ok = torch.stack(oks)  # (A, B)
        passed = ok.any(0)
        win = ok.to(i32).argmax(0)  # the lowest passing index
        lsro += torch.where(active, torch.where(passed, win + 1, A), 0).to(i32)
        acc = passed & active
        cols = torch.arange(B)
        U = torch.where(acc, torch.stack(Us)[win, ..., cols].permute(1, 2, 0), U)
        X = torch.where(acc, torch.stack(Xs)[win, ..., cols].permute(1, 2, 0), X)
        grown = torch.clamp(reg * 10.0 + cfg.reg_min, max=cfg.reg_max)
        reg = torch.where(active, torch.where(acc, torch.clamp(reg * 0.5, min=cfg.reg_min), grown), reg)

    Jtrue = cost(U, X)
    l0, l1, l2 = m.terminal_value(*X[N])[:3]
    kkt = torch.zeros(B)
    for k in reversed(range(N)):
        v, w = U[k, 0], U[k, 1]
        a02, a12, bc, bsn, b01, b11 = m.jac(*X[k], v, w)
        g = m.grad(k, *X[k], v, w)
        gu0 = g.lu0 + bc * l0 + bsn * l1
        gu1 = g.lu1 + b01 * l0 + b11 * l1 + dt * l2
        r0 = (v - torch.clamp(v - gu0, lo_v, hi_v)).abs()
        r1 = (w - torch.clamp(w - gu1, lo_w, hi_w)).abs()
        kkt = torch.maximum(kkt, torch.maximum(r0, r1))
        l0, l1, l2 = g.lx0 + l0, g.lx1 + l1, g.lx2 + a02 * l0 + a12 * l1 + l2
    return U, X, Jtrue, kkt, iters, lsro


def _point_line_search_bank(rng, Bn, Nh, parity):
    """(cfg, model, u0) of K1 on a headline-like bank; corrected mode adds
    three live points near each start-goal line."""
    x0 = rng.uniform(-0.3, 0.3, size=(Bn, 3))
    goal = np.concatenate([rng.uniform(-1.5, 1.5, size=(Bn, 2)), rng.uniform(-np.pi, np.pi, size=(Bn, 1))], axis=1)
    settings = ts.SolverSettings()
    prob = ts.make_point_stabilization(T_PARAMS, horizon=Nh, settings=settings, reference_parity=parity, device="cpu")
    args = [torch.tensor(x0, dtype=torch.float32), torch.tensor(goal, dtype=torch.float32)]
    if not parity:  # three live points near each start-goal line
        ox, oy = np.full((Bn, N_OBS), 100.0), np.full((Bn, N_OBS), 100.0)
        mid = (x0[:, :2] + goal[:, :2]) / 2
        for j in range(3):
            ox[:, j], oy[:, j] = (mid + rng.uniform(-0.4, 0.4, size=(Bn, 2))).T
        args += [torch.tensor(ox, dtype=torch.float32), torch.tensor(oy, dtype=torch.float32)]
    solver = ck.make_cuda_point_stab_solver(prob.ocp, settings, with_counters=True)
    x0g, w, obs, u0 = solver._pack(torch.func.vmap(prob.make_theta)(*args), torch.zeros(Bn, Nh, 2))
    return solver.cfg, ck._PointStabModel(solver.cfg, x0g, w, obs), u0


def _tracking_line_search_bank(rng, Bn, Nh, wrap, terminal_weight, yaw0, yaw_ref):
    """(cfg, model, u0) of K2 on straight references at 0.15 m/s with one
    live obstacle near each line, starting at heading ``yaw0`` (an interval)
    against a reference heading ``yaw_ref``."""
    x0 = np.concatenate([rng.uniform(-0.2, 0.2, size=(Bn, 2)), rng.uniform(*yaw0, size=(Bn, 1))], axis=1)
    t = np.arange(1, Nh + 1) * T_PARAMS.dt
    x_ref = np.stack([x0[:, 0:1] + 0.15 * t[None], np.zeros((Bn, Nh)), np.full((Bn, Nh), yaw_ref)], axis=2)
    u_ref = np.tile([0.15, 0.0], (Bn, Nh, 1))
    ox, oy = np.full((Bn, N_OBS), 100.0), np.full((Bn, N_OBS), 100.0)
    ox[:, 0], oy[:, 0] = rng.uniform(0.3, 0.6, size=Bn), rng.uniform(-0.15, 0.15, size=Bn)
    settings = ts.SolverSettings()
    prob = ts.make_tracking(
        T_PARAMS, horizon=Nh, settings=settings, reference_parity=False, terminal_weight=terminal_weight, device="cpu"
    )
    args = [torch.tensor(a, dtype=torch.float32) for a in (x0, x_ref, u_ref, ox, oy)]
    solver = ck.make_cuda_tracking_solver(prob.ocp, settings, with_counters=True, wrap_yaw=wrap)
    assert solver.cfg.wrap_yaw == wrap
    x0p, xref, uref, w, obs, u0 = solver._pack(torch.func.vmap(prob.make_theta)(*args), torch.zeros(Bn, Nh, 2))
    return solver.cfg, ck._TrackingModel(solver.cfg, x0p, xref, uref, w, obs), u0


LINE_SEARCH_BANKS = {
    "parity": lambda rng, Bn, Nh: _point_line_search_bank(rng, Bn, Nh, True),
    "obstacle_active": lambda rng, Bn, Nh: _point_line_search_bank(rng, Bn, Nh, False),
    # headings near +pi against a reference near -pi: the wrap decides the error
    "tracking_wrap": lambda rng, Bn, Nh: _tracking_line_search_bank(rng, Bn, Nh, True, (0.0,) * 3, (2.8, 3.4), -3.0),
    "tracking_no_wrap": lambda rng, Bn, Nh: _tracking_line_search_bank(
        rng, Bn, Nh, False, (0.0,) * 3, (2.8, 3.4), -3.0
    ),
    "tracking_terminal_obstacle": lambda rng, Bn, Nh: _tracking_line_search_bank(
        rng, Bn, Nh, True, (10.0, 10.0, 1.0), (-0.2, 0.2), 0.0
    ),
}


@pytest.mark.parametrize("bank", list(LINE_SEARCH_BANKS))
def test_speculative_line_search_reproduces_first_accept(bank):
    """The equivalence K1's and K2's lane groups rest on, on a B=64, N=20
    bank with the default schedule: the group schedule gives _bank_plain's
    U, X, cost, KKT residual, iters and ls_rollouts bit for bit. The
    tracking banks take the yaw wrap (on and off), the terminal quadratic
    and the adjoint seed through the same schedule."""
    Bn, Nh = 64, 20
    cfg, model, u0 = LINE_SEARCH_BANKS[bank](np.random.default_rng(11), Bn, Nh)
    ref = ck._bank_plain(cfg, model, u0)
    got = _group_schedule(cfg, model, u0)
    for name, a, b in zip(("U", "X", "cost", "kkt", "iters", "ls_rollouts"), got, ref):
        assert torch.equal(a, b), name
    iters, ls = ref[4], ref[5]
    # the bank exercises first accepts beyond alpha = 1
    assert int((ls > iters).sum()) > 0 and int(iters.sum()) > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card (python3 chip_smoke.py)")
    return torch.device("cuda", 0)


def _assert_bit_equal(got, ref):
    (sol, cnt), (rsol, rcnt) = got, ref
    for name in ("U", "X", "cost", "kkt_residual", "n_iters"):
        assert torch.equal(getattr(sol, name), getattr(rsol, name)), name
    for name in ("iters", "ls_rollouts"):
        assert torch.equal(cnt[name], rcnt[name]), name


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    """K1 and K2 launched on the card against their plain versions on the
    same CUDA tensors: built with -fmad=false, they agree bit for bit, on
    every output and on the executed-work counters."""
    _, thetas = _point_bank(1, False, [(0, (0.3, 0.7, -0.2, 0.2))])
    tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, reference_parity=False, device="cpu")
    k1 = ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST, with_counters=True)
    th, U0 = theta_from_numpy(thetas, cuda_device), torch.zeros(B, N, 2, device=cuda_device)
    _assert_bit_equal(k1(th, U0), k1.plain(th, U0))
    one = {k: v[:1] for k, v in th.items()}  # B=1: one group in one block
    _assert_bit_equal(k1(one, U0[:1]), k1.plain(one, U0[:1]))
    _, tprob2, thetas2 = _tracking_bank(7, 0.9, (2.0, 2.0, 1.0))
    k2 = ck.make_cuda_tracking_solver(tprob2.ocp, T_FAST, with_counters=True)
    th2 = theta_from_numpy(thetas2, cuda_device)
    _assert_bit_equal(k2(th2, U0), k2.plain(th2, U0))
    one2 = {k: v[:1] for k, v in th2.items()}
    _assert_bit_equal(k2(one2, U0[:1]), k2.plain(one2, U0[:1]))
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches) == (2, 2)

"""Port parity: two-pass straggler rescue and the compacted polish stage
(solver/rescue.py) of ros2_mpc_tpu_torch against ros2_mpc_tpu, on the CPU.

The bank passes of the port's composites run K1 and K2 through their
wrappers, which take the plain versions on CPU tensors. Inputs are made
with numpy from a seed. Tolerances:

* compaction and merge: bit-equal to the JAX functions on the same inputs;
* the composites against the JAX make_two_pass_solver over
  jax.vmap(make_solver) (the port's K1 and K2 hold to make_solver, not to
  the Pallas kernels, whose early exits are tile-wide): the live band,
  U atol 5e-4 and cost rtol 1e-3, row for row. A row whose first-pass KKT
  residual lies within a factor 2 of kkt_tol in either package may be a
  straggler in one and not the other; such rows are reported and left out
  of the row-wise comparison, at most 2 of 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.solver import rescue as jr
from ros2_mpc_tpu.solver.ilqr import make_solver as j_make_solver
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.convert import solution_to_numpy, theta_from_numpy
from ros2_mpc_tpu_torch.solver import rescue as tr

PARAMS, T_PARAMS = JParams(), TParams()
N = 10
WEAK = dict(barrier_stages=2, iters_per_stage=2, n_alphas=4)
STRONG = dict(barrier_stages=8, iters_per_stage=6, n_alphas=10)
LIVE = (5e-4, 1e-3)
TOL = 1e-4  # kkt_tol of every schedule here
NEAR_TOL_MAX = 2  # rows of 64 allowed near kkt_tol


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- compaction


def _fake_solutions(rng, B, n_fail, nan_rows=()):
    """A seeded first-pass Solution as numpy: ``n_fail`` rows above kkt_tol,
    NaN costs and residuals on ``nan_rows``."""
    kkt = rng.uniform(1e-7, 9e-5, B).astype(np.float32)
    fail = rng.choice(B, n_fail, replace=False)
    kkt[fail] = rng.uniform(2e-4, 1e-1, n_fail)
    cost = rng.uniform(1.0, 50.0, B).astype(np.float32)
    for r in nan_rows:
        kkt[r], cost[r] = np.nan, np.nan
    return dict(
        U=rng.normal(size=(B, N, 2)).astype(np.float32),
        X=rng.normal(size=(B, N + 1, 3)).astype(np.float32),
        cost=cost,
        kkt_residual=kkt,
        converged=kkt < TOL,
        n_iters=np.full(B, 24, np.int32),
        reg=rng.uniform(1e-9, 1e-3, B).astype(np.float32),
    )


def _both(sol):
    return (
        js.Solution(**{k: jnp.asarray(v) for k, v in sol.items()}),
        ts.Solution(**{k: torch.from_numpy(np.array(v)) for k, v in sol.items()}),
    )


def _thetas(rng, B):
    return {
        "x0": rng.normal(size=(B, 3)).astype(np.float32),
        "goal": rng.normal(size=(B, 3)).astype(np.float32),
        "obs_x": rng.normal(size=(B, 5)).astype(np.float32),
        "R": rng.uniform(size=(B, 2)).astype(np.float32),
        "obstacle_weight": rng.uniform(size=B).astype(np.float32),
    }


def _equal(got, ref, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=what)


COMPACTION_CASES = {  # name: (B, failed rows, capacity, NaN rows)
    "within_capacity": (32, 5, 8, ()),
    "overflow": (32, 12, 4, ()),
    "nan_rows": (32, 6, 8, (3, 17)),
    "none_failed": (16, 0, 4, ()),
}


@pytest.mark.parametrize("case", sorted(COMPACTION_CASES))
def test_select_and_merge_rescue_bit_equal_to_jax(case):
    B, n_fail, cap, nan_rows = COMPACTION_CASES[case]
    rng = np.random.default_rng(B + n_fail + cap)
    j_sols, t_sols = _both(_fake_solutions(rng, B, n_fail, nan_rows))
    th = _thetas(rng, B)
    U0 = rng.normal(size=(B, N, 2)).astype(np.float32)
    j_sub, j_seeds, j_idx, j_fail = jr._select_stragglers(j_sols, {k: jnp.asarray(v) for k, v in th.items()}, jnp.asarray(U0), cap)
    t_sub, t_seeds, t_idx, t_fail = tr._select_stragglers(t_sols, {k: torch.from_numpy(v) for k, v in th.items()}, torch.from_numpy(U0), cap)
    _equal(t_idx, j_idx, "idx")
    _equal(t_fail, j_fail, "fail")
    _equal(t_seeds, j_seeds, "seeds")
    for k in th:
        _equal(t_sub[k], j_sub[k], k)
    # a rescue pass's answer: 2 * cap rows, some better and some worse,
    # a NaN among them
    r = _fake_solutions(rng, 2 * cap, 2 * cap // 2, nan_rows=(1,))
    j_r, t_r = _both(r)
    j_out = jr._merge_rescue(j_sols, j_r, j_idx, j_fail, cap, TOL)
    t_out = tr._merge_rescue(t_sols, t_r, t_idx, t_fail, cap, TOL)
    for f in js.Solution._fields:
        _equal(getattr(t_out, f), getattr(j_out, f), f)
    # converged rows keep their first-pass iterates
    conv = np.asarray(j_sols.converged)
    _equal(t_out.U.numpy()[conv], np.asarray(j_sols.U)[conv], "converged rows")


@pytest.mark.parametrize("case", sorted(COMPACTION_CASES))
def test_select_and_merge_polish_bit_equal_to_jax(case):
    B, n_fail, cap, nan_rows = COMPACTION_CASES[case]
    rng = np.random.default_rng(100 + B + n_fail + cap)
    j_sols, t_sols = _both(_fake_solutions(rng, B, n_fail, nan_rows))
    th = _thetas(rng, B)
    j_sub, j_warm, j_idx, j_fail = jr._select_polish(j_sols, {k: jnp.asarray(v) for k, v in th.items()}, cap)
    t_sub, t_warm, t_idx, t_fail = tr._select_polish(t_sols, {k: torch.from_numpy(v) for k, v in th.items()}, cap)
    _equal(t_idx, j_idx, "idx")
    _equal(t_fail, j_fail, "fail")
    _equal(t_warm, j_warm, "warm")
    for k in th:
        _equal(t_sub[k], j_sub[k], k)
    j_p, t_p = _both(_fake_solutions(rng, cap, cap // 2, nan_rows=(0,)))
    j_out = jr._merge_polish(j_sols, j_p, j_idx, j_fail, cap, TOL)
    t_out = tr._merge_polish(t_sols, t_p, t_idx, t_fail, cap, TOL)
    for f in js.Solution._fields:
        _equal(getattr(t_out, f), getattr(j_out, f), f)


@pytest.mark.parametrize("where", ["two_pass", "polish_stage"])
def test_capacity_above_the_bank_raises(where):
    """JAX raises an opaque top_k error at trace time; the port names both
    numbers."""
    rng = np.random.default_rng(0)
    _, t_sols = _both(_fake_solutions(rng, 8, 2))
    solve = lambda th, U: t_sols  # noqa: E731
    make = tr.make_two_pass_solver if where == "two_pass" else tr.make_polish_stage
    comp = make(solve, solve, capacity=9)
    th = {k: torch.from_numpy(v) for k, v in _thetas(rng, 8).items()}
    with pytest.raises(ValueError, match="capacity 9 exceeds the bank of 8"):
        comp(th, torch.zeros(8, N, 2))
    with pytest.raises(ValueError, match="capacity"):
        make(solve, solve, capacity=0)


# ---------------------------------------------------------------- composites


def _obstacle_bank(B, seed):
    """test_rescue.py's obstacle bank: one live obstacle near each
    start-goal midpoint, corrected mode."""
    jp = js.make_point_stabilization(PARAMS, horizon=N, reference_parity=False)
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = np.concatenate([rng.uniform(-1.2, 1.2, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))], axis=1)
    ox, oy = np.full((B, PARAMS.n_obstacle_points), 100.0), np.full((B, PARAMS.n_obstacle_points), 100.0)
    mid = (x0[:, :2] + goal[:, :2]) / 2
    ox[:, 0] = mid[:, 0] + rng.uniform(-0.2, 0.2, size=B)
    oy[:, 0] = mid[:, 1] + rng.uniform(-0.2, 0.2, size=B)
    thetas = jax.vmap(jp.make_theta)(*(jnp.asarray(a) for a in (x0, goal, ox, oy)))
    tp = ts.make_point_stabilization(T_PARAMS, horizon=N, reference_parity=False, device="cpu")
    return jp, tp, thetas


def _tracking_bank(B, seed):
    """test_rescue.py's tracking bank: straight references at 0.15 m/s, one
    live obstacle near each, corrected mode."""
    jp = js.make_tracking(PARAMS, horizon=N, reference_parity=False)
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    t = np.arange(1, N + 1) * PARAMS.dt
    x_ref = np.stack([x0[:, 0:1] + 0.15 * t[None], np.zeros((B, N)), np.zeros((B, N))], axis=2)
    u_ref = np.tile([0.15, 0.0], (B, N, 1))
    ox, oy = np.full((B, PARAMS.n_obstacle_points), 100.0), np.full((B, PARAMS.n_obstacle_points), 100.0)
    ox[:, 0] = rng.uniform(0.3, 0.6, size=B)
    oy[:, 0] = rng.uniform(-0.1, 0.1, size=B)
    thetas = jax.vmap(jp.make_theta)(*(jnp.asarray(a) for a in (x0, x_ref, u_ref, ox, oy)))
    tp = ts.make_tracking(T_PARAMS, horizon=N, reference_parity=False, device="cpu")
    return jp, tp, thetas


def _port_two_pass(kind, tp, first, capacity):
    make = tr.make_cuda_two_pass_point_stab if kind == "point" else tr.make_cuda_two_pass_tracking
    return make(tp.ocp, ts.SolverSettings(**first), capacity=capacity, rescue_settings=ts.SolverSettings(**STRONG))


def _against_jax(kind, B, seed, capacity):
    jp, tp, thetas = (_obstacle_bank if kind == "point" else _tracking_bank)(B, seed)
    U0 = jnp.zeros((B, N, 2))
    j_first = jax.vmap(j_make_solver(jp.ocp, js.SolverSettings(**WEAK)))
    j_rescue = jax.vmap(j_make_solver(jp.ocp, js.SolverSettings(**STRONG)))
    j1 = jax.jit(j_first)(thetas, U0)
    j2 = jax.jit(js.make_two_pass_solver(j_first, j_rescue, capacity=capacity))(thetas, U0)
    comp = _port_two_pass(kind, tp, WEAK, capacity)
    tth = theta_from_numpy(thetas, "cpu")
    p1 = solution_to_numpy(comp.engines[0](tth, torch.zeros(B, N, 2)))
    p2 = solution_to_numpy(comp(tth, torch.zeros(B, N, 2)))
    k_p, k_j = p1.kkt_residual, np.asarray(j1.kkt_residual)
    near = (np.abs(np.log(k_p / TOL)) < np.log(2)) | (np.abs(np.log(k_j / TOL)) < np.log(2))
    print(f"{kind}: rows near kkt_tol {np.where(near)[0].tolist()} of {B}")
    assert near.sum() <= NEAR_TOL_MAX * B / 64
    keep = ~near
    for got, ref in ((p1, j1), (p2, j2)):
        np.testing.assert_allclose(got.U[keep], np.asarray(ref.U)[keep], atol=LIVE[0])
        np.testing.assert_allclose(got.cost[keep], np.asarray(ref.cost)[keep], rtol=LIVE[1])
        np.testing.assert_array_equal(got.converged[keep], np.asarray(ref.converged)[keep])
    return p1, p2


def test_two_pass_point_stab_matches_jax():
    """make_cuda_two_pass_point_stab (plain K1 here) against the JAX
    make_two_pass_solver over vmap(make_solver), WEAK first pass, STRONG
    rescue, B=64, capacity 32 (some stragglers rescued, some beyond)."""
    p1, p2 = _against_jax("point", 64, seed=1, capacity=32)
    assert p2.converged.mean() > p1.converged.mean()


def test_two_pass_tracking_matches_jax():
    """The tracking twin on plain K2 against JAX, B=32, capacity 8."""
    p1, p2 = _against_jax("tracking", 32, seed=6, capacity=8)
    assert p2.converged.mean() >= p1.converged.mean()


@pytest.mark.parametrize("first", ["weak", "fast"])
def test_two_pass_improves_and_preserves_converged_rows(first):
    """test_rescue.py's three properties on the port's composite: the
    converged fraction strictly improves, rows the first pass converged are
    bit-identical, no row's KKT residual gets worse. The WEAK first pass is
    the JAX test's; the fast schedule's converges some rows first."""
    settings = WEAK if first == "weak" else dict(barrier_stages=8, iters_per_stage=4, n_alphas=6)
    _, tp, thetas = _obstacle_bank(64, seed=1)
    comp = _port_two_pass("point", tp, settings, capacity=16)
    tth = theta_from_numpy(thetas, "cpu")
    s1 = solution_to_numpy(comp.engines[0](tth, torch.zeros(64, N, 2)))
    s2 = solution_to_numpy(comp(tth, torch.zeros(64, N, 2)))
    assert s1.converged.mean() < 1.0, "bank too easy to exercise the rescue"
    assert s2.converged.mean() > s1.converged.mean()
    np.testing.assert_array_equal(s2.U[s1.converged], s1.U[s1.converged])
    assert np.all(s2.kkt_residual <= s1.kkt_residual + 1e-7)
    if first == "fast":
        assert s1.converged.any()


def test_two_pass_capacity_overflow_keeps_first_pass_iterates():
    """More stragglers than capacity: the lowest-indexed are rescued, the
    rest keep their first-pass solution."""
    _, tp, thetas = _obstacle_bank(64, seed=2)
    cap = 4
    comp = _port_two_pass("point", tp, WEAK, capacity=cap)
    tth = theta_from_numpy(thetas, "cpu")
    s1 = solution_to_numpy(comp.engines[0](tth, torch.zeros(64, N, 2)))
    s2 = solution_to_numpy(comp(tth, torch.zeros(64, N, 2)))
    fail_idx = np.where(~s1.converged)[0]
    assert len(fail_idx) > cap, "bank too easy for the overflow test"
    np.testing.assert_array_equal(s2.U[fail_idx[cap:]], s1.U[fail_idx[cap:]])
    assert np.isfinite(s2.U).all()


@pytest.mark.parametrize("kind", ["point", "tracking"])
def test_two_pass_direction_against_pallas_interpret(kind):
    """The JAX Pallas composite (interpret mode, tiny tiles; its exits are
    per tile, so only the direction is compared): its converged fraction is
    at least its first pass's, and so is the port's on the same bank."""
    from ros2_mpc_tpu.solver import pallas_kernel as pk

    jp, tp, thetas = (_obstacle_bank(32, seed=3) if kind == "point" else _tracking_bank(32, seed=6))
    U0 = jnp.zeros((32, N, 2))
    weak, strong = js.SolverSettings(**WEAK), js.SolverSettings(**STRONG)
    j_make = js.make_pallas_two_pass_point_stab if kind == "point" else js.make_pallas_two_pass_tracking
    j_kernel = pk.make_pallas_point_stab_solver if kind == "point" else pk.make_pallas_tracking_solver
    tiles = dict(interpret=True, tile_s=2, tile_l=8)
    j2 = jax.jit(j_make(jp.ocp, weak, capacity=8, rescue_settings=strong, rescue_tile_s=2, **tiles))(thetas, U0)
    j1 = j_kernel(jp.ocp, weak, **tiles)(thetas, U0)
    assert float(jnp.mean(j2.converged)) >= float(jnp.mean(j1.converged))
    comp = _port_two_pass(kind, tp, WEAK, capacity=8)
    tth = theta_from_numpy(thetas, "cpu")
    p1 = solution_to_numpy(comp.engines[0](tth, torch.zeros(32, N, 2)))
    p2 = solution_to_numpy(comp(tth, torch.zeros(32, N, 2)))
    assert p2.converged.mean() >= p1.converged.mean()
    assert np.all(p2.kkt_residual <= p1.kkt_residual + 1e-6)
    assert np.isfinite(p2.U).all()


@pytest.mark.parametrize("kind", ["point", "tracking"])
def test_two_pass_composites_carry_their_engines(kind):
    """Each composite lists the bank solves it calls, in call order: the
    first pass's K1 or K2 wrapper at its schedule, then the rescue pass's at
    rescue_schedule() (the JAX package's), each called once a solve."""
    import dataclasses

    assert dataclasses.asdict(tr.rescue_schedule()) == dataclasses.asdict(jr.rescue_schedule())
    _, tp, thetas = (_obstacle_bank if kind == "point" else _tracking_bank)(16, seed=4)
    make = tr.make_cuda_two_pass_point_stab if kind == "point" else tr.make_cuda_two_pass_tracking
    comp = make(tp.ocp, ts.SolverSettings(**WEAK), capacity=4)
    first, rescue = comp.engines
    assert first.kind == rescue.kind == ("point_stab" if kind == "point" else "tracking")
    assert (first.cfg.n_alphas, len(first.cfg.mus)) == (4, 4)
    assert (rescue.cfg.n_alphas, len(rescue.cfg.mus)) == (12, 160)
    assert first.cfg.wrap_yaw == rescue.cfg.wrap_yaw == (kind == "tracking")

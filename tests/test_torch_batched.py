"""Port parity: the model-generic bank engine and the box-DDP KKT polish
(solver/batched.py) of ros2_mpc_tpu_torch against ros2_mpc_tpu, on the CPU.

Inputs are made with numpy from a seed and carried into the port with
convert.theta_from_numpy. The JAX engine runs lane-aligned (``lanes=8``);
the port's bank is B-leading. Bands (tests/test_pallas.py's engine bands):
inert banks U atol 1e-4 / cost rtol 1e-4; live obstacles, tracking, the
legacy barrier and the 2-control extra families U atol 5e-4 / cost rtol
1e-3; the quadrotor, as tests/test_batched_generic.py holds the JAX
engines to each other, U per channel within 1e-3 of the channel's box
width (its thrust box is 500x its torque box) and cost rtol 1e-4 on every
row. The small linear algebra: atol 1e-5.

Bank parity holds on the rows the reference certifies converged (KKT below
1e-4). On unconverged rows float32 rounding sends any two engines apart,
even two of one package: on the obstacle bank here the JAX fast engine and
the JAX vmap(make_solver) differ by 0.4 in U on a row at KKT 6e-2, and the
port's two engines reproduce each JAX engine on that row. The converged
fractions must agree within one row. The quadrotor's KKT residual (a
projected gradient in thrust units) scatters by 10-100x between any two
engines at equal U, so its converged fractions are not compared, and its
rows are compared where either engine certifies convergence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.solver import batched as jb
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.convert import solution_to_numpy, theta_from_numpy
from ros2_mpc_tpu_torch.solver import batched as tb

PARAMS, T_PARAMS = JParams(), TParams()
N = 10
FAST = dict(barrier_stages=4, iters_per_stage=3, n_alphas=6)
INERT, LIVE = (1e-4, 1e-4), (5e-4, 1e-3)
QUAD = (1e-3, 1e-4)  # per channel, as a share of the box width


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, m, bs=(2, 3)):
    A = rng.normal(size=bs + (m, m))
    return A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(m)


def _jax_layout(a):
    """(..., r, c) -> (r, c, ...), the JAX module's component-stacked layout."""
    return jnp.asarray(np.moveaxis(a, (-2, -1), (0, 1)))


def _from_jax_layout(a):
    return np.moveaxis(np.asarray(a), (0, 1), (-2, -1))


@pytest.mark.parametrize("m", [3, 4, 6])
def test_chol_solve_matches_jax(m):
    rng = np.random.default_rng(m)
    M = _spd(rng, m).astype(np.float32)
    rhs = rng.normal(size=(2, 3, m, 4)).astype(np.float32)
    got = tb._chol_solve(torch.from_numpy(M), torch.from_numpy(rhs)).numpy()
    ref = _from_jax_layout(jb._chol_solve(_jax_layout(M), _jax_layout(rhs)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.linalg.solve(M.astype(np.float64), rhs), atol=2e-5, rtol=2e-4)


def test_chol_solve_safeguards_indefinite_rows_against_jax():
    """A bank mixing PD and indefinite matrices: the indefinite rows take
    the heavy diagonal loading (solve M + 1e3 I), the PD rows are untouched,
    as in the JAX module (which factorizes every row twice)."""
    m = 4
    rng = np.random.default_rng(4)
    M = _spd(rng, m, bs=(6,))
    M[[1, 4]] = -np.eye(m) + 0.01  # indefinite
    M = M.astype(np.float32)
    rhs = rng.normal(size=(6, m, 1)).astype(np.float32)
    got = tb._chol_solve(torch.from_numpy(M), torch.from_numpy(rhs)).numpy()
    ref = _from_jax_layout(jb._chol_solve(_jax_layout(M), _jax_layout(rhs)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    want = np.linalg.solve(M[[1, 4]].astype(np.float64) + 1e3 * np.eye(m), rhs[[1, 4]])
    np.testing.assert_allclose(got[[1, 4]], want, rtol=1e-4, atol=1e-8)


def test_solve2x2_matches_jax():
    rng = np.random.default_rng(2)
    M = _spd(rng, 2, bs=(8,)).astype(np.float32)
    M[3] = [[-1.0, 0.2], [0.2, 0.5]]  # loses PD: loaded
    rhs = rng.normal(size=(8, 2, 3)).astype(np.float32)
    got, _ = tb._solve2x2(torch.from_numpy(M), torch.from_numpy(rhs))
    ref, _ = jb._solve2x2(_jax_layout(M), _jax_layout(rhs))
    np.testing.assert_allclose(got.numpy(), _from_jax_layout(ref), atol=1e-5, rtol=1e-5)


def test_probe_rejects_scalar_only_transition():
    def bad_F(x, u):
        # scalar semantics: x[2] instead of x[..., 2]
        return torch.stack([x[0] + u[0], x[1], x[2] + u[1]])

    ocp = ts.OCP(
        transition=bad_F,
        stage_cost=lambda x, u, k, th: torch.sum(x * x) + torch.sum(u * u),
        terminal_cost=lambda x, th: torch.zeros(()),
        horizon=4,
        n_states=3,
        n_controls=2,
        u_lo=(-1.0, -1.0),
        u_hi=(1.0, 1.0),
    )
    with pytest.raises(ValueError, match="batched semantics"):
        tb.make_bank_solver_fast(ocp, ts.SolverSettings())
    with pytest.raises(ValueError, match="batched semantics"):
        tb.make_bank_kkt_polish(ocp)


def _point_args(rng, B, obstacles):
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = rng.uniform(-1.2, 1.2, size=(B, 3))
    if not obstacles:
        return (x0, goal)
    ox, oy = np.full((B, PARAMS.n_obstacle_points), 100.0), np.full((B, PARAMS.n_obstacle_points), 100.0)
    ox[:, 0] = rng.uniform(0.3, 0.6, size=B)
    oy[:, 0] = rng.uniform(-0.2, 0.2, size=B)
    return (x0, goal, ox, oy)


def _tracking_args(rng, B):
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    t = np.arange(1, N + 1) * PARAMS.dt
    x_ref = np.stack([x0[:, 0:1] + 0.15 * t[None], np.zeros((B, N)), np.zeros((B, N))], axis=2)
    return (x0, x_ref, np.tile([0.15, 0.0], (B, N, 1)))


def _quad_args(rng, B):
    x0 = np.zeros((B, 12))
    x0[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0[:, 6:8] = rng.uniform(-0.15, 0.15, (B, 2))
    x0[:, 8] = rng.uniform(-0.5, 0.5, B)
    goal = np.concatenate([rng.uniform(-0.3, 0.3, (B, 3)), rng.uniform(-0.4, 0.4, (B, 1))], axis=1)
    return (x0, goal)


def _smooth_args(rng, B):
    x0 = np.zeros((B, 5))
    x0[:, :2] = rng.uniform(-0.2, 0.2, (B, 2))
    x0[:, 2] = rng.uniform(-np.pi, np.pi, B)
    goal = np.concatenate([rng.uniform(-0.6, 0.6, (B, 2)), rng.uniform(-np.pi, np.pi, (B, 1))], axis=1)
    return (x0, goal)


def _family(name, settings):
    """(JAX problem, port problem, make_theta args, band) of one family."""
    jset, tset = js.SolverSettings(**settings), ts.SolverSettings(**settings)
    rng = np.random.default_rng(sum(map(ord, name)))
    kw = dict(horizon=N, settings=jset), dict(horizon=N, settings=tset, device="cpu")
    if name == "point_stab":
        return (js.make_point_stabilization(PARAMS, **kw[0]), ts.make_point_stabilization(T_PARAMS, **kw[1]),
                _point_args(rng, 16, False), INERT)  # fmt: skip
    if name == "point_stab_obstacles":
        return (
            js.make_point_stabilization(PARAMS, reference_parity=False, **kw[0]),
            ts.make_point_stabilization(T_PARAMS, reference_parity=False, **kw[1]),
            _point_args(rng, 16, True),
            LIVE,
        )
    if name == "tracking":
        return (js.make_tracking(PARAMS, **kw[0]), ts.make_tracking(T_PARAMS, **kw[1]), _tracking_args(rng, 8), LIVE)
    if name == "legacy_obstacles":
        return (
            js.make_legacy_point_stabilization(PARAMS, **kw[0]),
            ts.make_legacy_point_stabilization(T_PARAMS, **kw[1]),
            _point_args(rng, 8, True),
            LIVE,
        )
    if name == "bicycle":
        return (
            js.make_bicycle_point_stabilization(PARAMS, **kw[0]),
            ts.make_bicycle_point_stabilization(T_PARAMS, **kw[1]),
            _point_args(rng, 16, False),
            LIVE,
        )
    if name == "smooth":
        return (
            js.make_smooth_point_stabilization(PARAMS, **kw[0]),
            ts.make_smooth_point_stabilization(T_PARAMS, **kw[1]),
            _smooth_args(rng, 16),
            LIVE,
        )
    assert name == "quadrotor"
    return (js.make_quadrotor_hover(**kw[0]), ts.make_quadrotor_hover(**kw[1]), _quad_args(rng, 16), QUAD)


def _bank(jp, args):
    thetas = jax.vmap(jp.make_theta)(*(jnp.asarray(a) for a in args))
    B = args[0].shape[0]
    U0 = np.tile(np.asarray(jp.default_u0)[None], (B, 1, 1)).astype(np.float32)
    return thetas, U0


def _assert_band(got, ref, band, ocp):
    """``got`` within ``band`` of ``ref``: for the 2-control families on
    every row the reference certifies converged (at least a quarter of the
    bank), with the converged fractions within one row; for the quadrotor on
    every row either certifies converged, U per channel as a share of its
    box width."""
    u_atol, c_rtol = band
    conv = np.asarray(ref.converged)
    if ocp.n_controls > 2:
        rows, scale = conv | got.converged, np.asarray(ocp.u_hi) - np.asarray(ocp.u_lo)
    else:
        rows, scale = conv, 1.0
        assert abs(got.converged.mean() - conv.mean()) <= 1.0 / len(conv)
    assert rows.sum() >= len(conv) / 4, f"only {rows.sum()} of {len(conv)} rows to compare"
    dU = (np.abs(got.U - np.asarray(ref.U)) / scale).max(axis=(1, 2))
    assert dU[rows].max() <= u_atol, f"max |dU| {dU[rows].max():.3e} on rows {np.where(dU > u_atol)[0]}"
    np.testing.assert_allclose(got.cost[rows], np.asarray(ref.cost)[rows], rtol=c_rtol, atol=1e-5)


def _fast_parity(name, jax_engine):
    """The port's fast engine on one family's bank against a JAX engine
    ("fast" or "vmap") and against the port's own vmap(make_solver)."""
    jp, tp, args, band = _family(name, FAST)
    thetas, U0 = _bank(jp, args)
    if jax_engine == "fast":
        ref = jax.jit(jb.make_bank_solver_fast(jp.ocp, jp.settings, lanes=8))(thetas, jnp.asarray(U0))
    else:
        ref = jax.jit(jax.vmap(jp.solve))(thetas, jnp.asarray(U0))
    tth = theta_from_numpy(thetas, "cpu")
    got = solution_to_numpy(tb.make_bank_solver_fast(tp.ocp, tp.settings)(tth, torch.from_numpy(U0)))
    assert got.U.shape == U0.shape and np.isfinite(got.U).all()
    _assert_band(got, ref, band, jp.ocp)
    vm = solution_to_numpy(torch.func.vmap(tp.solve)(tth, torch.from_numpy(U0)))
    _assert_band(got, vm, band, jp.ocp)
    np.testing.assert_array_equal(got.n_iters, np.full(U0.shape[0], tp.settings.total_iters))


@pytest.mark.parametrize(
    "name", ["point_stab", "point_stab_obstacles", "tracking", "legacy_obstacles", "bicycle", "smooth"]
)
def test_bank_solver_fast_matches_jax_and_vmap(name):
    """The port's fast engine against the JAX package's fast engine and
    against the port's own torch.func.vmap(make_solver), in the family's
    band."""
    _fast_parity(name, "fast")


def test_bank_solver_fast_quadrotor_matches_jax_vmap():
    """The quadrotor (m=4: the Cholesky path) against the JAX package's
    vmap(make_solver), which the JAX suite holds its own fast engine to
    (tests/test_batched_generic.py)."""
    _fast_parity("quadrotor", "vmap")


@pytest.mark.slow
def test_bank_solver_fast_quadrotor_matches_jax_fast_engine():
    """The quadrotor against the JAX fast engine itself; slow: XLA takes
    ~50 s on this CPU to compile the JAX engine's unrolled 12-state algebra."""
    _fast_parity("quadrotor", "fast")


def test_bank_solver_fast_takes_any_bank_size():
    """No lane multiple: B=5 solves, row for row the same as the first 5
    rows of an 8-row bank."""
    jp, tp, args, _ = _family("point_stab", FAST)
    thetas, U0 = _bank(jp, tuple(a[:8] for a in args))
    tth = theta_from_numpy(thetas, "cpu")
    solve = tb.make_bank_solver_fast(tp.ocp, tp.settings)
    s8 = solve(tth, torch.from_numpy(U0))
    s5 = solve({k: v[:5] for k, v in tth.items()}, torch.from_numpy(U0[:5]))
    np.testing.assert_allclose(s5.U.numpy(), s8.U[:5].numpy(), atol=1e-6)


def _weak_obstacle_bank(B, seed):
    """test_rescue.py's obstacle bank under its weak schedule."""
    weak = dict(barrier_stages=2, iters_per_stage=2, n_alphas=4)
    jp = js.make_point_stabilization(PARAMS, horizon=N, reference_parity=False)
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = np.concatenate([rng.uniform(-1.2, 1.2, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))], axis=1)
    ox, oy = np.full((B, PARAMS.n_obstacle_points), 100.0), np.full((B, PARAMS.n_obstacle_points), 100.0)
    mid = (x0[:, :2] + goal[:, :2]) / 2
    ox[:, 0] = mid[:, 0] + rng.uniform(-0.2, 0.2, size=B)
    oy[:, 0] = mid[:, 1] + rng.uniform(-0.2, 0.2, size=B)
    thetas = jax.vmap(jp.make_theta)(*(jnp.asarray(a) for a in (x0, goal, ox, oy)))
    first = jax.jit(jax.vmap(js.ilqr.make_solver(jp.ocp, js.SolverSettings(**weak))))(thetas, jnp.zeros((B, N, 2)))
    tp = ts.make_point_stabilization(T_PARAMS, horizon=N, reference_parity=False, device="cpu")
    return jp, tp, thetas, first


def test_kkt_polish_matches_jax_monotone_and_halves_kkt():
    """make_bank_kkt_polish on a weak-schedule obstacle bank, from the JAX
    first pass's iterates: against the JAX polish (the live band, and the
    KKT residuals within rtol 1e-2 or 1e-6 absolute), per-row residuals
    never above the warm start's, the mean at most half of it
    (test_rescue.py:170-186)."""
    jp, tp, thetas, first = _weak_obstacle_bank(16, seed=3)
    ref = jax.jit(jb.make_bank_kkt_polish(jp.ocp, n_iters=8, lanes=16))(thetas, first.U)
    got = solution_to_numpy(
        tb.make_bank_kkt_polish(tp.ocp, n_iters=8)(theta_from_numpy(thetas, "cpu"), torch.from_numpy(np.asarray(first.U)))
    )
    k0, k1 = np.asarray(first.kkt_residual), got.kkt_residual
    assert np.all(k1 <= k0 + 1e-7), "the polish must never worsen a row"
    assert k1.mean() < 0.5 * k0.mean(), (k0.mean(), k1.mean())
    assert got.converged.mean() >= np.asarray(first.converged).mean()
    _assert_band(got, ref, LIVE, jp.ocp)
    np.testing.assert_allclose(k1, np.asarray(ref.kkt_residual), rtol=1e-2, atol=1e-6)
    np.testing.assert_array_equal(got.converged, np.asarray(ref.converged))
    np.testing.assert_array_equal(got.n_iters, np.full(16, 8))


def _fast_polish_parity(jp, tp, args, capacity, band):
    """make_fast_polish_solver on a bank (fast schedule): against the JAX
    composite in the live band, never worse than its own first pass row for
    row, at least its converged fraction."""
    thetas, U0 = _bank(jp, args)
    ref = jax.jit(js.make_fast_polish_solver(jp.ocp, jp.settings, capacity=capacity, lanes=8))(thetas, jnp.asarray(U0))
    tth, tU0 = theta_from_numpy(thetas, "cpu"), torch.from_numpy(U0)
    comp = ts.make_fast_polish_solver(tp.ocp, tp.settings, capacity=capacity)
    got = solution_to_numpy(comp(tth, tU0))
    first = solution_to_numpy(comp.engines[0](tth, tU0))
    assert np.all(got.kkt_residual <= first.kkt_residual + 1e-7)
    assert got.converged.mean() >= first.converged.mean()
    _assert_band(got, ref, band, jp.ocp)


def test_fast_polish_solver_bicycle_matches_jax():
    """The fast-polish composite on the bicycle bank (N=10, capacity 8)."""
    jset, tset = js.SolverSettings.fast(), ts.SolverSettings.fast()
    jp = js.make_bicycle_point_stabilization(PARAMS, horizon=N, settings=jset)
    tp = ts.make_bicycle_point_stabilization(T_PARAMS, horizon=N, settings=tset, device="cpu")
    _fast_polish_parity(jp, tp, _point_args(np.random.default_rng(8), 16, False), 8, LIVE)


@pytest.mark.slow
def test_fast_polish_solver_quadrotor_matches_jax():
    """The fast-polish composite on the quadrotor bank (N=10, B=32, capacity
    8: test_batched_generic.py's recipe); slow: XLA takes ~100 s on this CPU
    to compile the JAX composite."""
    jset, tset = js.SolverSettings.fast(), ts.SolverSettings.fast()
    jp = js.make_quadrotor_hover(horizon=N, settings=jset)
    tp = ts.make_quadrotor_hover(horizon=N, settings=tset, device="cpu")
    _fast_polish_parity(jp, tp, _quad_args(np.random.default_rng(5), 32), 8, QUAD)


def test_fast_polish_solver_quadrotor_never_worse():
    """The fast-polish composite on the port's quadrotor bank alone (the
    JAX side is the slow test above; N=6, B=16, capacity 8, 4 polish
    steps): the polish never worsens a row, keeps the converged fraction,
    and its rows stay finite and inside the box."""
    tp = ts.make_quadrotor_hover(horizon=6, settings=ts.SolverSettings.fast(), device="cpu")
    x0, goal = _quad_args(np.random.default_rng(5), 16)
    tth = torch.func.vmap(tp.make_theta)(torch.tensor(x0, dtype=torch.float32), torch.tensor(goal, dtype=torch.float32))
    tU0 = tp.default_u0.repeat(16, 1, 1)
    comp = ts.make_fast_polish_solver(tp.ocp, tp.settings, capacity=8, polish_iters=4)
    got = solution_to_numpy(comp(tth, tU0))
    first = solution_to_numpy(comp.engines[0](tth, tU0))
    assert np.all(got.kkt_residual <= first.kkt_residual)
    assert got.kkt_residual.mean() < first.kkt_residual.mean()
    assert got.converged.mean() >= first.converged.mean()
    assert np.isfinite(got.U).all()
    assert np.all(got.U >= np.asarray(tp.ocp.u_lo)) and np.all(got.U <= np.asarray(tp.ocp.u_hi))

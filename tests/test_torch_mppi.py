"""The port's sampling engines (``ros2_mpc_tpu_torch.solver.mppi``) against
the JAX package's (``tests/test_mppi.py``) on the CPU.

MPPI samples: the port draws from a ``torch.Generator`` where the JAX
package splits a PRNG key, so the parity tests inject JAX's own white draws
(``jax.random.normal(split(key, n_iters)[t], (N, S, m))`` for iteration t)
into the port's noise helper through ``convert.mppi_noise_from_numpy``, and
then hold the port within the live band of the North star: U atol 5e-4,
cost rtol 1e-3. The rest is held by outcome on the port's own generator:
bounds, determinism given a seed, and never worse than the plain solve.
The iLQR polishes run K1/K2's plain versions (``engine="cuda"`` on CPU
tensors) unless a test names another engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.solver import mppi as jm
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.convert import mppi_noise_from_numpy, theta_from_numpy
from ros2_mpc_tpu_torch.solver import mppi as tm
from ros2_mpc_tpu_torch.solver.ilqr import Solution

J_PARAMS, T_PARAMS = JParams(), TParams()
U_ATOL, COST_RTOL = 5e-4, 1e-3
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


def _point(horizon=20, corrected=True, settings=None):
    kw = dict(horizon=horizon, reference_parity=not corrected)
    j = js.make_point_stabilization(J_PARAMS, settings=settings and js.SolverSettings(**settings), **kw)
    t = ts.make_point_stabilization(T_PARAMS, settings=settings and ts.SolverSettings(**settings), device=CPU, **kw)
    return j, t


def _bank(jprob, *cols):
    """A JAX theta bank from numpy columns, and the port's copy of it."""
    jth = jax.vmap(jprob.make_theta)(*(jnp.asarray(c, dtype=jnp.float32) for c in cols))
    return jth, theta_from_numpy({k: np.asarray(v) for k, v in jth.items()}, device=CPU)


def _jax_draws(keys, settings, N, m):
    """(n_iters, B, N, S, m): iteration t of scenario b as JAX's MPPI draws it."""
    per = []
    for key in keys:
        ks = jax.random.split(key, settings.n_iters)
        per.append([np.asarray(jax.random.normal(k, (N, settings.n_samples, m))) for k in ks])
    return np.stack(per, axis=1)


def _obstacle_inputs(B, seed, n_obs):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    goal = np.c_[rng.uniform(-1.0, 1.0, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))]
    obs_x, obs_y = np.full((B, n_obs), 100.0), np.full((B, n_obs), 100.0)
    mid = (x0[:, :2] + goal[:, :2]) / 2
    obs_x[:, 0], obs_y[:, 0] = mid[:, 0] + 0.05, mid[:, 1] - 0.05
    return x0, goal, obs_x, obs_y


@pytest.mark.parametrize("formulation", ["point", "tracking"])
def test_mppi_matches_jax_on_injected_draws(monkeypatch, formulation):
    settings_j = jm.MppiSettings(n_samples=48, n_iters=5)
    settings_t = tm.MppiSettings(n_samples=48, n_iters=5)
    B, N = 3, 10
    if formulation == "point":
        jp, tp = _point(horizon=N)
        jth, tth = _bank(jp, *_obstacle_inputs(B, 5, J_PARAMS.n_obstacle_points))
    else:
        jp = js.make_tracking(J_PARAMS, horizon=N, reference_parity=False, terminal_weight=(10.0, 10.0, 1.0))
        tp = ts.make_tracking(T_PARAMS, horizon=N, reference_parity=False, terminal_weight=(10.0, 10.0, 1.0), device=CPU)
        rng = np.random.default_rng(6)
        tsec = np.arange(1, N + 1) * J_PARAMS.dt
        x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
        x_ref = np.stack([x0[:, :1] + 0.12 * tsec, np.zeros((B, N)), np.full((B, N), 0.3)], axis=2)
        u_ref = np.tile([0.12, 0.0], (B, N, 1))
        jth, tth = _bank(jp, x0, x_ref, u_ref)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    U0 = np.zeros((B, N, 2), np.float32)
    sol_j = jax.jit(jax.vmap(jm.make_mppi_solver(jp.ocp, settings_j)))(jth, jnp.asarray(U0), keys)
    monkeypatch.setattr(tm, "_white_noise", mppi_noise_from_numpy(_jax_draws(keys, settings_j, N, 2), device=CPU))
    sol_t = tm.make_mppi_solver(tp.ocp, settings_t, device=CPU)(tth, torch.as_tensor(U0), _gen(0))
    np.testing.assert_allclose(sol_t.U.numpy(), np.asarray(sol_j.U), atol=U_ATOL)
    np.testing.assert_allclose(sol_t.X.numpy(), np.asarray(sol_j.X), atol=U_ATOL)
    np.testing.assert_allclose(sol_t.cost.numpy(), np.asarray(sol_j.cost), rtol=COST_RTOL)
    np.testing.assert_array_equal(sol_t.converged.numpy(), np.asarray(sol_j.converged))
    np.testing.assert_allclose(sol_t.kkt_residual.numpy(), np.asarray(sol_j.kkt_residual), atol=U_ATOL, rtol=COST_RTOL)


def test_ar1_noise_matches_jax():
    """The AR(1) filter on one set of white draws, layout and values."""
    key = jax.random.PRNGKey(9)
    N, S, m, beta = 7, 5, 2, 0.6
    white = np.array(jax.random.normal(key, (N, S, m)))
    ref = np.asarray(jm._ar1_noise(key, S, N, m, beta))  # (S, N, m)
    got = tm._ar1_noise(torch.as_tensor(white)[:, None], beta)  # (S, 1, N, m)
    np.testing.assert_allclose(got[:, 0].numpy(), ref, atol=1e-6)


def test_multistart_vmap_matches_jax_on_injected_draws(monkeypatch):
    """The multistart engine on the iLQR the JAX package polishes with
    (engine="vmap": make_solver), fed JAX's MPPI draws."""
    N = 10
    settings = dict(barrier_stages=4, iters_per_stage=3, n_alphas=6)
    jp, tp = _point(horizon=N, settings=settings)
    jth, tth = _bank(jp, *_obstacle_inputs(2, 8, J_PARAMS.n_obstacle_points))
    ms_j = jm.MppiSettings(n_samples=16, n_iters=3)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    U0 = np.zeros((2, N, 2), np.float32)
    jsolve = js.make_multistart_solver(jp.ocp, jp.settings, ms_j, swing_fracs=(1.0,))
    sol_j = jax.jit(jax.vmap(jsolve))(jth, jnp.asarray(U0), keys)
    monkeypatch.setattr(tm, "_white_noise", mppi_noise_from_numpy(_jax_draws(keys, ms_j, N, 2), device=CPU))
    tsolve = tm.make_multistart_solver(
        tp.ocp, tp.settings, tm.MppiSettings(n_samples=16, n_iters=3), swing_fracs=(1.0,), engine="vmap", device=CPU
    )
    sol_t = tsolve(tth, torch.as_tensor(U0), _gen(0))
    np.testing.assert_allclose(sol_t.U.numpy(), np.asarray(sol_j.U), atol=U_ATOL)
    np.testing.assert_allclose(sol_t.cost.numpy(), np.asarray(sol_j.cost), rtol=COST_RTOL)
    np.testing.assert_array_equal(sol_t.converged.numpy(), np.asarray(sol_j.converged))
    np.testing.assert_array_equal(sol_t.n_iters.numpy(), np.asarray(sol_j.n_iters))


def test_mppi_matches_ilqr_cost_point_stab():
    """Open-floor drive-to-pose: the sampled optimum lands within a few
    percent of the Newton optimum, K1's (test_mppi.py:23-39)."""
    from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_point_stab_solver

    _, tp = _point()
    th = {k: v[None] for k, v in tp.make_theta(np.zeros(3), np.array([0.35, 0.15, 0.4])).items()}
    U0 = tp.default_u0[None]
    sol_m = tm.make_mppi_solver(tp.ocp, tm.MppiSettings(n_samples=192, n_iters=20), device=CPU)(th, U0, _gen(0))
    sol_i = make_cuda_point_stab_solver(tp.ocp, tp.settings)(th, U0)
    assert bool(sol_i.converged[0])
    assert float(sol_m.cost[0]) <= 1.05 * float(sol_i.cost[0]) + 1e-6
    d_m = float(torch.linalg.vector_norm(sol_m.X[0, -1, :2] - th["goal"][0, :2]))
    d_i = float(torch.linalg.vector_norm(sol_i.X[0, -1, :2] - th["goal"][0, :2]))
    assert d_m <= d_i + 0.05


def test_mppi_deterministic_given_a_seed():
    _, tp = _point()
    th = {k: v[None].repeat(2, *([1] * v.dim())) for k, v in tp.make_theta(np.zeros(3), np.array([0.3, -0.2, 0.0])).items()}
    U0 = torch.zeros(2, 20, 2)
    mppi = tm.make_mppi_solver(tp.ocp, tm.MppiSettings(n_samples=64, n_iters=6), device=CPU)
    a, b, c = mppi(th, U0, _gen(7)), mppi(th, U0, _gen(7)), mppi(th, U0, _gen(8))
    assert torch.equal(a.U, b.U) and torch.equal(a.cost, b.cost)
    assert not torch.equal(a.U, c.U)
    # one generator draws on: two scenarios of one bank sample differently
    assert not torch.equal(a.U[0], a.U[1])


def test_mppi_respects_bounds():
    _, tp = _point()
    th = {k: v[None] for k, v in tp.make_theta(np.zeros(3), np.array([1.5, 0.0, 0.0])).items()}
    sol = tm.make_mppi_solver(tp.ocp, tm.MppiSettings(n_samples=64, n_iters=8), device=CPU)(th, tp.default_u0[None], _gen(3))
    lo, hi = np.asarray(tp.ocp.u_lo), np.asarray(tp.ocp.u_hi)
    u = sol.U.numpy()
    assert (u >= lo - 1e-7).all() and (u <= hi + 1e-7).all()
    assert sol.n_iters.tolist() == [8] and sol.U.shape == (1, 20, 2)


def test_hybrid_never_worse_and_lifts_convergence():
    """On an obstacle-walled bank the hybrid (polish on K1's plain version)
    never loses to plain K1 on cost among rows both converge, and converges
    at least as many (test_mppi.py:77-112, B=12)."""
    from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_point_stab_solver

    _, tp = _point()
    rng = np.random.default_rng(11)
    B, n = 12, T_PARAMS.n_obstacle_points
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    goal = np.c_[rng.uniform(-1.2, 1.2, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))]
    obs_x, obs_y = np.full((B, n), 100.0), np.full((B, n), 100.0)
    mid = (x0[:, :2] + goal[:, :2]) / 2
    seg = goal[:, :2] - x0[:, :2]
    perp = np.stack([-seg[:, 1], seg[:, 0]], axis=1)
    perp /= np.linalg.norm(perp, axis=1, keepdims=True) + 1e-9
    for j, off in enumerate((-0.12, 0.0, 0.12)):
        obs_x[:, j] = mid[:, 0] + off * perp[:, 0]
        obs_y[:, j] = mid[:, 1] + off * perp[:, 1]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    th = torch.func.vmap(tp.make_theta)(f32(x0), f32(goal), f32(obs_x), f32(obs_y))
    U0 = torch.zeros(B, 20, 2)
    hybrid = tm.make_hybrid_solver(tp.ocp, tp.settings, device=CPU)
    (k1,) = hybrid.engines
    sol_h = hybrid(th, U0, _gen(0))
    sol_p = make_cuda_point_stab_solver(tp.ocp, tp.settings)(th, U0)
    assert int(sol_h.converged.sum()) >= int(sol_p.converged.sum())
    both = sol_h.converged & sol_p.converged
    assert bool((sol_h.cost[both] <= sol_p.cost[both] + 1e-5).all())
    assert k1.kind == "point_stab" and k1.launches == 0  # plain version on CPU tensors


def test_packed_hybrid_matches_direct():
    """The packed tick forwards the generator and reproduces the direct
    hybrid solve exactly (same theta, same seed), with the shifted warm
    start (test_mppi.py:115-135)."""
    from ros2_mpc_tpu_torch.solver.cuda_kernel import single_scenario
    from ros2_mpc_tpu_torch.solver.packed import make_packed_point_stab

    _, tp = _point(horizon=10)
    hybrid = tm.make_hybrid_solver(tp.ocp, tp.settings, tm.MppiSettings(n_samples=32, n_iters=4), device=CPU)
    solve_pk, pack = make_packed_point_stab(tp, T_PARAMS, solve_fn=single_scenario(hybrid))
    n = T_PARAMS.n_obstacle_points
    x0, goal, obs = np.array([0.1, -0.1, 0.3]), np.array([0.8, 0.4, 0.0]), np.full(n, 100.0)
    sol_pk, u_next = solve_pk(pack(x0, goal, obs, obs), tp.default_u0, _gen(5))
    th = {k: v[None] for k, v in tp.make_theta(x0, goal, obs, obs).items()}
    sol_d = hybrid(th, tp.default_u0[None], _gen(5))
    assert torch.equal(sol_pk.U, sol_d.U[0])
    assert torch.equal(u_next[:-1], sol_d.U[0, 1:])


def test_multistart_breaks_symmetric_saddle():
    """An obstacle dead-center on the start-goal line: plain K1 hovers on
    the symmetry axis; the multistart engine's arc seeds (polished as one K1
    bank) find the detour (test_mppi.py:169-202)."""
    from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_point_stab_solver

    _, tp = _point(horizon=40)
    n = T_PARAMS.n_obstacle_points
    obs_x, obs_y = np.full(n, 100.0), np.full(n, 100.0)
    obs_x[0], obs_y[0] = 0.5, 0.0
    th = {k: v[None] for k, v in tp.make_theta(np.zeros(3), np.array([1.0, 0.0, 0.0]), obs_x, obs_y).items()}
    th["Q"] = torch.tensor([[5.0, 5.0, 0.05]])  # make reaching pay
    U0 = tp.default_u0[None]
    sol_p = make_cuda_point_stab_solver(tp.ocp, tp.settings)(th, U0)
    ms = tm.make_multistart_solver(tp.ocp, tp.settings, tm.MppiSettings(n_samples=64, n_iters=6), device=CPU)
    sol_m = ms(th, U0, _gen(0))
    X_p, X_m = sol_p.X[0].numpy(), sol_m.X[0].numpy()
    assert np.abs(X_p[:, 1]).max() < 1e-3
    assert np.linalg.norm(X_p[:, :2] - [1.0, 0.0], axis=1).min() > 0.5
    assert bool(sol_m.converged[0])
    assert float(sol_m.cost[0]) < 0.8 * float(sol_p.cost[0])
    assert np.linalg.norm(X_m[:, :2] - [1.0, 0.0], axis=1).min() < 0.25
    assert np.hypot(X_m[:, 0] - 0.5, X_m[:, 1]).min() > 0.1


def test_multistart_never_worse_on_open_floor():
    """No obstacle: the warm start is one of the polished starts, so the
    multistart reproduces or beats the plain solve (test_mppi.py:205-219)."""
    from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_point_stab_solver

    _, tp = _point()
    th = {k: v[None] for k, v in tp.make_theta(np.zeros(3), np.array([0.4, 0.25, 0.5])).items()}
    U0 = tp.default_u0[None]
    sol_p = make_cuda_point_stab_solver(tp.ocp, tp.settings)(th, U0)
    ms = tm.make_multistart_solver(tp.ocp, tp.settings, tm.MppiSettings(n_samples=32, n_iters=3), device=CPU)
    sol_m = ms(th, U0, _gen(1))
    assert float(sol_m.cost[0]) <= float(sol_p.cost[0]) + 1e-5
    assert bool(sol_m.converged[0]) >= bool(sol_p.converged[0])


def test_multistart_generalizes_to_bicycle():
    """The arc seeds come from the control box alone: the bicycle polished
    on the generic bank engine (test_mppi.py:222-236)."""
    tb = ts.make_bicycle_point_stabilization(T_PARAMS, horizon=24, device=CPU)
    th = {k: v[None] for k, v in tb.make_theta(np.zeros(3), np.array([0.7, 0.2, 0.0])).items()}
    ms = tm.make_multistart_solver(tb.ocp, tb.settings, tm.MppiSettings(n_samples=32, n_iters=3), engine="fast", device=CPU)
    sol = ms(th, tb.default_u0[None], _gen(2))
    assert bool(sol.converged[0])
    u, lo, hi = sol.U.numpy(), np.asarray(tb.ocp.u_lo), np.asarray(tb.ocp.u_hi)
    assert (u >= lo - 1e-6).all() and (u <= hi + 1e-6).all()
    with pytest.raises(ValueError, match="K1"):
        tm.make_multistart_solver(tb.ocp, tb.settings, kind="bicycle", device=CPU)


def test_selection_semantics_nan_and_nonconverged():
    """The ranking of the JAX package, case for case (test_mppi.py:239-268):
    among all-non-converged candidates the lowest cost wins, a NaN cost
    never wins over a finite one, ties go to the plain solve; and a bank of
    scenarios gives one index each."""

    def bank(cost, conv):
        k = len(cost)
        return Solution(
            U=torch.zeros(k, 2, 2), X=torch.zeros(k, 3, 3), cost=torch.tensor(cost),
            kkt_residual=torch.zeros(k), converged=torch.tensor(conv),
            n_iters=torch.zeros(k, dtype=torch.int32), reg=torch.zeros(k),
        )  # fmt: skip

    assert int(tm._select_best(bank([500.0, 3.0, 80.0], [False] * 3))) == 1
    assert int(tm._select_best(bank([np.nan, 2.0], [True, True]))) == 1
    assert int(tm._select_best(bank([1.0, 50.0], [False, True]))) == 1
    assert int(tm._select_best(bank([np.nan, np.nan, 4.0], [False] * 3))) == 2
    sols = Solution(*(None,) * 7)._replace(
        cost=torch.tensor([[500.0, 1.0], [3.0, 50.0], [80.0, np.nan]]),
        converged=torch.tensor([[False, False], [False, True], [False, True]]),
    )
    assert tm._select_best(sols).tolist() == [1, 1]

    def one(c, v):
        return Solution(U=0, X=0, cost=torch.tensor(c), kkt_residual=0, converged=torch.tensor(v), n_iters=0, reg=0)

    assert not bool(tm._prefer_first(one(np.nan, True), one(5.0, True)))
    assert bool(tm._prefer_first(one(2.0, True), one(5.0, True)))
    assert bool(tm._prefer_first(one(5.0, True), one(2.0, False)))
    assert not bool(tm._prefer_first(one(3.0, True), one(3.0, True)))  # tie -> plain


def test_mppi_builders_run_on_the_card_by_default(monkeypatch):
    _, tp = _point(horizon=6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tm.make_mppi_solver, tm.make_hybrid_solver, tm.make_multistart_solver):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(tp.ocp)

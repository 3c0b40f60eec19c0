"""Port parity: ros2_mpc_tpu_torch's make_solver (torch.func) and problem
builders against ros2_mpc_tpu's, on the CPU.

Inputs are made with numpy from a seed, built into thetas by the JAX
package and carried into the port with convert.theta_from_numpy, so both
solve the same problems. Bands (tests/test_pallas.py's engine bands):
inert banks U atol 1e-4 and cost rtol 1e-4; live obstacles, tracking and
the legacy barrier U atol 5e-4 and cost rtol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.convert import solution_to_numpy, theta_from_numpy

PARAMS = JParams()  # the JAX package's; the port builds from its own T_PARAMS
T_PARAMS = TParams()
N = 10
B = 8
J_FAST = js.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
T_FAST = ts.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
INERT, LIVE = (1e-4, 1e-4), (5e-4, 1e-3)


def _point_inputs(seed, obstacles):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = rng.uniform(-1.2, 1.2, size=(B, 3))
    if not obstacles:
        return (x0, goal)
    ox = np.full((B, PARAMS.n_obstacle_points), 100.0)
    oy = np.full((B, PARAMS.n_obstacle_points), 100.0)
    ox[:, 0] = rng.uniform(0.3, 0.7, size=B)
    oy[:, 0] = rng.uniform(-0.2, 0.2, size=B)
    return (x0, goal, ox, oy)


def _tracking_inputs(seed):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    ts_ = np.arange(1, N + 1) * PARAMS.dt
    # reference yaw 2.9 rad from a start near 0 puts the wrap to work
    x_ref = np.stack([x0[:, 0:1] + 0.15 * ts_[None], np.zeros((B, N)), np.full((B, N), 2.9)], axis=2)
    x0[:, 2] = rng.uniform(-3.0, -2.6, size=B)
    u_ref = np.tile([0.15, 0.0], (B, N, 1))
    ox = np.full((B, PARAMS.n_obstacle_points), 100.0)
    oy = np.full((B, PARAMS.n_obstacle_points), 100.0)
    ox[:, 0] = rng.uniform(0.3, 0.6, size=B)
    oy[:, 0] = rng.uniform(-0.15, 0.15, size=B)
    return (x0, x_ref, u_ref, ox, oy)


CASES = {
    "point_parity": (
        lambda m: m.make_point_stabilization(_params(m), horizon=N, **_opts(m)),
        lambda: _point_inputs(0, obstacles=False),
        INERT,
    ),
    "point_corrected_obstacles": (
        lambda m: m.make_point_stabilization(
            _params(m), horizon=N, reference_parity=False, **_opts(m)
        ),
        lambda: _point_inputs(1, obstacles=True),
        LIVE,
    ),
    "tracking_corrected_wrap_terminal": (
        lambda m: m.make_tracking(
            _params(m), horizon=N, reference_parity=False,
            terminal_weight=(2.0, 2.0, 1.0), **_opts(m),
        ),
        lambda: _tracking_inputs(5),
        LIVE,
    ),
    "legacy": (
        lambda m: m.make_legacy_point_stabilization(_params(m), horizon=N, **_opts(m)),
        lambda: _point_inputs(2, obstacles=False),
        LIVE,
    ),
}  # fmt: skip


def _params(mod):
    return PARAMS if mod is js else T_PARAMS


def _opts(mod):
    # the port runs on the card unless told otherwise: these tests name the CPU
    return {"settings": J_FAST} if mod is js else {"settings": T_FAST, "device": "cpu"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_solver_matches_jax(case):
    build, inputs, (u_atol, c_rtol) = CASES[case]
    jprob, tprob = build(js), build(ts)
    args = inputs()
    jthetas = jax.vmap(jprob.make_theta)(*(jnp.asarray(a) for a in args))
    ref = jax.jit(jax.vmap(jprob.solve))(jthetas, jnp.zeros((B, N, 2)))
    got = torch.func.vmap(tprob.solve)(theta_from_numpy(jthetas, "cpu"), torch.zeros(B, N, 2))
    got = solution_to_numpy(got)
    np.testing.assert_allclose(got.U, np.asarray(ref.U), atol=u_atol)
    np.testing.assert_allclose(got.cost, np.asarray(ref.cost), rtol=c_rtol)
    assert got.U.dtype == np.float32 and got.X.shape == (B, N + 1, 3)
    np.testing.assert_array_equal(got.n_iters, np.full(B, T_FAST.total_iters))
    # the KKT certificate tells the same story
    assert abs(got.converged.mean() - np.asarray(ref.converged).mean()) <= 0.25


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_theta_matches_jax(case):
    build, inputs, _ = CASES[case]
    jprob, tprob = build(js), build(ts)
    args = [a[0] for a in inputs()]  # one scenario
    ref = jprob.make_theta(*(jnp.asarray(a) for a in args))
    got = tprob.make_theta(*args)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == torch.float32, k
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k], dtype=np.float32), err_msg=k)
    # default obstacle pads (1e3 sentinels) when none are given
    got0 = tprob.make_theta(*args[: 3 if case.startswith("tracking") else 2])
    assert float(got0["obs_x"].min()) == 1e3 and got0["obs_x"].shape == (PARAMS.n_obstacle_points,)


@pytest.mark.parametrize("case", sorted(CASES))
def test_problem_templates_match_jax(case):
    build, _, _ = CASES[case]
    jprob, tprob = build(js), build(ts)
    for field in ("horizon", "n_states", "n_controls", "u_lo", "u_hi", "meta"):
        assert getattr(tprob.ocp, field) == getattr(jprob.ocp, field), field
    assert (tprob.kind, tprob.tags) == (jprob.kind, jprob.tags)
    assert tuple(tprob.default_u0.shape) == tuple(jprob.default_u0.shape)


def test_settings_presets_match_jax():
    for name in ("__call__", "fast", "realtime"):
        j = js.SolverSettings() if name == "__call__" else getattr(js.SolverSettings, name)()
        t = ts.SolverSettings() if name == "__call__" else getattr(ts.SolverSettings, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.total_iters == j.total_iters
        np.testing.assert_allclose(t.mu_schedule_np(), np.asarray(j.mu_schedule()), rtol=1e-6)


def test_horizon_parallel_is_not_ported_yet():
    prob = ts.make_point_stabilization(T_PARAMS, horizon=N, device="cpu")
    with pytest.raises(NotImplementedError):
        ts.make_solver(prob.ocp, ts.SolverSettings(horizon_parallel=True))

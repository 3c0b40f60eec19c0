"""Port parity: the extra model families (models/bicycle.py, quadrotor.py,
unicycle_dyn.py) and their problem factories (solver/problems_ext.py) of
ros2_mpc_tpu_torch against ros2_mpc_tpu, float32 on the CPU.

Inputs are made with numpy from a seed. Tolerances: the dynamics and the
costs atol 1e-6 with rtol 1e-6 (the quadrotor's angular accelerations and
the costs reach ~10, where one float32 ulp is ~1e-6); thetas exactly equal;
one solve per family within cost rtol 1e-3 and U 5e-4 of each control
channel's box width (the live band of tests/test_pallas.py, scaled per
channel because the quadrotor's thrust box is 500x its torque box, as
tests/test_batched_generic.py compares it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.models import bicycle as j_bicycle
from ros2_mpc_tpu.models import quadrotor as j_quad
from ros2_mpc_tpu.models import unicycle_dyn as j_dyn
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.convert import solution_to_numpy, theta_from_numpy
from ros2_mpc_tpu_torch.models import bicycle as t_bicycle
from ros2_mpc_tpu_torch.models import quadrotor as t_quad
from ros2_mpc_tpu_torch.models import unicycle_dyn as t_dyn
from ros2_mpc_tpu_torch.ops.integrators import make_step as t_make_step
from ros2_mpc_tpu_torch.ops.integrators import rollout as t_rollout

PARAMS, T_PARAMS = JParams(), TParams()
TOL = dict(atol=1e-6, rtol=1e-6)
MODELS = {  # name: (JAX f, port f, n, m)
    "bicycle": (j_bicycle.make_f(0.3), t_bicycle.make_f(0.3), 3, 2),
    "unicycle_dyn": (j_dyn.f, t_dyn.f, 5, 2),
    "quadrotor": (j_quad.make_f(), t_quad.make_f(), 12, 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_f_matches_jax(name):
    f_j, f_t, n, m = MODELS[name]
    rng = np.random.default_rng(len(name))
    x, u = _rand(rng, 64, n, scale=0.5), _rand(rng, 64, m, scale=0.3)
    got = f_t(torch.from_numpy(x), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, np.asarray(f_j(jnp.asarray(x), jnp.asarray(u))), **TOL)
    # trailing-component semantics: one vector and a (4, 16) batch agree
    np.testing.assert_allclose(
        f_t(torch.from_numpy(x[0]), torch.from_numpy(u[0])).numpy(), got[0], **TOL
    )
    got2 = f_t(torch.from_numpy(x.reshape(4, 16, n)), torch.from_numpy(u.reshape(4, 16, m))).numpy()
    np.testing.assert_array_equal(got2.reshape(64, n), got)


def test_quadrotor_constants_and_hover_match_jax():
    assert t_quad.GRAVITY == j_quad.GRAVITY
    assert (t_quad.N_STATES, t_quad.N_CONTROLS) == (j_quad.N_STATES, j_quad.N_CONTROLS)
    for mod_t, mod_j in ((t_bicycle, j_bicycle), (t_dyn, j_dyn)):
        assert (mod_t.N_STATES, mod_t.N_CONTROLS) == (mod_j.N_STATES, mod_j.N_CONTROLS)
    np.testing.assert_array_equal(t_quad.hover_control(0.7).numpy(), np.asarray(j_quad.hover_control(0.7)))
    # hover is a fixed point of the port's dynamics
    xdot = t_quad.make_f()(torch.zeros(12), t_quad.hover_control())
    assert float(xdot.abs().max()) < 1e-6


def test_bicycle_constant_steer_is_circular_arc():
    """Constant (v, delta) traces a circle of radius L / tan(delta) in the
    port too (test_models_ext.py's closed form)."""
    L, v, delta, dt, T = 0.3, 0.2, 0.3, 0.01, 500
    F = t_make_step(t_bicycle.make_f(L), "rk4", dt)
    X = t_rollout(F, torch.zeros(3), torch.tensor([v, delta]).repeat(T, 1)).numpy()
    R = L / np.tan(delta)
    np.testing.assert_allclose(np.hypot(X[:, 0], X[:, 1] - R), R, rtol=1e-5)
    np.testing.assert_allclose(X[-1, 2], v / R * T * dt, rtol=1e-5)


def test_smooth_unicycle_constant_accel_closed_form():
    """From rest on a straight line: v = a t, x = a t^2 / 2 (the port's
    model and RK4, test_models_ext.py's closed form)."""
    a, dt, T = 0.25, 0.01, 400
    F = t_make_step(t_dyn.f, "rk4", dt)
    X = t_rollout(F, torch.zeros(5), torch.tensor([a, 0.0]).repeat(T, 1)).numpy()
    t = T * dt
    np.testing.assert_allclose(X[-1, 3], a * t, rtol=1e-6)
    np.testing.assert_allclose(X[-1, 0], 0.5 * a * t * t, rtol=1e-4)
    assert abs(X[-1, 1]) < 1e-9 and abs(X[-1, 2]) < 1e-9


def _families():
    """name: (JAX problem, port problem, make_theta args as numpy)."""
    rng = np.random.default_rng(7)
    n_obs = PARAMS.n_obstacle_points
    obs_x, obs_y = np.full(n_obs, 100.0), np.full(n_obs, 100.0)
    obs_x[0], obs_y[0] = 0.4, 0.05
    x5 = np.zeros(5)
    x5[:3] = rng.uniform(-0.2, 0.2, 3)
    x12 = np.zeros(12)
    x12[0:3] = rng.uniform(-0.4, 0.4, 3)
    x12[6:9] = rng.uniform(-0.15, 0.15, 3)
    N = 8
    return {
        "bicycle": (
            js.make_bicycle_point_stabilization(PARAMS, horizon=N),
            ts.make_bicycle_point_stabilization(T_PARAMS, horizon=N, device="cpu"),
            (rng.uniform(-0.3, 0.3, 3), np.array([0.8, 0.3, 0.3]), obs_x, obs_y),
        ),
        "smooth": (
            js.make_smooth_point_stabilization(PARAMS, horizon=N),
            ts.make_smooth_point_stabilization(T_PARAMS, horizon=N, device="cpu"),
            (x5, np.array([0.6, 0.2, 0.0]), obs_x, obs_y),
        ),
        "quadrotor": (
            js.make_quadrotor_hover(horizon=N),
            ts.make_quadrotor_hover(horizon=N, device="cpu"),
            (x12, np.array([0.2, -0.1, 0.3, 0.2])),
        ),
    }


@pytest.mark.parametrize("name", ["bicycle", "smooth", "quadrotor"])
def test_problem_ext_factory_matches_jax(name):
    """Theta, OCP fields, default warm start, transition, stage and terminal
    costs of each factory against the JAX package's."""
    jp, tp, args = _families()[name]
    th_j = jp.make_theta(*(jnp.asarray(a) for a in args))
    th_t = tp.make_theta(*args)
    assert set(th_t) == set(th_j)
    for k in th_j:
        assert th_t[k].dtype == torch.float32 and th_t[k].device.type == "cpu"
        np.testing.assert_array_equal(th_t[k].numpy(), np.asarray(th_j[k]), err_msg=k)
    fields = ("horizon", "n_states", "n_controls", "u_lo", "u_hi")
    assert [getattr(tp.ocp, f) for f in fields] == [getattr(jp.ocp, f) for f in fields]
    assert (tp.kind, tp.tags) == (jp.kind, jp.tags)
    np.testing.assert_array_equal(tp.default_u0.numpy(), np.asarray(jp.default_u0))

    rng = np.random.default_rng(11)
    n, m = jp.ocp.n_states, jp.ocp.n_controls
    lo, hi = np.asarray(jp.ocp.u_lo), np.asarray(jp.ocp.u_hi)
    x = np.asarray(args[0], np.float32) + _rand(rng, 16, n, scale=0.1)
    u = (lo + (hi - lo) * rng.uniform(0.05, 0.95, (16, m))).astype(np.float32)
    np.testing.assert_allclose(
        tp.ocp.transition(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
        np.asarray(jp.ocp.transition(jnp.asarray(x), jnp.asarray(u))),
        **TOL,
    )
    tt = theta_from_numpy(th_j, "cpu")
    for i in range(4):
        for k in (0, jp.ocp.horizon - 1):
            got = float(tp.ocp.stage_cost(torch.from_numpy(x[i]), torch.from_numpy(u[i]), k, tt))
            ref = float(jp.ocp.stage_cost(jnp.asarray(x[i]), jnp.asarray(u[i]), k, th_j))
            np.testing.assert_allclose(got, ref, **TOL)
        got = float(tp.ocp.terminal_cost(torch.from_numpy(x[i]), tt))
        np.testing.assert_allclose(got, float(jp.ocp.terminal_cost(jnp.asarray(x[i]), th_j)), **TOL)


@pytest.mark.parametrize("name", ["bicycle", "smooth", "quadrotor"])
def test_problem_ext_solve_matches_jax(name):
    """One scenario through each family's Problem.solve (make_solver, the
    fast test schedule) in both packages; the live band."""
    jp, tp, args = _families()[name]
    settings = dict(barrier_stages=3, iters_per_stage=3, n_alphas=6)
    jsolve = js.ilqr.make_solver(jp.ocp, js.SolverSettings(**settings))
    tsolve = ts.make_solver(tp.ocp, ts.SolverSettings(**settings))
    th_j = jp.make_theta(*(jnp.asarray(a) for a in args))
    ref = jax.jit(jsolve)(th_j, jp.default_u0)
    got = solution_to_numpy(tsolve(theta_from_numpy(th_j, "cpu"), tp.default_u0))
    # per-channel scale: the quadrotor's thrust box is 500x its torque box
    width = np.asarray(jp.ocp.u_hi) - np.asarray(jp.ocp.u_lo)
    assert np.abs((got.U - np.asarray(ref.U)) / width).max() < 5e-4
    np.testing.assert_allclose(got.cost, float(ref.cost), rtol=1e-3)
    assert np.isfinite(got.X).all()


@pytest.mark.parametrize("name", ["bicycle", "smooth", "quadrotor"])
def test_theta_from_numpy_carries_the_ext_thetas(name):
    """convert.theta_from_numpy carries a bank of each new factory's JAX
    thetas into the port unchanged: equal to the port's own batched
    make_theta, leaf for leaf."""
    jp, tp, args = _families()[name]
    batch = [np.stack([np.asarray(a, np.float64)] * 3) for a in args]
    batch[0] = batch[0] + np.arange(3)[:, None] * 0.01
    th_j = jax.vmap(jp.make_theta)(*(jnp.asarray(a) for a in batch))
    got = theta_from_numpy(th_j, "cpu")
    ref = torch.func.vmap(tp.make_theta)(*(torch.tensor(a, dtype=torch.float32) for a in batch))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == tuple(ref[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)

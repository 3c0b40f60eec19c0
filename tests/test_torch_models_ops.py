"""Port parity: unicycle model, integrators, cost terms and the warm-start
shift of ros2_mpc_tpu_torch against ros2_mpc_tpu, float32 on the CPU.

Tolerance: atol 1e-6 (and rtol 1e-6 for the obstacle sums, whose values
reach ~10 where one float32 ulp is ~1e-6); both packages evaluate the same
float32 expressions, so only rounding differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu.models import unicycle as j_unicycle
from ros2_mpc_tpu.ops import costs as j_costs
from ros2_mpc_tpu.ops import integrators as j_int
from ros2_mpc_tpu.solver.warmstart import shift_controls as j_shift
from ros2_mpc_tpu_torch.models import unicycle as t_unicycle
from ros2_mpc_tpu_torch.ops import costs as t_costs
from ros2_mpc_tpu_torch.ops import integrators as t_int
from ros2_mpc_tpu_torch.solver.warmstart import shift_controls as t_shift

ATOL = 1e-6
DT = 0.2


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    got = fn_t(*(torch.from_numpy(a) for a in arrays))
    ref = fn_j(*(jnp.asarray(a) for a in arrays))
    return np.asarray(got), np.asarray(ref)


def test_unicycle_f_matches_jax():
    rng = np.random.default_rng(0)
    x, u = _rand(rng, 64, 3, scale=3.0), _rand(rng, 64, 2)
    got, ref = _both(j_unicycle.f, t_unicycle.f, x, u)
    assert got.shape == (64, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert (t_unicycle.N_STATES, t_unicycle.N_CONTROLS) == (j_unicycle.N_STATES, j_unicycle.N_CONTROLS)


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_steps_match_jax(integrator):
    rng = np.random.default_rng(1)
    x, u = _rand(rng, 64, 3), _rand(rng, 64, 2)
    step_j = {"euler": j_int.euler_step, "rk4": j_int.rk4_step}[integrator]
    step_t = {"euler": t_int.euler_step, "rk4": t_int.rk4_step}[integrator]
    got, ref = _both(
        lambda a, b: step_j(j_unicycle.f, a, b, DT), lambda a, b: step_t(t_unicycle.f, a, b, DT), x, u
    )
    np.testing.assert_allclose(got, ref, atol=ATOL)
    F_t = t_int.make_step(t_unicycle.f, integrator, DT)
    F_j = j_int.make_step(j_unicycle.f, integrator, DT)
    np.testing.assert_allclose(*_both(F_j, F_t, x, u), atol=ATOL)


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_rollout_matches_jax(integrator):
    rng = np.random.default_rng(2)
    x0, U = _rand(rng, 3), _rand(rng, 20, 2, scale=0.2)
    got, ref = _both(
        lambda a, b: j_int.rollout(j_int.make_step(j_unicycle.f, integrator, DT), a, b),
        lambda a, b: t_int.rollout(t_int.make_step(t_unicycle.f, integrator, DT), a, b),
        x0,
        U,
    )
    assert got.shape == (21, 3)
    np.testing.assert_allclose(got[0], x0)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_quadratic_and_reverse_penalty_match_jax():
    rng = np.random.default_rng(3)
    e, w, u = _rand(rng, 32, 3), np.abs(_rand(rng, 3)), _rand(rng, 32, 2, scale=0.2)
    np.testing.assert_allclose(*_both(j_costs.quadratic_error, t_costs.quadratic_error, e, w), atol=ATOL)
    got, ref = _both(lambda a: j_costs.reverse_penalty(a, 0.5), lambda a: t_costs.reverse_penalty(a, 0.5), u)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("family", ["gaussian", "barrier"])
def test_obstacle_costs_match_jax(family):
    rng = np.random.default_rng(4)
    xy = rng.uniform(-1.0, 1.0, size=(16, 2)).astype(np.float32)
    ox = rng.uniform(-1.5, 1.5, size=24).astype(np.float32)
    oy = rng.uniform(-1.5, 1.5, size=24).astype(np.float32)
    ox[12:], oy[12:] = 100.0, 100.0  # sentinel tail, as the nodes pad
    got, ref = _both(
        lambda a, b, c: j_costs.OBSTACLE_COSTS[family](a, b, c, 0.2, 0.5),
        lambda a, b, c: t_costs.OBSTACLE_COSTS[family](a, b, c, 0.2, 0.5),
        xy,
        ox,
        oy,
    )
    assert got.shape == (16,)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-6)


def test_costs_compose_with_torch_func():
    """The solver quadratizes the terms with torch.func: the Gaussian
    obstacle gradient must match jax.grad."""
    rng = np.random.default_rng(5)
    xy = rng.uniform(-0.5, 0.5, size=2).astype(np.float32)
    ox, oy = rng.uniform(-1, 1, size=8).astype(np.float32), rng.uniform(-1, 1, size=8).astype(np.float32)
    g_t = torch.func.grad(lambda p: t_costs.gaussian_obstacle_cost(p, torch.from_numpy(ox), torch.from_numpy(oy), 0.2, 5.0))(torch.from_numpy(xy))
    g_j = jax.grad(lambda p: j_costs.gaussian_obstacle_cost(p, jnp.asarray(ox), jnp.asarray(oy), 0.2, 5.0))(jnp.asarray(xy))
    np.testing.assert_allclose(np.asarray(g_t), np.asarray(g_j), atol=1e-5, rtol=1e-5)


def test_shift_controls_matches_jax():
    U = np.random.default_rng(6).standard_normal((10, 2)).astype(np.float32)
    got, ref = _both(j_shift, t_shift, U)
    np.testing.assert_array_equal(got, ref)

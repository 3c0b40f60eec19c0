"""Where the port's ``make_solver`` and the JAX package's diverge on the
bicycle sweep's scenario 7 (``tests/test_oracle_sweep.py::test_bicycle_oracle_sweep``,
seed 7): every input of the first iteration's backward pass, held against
the JAX package's on the CPU.

The port's kinematic bicycle divided by the wheelbase where XLA multiplies
by its float32 reciprocal, and a Python float against a product of 0-dim
tensors made ``torch.func.jacfwd``'s tangents float64, so the Jacobian ``B``
left the JAX package's float32 arithmetic. Both are repaired in
``models/bicycle.py``; the transition and both Jacobians now equal the JAX
package's bit for bit.

What is left apart is not an evaluation order the port's code chooses:

* ``lxx``: the Gaussian obstacle cost's Hessian equals the JAX package's
  run op by op (``jax.disable_jit``), and differs only under ``jit``, where
  XLA's CPU backend fuses its multiply-adds;
* ``lx``: the two autodiff systems sum the stage cost's cotangents in
  another order. JAX adds one product of the quadratic ``Q e`` to the
  obstacle term and then the other, PyTorch adds the two products first;
* ``luu``: their second derivatives of the barrier's ``log`` differ. JAX
  differentiates ``g / a`` as ``-t g (1 / (a a))``, PyTorch as
  ``(-t (g / a)) / a``.

The JAX package's own ``make_solver`` converges on scenario 7 only with
XLA's fusion; the same solver run op by op stops unconverged in another
basin, as the port's does (ROADMAP §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jacfwd

import oracle_banks as ob
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.ops.integrators import rollout as jrollout
from ros2_mpc_tpu.solver import make_bicycle_point_stabilization as jax_bicycle
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.ops import costs
from ros2_mpc_tpu_torch.ops.integrators import rollout
from ros2_mpc_tpu_torch.solver import SolverSettings, make_bicycle_point_stabilization

N = ob.N
SCENARIO = 7
OP_BY_OP = range(0, N, 4)  # the stages run op by op (each primitive its own XLA call: slow)
f32 = np.float32


@pytest.fixture(scope="module")
def first_iterate():
    """Both problems on scenario 7, at the solver's first iterate: the
    cleared default controls and their rollout (equal in both packages)."""
    case = ob._draw("bicycle")[SCENARIO]
    jp = jax_bicycle(JParams(), horizon=N)
    tp = make_bicycle_point_stabilization(Params(), horizon=N, device="cpu")
    jth = jp.make_theta(*case)
    tth = tp.make_theta(*(torch.as_tensor(np.asarray(a), dtype=torch.float32) for a in case))
    U = torch.zeros(N, 2)  # U0 = 0 lies inside the box: make_solver's clip keeps it
    X = rollout(tp.ocp.transition, tth["x0"], U)
    jX = np.asarray(jax.jit(lambda x0, U: jrollout(jp.ocp.transition, x0, U))(jth["x0"], U.numpy()))
    np.testing.assert_array_equal(X.numpy(), jX)
    mu = float(SolverSettings().mu_schedule()[0])
    return jp, tp, jth, tth, X[:-1], U, mu


def _stage_cost_mu(ocp, lo, hi, theta, mu, log, total):
    """make_solver's stage cost with the barrier, over z = (x, u)."""

    def lz(z, k):
        u = z[3:]
        return ocp.stage_cost(z[:3], u, k, theta) + (-mu * total(log(u - lo) + log(hi - u)))

    return lz


def _derivatives(first_iterate):
    """Per stage: (A, B, lx, lu, lxx, lux, luu) of the port, of the JAX
    package under jit and, at the OP_BY_OP stages, of the JAX package op by
    op (each third array holds those stages only)."""
    jp, tp, jth, tth, X, U, mu = first_iterate
    jlz = _stage_cost_mu(jp.ocp, jnp.asarray(jp.ocp.u_lo), jnp.asarray(jp.ocp.u_hi), jth, mu, jnp.log, jnp.sum)
    tlz = _stage_cost_mu(
        tp.ocp, torch.tensor(tp.ocp.u_lo), torch.tensor(tp.ocp.u_hi), tth, mu, torch.log, torch.sum
    )
    jF, tF = jp.ocp.transition, tp.ocp.transition

    def jder(x, u, k):
        z = jnp.concatenate([x, u])
        g, H = jax.grad(jlz)(z, k), jax.hessian(jlz)(z, k)
        A, B = jax.jacfwd(lambda xx: jF(xx, u))(x), jax.jacfwd(lambda uu: jF(x, uu))(u)
        return A, B, g[:3], g[3:], H[:3, :3], H[3:, :3], H[3:, 3:]

    def tder(x, u, k):
        z = torch.cat([x, u])
        g, H = grad(lambda zz: tlz(zz, k))(z), hessian(lambda zz: tlz(zz, k))(z)
        A, B = jacfwd(lambda xx: tF(xx, u))(x), jacfwd(lambda uu: tF(x, uu))(u)
        return A, B, g[:3], g[3:], H[:3, :3], H[3:, :3], H[3:, 3:]

    stack = lambda rows: [np.stack(v) for v in zip(*rows)]  # noqa: E731
    port = stack([[t.detach().numpy() for t in tder(X[k], U[k], k)] for k in range(N)])
    jitted = jax.jit(jder, static_argnums=2)
    on_jit = stack([[np.asarray(t) for t in jitted(X[k].numpy(), U[k].numpy(), k)] for k in range(N)])
    with jax.disable_jit():
        op_by_op = stack([[np.asarray(t) for t in jder(jnp.asarray(X[k]), jnp.asarray(U[k]), k)] for k in OP_BY_OP])
    return dict(zip(("A", "B", "lx", "lu", "lxx", "lux", "luu"), zip(port, on_jit, op_by_op)))


def test_bicycle_first_iteration_apart_only_where_named(first_iterate):
    d = _derivatives(first_iterate)
    # the transition's Jacobians: float32 and equal (B was float64 and
    # 1.5e-8 apart before the model's repair), as lu and lux
    for name in ("A", "B", "lu", "lux"):
        port, on_jit, op_by_op = d[name]
        assert port.dtype == np.float32, name
        np.testing.assert_array_equal(port, on_jit, err_msg=name)
        np.testing.assert_array_equal(port[OP_BY_OP], op_by_op, err_msg=name)
    # lxx: equal to the JAX package op by op; under jit XLA's fusion moves it
    port, on_jit, op_by_op = d["lxx"]
    np.testing.assert_array_equal(port[OP_BY_OP], op_by_op)
    assert (port != on_jit).any()
    # lx and luu: the same in both of the JAX package's modes, so not XLA's
    # fusion; each autodiff system's own rule, written out below
    for name in ("lx", "luu"):
        port, on_jit, op_by_op = d[name]
        np.testing.assert_array_equal(on_jit[OP_BY_OP], op_by_op, err_msg=name)
        assert (port != on_jit).any(), name
    _, tp, _, tth, X, U, mu = first_iterate
    Q = tth["Q"].numpy()
    for k in range(N):
        e = (X[k] - tth["goal"]).numpy()
        g_obs = grad(
            lambda x: costs.gaussian_obstacle_cost(
                x[:2], tth["obs_x"], tth["obs_y"], tth["inflation_radius"], tth["obstacle_gain"]
            )
        )(X[k]).numpy()
        qe = (Q * e).astype(f32)
        np.testing.assert_array_equal(d["lx"][1][k], (qe + (qe + g_obs).astype(f32)).astype(f32))
        np.testing.assert_array_equal(d["lx"][0][k], ((qe + qe).astype(f32) + g_obs).astype(f32))


def test_barrier_second_derivative_rules():
    """``luu``'s difference is the barrier's alone: on scenario 7's first
    controls and on spread controls, the JAX package's Hessian of
    ``-mu * sum(log(u - lo) + log(hi - u))`` is ``mu / (a a) + mu / (b b)``
    per control, PyTorch's ``(mu / a) / a + (mu / b) / b`` (a = u - lo,
    b = hi - u, float32 throughout)."""
    tp = make_bicycle_point_stabilization(Params(), horizon=N, device="cpu")
    lo, hi = np.asarray(tp.ocp.u_lo, f32), np.asarray(tp.ocp.u_hi, f32)
    mu = f32(SolverSettings().mu_schedule()[0])
    rng = np.random.default_rng(0)
    us = np.concatenate([np.zeros((1, 2)), rng.uniform(lo + 0.01, hi - 0.01, (32, 2))]).astype(f32)
    jb = lambda u: -mu * jnp.sum(jnp.log(u - lo) + jnp.log(hi - u))  # noqa: E731
    tlo, thi = torch.from_numpy(lo), torch.from_numpy(hi)
    tb = lambda u: -float(mu) * torch.sum(torch.log(u - tlo) + torch.log(thi - u))  # noqa: E731
    jH = np.stack([np.diag(np.asarray(jax.jit(jax.hessian(jb))(u))) for u in us])
    tH = np.stack([np.diag(hessian(tb)(torch.from_numpy(u)).numpy()) for u in us])
    a, b = (us - lo).astype(f32), (hi - us).astype(f32)
    jax_rule = (mu * (f32(1) / (a * a)).astype(f32)).astype(f32) + (mu * (f32(1) / (b * b)).astype(f32)).astype(f32)
    torch_rule = ((mu / a).astype(f32) / a).astype(f32) + ((mu / b).astype(f32) / b).astype(f32)
    np.testing.assert_array_equal(jH, jax_rule.astype(f32))
    np.testing.assert_array_equal(tH, torch_rule.astype(f32))
    assert (jH != tH).any()

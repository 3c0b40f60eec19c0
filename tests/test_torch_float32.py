"""The port's derivatives stay in float32, as the JAX package's do under XLA,
for every problem factory; and the quadrotor's dynamics are held row by row
against the JAX package's jitted ``f`` on the CPU.

``make_solver`` (``solver/ilqr.py``) takes each derivative as
``torch.func`` returns it, with no cast: a factory whose transition or costs
leak float64 (a Python float scaling a product of 0-dim tensors makes
``jacfwd``'s tangents float64) fails here.

The quadrotor's ``f`` is evaluated below in numpy, one float32 rounding per
operation in the port's order (``_quadrotor_rows``). The port equals that
evaluation bit for bit on PyTorch's sin/cos: every value the port's own
expression decides, the float32 reciprocals of the mass and inertias and the
float32 constants, is pinned there. The JAX package's jitted ``f`` equals
the same evaluation on XLA's sin/cos, with each row's last multiply-add
either rounded once (XLA's CPU backend contracts it into a fused
multiply-add) or twice. Run op by op (``jax.disable_jit``) it equals the
evaluation without contraction. Those two causes, and only they, keep the
rows apart:

* the angular accelerations (rows 9-11) read no sin/cos, so each element
  equals the port's bit for bit or, where XLA fused ``tau - (dJ w) w``,
  the single rounding of the port's own operands;
* velocity and Euler rates (rows 3-8) read sin/cos, where XLA's and
  PyTorch's float32 results are one ulp apart on a few percent of angles.
  They are held at ``ROW_ULPS`` float32 epsilons of the sum of each row's
  term magnitudes: up to three sin/cos factors a term, each one ulp apart
  between the libraries, and the one rounding the contraction saves.

The contraction is XLA's choice, not the port's: on a few percent of the
draws below, the first two angular accelerations differ from the jitted ``f`` by
that one rounding.

Inputs are made with numpy from a seed at a small horizon.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd, jacrev, vmap

from ros2_mpc_tpu.models import quadrotor as j_quad
from ros2_mpc_tpu.ops.integrators import make_step as j_make_step
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.models import bicycle as t_bicycle
from ros2_mpc_tpu_torch.models import quadrotor as t_quad
from ros2_mpc_tpu_torch.ops.grid import reciprocal_f32

N = 8
FAST = ts.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
ROW_ULPS = 4
f32 = np.float32
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors through many ops: under the suite's parallel workers
    PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _point(rng, n):
    return (rng.uniform(-0.3, 0.3, n), rng.uniform(-1.0, 1.0, 3))


def _tracking(rng, n):
    x0 = rng.uniform(-0.2, 0.2, 3)
    x_ref = np.stack([x0[0] + 0.15 * np.arange(1, N + 1) * Params().dt, np.zeros(N), np.full(N, 0.4)], axis=1)
    return (x0, x_ref, np.tile([0.15, 0.0], (N, 1)))


def _quadrotor(rng, n):
    x0 = np.concatenate([rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.2, 0.2, 9)])
    return (x0, rng.uniform(-0.5, 0.5, 4))


FACTORIES = {  # name: (problem on the CPU, theta inputs from a numpy Generator)
    "point": (lambda: ts.make_point_stabilization(Params(), horizon=N, settings=FAST, device="cpu"), _point),
    "tracking": (lambda: ts.make_tracking(Params(), horizon=N, settings=FAST, device="cpu"), _tracking),
    "legacy": (lambda: ts.make_legacy_point_stabilization(Params(), horizon=N, settings=FAST, device="cpu"), _point),
    "bicycle": (lambda: ts.make_bicycle_point_stabilization(Params(), horizon=N, settings=FAST, device="cpu"), _point),
    "smooth": (lambda: ts.make_smooth_point_stabilization(Params(), horizon=N, settings=FAST, device="cpu"), _point),
    "quadrotor": (lambda: ts.make_quadrotor_hover(horizon=N, settings=FAST, device="cpu"), _quadrotor),
}


def _problem(name, seed=0):
    build, inputs = FACTORIES[name]
    prob = build()
    rng = np.random.default_rng(seed)
    theta = prob.make_theta(*(torch.as_tensor(a, dtype=torch.float32) for a in inputs(rng, prob.ocp.n_states)))
    return prob, theta, rng


def _xu(rng, ocp, *shape):
    lo, hi = np.asarray(ocp.u_lo), np.asarray(ocp.u_hi)
    x = 0.3 * rng.standard_normal((*shape, ocp.n_states))
    u = lo + (hi - lo) * rng.uniform(0.2, 0.8, (*shape, ocp.n_controls))
    return torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(u, dtype=torch.float32)


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_transition_and_jacobians_are_float32(name):
    prob, _, rng = _problem(name)
    F = prob.ocp.transition
    x, u = _xu(rng, prob.ocp)
    assert F(x, u).dtype == torch.float32
    for J in (jacfwd(F, argnums=(0, 1))(x, u), jacrev(F, argnums=(0, 1))(x, u)):
        assert [j.dtype for j in J] == [torch.float32] * 2, name
    xb, ub = _xu(rng, prob.ocp, 4)
    A, B = vmap(jacrev(F, argnums=(0, 1)))(xb, ub)
    assert (A.dtype, B.dtype) == (torch.float32, torch.float32)
    assert A.shape == (4, prob.ocp.n_states, prob.ocp.n_states)


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_cost_hessians_are_float32(name):
    prob, theta, rng = _problem(name)
    ocp, n = prob.ocp, prob.ocp.n_states
    x, u = _xu(rng, ocp)
    H = hessian(lambda z: ocp.stage_cost(z[:n], z[n:], 0, theta))(torch.cat([x, u]))
    P = hessian(lambda xx: ocp.terminal_cost(xx, theta))(x)
    assert (H.dtype, P.dtype) == (torch.float32, torch.float32)
    assert bool(torch.isfinite(H).all()) and bool(torch.isfinite(P).all())


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_make_solver_solution_is_float32(name):
    prob, theta, _ = _problem(name)
    sol = prob.solve(theta, prob.default_u0)
    for field in ("U", "X", "cost", "kkt_residual", "reg"):
        v = getattr(sol, field)
        assert v.dtype == torch.float32, field
        assert bool(torch.isfinite(v).all()), field
    assert sol.U.shape == (N, prob.ocp.n_controls) and sol.X.shape == (N + 1, prob.ocp.n_states)


def _quadrotor_rows(x, u, sin, cos, fused):
    """The quadrotor's ``f`` in float32 numpy, the port's operation order,
    on the given sin/cos; ``fused`` rounds each row's last multiply-add
    once, as a fused multiply-add does."""
    if fused:
        mul_add = lambda a, b, c: f32(np.float64(a) * np.float64(b) + np.float64(c))  # noqa: E731
    else:
        mul_add = lambda a, b, c: a * b + c  # noqa: E731
    mass, (Jx, Jy, Jz) = 0.5, (2.3e-3, 2.3e-3, 4.0e-3)
    phi, th, psi = x[:, 6], x[:, 7], x[:, 8]
    wx, wy, wz = x[:, 9], x[:, 10], x[:, 11]
    cphi, sphi, cth, sth, cpsi, spsi = cos(phi), sin(phi), cos(th), sin(th), cos(psi), sin(psi)
    a = u[:, 0] * f32(reciprocal_f32(mass))
    tth = sth / cth
    rows = [
        a * mul_add(cpsi * sth, cphi, spsi * sphi),
        a * mul_add(spsi * sth, cphi, -(cpsi * sphi)),
        mul_add(a, cth * cphi, -f32(t_quad.GRAVITY)),
        mul_add(cphi * tth, wz, mul_add(sphi * tth, wy, wx)),
        mul_add(cphi, wy, -(sphi * wz)),
        mul_add(sphi, wy, cphi * wz) / cth,
        mul_add(-(f32(Jz - Jy) * wy), wz, u[:, 1]) * f32(reciprocal_f32(Jx)),
        mul_add(-(f32(Jx - Jz) * wz), wx, u[:, 2]) * f32(reciprocal_f32(Jy)),
        mul_add(-(f32(Jy - Jx) * wx), wy, u[:, 3]) * f32(reciprocal_f32(Jz)),
    ]
    return np.concatenate([x[:, 3:6], np.stack(rows, axis=1)], axis=1)


def _row_scale(x, u):
    """Per element and row 3-8, the sum of the magnitudes of the row's terms."""
    phi, th, wx, wy, wz = x[:, 6], x[:, 7], x[:, 9], x[:, 10], x[:, 11]
    a = np.abs(2.0 * u[:, 0])
    tth = np.abs(np.tan(th))
    s, c, ct = np.abs(np.sin(phi)), np.abs(np.cos(phi)), np.abs(np.cos(th))
    return np.stack(
        [
            2.0 * a,
            2.0 * a,
            a + t_quad.GRAVITY,
            np.abs(wx) + (s * np.abs(wy) + c * np.abs(wz)) * tth,
            c * np.abs(wy) + s * np.abs(wz),
            (s * np.abs(wy) + c * np.abs(wz)) / ct,
        ],
        axis=1,
    )


def test_quadrotor_rows_against_jax():
    rng = np.random.default_rng(14)
    B = 256
    x = (0.5 * rng.standard_normal((B, 12))).astype(f32)
    u = np.concatenate([0.5 * 9.81 + 0.3 * rng.standard_normal((B, 1)), 0.01 * rng.standard_normal((B, 3))], 1)
    u = u.astype(f32)
    port = t_quad.make_f()(torch.from_numpy(x), torch.from_numpy(u)).numpy()
    jitted = np.asarray(jax.jit(j_quad.make_f())(x, u))
    with jax.disable_jit():
        op_by_op = np.asarray(j_quad.make_f()(jnp.asarray(x), jnp.asarray(u)))
    t_sin, t_cos = (lambda v, fn=fn: fn(torch.from_numpy(v)).numpy() for fn in (torch.sin, torch.cos))
    x_sin, x_cos = (lambda v, fn=fn: np.asarray(jax.jit(fn)(v)) for fn in (jnp.sin, jnp.cos))

    # the port: its own expression, one rounding per operation
    np.testing.assert_array_equal(port, _quadrotor_rows(x, u, t_sin, t_cos, fused=False))
    # the JAX package: the same expression on XLA's sin/cos; jitted, each
    # row's last multiply-add rounded once or twice; op by op, twice (rows
    # 3-8 only: op by op divides by the inertias, jitted it multiplies by
    # their float32 reciprocals, as the port does)
    xla_fused = _quadrotor_rows(x, u, x_sin, x_cos, fused=True)
    xla_plain = _quadrotor_rows(x, u, x_sin, x_cos, fused=False)
    assert ((jitted == xla_fused) | (jitted == xla_plain)).all()
    np.testing.assert_array_equal(op_by_op[:, 3:9], xla_plain[:, 3:9])

    np.testing.assert_array_equal(port[:, :3], jitted[:, :3])
    # angular accelerations: equal, or the contraction's single rounding
    fused_port = _quadrotor_rows(x, u, t_sin, t_cos, fused=True)
    assert ((jitted[:, 9:] == port[:, 9:]) | (jitted[:, 9:] == fused_port[:, 9:])).all()
    # velocities and Euler rates: sin/cos one ulp apart, and the contraction
    gap = np.abs(port[:, 3:9] - jitted[:, 3:9])
    assert (gap <= ROW_ULPS * EPS32 * _row_scale(x, u)).all(), float((gap / _row_scale(x, u)).max() / EPS32)


def test_quadrotor_jacobians_match_jax():
    """The RK4 transition's Jacobians, float32 and within 1e-6 of the JAX
    package's under jit (``B`` was float64 and 3e-5 off while the port
    divided by the mass and the inertias)."""
    rng = np.random.default_rng(3)
    jp = j_quad.make_f()
    tp = ts.make_quadrotor_hover(horizon=N, device="cpu")
    jF = j_make_step(jp, "rk4", 0.05)
    jac = jax.jit(jax.jacfwd(jF, argnums=(0, 1)))
    for _ in range(4):
        x = (0.3 * rng.standard_normal(12)).astype(f32)
        u = np.concatenate([[0.5 * 9.81], 0.01 * rng.standard_normal(3)]).astype(f32)
        A, B = jacfwd(tp.ocp.transition, argnums=(0, 1))(torch.from_numpy(x), torch.from_numpy(u))
        jA, jB = jac(x, u)
        assert (A.dtype, B.dtype) == (torch.float32, torch.float32)
        np.testing.assert_allclose(A.numpy(), np.asarray(jA), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(B.numpy(), np.asarray(jB), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("model", ["bicycle", "quadrotor"])
def test_models_make_no_tensor_per_call(model, monkeypatch):
    """A model's constants are copied to the device once; a ``torch.tensor``
    inside ``f`` would be a blocking host-to-device copy on every transition
    on the card."""
    f, n, m = (t_bicycle.make_f(0.3), 3, 2) if model == "bicycle" else (t_quad.make_f(), 12, 4)
    rng = np.random.default_rng(5)
    x, u = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32) for s in ((n,), (m,)))
    f(x, u)  # the first call copies the constants
    made = []
    for ctor in ("tensor", "as_tensor", "full", "scalar_tensor"):
        real = getattr(torch, ctor)
        monkeypatch.setattr(torch, ctor, lambda *a, _real=real, _ctor=ctor, **k: made.append(_ctor) or _real(*a, **k))
    for _ in range(3):
        f(x, u)
    jacfwd(f, argnums=(0, 1))(x, u)
    vmap(jacrev(f, argnums=(0, 1)))(x.repeat(4, 1), u.repeat(4, 1))
    assert made == []

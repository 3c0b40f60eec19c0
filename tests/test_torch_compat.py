"""The port's reference-API adapters (``ros2_mpc_tpu_torch.compat``) held
against the JAX package's (tests/test_compat.py) on the CPU, on
tests/test_compat.py's inputs: the same signatures, shapes and layouts, the
controls within 5e-4 and the cost within rtol 1e-3 (the engines' live band,
tests/test_pallas.py), the state trajectory within 1e-3. Strict mode raises
on a solve that did not converge. Each adapter solves once a package (the
port's ``make_solver`` takes ~20 s a solve on this CPU)."""

import numpy as np
import pytest
import torch

from ros2_mpc_tpu import compat as jcompat
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu_torch import compat
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.solver import Solution

N = 10
U_ATOL, COST_RTOL, X_ATOL = 5e-4, 1e-3, 1e-3
POINT_ARGS = (np.array([0, 0, 0.0]), np.array([1.0, 0.0, 0.0]))


def tracking_args(dt):
    x0 = np.array([0.0, 0.0, 0.0])
    ts = np.arange(1, N + 1) * dt
    pf = np.stack([0.15 * ts, np.zeros(N), np.zeros(N)], axis=1).flatten().reshape(-1, 1)
    puf = np.tile([0.15, 0.0], (N, 1)).flatten().reshape(-1, 1)
    return x0, pf, puf


def recorded(mpc):
    """Keep the Solution of the adapter's solve (its cost is not returned)."""
    solve, kept = mpc._solve, []

    def run(theta, U0):
        kept.append(solve(theta, U0))
        return kept[-1]

    mpc._solve = run
    return kept


@pytest.fixture(scope="module", params=["TrackingMpc", "PointStabilizationMpc", "LegacyPointStabilizationMpc"])
def solved(request):
    """(port adapter, its output, its Solution, the JAX adapter's output and Solution)."""
    name = request.param
    mpc = getattr(compat, name)(Params(), horizon=N, device="cpu")
    jmpc = getattr(jcompat, name)(JParams(), horizon=N)
    sols, jsols = recorded(mpc), recorded(jmpc)
    u0 = np.zeros((mpc.n_controls, mpc.N))  # reference layout (path_follower:186)
    args = tracking_args(mpc.dt) if name == "TrackingMpc" else POINT_ARGS
    return name, mpc, mpc.perform_mpc(u0, *args), sols[0], jmpc.perform_mpc(u0, *args), jsols[0]


def test_adapter_matches_jax(solved):
    name, mpc, out, sol, jout, jsol = solved
    assert (mpc.N, mpc.n_states, mpc.n_controls, mpc.dt) == (N, 3, 2, 0.2)
    np.testing.assert_allclose(float(sol.cost), float(jsol.cost), rtol=COST_RTOL)
    if name == "TrackingMpc":
        (x_opt, u_first), (jx, ju) = out, jout
        assert x_opt.shape == (3, N + 1) and u_first.shape == (2,)  # CasADi sol.value(X) layout
        assert u_first[0] > 0.1  # drives forward along the reference
        np.testing.assert_allclose(u_first, ju, atol=U_ATOL)
        np.testing.assert_allclose(x_opt, jx, atol=X_ATOL)
    elif name == "PointStabilizationMpc":
        assert isinstance(out, np.ndarray) and out.shape == (2,)
        assert out[0] > 0.05 and -0.05 - 1e-6 <= out[0] <= 0.15 + 1e-6  # bounds honored
        np.testing.assert_allclose(out, jout, atol=U_ATOL)
    else:
        (x_opt, u_opt), (jx, ju) = out, jout
        assert x_opt.shape == (3, N + 1) and u_opt.shape == (2, N)
        np.testing.assert_allclose(u_opt, ju, atol=U_ATOL)
        np.testing.assert_allclose(x_opt, jx, atol=X_ATOL)


def test_strict_mode_raises_on_nonconvergence(solved):
    """strict=True raises SolveError when the solve reports no convergence
    (the adapter's own check; the solve is the one of the fixture, its
    converged flag cleared)."""
    name, mpc, _, sol, _, _ = solved
    strict = getattr(compat, name)(Params(), horizon=N, device="cpu", strict=True)
    strict._solve = lambda theta, U0: Solution(**{**sol._asdict(), "converged": torch.tensor(False)})
    args = tracking_args(strict.dt) if name == "TrackingMpc" else POINT_ARGS
    with pytest.raises(compat.SolveError, match="did not converge"):
        strict.perform_mpc(np.zeros((2, N)), *args)
    strict._solve = lambda theta, U0: sol
    strict.perform_mpc(np.zeros((2, N)), *args)  # converged: no raise
    assert compat.Mpc is compat.TrackingMpc


def test_adapters_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.TrackingMpc(Params(), horizon=N)

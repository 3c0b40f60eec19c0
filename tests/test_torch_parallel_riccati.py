"""The port's horizon-parallel LQR backward pass
(``ros2_mpc_tpu_torch.solver.parallel_riccati``) against its sequential
sweep and the JAX package's (``tests/test_parallel_riccati.py``), and
``make_solver(horizon_parallel=True)`` against the sequential solver.

The LQR parity runs in float64 on both sides (JAX under
``jax.enable_x64``), so the band is the scan's own rounding:
1e-5. The solver parity is float32, at the JAX suite's band for the same
check (U atol 5e-4, cost rtol 1e-4).
"""

import numpy as np
import pytest
import torch

from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.solver.parallel_riccati import (
    LQRProblem,
    _combine,
    _reverse_scan,
    lqr_backward_parallel,
    lqr_backward_sequential,
)

LQR_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_lqr(N, n=3, m=2, seed=0):
    """tests/test_parallel_riccati.py's problem, as numpy float64."""
    rng = np.random.default_rng(seed)
    A = np.stack([np.eye(n) + 0.05 * rng.standard_normal((n, n)) for _ in range(N)])
    B = 0.2 * rng.standard_normal((N, n, m))
    lxx, luu = [], []
    for _ in range(N):
        Mx = rng.standard_normal((n, n))
        lxx.append(Mx @ Mx.T * 0.1 + 0.5 * np.eye(n))
        Mu = rng.standard_normal((m, m))
        luu.append(Mu @ Mu.T * 0.1 + 1.0 * np.eye(m))
    lux = 0.05 * rng.standard_normal((N, m, n))
    lx = rng.standard_normal((N, n))
    lu = rng.standard_normal((N, m))
    return dict(
        A=A, B=B, lxx=np.stack(lxx), lux=lux, luu=np.stack(luu), lx=lx, lu=lu,
        P_N=np.eye(n) * 2.0, p_N=rng.standard_normal(n),
    )  # fmt: skip


def _close(got, want, tol=LQR_TOL):
    for f in ("P", "p", "K", "kff"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), rtol=tol, atol=tol, err_msg=f)


@pytest.mark.parametrize("N", [1, 7, 64])
def test_parallel_matches_sequential_and_jax(N):
    import jax

    from ros2_mpc_tpu.solver import parallel_riccati as jpr

    data = random_lqr(N, seed=N)
    prob = LQRProblem(**{k: torch.as_tensor(v) for k, v in data.items()})
    par, seq = lqr_backward_parallel(prob), lqr_backward_sequential(prob)
    assert par.P.shape == (N + 1, 3, 3) and par.K.shape == (N, 2, 3) and par.P.dtype == torch.float64
    _close(par, seq)
    with jax.enable_x64(True):
        import jax.numpy as jnp

        jprob = jpr.LQRProblem(**{k: jnp.asarray(v) for k, v in data.items()})
        jpar, jseq = jpr.lqr_backward_parallel(jprob), jpr.lqr_backward_sequential(jprob)
        _close(par, jpar)
        _close(seq, jseq)


def test_reverse_scan_is_the_suffix_product():
    """Every element of the Hillis-Steele scan equals the fold of its suffix,
    e_k (x) (e_{k+1} (x) (... (x) e_{L-1})), at lengths that are and are not
    powers of two (float64, random elements with symmetric C and J)."""
    for L in (1, 2, 5, 8, 13):
        rng = np.random.default_rng(L)
        draw = lambda *s: torch.as_tensor(0.3 * rng.standard_normal(s))  # noqa: E731
        C, J = draw(L, 3, 3), draw(L, 3, 3)
        leaves = (draw(L, 3, 3), draw(L, 3), C @ C.transpose(-1, -2), draw(L, 3), J @ J.transpose(-1, -2))
        scan = _reverse_scan(leaves)
        for k in range(L):
            acc = tuple(a[L - 1] for a in leaves)
            for j in range(L - 2, k - 1, -1):
                acc = _combine(tuple(a[j] for a in leaves), acc)
            for got, want in zip(scan, acc):
                np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=1e-9, atol=1e-9)


def test_policies_minimize_the_qp():
    """Rolling out du = -K dx - kff from dx0 = 0 beats small perturbations of
    the controls on the quadratic objective (test_parallel_riccati.py:51-87)."""
    N = 16
    data = random_lqr(N, seed=7)
    prob = LQRProblem(**{k: torch.as_tensor(v) for k, v in data.items()})
    g = lqr_backward_parallel(prob)

    def cost_of(du_seq):
        dx, J = torch.zeros(3, dtype=torch.float64), 0.0
        for k in range(N):
            du = du_seq[k]
            J = J + 0.5 * dx @ prob.lxx[k] @ dx + prob.lx[k] @ dx
            J = J + 0.5 * du @ prob.luu[k] @ du + prob.lu[k] @ du + du @ prob.lux[k] @ dx
            dx = prob.A[k] @ dx + prob.B[k] @ du
        return J + 0.5 * dx @ prob.P_N @ dx + prob.p_N @ dx

    dx, dus = torch.zeros(3, dtype=torch.float64), []
    for k in range(N):
        du = -g.K[k] @ dx - g.kff[k]
        dus.append(du)
        dx = prob.A[k] @ dx + prob.B[k] @ du
    du_opt = torch.stack(dus)
    J_opt = float(cost_of(du_opt))
    rng = np.random.default_rng(3)
    for _ in range(5):
        assert J_opt <= float(cost_of(du_opt + 0.01 * torch.as_tensor(rng.standard_normal(du_opt.shape)))) + 1e-9


def test_parallel_runs_under_vmap_in_float32():
    """A batch of problems through torch.func.vmap, float32, against the
    sequential sweep (the form make_solver uses under vmap)."""
    probs = [random_lqr(9, seed=s) for s in (1, 2, 3)]
    batch = LQRProblem(**{k: torch.as_tensor(np.stack([p[k] for p in probs]), dtype=torch.float32) for k in probs[0]})
    par = torch.func.vmap(lqr_backward_parallel)(batch)
    seq = torch.func.vmap(lqr_backward_sequential)(batch)
    _close(par, seq, tol=2e-4)


def test_solver_with_horizon_parallel_backward():
    """settings.horizon_parallel routes make_solver's sweep through the scan;
    the solution matches the sequential solver (test_parallel_riccati.py:90-110)."""
    P = Params()
    N = 16
    kw = dict(barrier_stages=4, iters_per_stage=3, n_alphas=6)
    seq = ts.make_point_stabilization(P, horizon=N, settings=ts.SolverSettings(**kw), device="cpu")
    par = ts.make_point_stabilization(P, horizon=N, settings=ts.SolverSettings(horizon_parallel=True, **kw), device="cpu")
    theta = seq.make_theta(np.array([0.0, 0.0, 0.0]), np.array([1.0, 0.8, 0.5]))
    s1 = seq.solve(theta, seq.default_u0)
    s2 = par.solve(theta, par.default_u0)
    np.testing.assert_allclose(s2.U.numpy(), s1.U.numpy(), atol=5e-4)
    np.testing.assert_allclose(float(s2.cost), float(s1.cost), rtol=1e-4)

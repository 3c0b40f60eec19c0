"""Horizon-parallel LQR backward pass: a reverse log-depth scan over stages.

Port of :mod:`ros2_mpc_tpu.solver.parallel_riccati`. The sequential Riccati
sweep takes N dependent steps; this module parallelizes the inner LQR solve
over the horizon with the conditional-value-function element algebra of
Särkkä & García-Fernández, "Temporal Parallelization of Bayesian Smoothers"
(IEEE TAC 2021): each stage becomes an associative element

    e = (A, b, C, eta, J)

combined as

    D     = (I + C_i J_j)^{-1}
    A_ij  = A_j D A_i
    b_ij  = A_j D (b_i + C_i eta_j) + b_j
    C_ij  = A_j D C_i A_j^T + C_j
    eta_ij= A_i^T D^T (eta_j - J_j b_i) + eta_i
    J_ij  = A_i^T D^T J_j A_i + J_i

so a reverse scan gives every suffix value function
V_k(x) = 1/2 x^T J_k x - eta_k^T x in O(log N) depth. General quadratic
stage costs (cross terms l_ux, control-linear l_u) are reduced to that form
by completing the square in u.

PyTorch has no stable ``associative_scan``: :func:`_reverse_scan` is a
Hillis-Steele doubling written by hand, ceil(log2(N+1)) levels, each one
batched ``torch.linalg.solve`` and matmul over every stage at once.

The functions take one problem, stage-major (``A`` is (N, n, n)), and run
where their tensors lie, in their dtype; ``torch.func.vmap`` adds a batch.
For the horizons of the reference the sequential sweep is faster; the
log-depth pass is the long-horizon path. Correctness is pinned against the
sequential recursion and the JAX package in the tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LQRProblem(NamedTuple):
    """Time-varying LQR data, stage-major.

    A (N, n, n), B (N, n, m): dynamics dx' = A dx + B du
    lxx (N, n, n), lux (N, m, n), luu (N, m, m): cost Hessian blocks
    lx (N, n), lu (N, m): cost gradients
    P_N (n, n), p_N (n,): terminal value quadratic/linear terms
    """

    A: torch.Tensor
    B: torch.Tensor
    lxx: torch.Tensor
    lux: torch.Tensor
    luu: torch.Tensor
    lx: torch.Tensor
    lu: torch.Tensor
    P_N: torch.Tensor
    p_N: torch.Tensor


class LQRGains(NamedTuple):
    K: torch.Tensor  # (N, m, n)
    kff: torch.Tensor  # (N, m)
    P: torch.Tensor  # (N+1, n, n) value Hessians
    p: torch.Tensor  # (N+1, n) value gradients


def _T(M):
    return M.transpose(-1, -2)


def _mv(M, v):
    """(..., r, c) @ (..., c) -> (..., r)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _solve(M, R):
    # no singular-matrix check: that would read the device back, and a
    # singular system gives non-finite values as jnp.linalg.solve does
    return torch.linalg.solve_ex(M, R)[0]


def _gains_from_value(prob: LQRProblem, P_next, p_next):
    """Every stage's gains given V_{k+1}: the Riccati policy extraction,
    ``du = -K dx - kff``."""
    Bt = _T(prob.B)
    Qu = prob.lu + _mv(Bt, p_next)
    Quu = prob.luu + Bt @ P_next @ prob.B
    Qux = prob.lux + Bt @ P_next @ prob.A
    sol = _solve(Quu, torch.cat([Qu.unsqueeze(-1), Qux], dim=-1))
    return sol[..., 1:], sol[..., 0]


def lqr_backward_sequential(prob: LQRProblem) -> LQRGains:
    """The reference O(N) backward recursion."""
    P1, p1 = prob.P_N, prob.p_N
    N = prob.A.shape[0]
    Ps, ps = [None] * N, [None] * N
    for k in reversed(range(N)):
        A, B = prob.A[k], prob.B[k]
        At, Bt = _T(A), _T(B)
        Qx = prob.lx[k] + _mv(At, p1)
        Qu = prob.lu[k] + _mv(Bt, p1)
        Qxx = prob.lxx[k] + At @ P1 @ A
        Quu = prob.luu[k] + Bt @ P1 @ B
        Qux = prob.lux[k] + Bt @ P1 @ A
        sol = _solve(Quu, torch.cat([Qu.unsqueeze(-1), Qux], dim=-1))
        kff, K = sol[..., 0], sol[..., 1:]
        P = Qxx - _T(Qux) @ K
        p1 = Qx - _mv(_T(Qux), kff)
        P1 = 0.5 * (P + _T(P))
        Ps[k], ps[k] = P1, p1
    P_all = torch.stack(Ps + [prob.P_N])
    p_all = torch.stack(ps + [prob.p_N])
    K, kff = _gains_from_value(prob, P_all[1:], p_all[1:])
    return LQRGains(K=K, kff=kff, P=P_all, p=p_all)


def _make_elements(prob: LQRProblem):
    """Stage elements (complete the square in u, map to the LQT leaves), then
    the terminal element: pure cost, no propagation (A = 0 ends the
    dependencies)."""
    A, B, lxx, lux, luu, lx, lu = prob[:7]
    n = A.shape[-1]
    Bt, luxT = _T(B), _T(lux)
    Rinv_lux = _solve(luu, lux)  # (N, m, n)
    Rinv_lu = _solve(luu, lu.unsqueeze(-1)).squeeze(-1)  # (N, m)
    F = A - B @ Rinv_lux
    b = -_mv(B, Rinv_lu)
    C = B @ _solve(luu, Bt)
    J = lxx - luxT @ Rinv_lux
    eta = -(lx - _mv(luxT, Rinv_lu))
    zero_n = torch.zeros((1, n, n), dtype=A.dtype, device=A.device)
    return (
        torch.cat([F, zero_n]),
        torch.cat([b, torch.zeros((1, n), dtype=A.dtype, device=A.device)]),
        torch.cat([C, zero_n]),
        torch.cat([eta, -prob.p_N.unsqueeze(0)]),
        torch.cat([J, prob.P_N.unsqueeze(0)]),
    )


def _combine(left, right):
    """The associative combination, batched over leading dims; ``left`` is
    earlier in time."""
    A1, b1, C1, eta1, J1 = left
    A2, b2, C2, eta2, J2 = right
    n = A1.shape[-1]
    eye = torch.eye(n, dtype=A1.dtype, device=A1.device)
    IC1J2 = eye + C1 @ J2
    D = _solve(IC1J2, eye.expand_as(IC1J2))  # (I + C1 J2)^{-1}
    A2D = A2 @ D
    A = A2D @ A1
    b = _mv(A2D, b1 + _mv(C1, eta2)) + b2
    C = A2D @ C1 @ _T(A2) + C2
    A1tDt = _T(A1) @ _T(D)
    eta = _mv(A1tDt, eta2 - _mv(J2, b1)) + eta1
    J = A1tDt @ J2 @ A1 + J1
    J = 0.5 * (J + _T(J))
    return A, b, C, eta, J


def _reverse_scan(elems):
    """Inclusive reverse scan over the leading (stage) axis: element k of the
    result is e_k (x) e_{k+1} (x) ... (x) e_{L-1}. Hillis-Steele doubling:
    after the level with offset s, element k covers [k, k + 2s); the last s
    elements already cover the rest of the sequence and stay."""
    L = elems[0].shape[0]
    acc, s = elems, 1
    while s < L:
        combined = _combine(tuple(a[: L - s] for a in acc), tuple(a[s:] for a in acc))
        acc = tuple(torch.cat([c, a[L - s :]]) for c, a in zip(combined, acc))
        s *= 2
    return acc


def lqr_backward_parallel(prob: LQRProblem) -> LQRGains:
    """The O(log N)-depth backward pass by the reverse scan."""
    _, _, _, etas, Js = _reverse_scan(_make_elements(prob))
    P_all = Js  # (N+1, n, n): V_k's Hessian
    p_all = -etas  # (N+1, n): V_k's gradient
    K, kff = _gains_from_value(prob, P_all[1:], p_all[1:])
    return LQRGains(K=K, kff=kff, P=P_all, p=p_all)

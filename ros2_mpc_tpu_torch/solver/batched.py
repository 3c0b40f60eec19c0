"""Model-generic bank engine and the box-DDP KKT polish, on tensors.

Port of :mod:`ros2_mpc_tpu.solver.batched`. The JAX module lays the bank out
lane-major, ``(B // 128, 128)`` in the two minor dims, because XLA pads the
small minor dims of a batch-major layout to TPU tiles; that layout and its
``lanes=`` argument are not carried over. Here the bank is B-leading, any
B >= 1, and the small n x n / m x m algebra is batched ``torch.matmul``:

* states ``(B, N+1, n)``, controls ``(B, N, m)``; Jacobians ``(B, N, n, n)``
  and ``(B, N, n, m)`` from one ``torch.func.jacrev`` of the transition over
  every stage at once;
* every stage's cost gradient and Hessian from one reverse pass over the
  summed costs and one vmapped reverse-over-reverse pass (the costs are
  separable over stages and scenarios; PyTorch's forward mode runs these
  ops through slow Python decompositions); the log barrier's are added in
  closed form;
* the Riccati sweep, the Armijo line search over every step size at once,
  acceptance and Levenberg regularization per scenario.

Model-generic over small OCPs: any :class:`~.ilqr.OCP` whose ``transition``
has trailing-component batched semantics (``x[..., i]`` and
``torch.stack(..., dim=-1)``, as every model in ``models/``). The m x m
``Quu`` solve takes the closed-form 2x2 inverse for two controls and the
unrolled Cholesky :func:`_chol_solve` otherwise, with the same heavy
diagonal loading where positive-definiteness is lost. Nothing here is a
kernel: the JAX module is XLA, outside any Pallas kernel, and so is this.

Same algorithm and schedule as :func:`~.ilqr.make_solver`.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacrev, vjp, vmap

from ..device import device_constant
from .ilqr import OCP, Solution, SolverSettings

_F32 = torch.float32


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _mv(A, v):
    """(..., r, c) @ (..., c) -> (..., r)."""
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def _solve2x2(M, rhs):
    """Solve ``M X = rhs`` for a 2x2 ``M`` (..., 2, 2) with the PD safeguard
    (heavy diagonal loading where det <= 1e-12 or a diagonal entry <= 0);
    ``rhs`` is (..., 2, k). Returns ``(X, (a, b, c, d))``."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    bad = (det <= 1e-12) | (torch.minimum(a, d) <= 0.0)
    a = torch.where(bad, a + 1e3, a)
    d = torch.where(bad, d + 1e3, d)
    det = torch.where(bad, a * d - b * c, det)
    inv_det = (1.0 / det).unsqueeze(-1)
    r0, r1 = rhs[..., 0, :], rhs[..., 1, :]
    x0 = (d.unsqueeze(-1) * r0 - b.unsqueeze(-1) * r1) * inv_det
    x1 = (a.unsqueeze(-1) * r1 - c.unsqueeze(-1) * r0) * inv_det
    return torch.stack([x0, x1], dim=-2), (a, b, c, d)


def _chol_factor(M):
    """Unrolled Cholesky of (..., m, m). Returns ``(L, min_pivot)``: ``L[i][k]``
    (k <= i) are the factor's components, each (...,), and ``min_pivot`` the
    smallest diagonal pivot before the sqrt clamp (the PD certificate)."""
    m = M.shape[-1]
    L = [[None] * m for _ in range(m)]
    min_piv = None
    for i in range(m):
        s = M[..., i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        min_piv = s if min_piv is None else torch.minimum(min_piv, s)
        d = torch.sqrt(torch.clamp(s, min=1e-20))
        L[i][i] = d
        inv_d = 1.0 / d
        for j in range(i + 1, m):
            t = M[..., j, i]
            for k in range(i):
                t = t - L[j][k] * L[i][k]
            L[j][i] = t * inv_d
    return L, min_piv


def _chol_solve(M, rhs):
    """Solve ``M X = rhs`` for an m x m ``M`` (..., m, m) via the unrolled
    Cholesky; ``rhs`` is (..., m, k). A matrix whose factorization shows a
    pivot <= 1e-12 is solved as ``M + 1e3 I`` instead, the 2x2 path's
    loading. Every matrix is factorized as it is and loaded, and the loaded
    factor taken where a pivot showed lost positive-definiteness, as the
    JAX module does: factorizing only the rows that lost it would need their
    count on the host, a read back every Riccati stage that a fleet's device
    loop must not make."""
    m = M.shape[-1]
    L, min_piv = _chol_factor(M)
    bad = min_piv <= 1e-12
    L_load, _ = _chol_factor(M + 1e3 * torch.eye(m, dtype=M.dtype, device=M.device))
    L = [
        [None if comp is None else torch.where(bad, load, comp) for comp, load in zip(row, row_load)]
        for row, row_load in zip(L, L_load)
    ]
    y = [None] * m
    for i in range(m):  # forward substitution: L y = rhs
        t = rhs[..., i, :]
        for k in range(i):
            t = t - L[i][k].unsqueeze(-1) * y[k]
        y[i] = t / L[i][i].unsqueeze(-1)
    x = [None] * m
    for i in reversed(range(m)):  # back substitution: L^T x = y
        t = y[i]
        for k in range(i + 1, m):
            t = t - L[k][i].unsqueeze(-1) * x[k]
        x[i] = t / L[i][i].unsqueeze(-1)
    return torch.stack(x, dim=-2)


def _solve_quu(Quu, rhs):
    return _solve2x2(Quu, rhs)[0] if Quu.shape[-1] == 2 else _chol_solve(Quu, rhs)


def _probe_batch_semantics(F, n, m):
    """Build-time guard: the engine hands ``F`` arrays with leading batch
    dims and trusts broadcasting. A transition written with scalar-only
    semantics (``x[2]`` for ``x[..., 2]``) would give silently wrong banks;
    one 2x2 probe against ``vmap(vmap(F))`` catches it."""
    xt = torch.linspace(-0.3, 0.3, n * 4, dtype=_F32).reshape(n, 2, 2).movedim(0, -1)
    ut = torch.linspace(-0.1, 0.1, m * 4, dtype=_F32).reshape(m, 2, 2).movedim(0, -1)
    try:
        batched = F(xt, ut)
    except Exception as e:  # shape errors vary by model
        raise ValueError(
            "the bank engine needs a transition with (..., n) batched semantics "
            f"(models/ style); F raised on a batched probe: {e}"
        ) from e
    looped = vmap(vmap(F))(xt, ut)
    if batched.shape != looped.shape or not bool(torch.allclose(batched, looped, atol=1e-5)):
        raise ValueError(
            "the bank engine needs a transition with (..., n) batched semantics: "
            "F(x_batch, u_batch) disagrees with vmap(F) on a probe"
        )


class _BankTerms:
    """One OCP's bank-level pieces on B-leading tensors: rollouts, true cost,
    the KKT residual, and the quadratization of every stage at once.
    ``theta`` leaves and states lead with B."""

    def __init__(self, ocp: OCP):
        self.ocp = ocp
        self.F = ocp.transition
        self.stage = [vmap(lambda x, u, th, k=k: ocp.stage_cost(x, u, k, th)) for k in range(ocp.horizon)]
        # the line search's candidates: (A, B, ...) states and controls, theta (B, ...)
        self.stage2 = [vmap(s, in_dims=(0, 0, None)) for s in self.stage]
        self.terminal = vmap(ocp.terminal_cost)
        self.terminal2 = vmap(self.terminal, in_dims=(0, None))
        self.dyn_jac = vmap(jacrev(self.F, argnums=(0, 1)))

    def rollout(self, U, theta, barrier=None):
        """X (B, N+1, n) and the cost (B,) of U (B, N, m): the true cost, or
        with ``barrier = (lo, hi, mu)`` the barrier cost."""
        x = theta["x0"]
        X, J = [x], 0.0
        for k in range(self.ocp.horizon):
            c = self.stage[k](x, U[:, k], theta)
            J = J + (c if barrier is None else c + _barrier(U[:, k], *barrier))
            x = self.F(x, U[:, k])
            X.append(x)
        return torch.stack(X, dim=1), J + self.terminal(x, theta)

    def true_cost(self, U, theta):
        return self.rollout(U, theta)[1]

    def kkt(self, U, theta, lo, hi):
        """Projected-gradient infinity norm of the true cost, per scenario."""
        g = grad(lambda UU: self.true_cost(UU, theta).sum())(U)
        return (U - torch.clamp(U - g, lo, hi)).abs().amax(dim=(1, 2))

    def derivs(self, X, U, theta):
        """A (B,N,n,n), Bm (B,N,n,m), the true-cost terms of each stage
        [(lx, lu, lxx, lux, luu)], and the terminal gradient and Hessian.

        The costs are separable over stages and scenarios, so one gradient
        of their sum gives every stage's gradient, and one vector-Hessian
        product with the cotangent e_i on every stage and scenario gives
        row i of every stage's Hessian: n+m such products in one vmap, in
        place of a Hessian call per stage."""
        B, N = U.shape[0], self.ocp.horizon
        n, m = self.ocp.n_states, self.ocp.n_controls
        A, Bm = self.dyn_jac(X[:, :-1].reshape(B * N, n), U.reshape(B * N, m))
        A, Bm = A.reshape(B, N, n, n), Bm.reshape(B, N, n, m)

        def total(Z, xN):
            c = sum(self.stage[k](Z[:, k, :n], Z[:, k, n:], theta).sum() for k in range(N))
            return c + self.terminal(xN, theta).sum()

        Z, xN = torch.cat([X[:, :-1], U], dim=-1), X[:, -1]
        (g, gN), vhp = vjp(grad(total, argnums=(0, 1)), Z, xN)
        eye, eyeN = torch.eye(n + m, dtype=Z.dtype, device=Z.device), torch.eye(n, dtype=Z.dtype, device=Z.device)
        H = vmap(lambda t: vhp((t.expand_as(Z), torch.zeros_like(xN)))[0])(eye[:, None, None, :])
        HN = vmap(lambda t: vhp((torch.zeros_like(Z), t.expand_as(xN)))[1])(eyeN[:, None, :])
        H, HN = H.permute(1, 2, 0, 3), HN.permute(1, 0, 2)  # (B, N, row, col), (B, row, col)
        terms = [
            (g[:, k, :n], g[:, k, n:], _sym(H[:, k, :n, :n]), H[:, k, n:, :n], _sym(H[:, k, n:, n:]))
            for k in range(N)
        ]
        return A, Bm, terms, gN, _sym(HN)


def _riccati(Vx, Vxx, A_k, B_k, lx, lu, lxx, lux, luu, reg):
    """The Q-function of one stage: (Qx, Qu, Qxx, Qux, Quu) with ``reg`` on
    Quu's diagonal."""
    At, Bt = A_k.transpose(-1, -2), B_k.transpose(-1, -2)
    Qx = lx + _mv(At, Vx)
    Qu = lu + _mv(Bt, Vx)
    VxxA = Vxx @ A_k
    Qxx = lxx + At @ VxxA
    Qux = lux + Bt @ VxxA
    eye = torch.eye(Qu.shape[-1], dtype=Qu.dtype, device=Qu.device)
    Quu = _sym(luu + Bt @ (Vxx @ B_k) + reg * eye)
    return Qx, Qu, Qxx, Qux, Quu


def _value_step(Qx, Qu, Qxx, Qux, Quu):
    """Gains and the value function one stage back."""
    sol = _solve_quu(Quu, torch.cat([Qu.unsqueeze(-1), Qux], dim=-1))
    kff, K = -sol[..., 0], -sol[..., 1:]
    Kt, QuxT = K.transpose(-1, -2), Qux.transpose(-1, -2)
    Quu_k = _mv(Quu, kff)
    Vx = Qx + _mv(Kt, Quu_k) + _mv(Kt, Qu) + _mv(QuxT, kff)
    Vxx = _sym(Qxx + Kt @ (Quu @ K) + Kt @ Qux + QuxT @ K)
    return kff, K, Quu_k, Vx, Vxx


def _candidates(t: _BankTerms, U, X, kffs, Ks, theta, alphas, lo, hi, eps, mu=None):
    """Every step size's closed-loop candidate in one sweep: controls
    (A, B, N, m) clipped into ``[lo + eps, hi - eps]``, and with ``mu`` their
    barrier costs (A, B)."""
    A = alphas.shape[0]
    al = alphas.reshape(A, 1, 1)
    xs = theta["x0"].unsqueeze(0).expand(A, *theta["x0"].shape)
    J, cand = 0.0, []
    for k in range(U.shape[1]):
        dx = xs - X[:, k]
        u = U[:, k] + al * kffs[k] + _mv(Ks[k], dx)
        u = torch.clamp(u, lo + eps, hi - eps)
        if mu is not None:
            J = J + (t.stage2[k](xs, u, theta) + _barrier(u, lo, hi, mu))
        cand.append(u)
        xs = t.F(xs, u)
    U_cand = torch.stack(cand, dim=2)
    if mu is None:
        return U_cand, None
    return U_cand, J + t.terminal2(xs, theta)


def _barrier(u, lo, hi, mu):
    return -mu * torch.sum(torch.log(u - lo) + torch.log(hi - u), dim=-1)


def _pick(U_cand, idx):
    """U_cand (A, B, N, m), idx (B,) -> (B, N, m)."""
    return U_cand[idx, torch.arange(U_cand.shape[1], device=idx.device)]


def _bank_size(thetas, U0s):
    B = U0s.shape[0]
    if B < 1 or any(v.shape[0] != B for v in thetas.values()):
        raise ValueError(f"thetas and U0s must share a leading bank dimension >= 1, U0s has {B}")
    return B


def make_bank_solver_fast(ocp: OCP, settings: SolverSettings = SolverSettings()):
    """Build ``solve_bank(thetas, U0s) -> Solution`` over a B-leading bank
    (any B >= 1): the log-barrier interior-point iLQR of
    :func:`~.ilqr.make_solver` on the whole bank at once. ``thetas`` is a
    dict of (B, ...) tensors, ``U0s`` (B, N, m), on one device. A build-time
    probe rejects transitions with scalar-only semantics."""
    N, n, m = ocp.horizon, ocp.n_states, ocp.n_controls
    _probe_batch_semantics(ocp.transition, n, m)
    t = _BankTerms(ocp)
    mus = [float(mu) for mu in settings.mu_schedule()]
    n_alphas = settings.n_alphas
    u_lo, u_hi = device_constant(ocp.u_lo), device_constant(ocp.u_hi)

    def solve_bank(thetas, U0s):
        B = _bank_size(thetas, U0s)
        dev = U0s.device
        lo, hi = u_lo(dev), u_hi(dev)
        alphas = 0.5 ** torch.arange(n_alphas, dtype=_F32, device=dev)
        eps = settings.interior_clip * (hi - lo)
        eps0 = 1e-3 * (hi - lo)
        U = torch.clamp(U0s.to(_F32), lo + eps0, hi - eps0)
        reg = torch.full((B,), settings.reg_init, dtype=_F32, device=dev)
        for mu in mus:
            X, J = t.rollout(U, thetas, (lo, hi, mu))
            A, Bm, terms, Vx, Vxx = t.derivs(X, U, thetas)
            dV1 = dV2 = torch.zeros(B, dtype=_F32, device=dev)
            kffs, Ks = [None] * N, [None] * N
            for k in reversed(range(N)):
                lx, lu, lxx, lux, luu = terms[k]
                s_lo, s_hi = U[:, k] - lo, hi - U[:, k]
                lu = lu - mu * (1.0 / s_lo - 1.0 / s_hi)
                luu = luu + torch.diag_embed(mu * (1.0 / (s_lo * s_lo) + 1.0 / (s_hi * s_hi)))
                Q = _riccati(Vx, Vxx, A[:, k], Bm[:, k], lx, lu, lxx, lux, luu, reg[:, None, None])
                kffs[k], Ks[k], Quu_k, Vx, Vxx = _value_step(*Q)
                dV1 = dV1 + (kffs[k] * Q[1]).sum(-1)
                dV2 = dV2 + 0.5 * (kffs[k] * Quu_k).sum(-1)
            U_cand, J_cand = _candidates(t, U, X, kffs, Ks, thetas, alphas, lo, hi, eps, mu)
            exp_red = -(alphas[:, None] * dV1 + (alphas * alphas)[:, None] * dV2)
            J_cand = torch.where(torch.isnan(J_cand), torch.inf, J_cand)
            accept = J_cand <= J - settings.armijo_c1 * torch.clamp(exp_red, min=0.0)
            any_acc = accept.any(dim=0)
            first = torch.argmax(accept.to(torch.int32), dim=0)  # largest accepted step
            U = torch.where(any_acc[:, None, None], _pick(U_cand, first), U)
            reg = torch.where(
                any_acc,
                torch.clamp(reg * 0.5, min=settings.reg_min),
                torch.clamp(reg * 10.0 + settings.reg_min, max=settings.reg_max),
            )
        X, J = t.rollout(U, thetas)
        kkt = t.kkt(U, thetas, lo, hi)
        return Solution(
            U=U,
            X=X,
            cost=J,
            kkt_residual=kkt,
            converged=kkt < settings.kkt_tol,
            n_iters=torch.full((B,), settings.total_iters, dtype=torch.int32, device=dev),
            reg=reg,
        )

    return solve_bank


def make_bank_kkt_polish(
    ocp: OCP,
    *,
    n_iters: int = 12,
    n_alphas: int = 5,
    reg: float = 1e-7,
    bound_tol: float = 1e-5,
    kkt_tol: float = SolverSettings().kkt_tol,
):
    """Last-mile KKT-descent polish: converge the rows float32 Armijo cannot.

    The stragglers of the interior-point engines on obstacle-cliff banks sit
    at KKT ~1e-4 with a channel pinned at its bound, whose barrier curvature
    poisons the free channel's Newton direction, and at costs where the last
    improvement is below float32 cost resolution. Two changes:

    * **box-DDP active-set masking**: a channel at its bound whose gradient
      pushes outward leaves ``Quu``/``Qux``/``Qu`` (unit diagonal), so the
      direction is exact on the free subspace;
    * **acceptance on the projected-gradient norm**: a candidate is taken
      only if it strictly lowers the KKT residual, so each row's residual
      is monotone non-increasing.

    Returns ``polish(thetas, U0s) -> Solution`` over a B-leading bank (any
    B >= 1); ``U0s`` is the warm start being polished.
    """
    N, n, m = ocp.horizon, ocp.n_states, ocp.n_controls
    _probe_batch_semantics(ocp.transition, n, m)
    t = _BankTerms(ocp)
    u_lo, u_hi = device_constant(ocp.u_lo), device_constant(ocp.u_hi)

    def polish_bank(thetas, U0s):
        B = _bank_size(thetas, U0s)
        dev = U0s.device
        lo, hi = u_lo(dev), u_hi(dev)
        alphas = 0.5 ** torch.arange(n_alphas, dtype=_F32, device=dev)
        eps = 1e-7 * (hi - lo)
        tol_b = bound_tol * (hi - lo)
        U = torch.clamp(U0s.to(_F32), lo + eps, hi - eps)
        k_best = t.kkt(U, thetas, lo, hi)
        # every candidate's residual in one call: the bank repeated per step
        big = {k: v.repeat(n_alphas, *([1] * (v.dim() - 1))) for k, v in thetas.items()}
        for _ in range(n_iters):
            X = t.rollout(U, thetas)[0]
            A, Bm, terms, Vx, Vxx = t.derivs(X, U, thetas)
            kffs, Ks = [None] * N, [None] * N
            for k in reversed(range(N)):
                Qx, Qu, Qxx, Qux, Quu = _riccati(Vx, Vxx, A[:, k], Bm[:, k], *terms[k], reg)
                # box-DDP: a channel at a bound with an outward gradient is pinned
                u_k = U[:, k]
                act = ((u_k <= lo + tol_b) & (Qu > 0)) | ((u_k >= hi - tol_b) & (Qu < 0))
                free = 1.0 - act.to(Qu.dtype)
                Qu = Qu * free
                Qux = Qux * free.unsqueeze(-1)
                Quu = Quu * (free.unsqueeze(-1) * free.unsqueeze(-2)) + torch.diag_embed(1.0 - free)
                kffs[k], Ks[k], _, Vx, Vxx = _value_step(Qx, Qu, Qxx, Qux, Quu)
            U_cand = _candidates(t, U, X, kffs, Ks, thetas, alphas, lo, hi, eps)[0]
            k_cand = t.kkt(U_cand.reshape(n_alphas * B, N, m), big, lo, hi).reshape(n_alphas, B)
            k_new = k_cand.amin(dim=0)
            better = k_new < k_best
            U = torch.where(better[:, None, None], _pick(U_cand, torch.argmin(k_cand, dim=0)), U)
            k_best = torch.where(better, k_new, k_best)
        X, J = t.rollout(U, thetas)
        return Solution(
            U=U,
            X=X,
            cost=J,
            kkt_residual=k_best,
            converged=k_best < kkt_tol,
            n_iters=torch.full((B,), n_iters, dtype=torch.int32, device=dev),
            reg=torch.full((B,), reg, dtype=_F32, device=dev),
        )

    return polish_bank

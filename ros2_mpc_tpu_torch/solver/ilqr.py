"""Interior-point iLQR on tensors: port of :mod:`ros2_mpc_tpu.solver.ilqr`.

The same primal log-barrier iLQR as the JAX package, one-to-one:

* **single shooting**: the dynamics are eliminated by an exact rollout of
  the same integrator, leaving ``min_U J(U)  s.t.  lo <= u_k <= hi``;
* **barrier continuation**: bounds enter as ``-mu * sum(log(u-lo)+log(hi-u))``
  with ``mu`` driven down a geometric schedule;
* **Riccati sweeps**: stage costs are quadratized with exact
  ``torch.func.hessian``, dynamics linearized with ``torch.func.jacfwd``,
  then a backward Riccati recursion and a feedback forward rollout;
* **line search**: every step size in ``0.5 ** arange(n_alphas)`` is rolled
  out and the largest Armijo-accepted one wins.

``make_solver`` is the algorithmic reference of the port, the engine behind
``Problem.solve`` and the single-robot tick engine. It solves one scenario;
``torch.func.vmap(solve)`` adds the scenario batch axis. Nothing here is a
kernel: the hand-written CUDA bank solvers live in
:mod:`ros2_mpc_tpu_torch.solver.cuda_kernel`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd


class OCP(NamedTuple):
    """An optimal-control-problem template (static part).

    ``stage_cost(x, u, k, theta)`` takes the stage index ``k`` as a Python
    int in ``[0, N)``. The discretization step ``dt`` is not a field: the CUDA
    builders recover it by probing ``transition`` once, as the TPU kernels
    do."""

    transition: Callable  # F(x, u) -> x_next  (discrete dynamics)
    stage_cost: Callable  # l(x, u, k, theta) -> scalar, k in [0, N)
    terminal_cost: Callable  # lf(x, theta) -> scalar
    horizon: int
    n_states: int
    n_controls: int
    u_lo: tuple
    u_hi: tuple
    # formulation facts hand-derived kernels must mirror ("wrap_yaw": the
    # tracking kernel wraps the yaw error in its analytic derivatives)
    meta: tuple = ()


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Fixed-iteration interior-point schedule."""

    mu_init: float = 1e-1
    mu_final: float = 1e-8
    barrier_stages: int = 10
    iters_per_stage: int = 6
    n_alphas: int = 10
    reg_init: float = 1e-6
    reg_min: float = 1e-9
    reg_max: float = 1e8
    armijo_c1: float = 1e-4
    interior_clip: float = 1e-7  # fraction of (hi-lo) kept as strict slack
    kkt_tol: float = 1e-4
    # the backward sweep through the O(log N)-depth reverse scan of
    # parallel_riccati.py (regularization on l_uu, no Quu safeguard: the
    # JAX package's horizon-parallel path)
    horizon_parallel: bool = False

    @property
    def total_iters(self) -> int:
        return self.barrier_stages * self.iters_per_stage

    @classmethod
    def fast(cls) -> "SolverSettings":
        """~2x fewer iterations than the default schedule."""
        return cls(barrier_stages=8, iters_per_stage=4, n_alphas=6)

    @classmethod
    def realtime(cls) -> "SolverSettings":
        """Low-latency profile for warm-started closed-loop ticks."""
        return cls(barrier_stages=4, iters_per_stage=3, n_alphas=6, mu_init=1e-2)

    def mu_schedule(self) -> np.ndarray:
        """Per-iteration barrier parameter, float32: geometric from mu_init to
        mu_final (computed in float64, then cast), held within each stage."""
        stages = np.logspace(np.log10(self.mu_init), np.log10(self.mu_final), self.barrier_stages)
        return np.repeat(stages, self.iters_per_stage).astype(np.float32)


class Solution(NamedTuple):
    """A solve's result; batched solvers add a leading scenario axis.

    ``n_iters``: for :func:`make_solver`, the schedule length. For the CUDA
    bank solvers and their plain versions, the iterations each scenario
    actually executed: every scenario leaves a converged barrier stage on its
    own, so the count is per scenario (the TPU kernel's exits, and its
    count, were per (8, 128) tile of scenarios)."""

    U: torch.Tensor  # (N, m) optimal controls
    X: torch.Tensor  # (N+1, n) optimal state trajectory
    cost: torch.Tensor  # scalar objective (without barrier)
    kkt_residual: torch.Tensor  # projected-gradient infinity norm
    converged: torch.Tensor  # bool: kkt_residual < settings.kkt_tol
    n_iters: torch.Tensor  # executed or scheduled iterations (see above)
    reg: torch.Tensor  # final Levenberg regularization


def _symmetrize(M):
    return 0.5 * (M + M.transpose(-1, -2))


def make_solver(ocp: OCP, settings: SolverSettings = SolverSettings()):
    """Build ``solve(theta, U0) -> Solution`` for one OCP template.

    ``theta`` is a dict of tensors (initial state, references, obstacle
    vectors, weights), all on ``U0``'s device. The function is composable
    with ``torch.func.vmap(solve)`` for scenario batches."""
    N, n, m = ocp.horizon, ocp.n_states, ocp.n_controls
    F = ocp.transition
    mus = [float(mu) for mu in settings.mu_schedule()]
    alpha_list = [0.5**a for a in range(settings.n_alphas)]

    def solve(theta, U0):
        dev = U0.device
        f32 = torch.float32
        u_lo = torch.tensor(ocp.u_lo, dtype=f32, device=dev)
        u_hi = torch.tensor(ocp.u_hi, dtype=f32, device=dev)
        u_range = u_hi - u_lo
        eye = torch.eye(m, dtype=f32, device=dev)
        alphas = torch.tensor(alpha_list, dtype=f32, device=dev)
        x0 = theta["x0"]

        def barrier(u, mu):
            return -mu * torch.sum(torch.log(u - u_lo) + torch.log(u_hi - u))

        def stage_cost_mu(x, u, k, mu):
            return ocp.stage_cost(x, u, k, theta) + barrier(u, mu)

        def rollout_and_cost(U, mu):
            x, acc, X = x0, 0.0, [x0]
            for k in range(N):
                acc = acc + stage_cost_mu(x, U[k], k, mu)
                x = F(x, U[k])
                X.append(x)
            return torch.stack(X), acc + ocp.terminal_cost(x, theta)

        def true_cost(U):
            x, acc = x0, 0.0
            for k in range(N):
                acc = acc + ocp.stage_cost(x, U[k], k, theta)
                x = F(x, U[k])
            return acc + ocp.terminal_cost(x, theta)

        def stage_derivs(x, u, k, mu):
            A = jacfwd(lambda xx: F(xx, u))(x)
            B = jacfwd(lambda uu: F(x, uu))(u)

            def lz(z):
                return stage_cost_mu(z[:n], z[n:], k, mu)

            z = torch.cat([x, u])
            g = grad(lz)(z)
            H = hessian(lz)(z)
            return A, B, g[:n], g[n:], H[:n, :n], H[n:, :n], H[n:, n:]

        def backward_pass(X, U, mu, reg):
            Vx = grad(lambda x: ocp.terminal_cost(x, theta))(X[-1])
            Vxx = hessian(lambda x: ocp.terminal_cost(x, theta))(X[-1])
            dV1, dV2 = 0.0, 0.0
            kffs, Ks = [None] * N, [None] * N
            for k in reversed(range(N)):
                A, B, lx, lu, lxx, lux, luu = stage_derivs(X[k], U[k], k, mu)
                Qx = lx + A.T @ Vx
                Qu = lu + B.T @ Vx
                Qxx = lxx + A.T @ Vxx @ A
                Qux = lux + B.T @ Vxx @ A
                Quu = _symmetrize(luu + B.T @ Vxx @ B + reg * eye)
                # explicit 2x2 determinant; heavy diagonal loading when Quu
                # lost positive-definiteness
                det = Quu[0, 0] * Quu[1, 1] - Quu[0, 1] * Quu[1, 0] if m == 2 else torch.linalg.det(Quu)
                bad = (det <= 1e-12) | (torch.diagonal(Quu).min() <= 0.0)
                Quu_safe = torch.where(bad, Quu + 1e3 * eye, Quu)
                rhs = torch.cat([Qu[:, None], Qux], dim=1)
                sol = torch.linalg.solve(Quu_safe, rhs)
                kff = -sol[:, 0]
                K = -sol[:, 1:]
                Vx = Qx + K.T @ Quu_safe @ kff + K.T @ Qu + Qux.T @ kff
                Vxx = _symmetrize(Qxx + K.T @ Quu_safe @ K + K.T @ Qux + Qux.T @ K)
                dV1 = dV1 + kff @ Qu
                dV2 = dV2 + 0.5 * kff @ Quu_safe @ kff
                kffs[k], Ks[k] = kff, K
            return kffs, Ks, dV1, dV2

        def backward_pass_parallel(X, U, mu, reg):
            """The same sweep through the log-depth LQR scan; the
            regularization lands on l_uu."""
            from .parallel_riccati import LQRProblem, lqr_backward_parallel

            d = [stage_derivs(X[k], U[k], k, mu) for k in range(N)]
            A, B, lx, lu, lxx, lux, luu = (torch.stack(z) for z in zip(*d))
            luu_reg = luu + reg * eye
            P_N = hessian(lambda x: ocp.terminal_cost(x, theta))(X[-1])
            p_N = grad(lambda x: ocp.terminal_cost(x, theta))(X[-1])
            gains = lqr_backward_parallel(
                LQRProblem(A=A, B=B, lxx=lxx, lux=lux, luu=luu_reg, lx=lx, lu=lu, P_N=P_N, p_N=p_N)
            )
            # the scan's convention is du = -K dx - kff; this solver applies
            # u + alpha * kff + K dx
            kff, K = -gains.kff, -gains.K
            Bt = B.transpose(-1, -2)
            Qu = lu + (Bt @ gains.p[1:].unsqueeze(-1)).squeeze(-1)
            Quu = luu_reg + Bt @ gains.P[1:] @ B
            dV1 = (kff * Qu).sum()
            dV2 = 0.5 * (kff * (Quu @ kff.unsqueeze(-1)).squeeze(-1)).sum()
            return list(kff), list(K), dV1, dV2

        def feedback_rollout(U, X_old, kffs, Ks, alpha, mu):
            """Closed-loop candidate at step ``alpha``, clipped into the strict
            interior so the barrier stays finite."""
            eps = settings.interior_clip * u_range
            x, acc, U_new = x0, 0.0, []
            for k in range(N):
                u = U[k] + alpha * kffs[k] + Ks[k] @ (x - X_old[k])
                u = torch.clamp(u, u_lo + eps, u_hi - eps)
                acc = acc + stage_cost_mu(x, u, k, mu)
                x = F(x, u)
                U_new.append(u)
            return torch.stack(U_new), acc + ocp.terminal_cost(x, theta)

        eps0 = 1e-3 * u_range
        U = torch.clamp(U0.to(f32), u_lo + eps0, u_hi - eps0)
        reg = torch.tensor(settings.reg_init, dtype=f32, device=dev)
        for mu in mus:
            X, J = rollout_and_cost(U, mu)
            bwd = backward_pass_parallel if settings.horizon_parallel else backward_pass
            kffs, Ks, dV1, dV2 = bwd(X, U, mu, reg)
            cands = [feedback_rollout(U, X, kffs, Ks, a, mu) for a in alpha_list]
            U_cands = torch.stack([c[0] for c in cands])
            J_cands = torch.stack([c[1] for c in cands])
            expected = -(alphas * dV1 + alphas**2 * dV2)
            J_cands = torch.where(torch.isnan(J_cands), torch.inf, J_cands)
            accept = J_cands <= J - settings.armijo_c1 * torch.clamp(expected, min=0.0)
            any_accept = accept.any()
            # largest accepted alpha (alphas descend: the first hit), picked
            # with a one-hot mask — a batched index cannot subscript under vmap
            first = torch.arange(len(alpha_list), device=dev) == torch.argmax(accept.to(torch.int32))
            U_pick = torch.where(first[:, None, None], U_cands, 0.0).sum(0)
            U = torch.where(any_accept, U_pick, U)
            reg = torch.where(
                any_accept,
                torch.clamp(reg * 0.5, min=settings.reg_min),
                torch.clamp(reg * 10.0 + settings.reg_min, max=settings.reg_max),
            )

        X, _ = rollout_and_cost(U, settings.mu_final)
        J = true_cost(U)
        g = grad(true_cost)(U)
        kkt = torch.max(torch.abs(U - torch.clamp(U - g, u_lo, u_hi)))
        return Solution(
            U=U,
            X=X,
            cost=J,
            kkt_residual=kkt,
            converged=kkt < settings.kkt_tol,
            n_iters=torch.tensor(settings.total_iters, device=dev),
            reg=reg,
        )

    return solve

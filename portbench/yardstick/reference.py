"""The benchmark's plain reference: the unicycle MPC problems of the upstream
planners and the interior-point iLQR that solves them, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: each
problem is built from the raw inputs the benchmark drew (poses, goals,
obstacle points, paths) and the constants of the configuration file.

Rows are independent scenarios. Every per-row tensor has the scenario axis
last, so that line-search candidates (one per step size) ride on a leading
axis. ``dtype`` is the arithmetic's precision: float32 as the configurations
state, bfloat16 for the control that must fail the comparison.

The solver is the schedule the configurations state (``SolverSettings`` of
the upstream port): single shooting, a log barrier on the control box driven
down a geometric schedule, a Riccati sweep with Levenberg regularisation and
a 2x2 safeguard, a first-accept Armijo line search over step sizes 2^-a, a
per-scenario exit from a barrier stage once the Newton decrement is small,
and the KKT residual of the projected gradient at the end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


@dataclass(frozen=True)
class Schedule:
    """The solver schedule of a cell (the port's ``SolverSettings`` fields)."""

    mu_init: float = 1e-1
    mu_final: float = 1e-8
    barrier_stages: int = 10
    iters_per_stage: int = 6
    n_alphas: int = 10
    reg_init: float = 1e-6
    reg_min: float = 1e-9
    reg_max: float = 1e8
    armijo_c1: float = 1e-4
    interior_clip: float = 1e-7
    kkt_tol: float = 1e-4
    stage_tol: float = 1e-10

    def mus(self) -> list:
        stages = np.logspace(np.log10(self.mu_init), np.log10(self.mu_final), self.barrier_stages)
        return [float(m) for m in np.repeat(stages, self.iters_per_stage).astype(np.float32)]


@dataclass
class Rows:
    """One batch of scenarios of one problem family, scenario axis last.

    ``kind`` is ``point_stab`` (RK4, goal quadratic, no terminal cost) or
    ``tracking`` (Euler, reference windows, wrapped yaw error, terminal pose
    quadratic and terminal obstacle term)."""

    kind: str
    dt: float
    u_lo: tuple
    u_hi: tuple
    x0: torch.Tensor  # (3, S)
    Q: torch.Tensor  # (3, S)
    R: torch.Tensor  # (2, S)
    rexp: torch.Tensor  # (S,) exponent of the reverse penalty exp(-rexp * v)
    gain: torch.Tensor  # (S,) obstacle gain times weight
    inv_ir2: torch.Tensor  # (S,) 1 / inflation_radius^2
    ox: torch.Tensor  # (S, n) obstacle points; sentinels contribute exactly 0
    oy: torch.Tensor
    goal: torch.Tensor = None  # (3, S) point_stab
    xref: torch.Tensor = None  # (N, 3, S) tracking
    uref: torch.Tensor = None  # (N, 2, S) tracking
    TW: torch.Tensor = None  # (3, S) tracking terminal weight

    @property
    def S(self) -> int:
        return self.x0.shape[-1]

    def to(self, dtype):
        out = {}
        for k, v in self.__dict__.items():
            out[k] = v.to(dtype) if isinstance(v, torch.Tensor) else v
        return Rows(**out)


def wrap(e):
    return e - TWO_PI * torch.round(e / TWO_PI)


# ------------------------------------------------------------------ model


def step(p: Rows, px, py, th, v, w):
    """One control period of the unicycle: classical RK4 (point_stab) or
    forward Euler (tracking) with the control held. The heading moves
    linearly within a period, so RK4's two midpoint stages coincide and
    its position update is ``v dt/6 (cos th + 4 cos th_mid + cos th_end)``."""
    dt = p.dt
    if p.kind == "tracking":
        return px + dt * v * torch.cos(th), py + dt * v * torch.sin(th), th + dt * w
    t2, t4 = th + 0.5 * dt * w, th + dt * w
    g = v * (dt / 6.0)
    return (
        px + g * (torch.cos(th) + 4.0 * torch.cos(t2) + torch.cos(t4)),
        py + g * (torch.sin(th) + 4.0 * torch.sin(t2) + torch.sin(t4)),
        t4,
    )


def plant_step(dt: float, px, py, th, v, w):
    """One classical RK4 step of the unicycle with every stage evaluated, as
    a generic integrator takes it (the fleet's plant)."""

    def f(t):
        return v * torch.cos(t), v * torch.sin(t), w

    k1 = f(th)
    k2 = f(th + dt / 2 * k1[2])
    k3 = f(th + dt / 2 * k2[2])
    k4 = f(th + dt * k3[2])
    return tuple(x + dt / 6 * (a + 2 * b + 2 * c + d) for x, a, b, c, d in zip((px, py, th), k1, k2, k3, k4))


def jacobians(p: Rows, px, py, th, v, w):
    """(A, B) of :func:`step`, each (S, 3, 3) / (S, 3, 2)."""
    dt = p.dt
    one, zero = torch.ones_like(px), torch.zeros_like(px)
    if p.kind == "tracking":
        c, s = torch.cos(th), torch.sin(th)
        a02, a12 = -dt * v * s, dt * v * c
        b00, b10, b01, b11 = dt * c, dt * s, zero, zero
    else:
        t2, t4 = th + 0.5 * dt * w, th + dt * w
        c0, s0, c2, s2, c4, s4 = torch.cos(th), torch.sin(th), torch.cos(t2), torch.sin(t2), torch.cos(t4), torch.sin(t4)
        C = dt / 6.0 * (c0 + 4.0 * c2 + c4)
        Sn = dt / 6.0 * (s0 + 4.0 * s2 + s4)
        a02, a12 = -v * Sn, v * C
        b00, b10 = C, Sn
        b01 = v * dt / 6.0 * (-4.0 * s2 * 0.5 * dt - s4 * dt)
        b11 = v * dt / 6.0 * (4.0 * c2 * 0.5 * dt + c4 * dt)
    A = torch.stack(
        [torch.stack([one, zero, a02], -1), torch.stack([zero, one, a12], -1), torch.stack([zero, zero, one], -1)],
        -2,
    )
    B = torch.stack(
        [torch.stack([b00, b01], -1), torch.stack([b10, b11], -1), torch.stack([zero, dt * one], -1)], -2
    )
    return A, B


# ------------------------------------------------------------------ costs


def _obstacle(p: Rows, px, py, derivs: bool):
    dx = px[..., None] - p.ox
    dy = py[..., None] - p.oy
    i2 = p.inv_ir2[:, None]
    e = p.gain[:, None] * torch.exp(-(dx * dx + dy * dy) * i2)
    val = e.sum(-1)
    if not derivs:
        return val
    gx = (-2.0 * i2 * dx * e).sum(-1)
    gy = (-2.0 * i2 * dy * e).sum(-1)
    hxx = (e * (4.0 * i2 * i2 * dx * dx - 2.0 * i2)).sum(-1)
    hxy = (e * 4.0 * i2 * i2 * dx * dy).sum(-1)
    hyy = (e * (4.0 * i2 * i2 * dy * dy - 2.0 * i2)).sum(-1)
    return val, gx, gy, hxx, hxy, hyy


def _errors(p: Rows, k, px, py, th):
    """Pose errors at stage ``k``, or at every stage (``k`` None: inputs
    (N, S), or (A, N, S) with candidates leading)."""
    if p.kind == "tracking":
        r, ur = (p.xref[k], p.uref[k]) if k is not None else (p.xref.transpose(0, 1), p.uref.transpose(0, 1))
        return px - r[0], py - r[1], wrap(th - r[2]), ur
    g = p.goal
    return px - g[0], py - g[1], th - g[2], None


def stage_cost(p: Rows, k, px, py, th, v, w):
    ex, ey, eth, ur = _errors(p, k, px, py, th)
    ev, ew = (v, w) if ur is None else (v - ur[0], w - ur[1])
    c = p.Q[0] * ex * ex + p.Q[1] * ey * ey + p.Q[2] * eth * eth
    c = c + p.R[0] * ev * ev + p.R[1] * ew * ew + torch.exp(-p.rexp * v)
    return c + _obstacle(p, px, py, False)


def terminal_cost(p: Rows, px, py, th):
    if p.kind != "tracking":
        return torch.zeros_like(px)
    r = p.xref[-1]
    ex, ey, eth = px - r[0], py - r[1], wrap(th - r[2])
    quad = p.TW[0] * ex * ex + p.TW[1] * ey * ey + p.TW[2] * eth * eth
    return _obstacle(p, px, py, False) + quad


def stage_derivs(p: Rows, k, px, py, th, v, w):
    """(lx (S,3), lu (S,2), lxx (S,3,3), luu (S,2,2)) of the stage cost
    without the barrier (l_ux is zero)."""
    _, gx, gy, hxx, hxy, hyy = _obstacle(p, px, py, True)
    ex, ey, eth, ur = _errors(p, k, px, py, th)
    ev, ew = (v, w) if ur is None else (v - ur[0], w - ur[1])
    er = torch.exp(-p.rexp * v)
    zero = torch.zeros_like(px)
    lx = torch.stack([2.0 * p.Q[0] * ex + gx, 2.0 * p.Q[1] * ey + gy, 2.0 * p.Q[2] * eth], -1)
    lu = torch.stack([2.0 * p.R[0] * ev - p.rexp * er, 2.0 * p.R[1] * ew], -1)
    lxx = torch.stack(
        [
            torch.stack([2.0 * p.Q[0] + hxx, hxy, zero], -1),
            torch.stack([hxy, 2.0 * p.Q[1] + hyy, zero], -1),
            torch.stack([zero, zero, 2.0 * p.Q[2] + zero], -1),
        ],
        -2,
    )
    luu = torch.stack(
        [
            torch.stack([2.0 * p.R[0] + p.rexp * p.rexp * er, zero], -1),
            torch.stack([zero, 2.0 * p.R[1] + zero], -1),
        ],
        -2,
    )
    return lx, lu, lxx, luu


def terminal_derivs(p: Rows, px, py, th):
    """(Vx (S,3), Vxx (S,3,3)) of the terminal cost."""
    zero = torch.zeros_like(px)
    if p.kind != "tracking":
        return torch.stack([zero] * 3, -1), torch.stack([torch.stack([zero] * 3, -1)] * 3, -2)
    _, gx, gy, hxx, hxy, hyy = _obstacle(p, px, py, True)
    r = p.xref[-1]
    ex, ey, eth = px - r[0], py - r[1], wrap(th - r[2])
    Vx = torch.stack([gx + 2.0 * p.TW[0] * ex, gy + 2.0 * p.TW[1] * ey, 2.0 * p.TW[2] * eth], -1)
    Vxx = torch.stack(
        [
            torch.stack([hxx + 2.0 * p.TW[0], hxy, zero], -1),
            torch.stack([hxy, hyy + 2.0 * p.TW[1], zero], -1),
            torch.stack([zero, zero, 2.0 * p.TW[2] + zero], -1),
        ],
        -2,
    )
    return Vx, Vxx


# ------------------------------------------------------------ evaluation


def states(p: Rows, U):
    """The trajectory (N+1, 3, ...) of controls U (N, 2, ...) from x0."""
    px, py, th = p.x0[0], p.x0[1], p.x0[2]
    X = [torch.stack([px, py, th])]
    for k in range(U.shape[0]):
        px, py, th = step(p, px, py, th, U[k, 0], U[k, 1])
        X.append(torch.stack([px, py, th]))
    return torch.stack(X)


def cost(p: Rows, X, U, mu=None):
    """The cost of a trajectory, every stage at once; with ``mu`` the
    barrier cost the solver descends."""
    N = U.shape[0]
    v, w = U[:, 0], U[:, 1]
    J = stage_cost(p, None, X[:N, 0], X[:N, 1], X[:N, 2], v, w).sum(0)
    if mu is not None:
        J = J - mu * barrier(p, v, w).sum(0)
    return J + terminal_cost(p, X[N, 0], X[N, 1], X[N, 2])


def rollout(p: Rows, U, mu=None):
    X = states(p, U)
    return X, cost(p, X, U, mu)


def barrier(p: Rows, v, w):
    (lo_v, lo_w), (hi_v, hi_w) = p.u_lo, p.u_hi
    return torch.log(v - lo_v) + torch.log(hi_v - v) + torch.log(w - lo_w) + torch.log(hi_w - w)


def _linearize(p: Rows, X, U):
    """Jacobians and stage-cost derivatives at every stage, (N, S, ...)."""
    N = U.shape[0]
    args = (X[:N, 0], X[:N, 1], X[:N, 2], U[:, 0], U[:, 1])
    return jacobians(p, *args), stage_derivs(p, None, *args)


def kkt_residual(p: Rows, U, X):
    """The infinity norm over stages of ``u - clip(u - grad_u J, lo, hi)``
    with the gradient of the true cost (no barrier) by the adjoint sweep."""
    N = U.shape[0]
    (A, B), (lx, lu, _, _) = _linearize(p, X, U)
    lam = terminal_derivs(p, X[N, 0], X[N, 1], X[N, 2])[0]
    gu = [None] * N
    for k in reversed(range(N)):
        gu[k] = lu[k] + (B[k].mT @ lam[..., None])[..., 0]
        lam = lx[k] + (A[k].mT @ lam[..., None])[..., 0]
    gu = torch.stack(gu)
    (lo_v, lo_w), (hi_v, hi_w) = p.u_lo, p.u_hi
    v, w = U[:, 0], U[:, 1]
    r0 = (v - torch.clamp(v - gu[..., 0], lo_v, hi_v)).abs()
    r1 = (w - torch.clamp(w - gu[..., 1], lo_w, hi_w)).abs()
    return torch.maximum(r0, r1).amax(0)


def evaluate(p: Rows, U):
    """What a solve's controls U (N, 2, S) mean: (X (N+1,3,S), true cost
    (S,), KKT residual (S,))."""
    X, J = rollout(p, U)
    return X, J, kkt_residual(p, U, X)


# ------------------------------------------------------------------ solve


def _solve2(Quu, rhs):
    """Quu^-1 rhs for (S,2,2) Quu and (S,2,k) rhs, by the adjugate."""
    a, b, c, d = Quu[:, 0, 0], Quu[:, 0, 1], Quu[:, 1, 0], Quu[:, 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2) / det[:, None, None]
    return inv @ rhs


def solve(p: Rows, U0, sched: Schedule):
    """The bank solve from warm start U0 (N, 2, S). Returns a dict with U,
    X, cost, kkt, converged, iters (each scenario's executed iterations)
    and ls_rollouts (its line-search candidate rollouts, counted as a
    sequential first-accept search counts them)."""
    N, S = U0.shape[0], p.S
    dtype, dev = U0.dtype, U0.device
    lo = torch.tensor(p.u_lo, dtype=torch.float32)
    hi = torch.tensor(p.u_hi, dtype=torch.float32)
    rng = hi - lo
    init_lo, init_hi = (lo + 1e-3 * rng).tolist(), (hi - 1e-3 * rng).tolist()
    eps = (sched.interior_clip * rng).to(torch.float32)
    ls_lo, ls_hi = (lo + eps).tolist(), (hi - eps).tolist()
    (lo_v, lo_w), (hi_v, hi_w) = p.u_lo, p.u_hi
    U = torch.stack(
        [torch.clamp(U0[:, 0], init_lo[0], init_hi[0]), torch.clamp(U0[:, 1], init_lo[1], init_hi[1])], 1
    )
    reg = torch.full((S,), sched.reg_init, dtype=dtype, device=dev)
    done = torch.zeros(S, dtype=torch.int64, device=dev)
    iters = torch.zeros(S, dtype=torch.int64, device=dev)
    lsro = torch.zeros(S, dtype=torch.int64, device=dev)
    nA = sched.n_alphas
    alphas = torch.tensor([0.5**a for a in range(nA)], dtype=dtype, device=dev)[:, None]
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    for it, mu in enumerate(sched.mus()):
        stage, first = it // sched.iters_per_stage, it % sched.iters_per_stage == 0
        active = done <= stage
        if not bool(active.any()):
            continue
        iters += active.long()
        X, J = rollout(p, U, mu)

        # the backward sweep on every stage's linearisation, barrier included
        (A, B), (lx, lu, lxx, luu) = _linearize(p, X, U)
        v, w = U[:, 0], U[:, 1]
        sv0, sv1, sw0, sw1 = v - lo_v, hi_v - v, w - lo_w, hi_w - w
        lu = lu - mu * torch.stack([1.0 / sv0 - 1.0 / sv1, 1.0 / sw0 - 1.0 / sw1], -1)
        luu = luu + mu * torch.diag_embed(
            torch.stack([1.0 / (sv0 * sv0) + 1.0 / (sv1 * sv1), 1.0 / (sw0 * sw0) + 1.0 / (sw1 * sw1)], -1)
        )
        luu = luu + reg[:, None, None] * eye2
        At, Bt = A.mT, B.mT
        Vx, Vxx = terminal_derivs(p, X[N, 0], X[N, 1], X[N, 2])
        dV1 = torch.zeros_like(J)
        dV2 = torch.zeros_like(J)
        kff, Kfb = [None] * N, [None] * N
        for k in reversed(range(N)):
            Qx = lx[k] + (At[k] @ Vx[..., None])[..., 0]
            Qu = lu[k] + (Bt[k] @ Vx[..., None])[..., 0]
            VA = Vxx @ A[k]
            Qxx = lxx[k] + At[k] @ VA
            Quu = luu[k] + Bt[k] @ Vxx @ B[k]
            Qux = Bt[k] @ VA
            det = Quu[:, 0, 0] * Quu[:, 1, 1] - Quu[:, 0, 1] * Quu[:, 1, 0]
            bad = (det <= 1e-12) | (torch.minimum(Quu[:, 0, 0], Quu[:, 1, 1]) <= 0.0)
            Quu = Quu + torch.where(bad, 1e3, 0.0).to(dtype)[:, None, None] * eye2
            kf = -_solve2(Quu, Qu[..., None])[..., 0]
            K = -_solve2(Quu, Qux)
            Kt, Quxt = K.mT, Qux.mT
            Qk = (Quu @ kf[..., None])[..., 0]
            Vx = Qx + (Kt @ (Qk + Qu)[..., None])[..., 0] + (Quxt @ kf[..., None])[..., 0]
            Vxx = Qxx + Kt @ Quu @ K + Kt @ Qux + Quxt @ K
            dV1 = dV1 + (kf * Qu).sum(-1)
            dV2 = dV2 + 0.5 * (kf * Qk).sum(-1)
            kff[k], Kfb[k] = kf, K

        if not first:
            hit = active & (-(dV1 + dV2) - sched.stage_tol * (1.0 + J.abs()) < 0.0)
            done = torch.where(hit, torch.full_like(done, stage + 1), done)

        # every step size at once on a leading axis; the first accepted wins
        px, py, th = (t.expand(nA, -1) for t in p.x0)
        traj, cand = [], []
        for k in range(N):
            dx = torch.stack([px - X[k, 0], py - X[k, 1], th - X[k, 2]], -1)  # (A, S, 3)
            u = U[k].T + alphas[..., None] * kff[k] + (Kfb[k] @ dx[..., None])[..., 0]
            cv = torch.clamp(u[..., 0], ls_lo[0], ls_hi[0])
            cw = torch.clamp(u[..., 1], ls_lo[1], ls_hi[1])
            traj.append(torch.stack([px, py, th], 1))  # (A, 3, S)
            cand.append(torch.stack([cv, cw], 1))  # (A, 2, S)
            px, py, th = step(p, px, py, th, cv, cw)
        traj = torch.stack(traj, 1)  # (A, N, 3, S)
        cand = torch.stack(cand, 1)  # (A, N, 2, S)
        cv, cw = cand[:, :, 0], cand[:, :, 1]
        Jc = stage_cost(p, None, traj[:, :, 0], traj[:, :, 1], traj[:, :, 2], cv, cw).sum(1)
        Jc = Jc - mu * barrier(p, cv, cw).sum(1) + terminal_cost(p, px, py, th)
        expected = -(alphas * dV1 + alphas * alphas * dV2)
        Jc = torch.where(torch.isnan(Jc), torch.inf, Jc)
        ok = Jc <= J - sched.armijo_c1 * torch.clamp(expected, min=0.0)
        accepted = ok.any(0) & active
        first_ok = torch.argmax(ok.to(torch.int8), dim=0)
        lsro += torch.where(active, torch.where(ok.any(0), first_ok + 1, nA), 0)
        pick = cand.gather(0, first_ok.view(1, 1, 1, S).expand(1, N, 2, S))[0]
        U = torch.where(accepted, pick, U)
        grown = torch.clamp(reg * 10.0 + sched.reg_min, max=sched.reg_max)
        shrunk = torch.clamp(reg * 0.5, min=sched.reg_min)
        reg = torch.where(active, torch.where(accepted, shrunk, grown), reg)

    X, J, kkt = evaluate(p, U)
    return {
        "U": U,
        "X": X,
        "cost": J,
        "kkt": kkt,
        "converged": kkt < sched.kkt_tol,
        "iters": iters,
        "ls_rollouts": lsro,
    }


# ------------------------------------------------------------ fleet pieces


def tracking_window(pos, goal, wps, yaw, speed, omega, horizon: int, latch_end: float = 0.5):
    """Every robot's reference window along its own path, as the upstream
    path follower builds one (scripts/path_follower_local_planner.py): the
    window starts at the waypoint nearest the robot and holds the path's
    last sample past its end; within ``latch_end`` of the final waypoint the
    state reference is the goal pose repeated and the control reference 0.

    ``pos`` (S, 2), ``goal`` (S, 3), ``wps`` (S, P, 2), ``yaw``/``speed``/
    ``omega`` (S, P). Returns x_ref (S, N, 3), u_ref (S, N, 2)."""
    S, P = wps.shape[:2]
    d2 = ((wps[..., 0] - pos[:, :1]) ** 2) + ((wps[..., 1] - pos[:, 1:]) ** 2)
    anchor = torch.argmin(d2, dim=1)
    idx = torch.clamp(anchor[:, None] + torch.arange(horizon, device=pos.device)[None], max=P - 1)
    near_end = ((pos[:, 0] - wps[:, -1, 0]) ** 2 + (pos[:, 1] - wps[:, -1, 1]) ** 2) < latch_end * latch_end
    take = lambda t: torch.gather(t, 1, idx)  # noqa: E731
    x_ref = torch.stack([take(wps[..., 0]), take(wps[..., 1]), take(yaw)], -1)
    u_ref = torch.stack([take(speed), take(omega)], -1)
    x_ref = torch.where(near_end[:, None, None], goal[:, None, :].expand_as(x_ref), x_ref)
    u_ref = torch.where(near_end[:, None, None], torch.zeros_like(u_ref), u_ref)
    return x_ref, u_ref


def plant(x, u, dt):
    """The fleet's plant: one RK4 step of the unicycle, yaw wrapped to
    (-pi, pi]. ``x`` (S, 3), ``u`` (S, 2)."""
    px, py, th = plant_step(dt, x[:, 0], x[:, 1], x[:, 2], u[:, 0], u[:, 1])
    return torch.stack([px, py, wrap(th)], -1)

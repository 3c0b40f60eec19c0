"""Whole-solver bank kernels for Hopper (K1, K2), their plain versions, and
the wrappers that choose between them.

Port of :mod:`ros2_mpc_tpu.solver.pallas_kernel`. The TPU kernels run the
complete interior-point iLQR (rollouts, analytic derivatives, Riccati sweep,
Armijo line search, barrier continuation) per (8, 128)-scenario tile in
VMEM. Here it is hand-written CUDA C++ for ``sm_90a`` on structure-of-arrays
planes ``(..., B)`` with the scenario index minor, any B >= 1:

* K1 (``csrc/point_stab.cu``, point stabilization) and K2
  (``csrc/tracking.cu``, tracking) run one scenario on a group of lanes
  (``csrc/group_solve.cuh``): per-stage derivatives across lanes; the
  line search rolls out its candidates' states across lanes, then costs
  them one at a time across lanes, stopping at the first that passes; the
  iterate in shared memory sized from N and n_alphas at launch
  (:func:`group_geometry` mirrors it).

Beside each kernel is its plain PyTorch version, :func:`point_stab_bank_plain`
and :func:`tracking_bank_plain`: batched code over ``(B,)`` planes that
transcribes the same closed-form math, with the per-scenario stage exit and
first-accept line search done with masks. The CPU tests hold it against the
JAX kernel; on the card it is the yardstick for the CUDA kernel.

Dispatch: ``solve_bank`` takes the plain version only because its tensors lie
on the CPU. On CUDA tensors it launches the kernel or raises; nothing falls
back.

Differences from the TPU kernel, each chosen here:

* early exits are per scenario (zero obstacle weight, live obstacle prefix,
  converged barrier stage, first accepted step), not per tile, so
  ``Solution.n_iters`` counts each scenario's own executed iterations;
* step sizes are exact powers of two, as ``make_solver``'s ``0.5 ** a``
  (the TPU kernel formed ``exp(-ln2 * a)``);
* clip/max/min keep NaN as ``jnp.clip``/``jnp.maximum`` do, so a NaN
  candidate is rejected by the line search, not clipped into the box.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils.telemetry import span
from .ilqr import OCP, Solution, SolverSettings

# Each kernel's lanes per scenario and scenarios per block, compile-time
# constants of its source (MPC_K1_* in csrc/point_stab.cu, MPC_K2_* in
# csrc/tracking.cu) chosen by measurement (PERF.md), and the floats a stage
# it keeps in shared memory ahead of the schedule's scratch (K2's reference
# windows, kWindowFloats). The kernel's entry point sizes its launch
# itself; the wrapper mirrors it (group_geometry) only to refuse a shape
# before any build, and kernel_info reads the kernel's own geometry back.
GROUP_GEOMETRY = {  # kind: (lanes a scenario, scenarios a block, floats a stage)
    "point_stab": (8, 16, 0),
    "tracking": (8, 16, 5),
}
# The most dynamic shared memory one block may have on sm_90 (227 KB).
SMEM_PER_BLOCK = 232_448

_F32 = torch.float32

# pallas_kernel.py::_fast_sincos polynomials, same coefficients
_FAST_SIN_COEFFS = (  # sin(pi*t) = t * P(t^2), t in [-1, 1]
    3.1415926409395274,
    -5.167712276801008,
    2.5501582806119174,
    -0.5992355764432307,
    0.08207129109395697,
    -0.007267320535221715,
    0.00039296507715625833,
)
_FAST_COS_COEFFS = (  # cos(pi*t) = Q(t^2)
    0.9999999999193593,
    -4.934802189554386,
    4.0587118821364125,
    -1.3352607094469389,
    0.23532212897176416,
    -0.025787854657773987,
    0.001905911958441571,
    -8.916973037465991e-05,
)
_INV_2PI = float(1.0 / (2.0 * np.pi))
_TWO_PI = float(2.0 * np.pi)
_INV_PI = float(1.0 / np.pi)


def fast_sincos(x: torch.Tensor):
    """(cos x, sin x) from one 2*pi reduction and the degree-13/14
    polynomials of the TPU kernels (max abs error ~3.3e-6 for |x| <= 60)."""
    r = x - _TWO_PI * torch.floor(x * _INV_2PI + 0.5)
    t = r * _INV_PI
    t2 = t * t
    ps = _FAST_SIN_COEFFS[-1]
    for c in _FAST_SIN_COEFFS[-2::-1]:
        ps = ps * t2 + c
    pc = _FAST_COS_COEFFS[-1]
    for c in _FAST_COS_COEFFS[-2::-1]:
        pc = pc * t2 + c
    return pc, ps * t


def _stock_sincos(x):
    return torch.cos(x), torch.sin(x)


class BankConfig(NamedTuple):
    """What a bank solver fixes at build time (the kernels' scalar args)."""

    N: int
    dt: float
    lo_v: float
    hi_v: float
    lo_w: float
    hi_w: float
    eps_v: float
    eps_w: float
    mus: tuple  # per-iteration barrier parameter (float32 values)
    stages: tuple  # barrier stage of each iteration
    firsts: tuple  # 1 on a stage's first iteration
    n_alphas: int
    c1: float
    reg_init: float
    reg_min: float
    reg_max: float
    stage_tol: float
    kkt_tol: float
    fast_sincos: bool
    wrap_yaw: bool


def _bank_config(ocp: OCP, settings: SolverSettings, stage_tol, fast_sincos, wrap_yaw):
    # The OCP closes over dt; recover it by probing the transition once
    # (theta' = theta + dt * w for both integrators).
    dt = float(ocp.transition(torch.zeros(3), torch.tensor([0.0, 1.0]))[2])
    lo = np.asarray(ocp.u_lo, dtype=np.float32)
    hi = np.asarray(ocp.u_hi, dtype=np.float32)
    eps = (settings.interior_clip * (hi - lo)).astype(np.float32)
    stage = np.repeat(np.arange(settings.barrier_stages), settings.iters_per_stage)
    first = np.concatenate([[1], (np.diff(stage) != 0).astype(np.int64)])
    return BankConfig(
        N=ocp.horizon,
        dt=dt,
        lo_v=float(lo[0]),
        hi_v=float(hi[0]),
        lo_w=float(lo[1]),
        hi_w=float(hi[1]),
        eps_v=float(eps[0]),
        eps_w=float(eps[1]),
        mus=tuple(float(m) for m in settings.mu_schedule()),
        stages=tuple(int(s) for s in stage),
        firsts=tuple(int(f) for f in first),
        n_alphas=settings.n_alphas,
        c1=settings.armijo_c1,
        reg_init=settings.reg_init,
        reg_min=settings.reg_min,
        reg_max=settings.reg_max,
        stage_tol=stage_tol,
        kkt_tol=settings.kkt_tol,
        fast_sincos=fast_sincos,
        wrap_yaw=wrap_yaw,
    )


# ------------------------------------------------------------ plain versions


def _fold(t):
    """Sum over the leading (obstacle) axis in slot order from 0.0, as the
    kernels accumulate: ``torch.sum`` may pair the terms in another order
    (on the card it does, past four terms), a last-bit difference that the
    line search can amplify."""
    acc = t.new_zeros(t.shape[1:])
    for row in t:
        acc = acc + row
    return acc


class _Obstacles:
    """``ow * sum_j exp(-r_j^2 * inv_ir2)`` and its derivatives over planes
    ``(2, n_obs, B)``. Cut once to the bank's longest live prefix: the cut
    points are 100 m sentinels whose terms are exactly 0.0 (the kernel walks
    each scenario's own prefix instead)."""

    def __init__(self, obs, ow, inv_ir2):
        self.on = ow.abs() > 0.0
        live = ((obs[0].abs() < 90.0) | (obs[1].abs() < 90.0)) & self.on
        rows = torch.nonzero(live.any(dim=1))
        n_live = int(rows.max()) + 1 if rows.numel() else 0
        self.ox, self.oy = obs[0, :n_live], obs[1, :n_live]
        self.ow, self.i2 = ow, inv_ir2

    def _e(self, px, py):
        dx = px - self.ox
        dy = py - self.oy
        return dx, dy, self.ow * torch.exp(-(dx * dx + dy * dy) * self.i2)

    def value(self, px, py):
        _, _, e = self._e(px, py)
        return torch.where(self.on, _fold(e), 0.0)

    def terms(self, px, py):
        dx, dy, e = self._e(px, py)
        i2 = self.i2
        out = (
            _fold(-2.0 * i2 * dx * e),
            _fold(-2.0 * i2 * dy * e),
            _fold(e * (4.0 * i2 * i2 * dx * dx - 2.0 * i2)),
            _fold(e * 4.0 * i2 * i2 * dx * dy),
            _fold(e * (4.0 * i2 * i2 * dy * dy - 2.0 * i2)),
        )
        return tuple(torch.where(self.on, o, 0.0) for o in out)


class _Grad(NamedTuple):  # stage-cost derivatives without the barrier
    lx0: torch.Tensor
    lx1: torch.Tensor
    lx2: torch.Tensor
    lu0: torch.Tensor
    lu1: torch.Tensor
    lxx00: torch.Tensor
    lxx01: torch.Tensor
    lxx11: torch.Tensor
    lxx22: torch.Tensor
    luu00: torch.Tensor
    luu11: torch.Tensor


class _PointStabModel:
    """K1's problem on (B,) planes: RK4 with closed-form A/B, goal and
    control quadratics, reverse penalty, Gaussian obstacles, no terminal."""

    def __init__(self, cfg: BankConfig, x0g, w, obs):
        self.x0 = tuple(x0g[0:3])
        self.gx, self.gy, self.gth = x0g[3:6]
        self.Q0, self.Q1, self.Q2, self.R0, self.R1, self.rf = w[0:6]
        self.obs = _Obstacles(obs, w[6], w[7])
        self.sincos = fast_sincos if cfg.fast_sincos else _stock_sincos
        self.dt = cfg.dt
        self.dt6 = float(np.float32(cfg.dt) / np.float32(6.0))  # the kernel's dt / 6.f

    def _rk4_trig(self, th, w):
        dt = self.dt
        th2 = th + 0.5 * dt * w
        th4 = th + dt * w
        c0, s0 = self.sincos(th)
        c2, s2 = self.sincos(th2)
        c4, s4 = self.sincos(th4)
        C = self.dt6 * (c0 + 4.0 * c2 + c4)
        S = self.dt6 * (s0 + 4.0 * s2 + s4)
        return th4, C, S, c2, s2, c4, s4

    def step(self, px, py, th, v, w):
        th4, C, S = self._rk4_trig(th, w)[:3]
        return px + v * C, py + v * S, th4

    def jac(self, px, py, th, v, w):
        dt = self.dt
        _, C, S, c2, s2, c4, s4 = self._rk4_trig(th, w)
        b01 = -(v * self.dt6) * (4.0 * s2 * (0.5 * dt) + s4 * dt)
        b11 = (v * self.dt6) * (4.0 * c2 * (0.5 * dt) + c4 * dt)
        return -v * S, v * C, C, S, b01, b11

    def stage_cost(self, k, px, py, th, v, w):
        ex, ey, eth = px - self.gx, py - self.gy, th - self.gth
        c = self.Q0 * ex * ex + self.Q1 * ey * ey + self.Q2 * eth * eth
        c = c + self.R0 * v * v + self.R1 * w * w + torch.exp(-self.rf * v)
        return c + self.obs.value(px, py)

    def grad(self, k, px, py, th, v, w):
        ogx, ogy, ohxx, ohxy, ohyy = self.obs.terms(px, py)
        er = torch.exp(-self.rf * v)
        return _Grad(
            2.0 * self.Q0 * (px - self.gx) + ogx,
            2.0 * self.Q1 * (py - self.gy) + ogy,
            2.0 * self.Q2 * (th - self.gth),
            2.0 * self.R0 * v - self.rf * er,
            2.0 * self.R1 * w,
            2.0 * self.Q0 + ohxx,
            ohxy,
            2.0 * self.Q1 + ohyy,
            2.0 * self.Q2,
            2.0 * self.R0 + self.rf * self.rf * er,
            2.0 * self.R1,
        )

    def terminal_cost(self, px, py, th):
        return torch.zeros_like(px)

    def terminal_value(self, px, py, th):
        return (torch.zeros_like(px),) * 9


class _TrackingModel:
    """K2's problem on (B,) planes: Euler, x_ref/u_ref windows, Gaussian
    obstacles on stages 0..N, terminal pose quadratic, optional yaw wrap."""

    def __init__(self, cfg: BankConfig, x0, xref, uref, w, obs):
        self.x0 = tuple(x0)
        self.xref, self.uref = xref, uref
        self.Q0, self.Q1, self.Q2, self.R0, self.R1, self.rf = w[0:6]
        self.TW0, self.TW1, self.TW2 = w[8:11]
        self.obs = _Obstacles(obs, w[6], w[7])
        self.sincos = fast_sincos if cfg.fast_sincos else _stock_sincos
        self.dt = cfg.dt
        self.wrap = cfg.wrap_yaw

    def wyaw(self, e):
        # round half to even, as jnp.round and the kernel's rintf
        return e - _TWO_PI * torch.round(e * _INV_2PI) if self.wrap else e

    def step(self, px, py, th, v, w):
        c, s = self.sincos(th)
        dt = self.dt
        return px + dt * v * c, py + dt * v * s, th + dt * w

    def jac(self, px, py, th, v, w):
        c, s = self.sincos(th)
        dt = self.dt
        z = torch.zeros_like(px)
        return -dt * v * s, dt * v * c, dt * c, dt * s, z, z

    def _errors(self, k, px, py, th):
        r = self.xref[k]
        return px - r[0], py - r[1], self.wyaw(th - r[2])

    def stage_cost(self, k, px, py, th, v, w):
        ex, ey, eth = self._errors(k, px, py, th)
        ev, ew = v - self.uref[k, 0], w - self.uref[k, 1]
        c = self.Q0 * ex * ex + self.Q1 * ey * ey + self.Q2 * eth * eth
        c = c + self.R0 * ev * ev + self.R1 * ew * ew + torch.exp(-self.rf * v)
        return c + self.obs.value(px, py)

    def grad(self, k, px, py, th, v, w):
        ogx, ogy, ohxx, ohxy, ohyy = self.obs.terms(px, py)
        ex, ey, eth = self._errors(k, px, py, th)
        ev, ew = v - self.uref[k, 0], w - self.uref[k, 1]
        er = torch.exp(-self.rf * v)
        return _Grad(
            2.0 * self.Q0 * ex + ogx,
            2.0 * self.Q1 * ey + ogy,
            2.0 * self.Q2 * eth,
            2.0 * self.R0 * ev - self.rf * er,
            2.0 * self.R1 * ew,
            2.0 * self.Q0 + ohxx,
            ohxy,
            2.0 * self.Q1 + ohyy,
            2.0 * self.Q2,
            2.0 * self.R0 + self.rf * self.rf * er,
            2.0 * self.R1,
        )

    def terminal_cost(self, px, py, th):
        ex, ey, eth = self._errors(-1, px, py, th)
        quad = self.TW0 * ex * ex + self.TW1 * ey * ey + self.TW2 * eth * eth
        return self.obs.value(px, py) + quad

    def terminal_value(self, px, py, th):
        ogx, ogy, ohxx, ohxy, ohyy = self.obs.terms(px, py)
        ex, ey, eth = self._errors(-1, px, py, th)
        z = torch.zeros_like(px)
        return (
            ogx + 2.0 * self.TW0 * ex,
            ogy + 2.0 * self.TW1 * ey,
            2.0 * self.TW2 * eth,
            ohxx + 2.0 * self.TW0,
            ohxy,
            z,
            ohyy + 2.0 * self.TW1,
            z,
            2.0 * self.TW2 + z,
        )


def _riccati_step(V, jc, g, reg, dt):
    """One backward step (l_ux == 0), as csrc/common.cuh riccati_step."""
    vx0, vx1, vx2, v00, v01, v02, v11, v12, v22 = V
    a02, a12, bc, bsn, b01, b11 = jc
    qx0 = g.lx0 + vx0
    qx1 = g.lx1 + vx1
    qx2 = g.lx2 + a02 * vx0 + a12 * vx1 + vx2
    qu0 = g.lu0 + bc * vx0 + bsn * vx1
    qu1 = g.lu1 + b01 * vx0 + b11 * vx1 + dt * vx2
    va02 = v00 * a02 + v01 * a12 + v02
    va12 = v01 * a02 + v11 * a12 + v12
    va22 = v02 * a02 + v12 * a12 + v22
    q00 = g.lxx00 + v00
    q01 = g.lxx01 + v01
    q02 = va02
    q11 = g.lxx11 + v11
    q12 = va12
    q22 = g.lxx22 + a02 * va02 + a12 * va12 + va22
    vb00 = v00 * bc + v01 * bsn
    vb10 = v01 * bc + v11 * bsn
    vb01 = v00 * b01 + v01 * b11 + v02 * dt
    vb11 = v01 * b01 + v11 * b11 + v12 * dt
    vb21 = v02 * b01 + v12 * b11 + v22 * dt
    quu00 = g.luu00 + bc * vb00 + bsn * vb10 + reg
    quu01 = bc * vb01 + bsn * vb11
    quu11 = g.luu11 + b01 * vb01 + b11 * vb11 + dt * vb21 + reg
    qux00 = bc * v00 + bsn * v01
    qux01 = bc * v01 + bsn * v11
    qux02 = bc * va02 + bsn * va12
    qux10 = b01 * v00 + b11 * v01 + dt * v02
    qux11 = b01 * v01 + b11 * v11 + dt * v12
    qux12 = b01 * va02 + b11 * va12 + dt * va22

    det = quu00 * quu11 - quu01 * quu01
    bad = (det <= 1e-12) | (torch.minimum(quu00, quu11) <= 0.0)
    quu00 = torch.where(bad, quu00 + 1e3, quu00)
    quu11 = torch.where(bad, quu11 + 1e3, quu11)
    det = torch.where(bad, quu00 * quu11 - quu01 * quu01, det)
    inv_det = 1.0 / det

    def solve2(r0, r1):
        return (quu11 * r0 - quu01 * r1) * inv_det, (quu00 * r1 - quu01 * r0) * inv_det

    kf0, kf1 = solve2(-qu0, -qu1)
    K00, K10 = solve2(-qux00, -qux10)
    K01, K11 = solve2(-qux01, -qux11)
    K02, K12 = solve2(-qux02, -qux12)

    qk0 = quu00 * kf0 + quu01 * kf1
    qk1 = quu01 * kf0 + quu11 * kf1
    nvx0 = qx0 + K00 * qk0 + K10 * qk1 + K00 * qu0 + K10 * qu1 + qux00 * kf0 + qux10 * kf1
    nvx1 = qx1 + K01 * qk0 + K11 * qk1 + K01 * qu0 + K11 * qu1 + qux01 * kf0 + qux11 * kf1
    nvx2 = qx2 + K02 * qk0 + K12 * qk1 + K02 * qu0 + K12 * qu1 + qux02 * kf0 + qux12 * kf1
    qkK0 = quu00 * K00 + quu01 * K10
    qkK1 = quu01 * K00 + quu11 * K10
    qkK0b = quu00 * K01 + quu01 * K11
    qkK1b = quu01 * K01 + quu11 * K11
    qkK0c = quu00 * K02 + quu01 * K12
    qkK1c = quu01 * K02 + quu11 * K12
    n00 = q00 + K00 * qkK0 + K10 * qkK1 + 2.0 * (K00 * qux00 + K10 * qux10)
    n01 = q01 + K00 * qkK0b + K10 * qkK1b + (K00 * qux01 + K10 * qux11) + (K01 * qux00 + K11 * qux10)
    n02 = q02 + K00 * qkK0c + K10 * qkK1c + (K00 * qux02 + K10 * qux12) + (K02 * qux00 + K12 * qux10)
    n11 = q11 + K01 * qkK0b + K11 * qkK1b + 2.0 * (K01 * qux01 + K11 * qux11)
    n12 = q12 + K01 * qkK0c + K11 * qkK1c + (K01 * qux02 + K11 * qux12) + (K02 * qux01 + K12 * qux11)
    n22 = q22 + K02 * qkK0c + K12 * qkK1c + 2.0 * (K02 * qux02 + K12 * qux12)
    V = (nvx0, nvx1, nvx2, n00, n01, n02, n11, n12, n22)
    dV1 = kf0 * qu0 + kf1 * qu1
    dV2 = 0.5 * (kf0 * qk0 + kf1 * qk1)
    return V, (kf0, kf1), ((K00, K01, K02), (K10, K11, K12)), dV1, dV2


def _bank_plain(cfg: BankConfig, m, u0):
    """The bank solve on (B,) planes, one scenario's schedule written as a
    sequence (a rollout per iteration, the line-search candidates one after
    another) with the per-scenario exits as masks. Returns (U (N,2,B),
    X (N+1,3,B), cost, kkt, iters, ls_rollouts)."""
    N, dt = cfg.N, cfg.dt
    lo_v, hi_v, lo_w, hi_w = cfg.lo_v, cfg.hi_v, cfg.lo_w, cfg.hi_w
    # clip bounds in float32 arithmetic, as the kernel forms them
    f32 = np.float32
    lo, hi, eps, d = f32([lo_v, lo_w]), f32([hi_v, hi_w]), f32([cfg.eps_v, cfg.eps_w]), f32(1e-3)
    (il_v, il_w), (ih_v, ih_w) = (lo + eps).tolist(), (hi - eps).tolist()
    (sl_v, sl_w), (sh_v, sh_w) = (lo + d * (hi - lo)).tolist(), (hi - d * (hi - lo)).tolist()
    B = u0.shape[-1]
    dev = u0.device
    i32 = torch.int32

    def barrier(v, w):
        return torch.log(v - lo_v) + torch.log(hi_v - v) + torch.log(w - lo_w) + torch.log(hi_w - w)

    def rollout(U, mu=None):
        """X (N+1,3,B) and the cost of U: barrier cost when mu is given."""
        px, py, th = m.x0
        X, J = [torch.stack([px, py, th])], torch.zeros_like(px)
        for k in range(N):
            v, w = U[k, 0], U[k, 1]
            c = m.stage_cost(k, px, py, th, v, w)
            J = J + (c if mu is None else c - mu * barrier(v, w))
            px, py, th = m.step(px, py, th, v, w)
            X.append(torch.stack([px, py, th]))
        return torch.stack(X), J + m.terminal_cost(px, py, th)

    U = torch.stack([torch.clamp(u0[:, 0], sl_v, sh_v), torch.clamp(u0[:, 1], sl_w, sh_w)], dim=1)
    reg = torch.full((B,), cfg.reg_init, dtype=_F32, device=dev)
    done = torch.zeros(B, dtype=i32, device=dev)
    iters = torch.zeros(B, dtype=i32, device=dev)
    lsro = torch.zeros(B, dtype=i32, device=dev)
    for mu, st, first in zip(cfg.mus, cfg.stages, cfg.firsts):
        active = done <= st
        if not bool(active.any()):
            continue
        iters += active.to(i32)
        X, J = rollout(U, mu)

        V = m.terminal_value(*X[N])
        dV1 = dV2 = torch.zeros_like(J)
        kff, kfb = [None] * N, [None] * N
        for k in reversed(range(N)):
            px, py, th = X[k]
            v, w = U[k, 0], U[k, 1]
            g = m.grad(k, px, py, th, v, w)
            sv_lo, sv_hi, sw_lo, sw_hi = v - lo_v, hi_v - v, w - lo_w, hi_w - w
            g = g._replace(
                lu0=g.lu0 - mu * (1.0 / sv_lo - 1.0 / sv_hi),
                lu1=g.lu1 - mu * (1.0 / sw_lo - 1.0 / sw_hi),
                luu00=g.luu00 + mu * (1.0 / (sv_lo * sv_lo) + 1.0 / (sv_hi * sv_hi)),
                luu11=g.luu11 + mu * (1.0 / (sw_lo * sw_lo) + 1.0 / (sw_hi * sw_hi)),
            )
            V, kff[k], kfb[k], d1, d2 = _riccati_step(V, m.jac(px, py, th, v, w), g, reg, dt)
            dV1, dV2 = dV1 + d1, dV2 + d2

        # per-scenario stage exit (never on a stage's first iteration)
        if not first:
            dec = -(dV1 + dV2)
            hit = active & (dec - cfg.stage_tol * (1.0 + J.abs()) < 0.0)
            done = torch.where(hit, torch.full_like(done, st + 1), done)

        # first-accept line search; scenarios skipping this iteration count
        # as accepted so they neither search nor commit
        accepted = ~active
        Ubest = U.clone()
        for a in range(cfg.n_alphas):
            searching = ~accepted
            if not bool(searching.any()):
                break
            lsro += searching.to(i32)
            alpha = 2.0**-a
            px, py, th = m.x0
            Jc = torch.zeros_like(J)
            cand = []
            for k in range(N):
                dx0, dx1, dx2 = px - X[k, 0], py - X[k, 1], th - X[k, 2]
                (K00, K01, K02), (K10, K11, K12) = kfb[k]
                v = U[k, 0] + alpha * kff[k][0] + (K00 * dx0 + K01 * dx1 + K02 * dx2)
                w = U[k, 1] + alpha * kff[k][1] + (K10 * dx0 + K11 * dx1 + K12 * dx2)
                v = torch.clamp(v, il_v, ih_v)
                w = torch.clamp(w, il_w, ih_w)
                Jc = Jc + (m.stage_cost(k, px, py, th, v, w) - mu * barrier(v, w))
                cand.append(torch.stack([v, w]))
                px, py, th = m.step(px, py, th, v, w)
            Jc = Jc + m.terminal_cost(px, py, th)
            expected = -(alpha * dV1 + alpha * alpha * dV2)
            Jc = torch.where(torch.isnan(Jc), torch.inf, Jc)
            ok = Jc <= J - cfg.c1 * torch.clamp(expected, min=0.0)
            Ubest = torch.where(searching, torch.stack(cand), Ubest)
            accepted = accepted | (ok & searching)
        acc = accepted & active
        U = torch.where(acc, Ubest, U)
        reg = torch.where(
            active,
            torch.where(
                acc,
                torch.clamp(reg * 0.5, min=cfg.reg_min),
                torch.clamp(reg * 10.0 + cfg.reg_min, max=cfg.reg_max),
            ),
            reg,
        )

    X, Jtrue = rollout(U)
    l0, l1, l2 = m.terminal_value(*X[N])[:3]
    kkt = torch.zeros_like(Jtrue)
    for k in reversed(range(N)):
        px, py, th = X[k]
        v, w = U[k, 0], U[k, 1]
        a02, a12, bc, bsn, b01, b11 = m.jac(px, py, th, v, w)
        g = m.grad(k, px, py, th, v, w)
        gu0 = g.lu0 + bc * l0 + bsn * l1
        gu1 = g.lu1 + b01 * l0 + b11 * l1 + dt * l2
        r0 = (v - torch.clamp(v - gu0, lo_v, hi_v)).abs()
        r1 = (w - torch.clamp(w - gu1, lo_w, hi_w)).abs()
        kkt = torch.maximum(kkt, torch.maximum(r0, r1))
        l0, l1, l2 = g.lx0 + l0, g.lx1 + l1, g.lx2 + a02 * l0 + a12 * l1 + l2
    return U, X, Jtrue, kkt, iters, lsro


def point_stab_bank_plain(cfg: BankConfig, x0g, w, obs, u0):
    """Plain PyTorch version of K1 on the kernel's planes: ``x0g`` (6, B),
    ``w`` (8, B), ``obs`` (2, n_obs, B), ``u0`` (N, 2, B). Returns
    ``(U (N,2,B), X (N+1,3,B), cost, kkt, iters, ls_rollouts)``."""
    return _bank_plain(cfg, _PointStabModel(cfg, x0g, w, obs), u0)


def tracking_bank_plain(cfg: BankConfig, x0, xref, uref, w, obs, u0):
    """Plain PyTorch version of K2 on the kernel's planes: ``x0`` (3, B),
    ``xref`` (N, 3, B), ``uref`` (N, 2, B), ``w`` (11, B), ``obs``
    (2, n_obs, B), ``u0`` (N, 2, B). Returns like
    :func:`point_stab_bank_plain`."""
    return _bank_plain(cfg, _TrackingModel(cfg, x0, xref, uref, w, obs), u0)


# ------------------------------------------------------------------ wrappers


def group_scratch_floats(N: int, n_alphas: int, group: int, extra: int = 0) -> int:
    """Floats of one scenario's shared scratch on ``group`` lanes, as
    ``csrc/group_solve.cuh group_scratch_floats``: ``extra`` floats of the
    kernel's own, X, U, kff, kfb, the stage terms, and the larger of the
    per-stage records (17 floats a stage) and the candidates' controls and
    states (5N for each of min(group, n_alphas) lanes), made odd."""
    slots = min(group, n_alphas)
    return (extra + 3 * (N + 1) + 11 * N + max(17 * N, 5 * N * slots)) | 1


def group_geometry(kind: str, B: int, N: int, n_alphas: int) -> dict:
    """The launch of kernel ``kind`` (a key of :data:`GROUP_GEOMETRY`) for a
    bank of B scenarios, as ``csrc/group_solve.cuh geometry`` computes it:
    lanes per scenario, scenarios and threads per block, blocks, and dynamic
    shared memory per block. Fewer scenarios share a block where B or the
    227 KB budget asks for it; raises ValueError where one scenario does not
    fit."""
    group, most, per_stage = GROUP_GEOMETRY[kind]
    per = 4 * group_scratch_floats(N, n_alphas, group, per_stage * N)
    spb = min(most, B, SMEM_PER_BLOCK // per)
    if spb < 1:
        raise ValueError(
            f"the {kind} kernel needs {per} bytes of shared memory for one scenario at N={N}, "
            f"n_alphas={n_alphas} (lanes {group}), more than the {SMEM_PER_BLOCK} a block may have"
        )
    return {
        "group": group,
        "scenarios_per_block": spb,
        "threads": spb * group,
        "blocks": -(-B // spb),
        "smem_bytes": spb * per,
    }


def _planes(t: torch.Tensor) -> torch.Tensor:
    """(B, *s) -> (*s, B), contiguous float32: the scenario index minor."""
    return t.to(_F32).movedim(0, -1).contiguous()


class CudaBankSolver:
    """``solve_bank(thetas, U0s) -> Solution`` over a bank of B scenarios.

    ``thetas`` is a dict of B-leading tensors (a batched ``make_theta``),
    ``U0s`` is (B, N, 2); all on one device. CPU tensors go to the plain
    version, CUDA tensors to the kernel; anything else raises. With
    ``with_counters`` the call returns ``(Solution, {"iters", "ls_rollouts"})``
    (per-scenario executed iterations and line-search candidate rollouts).

    ``launches`` counts the kernel's launches, and nothing else. Where a
    caller sets ``record`` to a list, each kernel call appends its
    ``(thetas, U0s, result)`` there, so every launch inside a composite can
    be held against :meth:`plain` on the inputs it was given.

    Under a profiler a call is the span ``bank.call``, enclosing
    ``bank.pack`` (:meth:`_pack`), ``bank.launch`` (:meth:`_launch`; on
    the CPU ``bank.plain``) and ``bank.finish`` (:meth:`_finish`).
    """

    def __init__(self, kind: str, cfg: BankConfig, with_counters: bool):
        self.kind = kind  # "point_stab" | "tracking"
        self.cfg = cfg
        self.with_counters = with_counters
        self.launches = 0
        self.record = None
        self._schedules: dict = {}  # device -> (mu, stage, first) tensors

    def _pack(self, thetas, U0s):
        x0 = thetas["x0"]
        if x0.dim() != 2 or x0.shape[1] != 3 or x0.shape[0] < 1:
            raise ValueError(f"thetas['x0'] must be (B, 3) with B >= 1, got {tuple(x0.shape)}")
        B, N = x0.shape[0], self.cfg.N
        if tuple(U0s.shape) != (B, N, 2):
            raise ValueError(f"U0s must be ({B}, {N}, 2), got {tuple(U0s.shape)}")
        obs_x, obs_y = thetas["obs_x"], thetas["obs_y"]
        if obs_x.dim() != 2 or obs_x.shape[0] != B or obs_y.shape != obs_x.shape:
            raise ValueError("thetas['obs_x'/'obs_y'] must be (B, n_obs)")
        w = [
            thetas["Q"][:, 0],
            thetas["Q"][:, 1],
            thetas["Q"][:, 2],
            thetas["R"][:, 0],
            thetas["R"][:, 1],
            thetas["reverse_factor"],
            thetas["obstacle_weight"] * thetas["obstacle_gain"],
            1.0 / thetas["inflation_radius"] ** 2,
        ]
        obs = torch.stack([_planes(obs_x), _planes(obs_y)])
        u0 = _planes(U0s)
        if self.kind == "point_stab":
            x0g = _planes(torch.cat([x0, thetas["goal"]], dim=1))
            planes = (x0g, _planes(torch.stack(w, dim=1)), obs, u0)
        else:
            tw = thetas.get("terminal_weight")
            if tw is None:  # thetas without the key solve the parity problem
                tw = torch.zeros_like(x0)
            w += [tw[:, 0], tw[:, 1], tw[:, 2]]
            xref, uref = _planes(thetas["x_ref"]), _planes(thetas["u_ref"])
            if tuple(xref.shape) != (N, 3, B) or tuple(uref.shape) != (N, 2, B):
                raise ValueError(f"thetas['x_ref'/'u_ref'] must be (B, {N}, 3) and (B, {N}, 2)")
            planes = (_planes(x0), xref, uref, _planes(torch.stack(w, dim=1)), obs, u0)
        dev = x0.device
        if any(p.device != dev for p in planes):
            raise ValueError("thetas and U0s must lie on one device")
        return planes

    def _plain(self, planes):
        fn = point_stab_bank_plain if self.kind == "point_stab" else tracking_bank_plain
        return fn(self.cfg, *planes)

    def _schedule(self, dev):
        if dev not in self._schedules:
            c = self.cfg
            self._schedules[dev] = (
                torch.tensor(c.mus, dtype=_F32, device=dev),
                torch.tensor(c.stages, dtype=torch.int32, device=dev),
                torch.tensor(c.firsts, dtype=torch.int32, device=dev),
            )
        return self._schedules[dev]

    def _launch(self, planes):
        from .. import _build

        c = self.cfg
        dev = planes[0].device
        obs, u0 = planes[-2], planes[-1]
        B, n_obs = u0.shape[-1], obs.shape[1]
        for p in planes:
            if p.dtype != _F32 or not p.is_contiguous():
                raise ValueError("kernel inputs must be contiguous float32")
        group_geometry(self.kind, B, c.N, c.n_alphas)  # raises before any build
        lib = _build.load_library()
        empty = lambda *s, dtype=_F32: torch.empty(*s, dtype=dtype, device=dev)  # noqa: E731
        U, X = empty(c.N, 2, B), empty(c.N + 1, 3, B)
        cost, kkt = empty(B), empty(B)
        iters, lsro = empty(B, dtype=torch.int32), empty(B, dtype=torch.int32)
        mu, stage, first = self._schedule(dev)
        ptrs = [p.data_ptr() for p in (*planes, mu, stage, first, U, X, cost, kkt, iters, lsro)]
        sched = [
            B, c.N, n_obs, len(c.mus), c.n_alphas,
            c.dt, c.lo_v, c.hi_v, c.lo_w, c.hi_w, c.eps_v, c.eps_w,
            c.c1, c.reg_init, c.reg_min, c.reg_max, c.stage_tol,
        ]  # fmt: skip
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if self.kind == "point_stab":
                err = lib.mpc_point_stab_launch(*ptrs, *sched, int(c.fast_sincos), stream)
            else:
                err = lib.mpc_tracking_launch(*ptrs, *sched, int(c.fast_sincos), int(c.wrap_yaw), stream)
        if err != 0:
            raise RuntimeError(f"{self.kind} kernel launch failed: {lib.mpc_error_string(err).decode()}")
        self.launches += 1
        return U, X, cost, kkt, iters, lsro

    def _finish(self, out):
        U, X, cost, kkt, iters, lsro = out
        sol = Solution(
            U=U.permute(2, 0, 1).contiguous(),
            X=X.permute(2, 0, 1).contiguous(),
            cost=cost,
            kkt_residual=kkt,
            converged=kkt < self.cfg.kkt_tol,
            n_iters=iters,
            reg=torch.zeros_like(cost),
        )
        if self.with_counters:
            return sol, {"iters": iters, "ls_rollouts": lsro}
        return sol

    def __call__(self, thetas, U0s):
        with span("bank.call"):
            with span("bank.pack"):
                planes = self._pack(thetas, U0s)
            dev = planes[0].device
            if dev.type == "cpu":
                with span("bank.plain"):
                    out = self._plain(planes)
            elif dev.type == "cuda":
                with span("bank.launch"):
                    out = self._launch(planes)
            else:
                raise ValueError(f"no bank solver for device {dev}")
            with span("bank.finish"):
                out = self._finish(out)
        # a caller's recorder runs outside the call's span
        if self.record is not None and dev.type == "cuda":
            self.record.append((thetas, U0s, out))
        return out

    def plain(self, thetas, U0s):
        """The plain PyTorch version on any device: the kernel's yardstick."""
        return self._finish(self._plain(self._pack(thetas, U0s)))

    def kernel_info(self, B: int = 4096) -> dict:
        """The kernel's geometry for a bank of B scenarios as its entry point
        computes it (the keys of :func:`group_geometry`), its registers,
        local memory and resident blocks per SM there, and ptxas's spill
        stores. Builds the kernels; needs a CUDA device."""
        from .. import _build

        c = self.cfg
        group_geometry(self.kind, B, c.N, c.n_alphas)  # raises before any build
        lib = _build.load_library()
        out = (ctypes.c_int * 6)()
        info = lib.mpc_point_stab_info if self.kind == "point_stab" else lib.mpc_tracking_info
        err = info(B, c.N, c.n_alphas, ctypes.cast(out, ctypes.c_void_p))
        if err != 0:
            raise RuntimeError(f"{self.kind} kernel info failed: {lib.mpc_error_string(err).decode()}")
        group, spb, smem, regs, local, per_sm = out
        return {
            "group": group,
            "scenarios_per_block": spb,
            "threads": spb * group,
            "blocks": -(-B // spb),
            "smem_bytes": smem,
            "registers": regs,
            "local_bytes": local,
            "blocks_per_sm": per_sm,
            "spill_stores": _build.spill_stores(f"{self.kind}_kernel"),
        }


def make_cuda_point_stab_solver(
    ocp: OCP,
    settings: SolverSettings = SolverSettings(),
    *,
    stage_tol: float = 1e-10,
    with_counters: bool = False,
    fast_sincos: bool = True,
) -> CudaBankSolver:
    """K1: ``solve_bank(thetas, U0s) -> Solution`` for a point-stabilization
    template from :func:`~ros2_mpc_tpu_torch.solver.problems.make_point_stabilization`
    (the kernel hard-codes that problem structure).

    ``stage_tol``: a scenario leaves a barrier stage once its Newton decrement
    ``-(dV1+dV2) < stage_tol * (1+|J|)`` (never on the stage's first
    iteration); at 1e-10 the skipped steps move U by ~1e-5. ``fast_sincos``
    selects the paired polynomial sin/cos (False: libdevice ``sincosf``)."""
    return CudaBankSolver(
        "point_stab", _bank_config(ocp, settings, stage_tol, fast_sincos, False), with_counters
    )


def make_cuda_tracking_solver(
    ocp: OCP,
    settings: SolverSettings = SolverSettings(),
    *,
    stage_tol: float = 1e-10,
    with_counters: bool = False,
    fast_sincos: bool = True,
    wrap_yaw: bool = None,
) -> CudaBankSolver:
    """K2: the tracking formulation of :func:`make_cuda_point_stab_solver`'s
    contract, for a template from
    :func:`~ros2_mpc_tpu_torch.solver.problems.make_tracking`. ``wrap_yaw``
    defaults to the OCP's ``meta`` (set by make_tracking's corrected mode)."""
    if wrap_yaw is None:
        wrap_yaw = "wrap_yaw" in getattr(ocp, "meta", ())
    return CudaBankSolver(
        "tracking", _bank_config(ocp, settings, stage_tol, fast_sincos, wrap_yaw), with_counters
    )


def single_scenario(solve_bank):
    """``solve(theta, U0, *extra) -> Solution`` for one scenario through a
    bank solve at B=1 (e.g. as ``solve_fn`` of the packed tick).
    ``solve_bank`` is a :class:`CudaBankSolver` built without counters, its
    ``plain``, or any B-leading ``solve_bank(thetas, U0s, *extra)`` (the
    MPPI family takes a generator as ``extra``)."""

    def solve(theta, U0, *extra):
        sol = solve_bank({k: v[None] for k, v in theta.items()}, U0[None], *extra)
        return Solution(*(f[0] for f in sol))

    return solve

"""Roofline accounting for the port's whole-solver kernels on one H100.

Port of :mod:`ros2_mpc_tpu.utils.roofline`, with the same names. Three
pieces:

1. **Measured peaks** (:func:`measure_vpu_peaks`): K3 (``csrc/chain.cu``)
   runs long dependent chains of FMAs, ``exp``, ``log`` or paired sin/cos per
   element, built beside K1 and K2 under their flags, and gives this card's
   rate for each op class as the solver kernels execute it.
   :func:`measure_loop_overhead` measures one loop trip in 64-thread
   blocks, one chain per thread.

2. **Analytic op counts** (:func:`point_stab_solve_flops`,
   :func:`tracking_solve_flops`, ...): the per-scenario written-op ledgers
   of the kernels' closed forms, framework-free NumPy, a copy of the JAX
   module's (its docstrings give the region constants). The port's kernels
   (``csrc/common.cuh``) keep those closed forms; their executed work comes
   from the kernels' counters (``with_counters=True``) and, for obstacles,
   from :func:`computed_obstacle_points` with ``tile_s=1, tile_l=1,
   chunk=1``: the port walks each scenario's own live prefix.

3. **The verdict** (:func:`roofline_report`): achieved FLOP/s, the share of
   the measured FMA peak, the cycle-model utilization at the measured
   per-class rates, and the arithmetic intensity.

On a CPU tensor (``device="cpu"``) the measuring functions run K3's plain
version, :func:`chain`, on the host clock: host rates, not the card's.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class FlopCount:
    """Op counts by op class. ``arith`` are 1-FLOP ops; transcendentals are
    counted as 1 *op* each (their cycle cost enters via the measured rates)."""

    arith: float = 0.0
    exp: float = 0.0
    log: float = 0.0
    sincos: float = 0.0

    @property
    def total_flops(self) -> float:
        """Conventional FLOP total (each transcendental = 1 FLOP)."""
        return self.arith + self.exp + self.log + self.sincos

    def __add__(self, other: "FlopCount") -> "FlopCount":
        return FlopCount(
            self.arith + other.arith,
            self.exp + other.exp,
            self.log + other.log,
            self.sincos + other.sincos,
        )

    def scale(self, k: float) -> "FlopCount":
        return FlopCount(self.arith * k, self.exp * k, self.log * k, self.sincos * k)


# ---------------------------------------------------------------------------
# Analytic ledgers (framework-free; the JAX module's, region by region). "P"
# is the number of obstacle points a solve computes per obstacle-term
# evaluation, from computed_obstacle_points().
# ---------------------------------------------------------------------------

def point_stab_solve_flops(
    N: int, P: float, iters: float, ls_rollouts: float, fast_sincos: bool = False
) -> FlopCount:
    """Per-scenario op count of one point-stabilization solve (K1) that
    executed ``iters`` solver iterations and ``ls_rollouts`` line-search
    candidate rollouts.

    Region ledger (ops per horizon step unless noted):

    * RK4 transition ``F``: 16 arith + 6 sincos.
    * RK4 Jacobian ``F_jac``: 26 arith + 6 sincos.
    * ``stage_cost`` (goal/control quadratics, reverse penalty, log barrier):
      29 arith + 1 exp + 4 log, plus P x (9 arith + 1 exp) obstacle value.
    * ``obstacle_terms`` (value+grad+Hessian): P x (39 arith + 1 exp).
    * rollout_cost step = stage_cost + accumulate + F = 46 (+9P) arith.
    * backward sweep step (F_jac, quadratization, Riccati update, 2x2
      solves): 361 (+39P) arith + (1+P) exp + 6 sincos.
    * line-search candidate step (feedback law, clip, stage_cost, F):
      72 (+9P) arith + (1+P) exp + 4 log + 6 sincos; +13 arith flat
      (Armijo test) per rollout.
    * commit + regularizer update: 2N + 4 arith per iteration.
    * final rollout: 37 (+9P) arith + (1+P) exp + 6 sincos per step.
    * adjoint KKT sweep: 73 (+39P) arith + (1+P) exp + 6 sincos per step.
    * strict-interior init: 4 arith per step, once.

    Arguments accept scalars or (B,) arrays (vectorized ledger for a bank).
    """
    I, R = np.asarray(iters, dtype=float), np.asarray(ls_rollouts, dtype=float)
    arith = (
        I * N * (46.0 + 361.0 + 2.0)  # rollout + backward + commit
        + I * 4.0  # regularizer update
        + R * (N * 72.0 + 13.0)  # line-search rollouts
        + N * (37.0 + 73.0 + 4.0)  # final rollout + adjoint + init_u
        + P * N * (I * (9.0 + 39.0) + R * 9.0 + (9.0 + 39.0))
    )
    exp = (2.0 * I + R + 2.0) * N * (1.0 + P)
    log = 4.0 * N * (I + R)
    sincos = 6.0 * N * (2.0 * I + R + 2.0)
    if fast_sincos:
        # the kernels' default paired-polynomial sin/cos (common.cuh
        # sincos_sel): each pair is ~21 FMA-class ops (shared 2*pi reduction
        # + odd/even Horner), so sincos ops convert to arith
        return FlopCount(arith + sincos * 10.5, exp, log, 0.0)
    return FlopCount(arith, exp, log, sincos)


def point_stab_phase_flops(
    N: int, P: float, iters: float, ls_rollouts: float, fast_sincos: bool = False
) -> dict:
    """The :func:`point_stab_solve_flops` ledger split by solver phase:

    * ``rollout``: the per-iteration trajectory+cost rollout, commit and
      regularizer bookkeeping;
    * ``backward``: F_jac, quadratization, Riccati recursion, 2x2 solves;
    * ``line_search``: all executed candidate rollouts + Armijo tests;
    * ``final``: strict-interior init, final rollout, adjoint KKT sweep.

    Summing the phases reproduces :func:`point_stab_solve_flops` exactly."""
    I, R = np.asarray(iters, dtype=float), np.asarray(ls_rollouts, dtype=float)
    zeros = np.zeros_like(I + R)

    def mk(arith, exp, log, sincos):
        if fast_sincos:
            return FlopCount(arith + sincos * 10.5, exp, log, zeros + 0.0)
        return FlopCount(arith, exp, log, sincos)

    phases = {
        "rollout": mk(
            I * N * (46.0 + 2.0) + I * 4.0 + P * N * I * 9.0,
            I * N * (1.0 + P),
            4.0 * N * I,
            6.0 * N * I,
        ),
        "backward": mk(
            I * N * 361.0 + P * N * I * 39.0,
            I * N * (1.0 + P),
            0.0 * I,
            6.0 * N * I,
        ),
        "line_search": mk(
            R * (N * 72.0 + 13.0) + P * N * R * 9.0,
            R * N * (1.0 + P),
            4.0 * N * R,
            6.0 * N * R,
        ),
        "final": mk(
            N * (37.0 + 73.0 + 4.0) + P * N * (9.0 + 39.0) + zeros,
            2.0 * N * (1.0 + P) + zeros,
            zeros + 0.0,
            6.0 * N * 2.0 + zeros,
        ),
    }
    return phases


def phase_model_seconds(phases: dict, peaks: dict) -> dict:
    """Cycle-model seconds per phase (each op class at its measured peak)."""
    out = {}
    for name, c in phases.items():
        out[name] = (
            c.arith / peaks["fma_flops_per_s"]
            + c.exp / peaks["exp_per_s"]
            + c.log / peaks["log_per_s"]
            + c.sincos / peaks["sincos_per_s"]
        )
    return out


def tracking_solve_flops(
    N: int,
    P: float,
    iters: float,
    ls_rollouts: float,
    terminal_quad: bool = True,
    fast_sincos: bool = False,
) -> FlopCount:
    """Per-scenario op count of one tracking solve (K2). Ledger differences
    vs point-stab: Euler ``F`` = 8 arith + 2 sincos, ``F_jac`` = 7 arith + 2
    sincos, reference subtractions in the cost (+2 arith), sparser B column
    (backward step = 311 + 39P arith), and a terminal obstacle evaluation per
    rollout / backward init / adjoint init. ``terminal_quad`` adds the
    optional terminal pose quadratic (~12 arith per cost evaluation)."""
    I, R = np.asarray(iters, dtype=float), np.asarray(ls_rollouts, dtype=float)
    tq = 12.0 if terminal_quad else 0.0
    # per-rollout terminal obstacle value: 9P arith + P exp; per backward /
    # adjoint init obstacle_terms: 39P arith + P exp
    arith = (
        I * (N * (40.0 + 311.0 + 2.0) + 4.0 + tq)
        + R * (N * 66.0 + 13.0 + 9.0 * P + tq)
        + N * (31.0 + 53.0 + 4.0)
        + 2.0 * (9.0 * P + tq)  # final rollout terminal + its duplicate in cost
        + P * N * (I * (9.0 + 39.0) + R * 9.0 + (9.0 + 39.0))
        + P * (I * (9.0 + 39.0) + 39.0)  # terminal obstacle in rollout/bwd/adjoint
    )
    exp = (2.0 * I + R + 2.0) * N * (1.0 + P) + P * (2.0 * I + R + 2.0)
    log = 4.0 * N * (I + R)
    sincos = 2.0 * N * (2.0 * I + R + 2.0) + 2.0 * N * I  # F_jac in bwd+adjoint
    if fast_sincos:
        return FlopCount(arith + sincos * 10.5, exp, log, 0.0)
    return FlopCount(arith, exp, log, sincos)


def bank_flops(per_scenario_fn, N: int, P, iters, ls_rollouts, **kw) -> FlopCount:
    """Total op count of a whole bank: ``per_scenario_fn`` (one of the
    ``*_solve_flops`` ledgers) evaluated with (B,) arrays and summed."""
    c = per_scenario_fn(N, np.asarray(P, dtype=float), iters, ls_rollouts, **kw)
    return FlopCount(
        float(np.sum(c.arith)),
        float(np.sum(c.exp)),
        float(np.sum(c.log)),
        float(np.sum(c.sincos)),
    )


def computed_obstacle_points(
    obs_x, obs_y, obstacle_weight, tile_s: int = 8, tile_l: int = 128, chunk: int = 8
) -> np.ndarray:
    """(B,) obstacle points computed per obstacle evaluation for scenarios
    that exit together in tiles of ``tile_s * tile_l``: zero if the tile's
    obstacle weight is all-zero, else ceil(live-prefix / chunk) x chunk where
    the live prefix is the tile-wide max index of any point within +-90 m.
    The defaults are the TPU kernel's (8, 128) tile and 8-point chunks; the
    port's kernels walk each scenario's exact prefix (``tile_s=1, tile_l=1,
    chunk=1``), and a warp of 32 lanes issues its longest lane's prefix
    (``tile_l=32``)."""
    obs_x = np.asarray(obs_x)
    obs_y = np.asarray(obs_y)
    w = np.broadcast_to(np.asarray(obstacle_weight), obs_x.shape[:1])
    B, n_obs = obs_x.shape
    tile = tile_s * tile_l
    if chunk and n_obs % chunk != 0:
        chunk = n_obs
    out = np.zeros(B)
    for t0 in range(0, B, tile):
        sl = slice(t0, min(t0 + tile, B))
        if not np.any(np.abs(w[sl]) > 0.0):
            continue
        live = np.logical_or(np.abs(obs_x[sl]) < 90.0, np.abs(obs_y[sl]) < 90.0)
        idx = np.where(live, np.arange(1, n_obs + 1)[None, :], 0)
        n_live = int(idx.max()) if idx.size else 0
        out[sl] = math.ceil(n_live / chunk) * chunk if n_live else 0
    return out


def bank_phase_flops(N: int, P, iters, ls_rollouts, **kw) -> dict:
    """Per-phase op counts summed over a bank (phase-name -> FlopCount)."""
    phases = point_stab_phase_flops(
        N, np.asarray(P, dtype=float), iters, ls_rollouts, **kw
    )
    return {
        k: FlopCount(
            float(np.sum(c.arith)),
            float(np.sum(c.exp)),
            float(np.sum(c.log)),
            float(np.sum(c.sincos)),
        )
        for k, c in phases.items()
    }


def point_stab_hbm_bytes(N: int, n_obs: int) -> float:
    """Device-memory traffic per scenario (f32): theta in (x0 3 + goal 3 +
    weights 8 + obstacles 2*n_obs + U0 2N) + outputs (U 2N + X 3(N+1) +
    cost/kkt/iters/ls 4)."""
    return 4.0 * (6 + 8 + 2 * n_obs + 2 * N + 2 * N + 3 * (N + 1) + 4)


def solver_loop_trips(N: int, iters, ls_rollouts, n_obs_chunks: float = 0.0) -> float:
    """Estimated loop trips one solve executes: per iteration a rollout (N),
    a backward sweep (N) and a commit (N) loop, ``ls_rollouts`` candidate
    rollouts of N trips each, plus init/final/adjoint (3N) and the
    per-evaluation obstacle loops (``n_obs_chunks`` trips per obstacle
    evaluation, a scalar or a (B,) array; pass 0 to ignore)."""
    I = np.asarray(iters, dtype=float)
    R = np.asarray(ls_rollouts, dtype=float)
    trips = I * 3.0 * N + R * N + 3.0 * N
    if np.any(n_obs_chunks):
        trips = trips + n_obs_chunks * (2.0 * I * N + R * N + 2.0 * N)
    return trips


def roofline_report(
    count: FlopCount,
    seconds: float,
    peaks: dict,
    hbm_bytes: float = 0.0,
) -> dict:
    """Achieved rate vs the measured rooflines.

    * ``achieved_gflops``: conventional FLOP/s (transcendentals = 1).
    * ``pct_vpu_fma_peak``: achieved / measured FMA peak, in percent;
      understates a transcendental-heavy kernel.
    * ``vpu_model_utilization``: cycle-model time (each op class at its own
      measured peak) / measured time: the share of the speed of light of
      this op mix.
    * ``arithmetic_intensity_flops_per_byte`` (with ``hbm_bytes``): compute-
      vs bandwidth-bound (the H100's ridge: 67 TFLOP/s over 3.35 TB/s, 20
      FLOP/B).
    """
    model_t = (
        count.arith / peaks["fma_flops_per_s"] * 1.0  # arith ops are 1 FLOP; peak counts 2/op
        + count.exp / peaks["exp_per_s"]
        + count.log / peaks["log_per_s"]
        + count.sincos / peaks["sincos_per_s"]
    )
    out = {
        "flops": count.total_flops,
        "achieved_gflops": count.total_flops / seconds / 1e9,
        "pct_vpu_fma_peak": 100.0 * (count.total_flops / seconds) / peaks["fma_flops_per_s"],
        "vpu_model_utilization": model_t / seconds,
        "transcendental_frac": (count.exp + count.log + count.sincos)
        / max(count.total_flops, 1.0),
    }
    if hbm_bytes:
        out["arithmetic_intensity_flops_per_byte"] = count.total_flops / hbm_bytes
    return out


# ---------------------------------------------------------------------------
# K3 and the measured peaks
# ---------------------------------------------------------------------------

# op -> (code in csrc/chain.cu, ops per step, FLOP per op in the peak, key)
CHAIN_OPS = {
    "fma": (0, 1, 2.0, "fma_flops_per_s"),
    "exp": (1, 1, 1.0, "exp_per_s"),
    "log": (2, 1, 1.0, "log_per_s"),
    "sincos": (3, 2, 1.0, "sincos_per_s"),
}
CHAIN_UNROLLS = (1, 16)  # the inner-loop lengths K3 is compiled for
# The peaks' geometry: 256-thread blocks, 1056 x 256 elements = 8 blocks on
# each of the H100's 132 SMs, 64 warps per SM, the most an SM holds: four
# times the 16 that cover a ~4-cycle FFMA latency with one dependent chain
# per thread, so the loop's own instructions are all that stand between the
# chain and the issue rate. (The TPU's 256 x 256 block would be 15.5 warps
# per SM, short of those 16.)
CHAIN_BLOCK = 256
PEAK_ROWS, PEAK_COLS = 1056, 256
# measure_loop_overhead's threads a block: the one-thread-per-scenario
# geometry the bank kernels were first built with, kept so that its number
# stays comparable with the earlier measurements in PERF.md
LOOP_BLOCK = 64
# The fma map's constants as the kernel's float literals round them.
_FMA_A = float(np.float32(1.0000001))
_FMA_B = float(np.float32(1e-9))


def _step(x: torch.Tensor, op: str) -> torch.Tensor:
    if op == "fma":
        # x * a is exact in float64 and so is + b while x < 1 (the chains
        # start at 0.5 and grow 2^-23 a step): one rounding to float32, as
        # the kernel's __fmaf_rn
        return (x.double() * _FMA_A + _FMA_B).float()
    if op == "exp":
        return torch.exp(-x)
    if op == "log":
        return torch.log(x) + 2.0
    return torch.cos(x) + 0.5 * torch.sin(x)


def chain(x: torch.Tensor, op: str, n_steps: int, unroll: int) -> torch.Tensor:
    """The plain version of K3: ``n_steps * unroll`` dependent applications
    of ``op``'s map (:data:`CHAIN_OPS`) to each element of float32 ``x``."""
    if op not in CHAIN_OPS:
        raise ValueError(f"op must be one of {sorted(CHAIN_OPS)}, got {op!r}")
    for _ in range(n_steps * unroll):
        x = _step(x, op)
    return x


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance between two float32 tensors in units in the
    last place: how many float32 values lie between them (0 when equal,
    +0 and -0 equal)."""

    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(2**31) - i, i)

    return (ordered(a) - ordered(b)).abs()


class ChainKernel:
    """K3: ``kernel(x, op, n_steps, unroll, block)`` computes
    :func:`chain` on ``x``'s device. A CPU tensor runs :func:`chain`; a CUDA
    tensor launches ``csrc/chain.cu`` (``unroll`` 1 or 16, one element per
    thread, ``block`` threads a block) or raises; anything else raises.

    ``launches`` counts the kernel's launches, and nothing else. The
    measuring functions launch the module's one instance,
    :data:`chain_kernel`."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, op: str, n_steps: int, unroll: int,
                 block: int = CHAIN_BLOCK) -> torch.Tensor:
        if x.device.type == "cpu":
            return chain(x, op, n_steps, unroll)
        if x.device.type != "cuda":
            raise ValueError(f"no chain kernel for device {x.device}")
        if op not in CHAIN_OPS or unroll not in CHAIN_UNROLLS or n_steps < 0:
            raise ValueError(f"bad chain: op {op!r}, unroll {unroll}, n_steps {n_steps}")
        if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
            raise ValueError("chain input must be a non-empty contiguous float32 tensor")
        from .. import _build

        lib = _build.load_library()
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.mpc_chain_launch(
                x.data_ptr(), out.data_ptr(), x.numel(), n_steps, CHAIN_OPS[op][0], unroll,
                block, stream,
            )
        if err != 0:
            raise RuntimeError(f"chain kernel launch failed: {lib.mpc_error_string(err).decode()}")
        self.launches += 1
        return out


chain_kernel = ChainKernel()


def _chain_rate(op_name: str, rows: int, cols: int, n_steps: int, unroll: int, device,
                n_calls: int = 4, block: int = CHAIN_BLOCK) -> float:
    """Sustained ops/s of K3 running ``n_steps * unroll`` dependent steps of
    ``op_name`` on each element of a (rows, cols) float32 block.

    Timing: a warm-up call, then ``n_calls`` back-to-back calls on distinct
    inputs, best of 2; on the card between two CUDA events, on the CPU on
    the host clock."""
    dev = torch.device(device)
    xs = [torch.full((rows, cols), 0.5 + 1e-4 * i, dtype=torch.float32, device=dev)
          for i in range(n_calls)]  # fmt: skip
    chain_kernel(xs[0], op_name, n_steps, unroll, block)  # warm-up (and the build)
    on_card = dev.type == "cuda"
    best = math.inf
    for _ in range(2):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            outs = [chain_kernel(x, op_name, n_steps, unroll, block) for x in xs]
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            outs = [chain_kernel(x, op_name, n_steps, unroll, block) for x in xs]
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    if not bool(torch.isfinite(outs[-1]).all()):
        raise RuntimeError(f"chain {op_name}: non-finite result")
    return n_calls * rows * cols * n_steps * unroll * CHAIN_OPS[op_name][1] / best


def measure_vpu_peaks(
    rows: int = PEAK_ROWS,
    cols: int = PEAK_COLS,
    target_s: float = 0.2,
    device=None,
) -> dict:
    """This card's throughput per op class, measured with K3.

    Returns ``{"fma_flops_per_s", "exp_per_s", "log_per_s", "sincos_per_s"}``
    (the JAX module's keys). Each chain is calibrated, then re-run long
    enough that every call holds ~``target_s`` of device work, so launch
    cost vanishes from the rate. FMA counts 2 FLOPs/op; the transcendental
    rates are ops/s (each carries one companion arith op, negate or add,
    inside the measured rate, so they are conservative). ``device=None`` is
    the card; ``device="cpu"`` runs the plain version briefly, uncalibrated."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    numel = rows * cols
    peaks = {}
    for name, (_, ops_per_step, flops_per_op, key) in CHAIN_OPS.items():
        unroll = 16
        n_steps = 4096 if on_card else 8
        rate = _chain_rate(name, rows, cols, n_steps, unroll, dev)
        if on_card:
            per_call = numel * n_steps * unroll * ops_per_step / rate
            n_steps = max(n_steps, int(n_steps * target_s / max(per_call, 1e-4)))
            rate = _chain_rate(name, rows, cols, n_steps, unroll, dev)
        peaks[key] = flops_per_op * rate
    return peaks


def measure_loop_overhead(
    rows: int = 32,
    cols: int = 128,
    device=None,
) -> float:
    """Measured per-trip overhead (seconds) of a loop in a kernel with one
    dependent chain per thread: ``rows * cols`` elements (default 4096, the
    bank size) in blocks of :data:`LOOP_BLOCK` (64) threads.

    Method: the FMA chain at ``unroll=16`` measures the FMA rate; the same
    chain at ``unroll=1`` pays one loop trip (counter, compare, branch) per
    FMA. The per-trip difference is the loop overhead. Feeds the gap
    decomposition: solver loop trips x this number = modelled control-flow
    seconds. ``device`` as in :func:`measure_vpu_peaks`."""
    dev = resolve_device(device)
    n_steps = 16384 if dev.type == "cuda" else 64
    rate16 = _chain_rate("fma", rows, cols, n_steps, 16, dev, block=LOOP_BLOCK)
    rate1 = _chain_rate("fma", rows, cols, n_steps * 16, 1, dev, block=LOOP_BLOCK)
    numel = rows * cols
    per_trip_1 = numel / rate1  # seconds per unroll=1 trip (1 FMA + overhead)
    per_fma = numel / rate16  # seconds per FMA inside an unrolled body
    return max(0.0, per_trip_1 - per_fma)

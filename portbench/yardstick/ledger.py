"""The roofline yardstick, frozen: the published peaks of one H100 and the
closed-form operation and byte counts of one solve.

The operation ledgers are copies of the port's ``utils/roofline.py``
(``point_stab_solve_flops``, ``tracking_solve_flops``,
``point_stab_hbm_bytes``), themselves the JAX package's region ledgers;
each transcendental counts as one operation, whatever implements it. A
later change to the program cannot move them.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def point_stab_flops(N: int, P, iters, ls_rollouts):
    """Operations of one point-stabilization solve that executed ``iters``
    iterations and ``ls_rollouts`` line-search candidate rollouts with ``P``
    live obstacle points (scalars or (S,) arrays). Per horizon step: RK4
    transition 16 arith + 6 sincos; rollout step 46 (+9P) arith; backward
    step 361 (+39P) arith + (1+P) exp + 6 sincos; line-search candidate
    step 72 (+9P) arith, +13 per rollout; commit 2N + 4 per iteration;
    final rollout 37 (+9P), adjoint 73 (+39P), interior init 4."""
    I, R, P = (np.asarray(a, dtype=float) for a in (iters, ls_rollouts, P))
    arith = (
        I * N * (46.0 + 361.0 + 2.0)
        + I * 4.0
        + R * (N * 72.0 + 13.0)
        + N * (37.0 + 73.0 + 4.0)
        + P * N * (I * (9.0 + 39.0) + R * 9.0 + (9.0 + 39.0))
    )
    exp = (2.0 * I + R + 2.0) * N * (1.0 + P)
    log = 4.0 * N * (I + R)
    sincos = 6.0 * N * (2.0 * I + R + 2.0)
    return arith + exp + log + sincos


def tracking_flops(N: int, P, iters, ls_rollouts, terminal_quad: bool = True):
    """Operations of one tracking solve: Euler transition 8 arith + 2
    sincos, Jacobian 7 + 2 sincos, reference subtractions +2, backward step
    311 (+39P), a terminal obstacle evaluation per rollout and per sweep's
    start, and the terminal pose quadratic (~12 arith an evaluation)."""
    I, R, P = (np.asarray(a, dtype=float) for a in (iters, ls_rollouts, P))
    tq = 12.0 if terminal_quad else 0.0
    arith = (
        I * (N * (40.0 + 311.0 + 2.0) + 4.0 + tq)
        + R * (N * 66.0 + 13.0 + 9.0 * P + tq)
        + N * (31.0 + 53.0 + 4.0)
        + 2.0 * (9.0 * P + tq)
        + P * N * (I * (9.0 + 39.0) + R * 9.0 + (9.0 + 39.0))
        + P * (I * (9.0 + 39.0) + 39.0)
    )
    exp = (2.0 * I + R + 2.0) * N * (1.0 + P) + P * (2.0 * I + R + 2.0)
    log = 4.0 * N * (I + R)
    sincos = 2.0 * N * (2.0 * I + R + 2.0) + 2.0 * N * I
    return arith + exp + log + sincos


def point_stab_bytes(N: int, n_obs: int) -> float:
    """Bytes one point-stabilization scenario must move, float32: inputs
    (x0 3, goal 3, weights 8, obstacles 2n, warm start 2N) read once and
    outputs (U 2N, X 3(N+1), cost, KKT, two counters) written once."""
    return 4.0 * (6 + 8 + 2 * n_obs + 2 * N + 2 * N + 3 * (N + 1) + 4)


def tracking_bytes(N: int, n_obs: int) -> float:
    """As :func:`point_stab_bytes` for tracking: x0 3, reference windows
    3N + 2N, weights 11, obstacles 2n, warm start 2N in; the same out."""
    return 4.0 * (3 + 5 * N + 11 + 2 * n_obs + 2 * N + 2 * N + 3 * (N + 1) + 4)


def bound_seconds(flops: float, nbytes: float) -> tuple:
    """The least time the card could take, and which peak sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

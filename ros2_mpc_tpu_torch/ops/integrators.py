"""Fixed-step integrators and horizon rollouts.

Port of :mod:`ros2_mpc_tpu.ops.integrators`: Euler for tracking, RK4 for
point stabilization (the reference's behavioural difference, kept). The JAX
``lax.scan`` rollout becomes a Python loop; PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import Callable

import torch

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def euler_step(f: Dynamics, x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One explicit-Euler step."""
    return x + dt * f(x, u)


def rk4_step(f: Dynamics, x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """One classical RK4 step with zero-order-hold control."""
    k1 = f(x, u)
    k2 = f(x + dt / 2 * k1, u)
    k3 = f(x + dt / 2 * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


STEPPERS = {"euler": euler_step, "rk4": rk4_step}


def make_step(f: Dynamics, integrator: str, dt) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Discrete transition ``F(x, u) -> x_next`` for a named integrator."""
    stepper = STEPPERS[integrator]

    def F(x, u):
        return stepper(f, x, u, dt)

    return F


def rollout(F: Callable, x0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Roll controls ``U: (N, m)`` from ``x0: (n,)`` through ``F``; returns
    ``X: (N+1, n)`` with ``X[0] == x0``."""
    X = [x0]
    for k in range(U.shape[0]):
        X.append(F(X[-1], U[k]))
    return torch.stack(X, dim=0)

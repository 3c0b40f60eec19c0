"""Kinematic bicycle (Ackermann / car-like) model on tensors.

Port of :mod:`ros2_mpc_tpu.models.bicycle`:

    xdot = v * cos(theta)
    ydot = v * sin(theta)
    thetadot = v * tan(delta) / wheelbase

State ``(x, y, theta)``, control ``(v, delta)``: forward speed and steering
angle. Constant steering drives a circular arc of radius
``wheelbase / tan(delta)``.
"""

from __future__ import annotations

import torch

N_STATES = 3
N_CONTROLS = 2


def make_f(wheelbase: float = 0.3):
    """Continuous-time dynamics ``f(x, u) -> xdot`` for a given wheelbase [m]."""

    def f(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        theta = x[..., 2]
        v = u[..., 0]
        delta = u[..., 1]
        return torch.stack(
            [v * torch.cos(theta), v * torch.sin(theta), v * torch.tan(delta) / wheelbase],
            dim=-1,
        )

    return f

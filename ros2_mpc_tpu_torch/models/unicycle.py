"""Differential-drive unicycle kinematics on tensors.

Port of :mod:`ros2_mpc_tpu.models.unicycle`:

    xdot = v * cos(theta),  ydot = v * sin(theta),  thetadot = w

State is ``(x, y, theta)``, control is ``(v, w)``. Pure and elementwise, so
it composes with ``torch.func`` (``vmap``, ``jacfwd``, ``hessian``).
"""

from __future__ import annotations

import torch

N_STATES = 3
N_CONTROLS = 2


def f(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Continuous-time unicycle dynamics. ``x``: (..., 3), ``u``: (..., 2)."""
    theta = x[..., 2]
    v = u[..., 0]
    w = u[..., 1]
    return torch.stack([v * torch.cos(theta), v * torch.sin(theta), w], dim=-1)

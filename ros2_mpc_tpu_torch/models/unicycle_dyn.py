"""Smooth-actuation unicycle: velocities as states, accelerations as controls.

Port of :mod:`ros2_mpc_tpu.models.unicycle_dyn`:

    xdot = v cos(theta),  ydot = v sin(theta),  thetadot = w
    vdot = a,             wdot  = alpha

State ``(x, y, theta, v, w)``, control ``(a, alpha)``: linear and angular
acceleration, box-bounded by the solver's interior-point treatment, so the
command's rate limit is part of the optimization.
"""

from __future__ import annotations

import torch

N_STATES = 5
N_CONTROLS = 2


def f(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Continuous-time dynamics. ``x``: (..., 5), ``u``: (..., 2)."""
    theta = x[..., 2]
    v = x[..., 3]
    w = x[..., 4]
    return torch.stack(
        [v * torch.cos(theta), v * torch.sin(theta), w, u[..., 0], u[..., 1]],
        dim=-1,
    )

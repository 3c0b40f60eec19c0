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

from ..device import device_constant
from ..ops.grid import reciprocal_f32

N_STATES = 3
N_CONTROLS = 2


def make_f(wheelbase: float = 0.3):
    """Continuous-time dynamics ``f(x, u) -> xdot`` for a given wheelbase [m].

    XLA divides by the constant wheelbase as a product with its float32
    reciprocal, so the port multiplies by that reciprocal too. It is a
    float32 tensor, not a Python float: a Python float against a product of
    0-dim tensors makes ``torch.func.jacfwd``'s tangents float64, and the
    transition's Jacobian ``B`` then leaves the float32 arithmetic of the
    JAX package. It is copied to the device once (``device_constant``): a
    new tensor on every call would block the host on each transition."""
    inv_wheelbase = device_constant(reciprocal_f32(wheelbase))

    def f(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        theta = x[..., 2]
        v = u[..., 0]
        delta = u[..., 1]
        inv = inv_wheelbase(x.device, x.dtype)
        return torch.stack([v * torch.cos(theta), v * torch.sin(theta), v * torch.tan(delta) * inv], dim=-1)

    return f

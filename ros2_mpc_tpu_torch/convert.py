"""Carry the JAX package's state into the port and back.

A theta pytree of :mod:`ros2_mpc_tpu` (a dict of arrays: the problem's
"weights" and sensor data) becomes the port's dict of float32 tensors, and a
port :class:`~ros2_mpc_tpu_torch.solver.ilqr.Solution` becomes NumPy again,
so both packages can be run on one input and compared. Only NumPy crosses
the boundary; this module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .solver.ilqr import Solution


def theta_from_numpy(thetas: dict, device=None) -> dict:
    """``{name: array}`` (NumPy or anything ``np.asarray`` takes, e.g. a jax
    array) -> ``{name: float32 tensor on device}``; ``device=None`` is the
    card (raises without one)."""
    device = resolve_device(device)
    return {
        k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
        for k, v in thetas.items()
    }


def solution_to_numpy(sol: Solution) -> Solution:
    """A Solution of tensors -> the same Solution of NumPy arrays."""
    return Solution(
        *(np.asarray(f.detach().cpu()) if torch.is_tensor(f) else np.asarray(f) for f in sol)
    )

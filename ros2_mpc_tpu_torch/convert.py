"""Carry the JAX package's state into the port and back.

A theta pytree of :mod:`ros2_mpc_tpu` (a dict of arrays: the problem's
"weights" and sensor data) becomes the port's dict of float32 tensors, as
does a fleet's path bank (``wps``, ``yaw``, ``speed``, ``omega``), and a
port :class:`~ros2_mpc_tpu_torch.solver.ilqr.Solution` becomes NumPy again,
so both packages can be run on one input and compared. An MPPI key's white
draws cross as a stand-in for the port's noise helper, so that the port's
MPPI samples what the JAX package's sampled. Only NumPy crosses the
boundary; this module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .solver.ilqr import Solution


def theta_from_numpy(thetas: dict, device=None) -> dict:
    """``{name: array}`` (NumPy or anything ``np.asarray`` takes, e.g. a jax
    array) -> ``{name: float32 tensor on device}``; ``device=None`` is the
    card (raises without one). It carries any dict of arrays, a fleet's path
    bank ``{"wps": (B,P,2), "yaw"/"speed"/"omega": (B,P)}`` included."""
    device = resolve_device(device)
    return {
        k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
        for k, v in thetas.items()
    }


def mppi_noise_from_numpy(draws, device=None):
    """A stand-in for :func:`ros2_mpc_tpu_torch.solver.mppi._white_noise`
    that returns given white draws instead of sampling: ``draws`` is
    (n_iters, B, N, S, m), iteration t of scenario b being the JAX package's
    ``jax.random.normal(jax.random.split(key_b, n_iters)[t], (N, S, m))``.
    The stand-in serves iteration t in the port's layout (N, B, S, m): all B
    rows for a ``torch.Generator`` (which it ignores), and for a
    :class:`~ros2_mpc_tpu_torch.solver.mppi.ScenarioStreams` the rows of its
    global scenarios (a shard of the bank)."""
    device = resolve_device(device)
    white = torch.as_tensor(np.array(draws, dtype=np.float32), device=device).permute(0, 2, 1, 3, 4)

    def white_noise(generator, t, shape, dev):
        first = getattr(generator, "offset", 0)
        out = white[t][:, first : first + shape[1]]
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"injected draws of iteration {t} are {tuple(out.shape)}, MPPI asks for {tuple(shape)}")
        return out.to(dev)

    return white_noise


def solution_to_numpy(sol: Solution) -> Solution:
    """A Solution of tensors -> the same Solution of NumPy arrays."""
    return Solution(
        *(np.asarray(f.detach().cpu()) if torch.is_tensor(f) else np.asarray(f) for f in sol)
    )

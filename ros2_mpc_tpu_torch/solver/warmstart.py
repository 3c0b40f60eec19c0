"""Warm-start utilities (port of :mod:`ros2_mpc_tpu.solver.warmstart`)."""

from __future__ import annotations

import torch


def shift_controls(U: torch.Tensor) -> torch.Tensor:
    """Shift ``U: (N, m)`` forward one step, repeating the final control."""
    return torch.cat([U[1:], U[-1:]], dim=0)

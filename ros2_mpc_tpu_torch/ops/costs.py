"""Stage-cost building blocks for the NMPC objectives.

Port of :mod:`ros2_mpc_tpu.ops.costs`: the diagonal quadratic, the reverse
penalty ``exp(-factor * v)``, and the two obstacle soft-cost families of the
reference (Gaussian bumps and the inverse-square barrier), each a pure
function of one stage over padded obstacle vectors ``(n_obs,)``.
"""

from __future__ import annotations

import torch


def quadratic_error(e: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """``e^T diag(w) e``."""
    return torch.sum(diag * e * e, dim=-1)


def reverse_penalty(u: torch.Tensor, factor) -> torch.Tensor:
    """``exp(-factor * v)`` — penalizes reverse motion."""
    return torch.exp(-factor * u[..., 0])


def gaussian_obstacle_cost(
    xy: torch.Tensor, obs_x: torch.Tensor, obs_y: torch.Tensor, inflation_radius, gain
) -> torch.Tensor:
    """``gain * sum_j exp(-((x-ox_j)^2 + (y-oy_j)^2) / ir^2)`` for one stage
    position ``xy: (..., 2)``."""
    dx = xy[..., 0:1] - obs_x
    dy = xy[..., 1:2] - obs_y
    r2 = dx * dx + dy * dy
    return gain * torch.sum(torch.exp(-r2 / (inflation_radius**2)), dim=-1)


def barrier_obstacle_cost(
    xy: torch.Tensor, obs_x: torch.Tensor, obs_y: torch.Tensor, inflation_radius, gain
) -> torch.Tensor:
    """``sum_j exp(gain * ir^2 / r_j^2)``, with ``r^2`` floored at 1e-12."""
    dx = xy[..., 0:1] - obs_x
    dy = xy[..., 1:2] - obs_y
    r2 = (dx * dx + dy * dy) / (inflation_radius**2)
    return torch.sum(torch.exp(gain / torch.clamp(r2, min=1e-12)), dim=-1)


OBSTACLE_COSTS = {
    "gaussian": gaussian_obstacle_cost,
    "barrier": barrier_obstacle_cost,
}

"""Occupancy mapping on a device: log-odds scan fusion with known poses —
port of :mod:`ros2_mpc_tpu.ops.mapping`.

The reference cannot build maps — it consumes a cartographer-built PGM
(maps/map_carto.yaml) and republishes it (core/map_server.py); mapping is
delegated to an external SLAM stack. With localization given (the same tf
chain the reference consumes), occupancy mapping itself is a scatter over
the whole scan: every lidar beam contributes free-space evidence along the
ray and occupied evidence at the endpoint, accumulated in log-odds.

Update rule (standard binary Bayes filter, Thrun et al. ch. 9):

    L[cell] += l_occ   for the beam endpoint (a return inside max_range)
    L[cell] -= l_free  for cells traversed before the endpoint
    p(occupied) = sigmoid(L), clamped to +/- l_max to stay revisable

One call folds the whole scan as one (B beams x T samples) scatter-add on
the grid's device (``index_put_`` with ``accumulate=True``), no Python loop
over beams. The JAX package makes it an XLA scatter-add, not a Pallas
kernel, so the port keeps it plain PyTorch. Grid convention matches the
PGM/sim world: row 0 = top, ``origin`` = world xy of the bottom-left corner.

The float32 operations run in the JAX version's order; a division by a
compile-time constant (the beam count, the resolution, the march step) is a
multiplication by its float32 reciprocal, as XLA makes it. The scatter's
accumulation order is not fixed on CUDA, so a cell's sum may differ in its
last bit from the CPU's; every sum of 0.85, -0.4 and the clamp lies at
least 0.019 away from the trinary thresholds (L = +/-0.619), so the
thresholded map does not.
"""

from __future__ import annotations

import torch

from .grid import reciprocal_f32

_F32 = torch.float32
# the binary Bayes filter's log-odds steps and its clamp (the JAX
# function's defaults, which no caller changes)
L_OCC, L_FREE, L_MAX = 0.85, 0.4, 8.0


def logodds_update(
    L,  # (H, W) float32 log-odds
    pose,  # (3,) x, y, yaw
    ranges,  # (B,) lidar returns in the robot frame (inf = no return)
    n_beams: int,
    angle_min,
    angle_max,
    origin,  # (2,) world meters of the bottom-left corner
    resolution: float,
    max_range: float,
):
    """One scan folded into the log-odds grid; returns the new grid (``L``
    is not changed). Every tensor argument lies on ``L``'s device;
    ``angle_min``/``angle_max`` may be Python floats or 0-d tensors."""
    H, W = L.shape
    dev = L.device
    f32 = lambda v: torch.as_tensor(v, dtype=_F32, device=dev)  # noqa: E731
    step = resolution / 2.0
    n_steps = int(max_range / step)
    a_min = f32(angle_min)
    span = f32(angle_max) - a_min
    beams = pose[2] + a_min + torch.arange(n_beams, device=dev) * span * reciprocal_f32(n_beams)
    ts = (torch.arange(n_steps, dtype=_F32, device=dev) + 1.0) * step  # (T,)
    finite = torch.isfinite(ranges)
    r = torch.where(finite, ranges, torch.inf)  # (B,)

    px = pose[0] + torch.cos(beams)[:, None] * ts[None, :]  # (B, T)
    py = pose[1] + torch.sin(beams)[:, None] * ts[None, :]
    inv = reciprocal_f32(resolution)
    # floor, not int-truncation: points one cell outside the left/bottom
    # edge would otherwise truncate toward zero, pass the bounds check, and
    # deposit evidence on border cells
    col = torch.floor((px - origin[0]) * inv).to(torch.int32)
    row = H - 1 - torch.floor((py - origin[1]) * inv).to(torch.int32)
    inside = (col >= 0) & (col < W) & (row >= 0) & (row < H)

    # free space strictly before the return; occupied at the SINGLE sample
    # nearest the return — a +/-window would thicken every wall by a cell
    # per side, which after the planner's dilation seals real doorways in
    # the self-built map
    free = ts[None, :] < (r[:, None] - resolution)
    # a non-finite return never stamps (hit_in_range below); it is zeroed
    # first because a float-to-int cast of inf is undefined in PyTorch
    r_fin = torch.where(finite, r, 0.0)
    end_idx = (torch.round(r_fin * reciprocal_f32(step)).to(torch.int32) - 1).clamp(0, n_steps - 1)
    # a return BEYOND max_range carves free space but must not stamp a
    # phantom wall at the clipped last sample
    hit_in_range = finite & (r <= max_range)
    occ = (torch.arange(n_steps, device=dev)[None, :] == end_idx[:, None]) & hit_in_range[:, None]
    delta = torch.where(occ, L_OCC, 0.0) - torch.where(free, L_FREE, 0.0)
    delta = torch.where(inside & (ts[None, :] <= max_range), delta, 0.0)

    cells = row.clamp(0, H - 1).long() * W + col.clamp(0, W - 1).long()
    L = L.reshape(-1).index_put((cells.reshape(-1),), delta.reshape(-1), accumulate=True)
    return L.reshape(H, W).clamp(-L_MAX, L_MAX)


def occupancy_probability(L):
    """p(occupied) per cell."""
    return torch.sigmoid(L)

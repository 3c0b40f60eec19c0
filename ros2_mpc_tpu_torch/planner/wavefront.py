"""Global planning on a device: batched wavefront distance fields — port of
:mod:`ros2_mpc_tpu.planner.wavefront`.

The reference's only on-line planner is host-side sequential A*
(ros2_mpc/planner/global_planner.py:91-93 via pyastar2d). A* is inherently
serial (one heap pop at a time). The data-parallel alternative is a
*wavefront / min-plus relaxation*: iterate

    d <- min(d, min_neighbor(d) + w)

over the whole grid at once until the field stops changing (bounded by the
grid diameter). Batching goals adds a leading axis: one loop relaxes the
distance fields of every goal together.

The sweeps run on the device of the weights. Each sweep is a handful of
elementwise tensor ops; the loop reads the "anything changed" flag back only
every ``CHECK_EVERY`` sweeps, never per sweep, and never runs past the sweep
budget. A sweep after convergence changes nothing, so the field equals the
JAX version's, whose ``lax.while_loop`` tests every sweep. Weights are
integers in float32 and ``_BIG`` is float32, so the arithmetic is exact and
the field matches the JAX package bit for bit.

Path extraction is greedy steepest descent on the converged field (host).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BIG = 1e9
_F32 = torch.float32
CHECK_EVERY = 16  # sweeps between reads of the convergence flag


def _relax_once(d, weights):
    """One min-plus sweep over the last two axes (4-neighborhood)."""
    up = F.pad(d[..., 1:, :], (0, 0, 0, 1), value=_BIG)
    down = F.pad(d[..., :-1, :], (0, 0, 1, 0), value=_BIG)
    left = F.pad(d[..., :, 1:], (0, 1), value=_BIG)
    right = F.pad(d[..., :, :-1], (1, 0), value=_BIG)
    best = torch.minimum(torch.minimum(up, down), torch.minimum(left, right))
    return torch.minimum(d, best + weights)


def relax(d0, weights, n_sweeps: int):
    """Relax ``d0`` (``(..., H, W)``) for at most ``n_sweeps`` sweeps, stopping
    once a sweep changes nothing. Returns ``(d, sweeps)``: the field and the
    JAX loop's sweep count (``lax.while_loop`` from ``(relax(d0), d0, 1)``:
    the sweeps run, the one that found nothing to change included), a 0-d
    int tensor on the device (reading it syncs)."""
    d = _relax_once(d0, weights)
    changed = (d != d0).any().to(torch.int64)  # sweeps that changed the field
    done = 1
    while done < n_sweeps:
        if not bool(changed.eq(done)):  # a sweep already changed nothing
            break
        for _ in range(min(CHECK_EVERY, n_sweeps - done)):
            nxt = _relax_once(d, weights)
            changed += (nxt != d).any()
            d = nxt
            done += 1
    # every sweep after the first unchanged one leaves the field as it is
    return d, torch.clamp(changed + 1, max=n_sweeps)


def goal_fields(shape, goals_rc, device):
    """The fields a relaxation starts from: ``(G, H, W)`` float32, 0 at each
    of the ``(G, 2)`` goal cells (or the one ``(2,)`` cell, G = 1), ``_BIG``
    elsewhere."""
    goals = torch.as_tensor(goals_rc, device=device).long().reshape(-1, 2)
    d0 = torch.full((goals.shape[0], *shape), _BIG, dtype=_F32, device=device)
    d0[torch.arange(goals.shape[0], device=device), goals[:, 0], goals[:, 1]] = 0.0
    return d0


def distance_field(weights, goal_rc, max_sweeps: int = 0):
    """Min-plus shortest-path distance-to-goal over a 4-neighborhood.

    ``weights``: (H, W) tensor of positive step costs (same convention as
    :func:`ros2_mpc_tpu_torch.planner.global_planner.astar_path` — e.g. free
    1, obstacle 255), on the device the field is computed on. ``goal_rc``:
    (2,) int cell. Returns (H, W) float32 distances on that device."""
    weights = weights.to(_F32)
    H, W = weights.shape
    n_sweeps = max_sweeps if max_sweeps > 0 else (H + W)
    return relax(goal_fields((H, W), goal_rc, weights.device)[0], weights, n_sweeps)[0]


def extract_path(dist, start_rc, max_len: int = 0) -> np.ndarray:
    """Greedy steepest descent from ``start_rc`` to the zero of the field.
    Returns (L, 2) (row, col) cells start-first; empty if start is
    disconnected. ``dist`` is read back to the host once."""
    d = dist.cpu().numpy() if isinstance(dist, torch.Tensor) else np.asarray(dist)
    H, W = d.shape
    if max_len <= 0:
        max_len = H * W
    r, c = int(start_rc[0]), int(start_rc[1])
    if d[r, c] >= _BIG:
        return np.empty((0, 2), dtype=np.int32)
    path = [(r, c)]
    for _ in range(max_len):
        if d[r, c] == 0.0:
            break
        best = None
        for nr, nc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
            if 0 <= nr < H and 0 <= nc < W:
                if best is None or d[nr, nc] < d[best[0], best[1]]:
                    best = (nr, nc)
        if best is None or d[best[0], best[1]] >= d[r, c]:
            break
        r, c = best
        path.append((r, c))
    return np.asarray(path, dtype=np.int32)


def batched_distance_fields(weights, goals_rc):
    """(G, 2) goals -> (G, H, W) distance fields, relaxed together in one
    loop (the JAX version vmaps :func:`distance_field`; each field runs its
    own sweeps there, and a converged field is unchanged by more)."""
    weights = weights.to(_F32)
    H, W = weights.shape
    return relax(goal_fields((H, W), goals_rc, weights.device), weights, H + W)[0]

"""``n_live`` obstacle points near each start-goal midpoint, each kept
``clearance`` off start and goal (redrawn up to ``retries`` times, then sent
to the sentinel), the other slots at the sentinel
(``chip_smoke.py::obstacle_clusters``). Reads ``x0``, ``goal``; adds
``ox``, ``oy`` (B, n_obs)."""

import torch

from yardstick.traffic import F32, clearance, uniform


def draw(ctx, raw, recipe):
    g, dev, n_obs = ctx.g, ctx.device, ctx.n_obs
    x0, goal = raw["x0"], raw["goal"]
    B = x0.shape[0]
    far = recipe["sentinel"]
    ox = torch.full((B, n_obs), far, dtype=F32, device=dev)
    oy = torch.full((B, n_obs), far, dtype=F32, device=dev)
    mid = (x0[:, :2] + goal[:, :2]) / 2
    for j in range(recipe["n_live"]):
        pts = mid + uniform(g, (B, 2), -recipe["spread"], recipe["spread"], dev)
        for _ in range(recipe["retries"]):
            bad = clearance(pts, x0, goal) < recipe["clearance"]
            redraw = mid + uniform(g, (B, 2), -recipe["respread"], recipe["respread"], dev)
            pts = torch.where(bad[:, None], redraw, pts)
        bad = clearance(pts, x0, goal) < recipe["clearance"]
        pts = torch.where(bad[:, None], torch.full_like(pts, far), pts)
        ox[:, j], oy[:, j] = pts[:, 0], pts[:, 1]
    return {"ox": ox, "oy": oy}

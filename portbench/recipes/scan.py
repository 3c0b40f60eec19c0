"""Obstacles from a lidar scan (TurtleBot3 LDS-01: 360 beams, 0.12-3.5 m)
of a random room around each start. Reads ``x0``, ``goal``; adds ``ox``,
``oy`` (B, n_obs)."""

import math

import torch

from yardstick.traffic import F32, uniform


def _box_distance(px, py, cx, cy, hw, hh):
    """Distance from points (B, 1) to axis-aligned boxes (B, K)."""
    dx = torch.clamp((px - cx).abs() - hw, min=0.0)
    dy = torch.clamp((py - cy).abs() - hh, min=0.0)
    return torch.sqrt(dx * dx + dy * dy)


def room_segments(g, x0, goal, recipe: dict, device):
    """A random indoor scene around each start: a rectangular room centred
    on the origin whose walls may have a doorway, and boxes (furniture,
    people) kept ``clearance`` plus ``box_margin`` off start and goal.
    Returns segment end points (B, M, 2) and (B, M, 2)."""
    B = x0.shape[0]
    h_lo, h_hi = recipe["room_half"]
    hx = uniform(g, (B, 1), h_lo, h_hi, device)
    hy = uniform(g, (B, 1), h_lo, h_hi, device)
    door = torch.rand((B, 4), generator=g, device=device) < recipe["door_prob"]
    dw = recipe["door_width"] * door.to(F32)
    # each wall is two segments with a gap of dw centred at t along it
    t = uniform(g, (B, 4), -1.0, 1.0, device)
    a, b = [], []
    for k, (hs, ho, axis, sign) in enumerate(((hx, hy, 0, 1), (hx, hy, 0, -1), (hy, hx, 1, 1), (hy, hx, 1, -1))):
        # wall at coordinate sign*ho on axis 1-axis, running along axis over [-hs, hs]
        c = t[:, k : k + 1] * (hs - 0.5 - dw[:, k : k + 1] / 2)
        lo_end, gap_lo, gap_hi, hi_end = -hs, c - dw[:, k : k + 1] / 2, c + dw[:, k : k + 1] / 2, hs
        fixed = sign * ho
        for s0, s1 in ((lo_end, gap_lo), (gap_hi, hi_end)):
            if axis == 0:
                a.append(torch.cat([s0, fixed], 1))
                b.append(torch.cat([s1, fixed], 1))
            else:
                a.append(torch.cat([fixed, s0], 1))
                b.append(torch.cat([fixed, s1], 1))
    k_max = recipe["boxes"][1]
    n_box = torch.randint(recipe["boxes"][0], k_max + 1, (B, 1), generator=g, device=device)
    side_lo, side_hi = recipe["box_side"]
    hw = uniform(g, (B, k_max), side_lo / 2, side_hi / 2, device)
    hh = uniform(g, (B, k_max), side_lo / 2, side_hi / 2, device)
    cx = uniform(g, (B, k_max), -1.0, 1.0, device) * (hx - hw)
    cy = uniform(g, (B, k_max), -1.0, 1.0, device) * (hy - hh)
    keep = torch.arange(k_max, device=device)[None] < n_box
    off = recipe["clearance"] + recipe["box_margin"]
    for p in (x0, goal):
        keep &= _box_distance(p[:, :1], p[:, 1:2], cx, cy, hw, hh) >= off
    far = recipe["sentinel"] * 10.0
    cx, cy = torch.where(keep, cx, far), torch.where(keep, cy, far)
    corners = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
    for i in range(4):
        (sx0, sy0), (sx1, sy1) = corners[i], corners[(i + 1) % 4]
        a.append(torch.stack([cx + sx0 * hw, cy + sy0 * hh], -1))
        b.append(torch.stack([cx + sx1 * hw, cy + sy1 * hh], -1))
    A = torch.cat([s[:, None] if s.dim() == 2 else s for s in a], 1)
    Bp = torch.cat([s[:, None] if s.dim() == 2 else s for s in b], 1)
    return A, Bp


def scan_returns(x0, A, Bp, recipe: dict):
    """Range of each of ``beams`` beams cast from each start pose (beam 0
    along the heading) against the segments; inf where nothing is hit
    between the scanner's minimum and maximum range. Returns (B, beams)
    ranges and angles."""
    beams = recipe["beams"]
    r_min, r_max = recipe["range"]
    ang = x0[:, 2:3] + torch.arange(beams, device=x0.device, dtype=F32)[None] * (2 * math.pi / beams)
    d = torch.stack([torch.cos(ang), torch.sin(ang)], -1)[:, :, None]  # (B, beams, 1, 2)
    o = x0[:, None, None, :2]
    e = (Bp - A)[:, None]  # (B, 1, M, 2)
    ao = A[:, None] - o  # (B, 1, M, 2)
    den = d[..., 0] * e[..., 1] - d[..., 1] * e[..., 0]
    tt = (ao[..., 0] * e[..., 1] - ao[..., 1] * e[..., 0]) / den
    ss = (ao[..., 0] * d[..., 1] - ao[..., 1] * d[..., 0]) / den
    hit = (den.abs() > 1e-9) & (tt >= 0) & (ss >= 0) & (ss <= 1)
    r = torch.where(hit, tt, torch.inf).amin(-1)
    r = torch.where((r >= r_min) & (r <= r_max), r, torch.inf)
    return r, ang


def draw(ctx, raw, recipe):
    """The corrected follower's obstacle vector from a scan of a random
    room (nodes/reference_gen.py::scan_to_world_obstacles): the returns
    inside the +-``window`` costmap square around the robot, the ``n_obs``
    nearest of them first, far sentinels after."""
    g, device, n_obs = ctx.g, ctx.device, ctx.n_obs
    x0, goal = raw["x0"], raw["goal"]
    A, Bp = room_segments(g, x0, goal, recipe, device)
    r, ang = scan_returns(x0, A, Bp, recipe)
    wx = x0[:, :1] + r * torch.cos(ang)
    wy = x0[:, 1:2] + r * torch.sin(ang)
    w = recipe["window"]
    inside = torch.isfinite(r) & ((wx - x0[:, :1]).abs() <= w) & ((wy - x0[:, 1:2]).abs() <= w)
    dist = torch.where(inside, r, torch.inf)
    k = min(n_obs, dist.shape[1])
    near, idx = torch.topk(dist, k, dim=1, largest=False, sorted=True)
    far = recipe["sentinel"]
    ox = torch.full((x0.shape[0], n_obs), far, dtype=F32, device=device)
    oy = torch.full_like(ox, far)
    live = torch.isfinite(near)
    ox[:, :k] = torch.where(live, torch.gather(wx, 1, idx), far)
    oy[:, :k] = torch.where(live, torch.gather(wy, 1, idx), far)
    return {"ox": ox, "oy": oy}


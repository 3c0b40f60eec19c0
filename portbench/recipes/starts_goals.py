"""Starts within ``start`` of the origin on each of x, y, yaw; goals within
``goal`` on x and y with any heading (``chip_smoke.py::headline_bank``'s
draws). Adds ``x0``, ``goal`` (B, 3)."""

import math

import torch

from yardstick.traffic import uniform


def draw(ctx, raw, recipe):
    g, B, dev = ctx.g, ctx.B, ctx.device
    s, r = recipe["start"], recipe["goal"]
    x0 = uniform(g, (B, 3), -s, s, dev)
    goal = torch.cat([uniform(g, (B, 2), -r, r, dev), uniform(g, (B, 1), -math.pi, math.pi, dev)], 1)
    return {"x0": x0, "goal": goal}

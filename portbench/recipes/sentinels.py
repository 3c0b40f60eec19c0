"""No obstacles: every slot at the far ``sentinel``. Adds ``ox``, ``oy``
(B, n_obs), B taken from ``x0`` where drawn."""

import torch

from yardstick.traffic import F32


def draw(ctx, raw, recipe):
    B = raw["x0"].shape[0] if "x0" in raw else ctx.B
    far = torch.full((B, ctx.n_obs), recipe["sentinel"], dtype=F32, device=ctx.device)
    return {"ox": far, "oy": far.clone()}

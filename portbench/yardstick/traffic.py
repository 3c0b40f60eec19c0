"""The one traffic generator: every input of a run, drawn from ``--seed``.

A traffic mix is a data file (``traffic/<mix>.json``). Its ``draws`` list
recipes by name (``recipes/<recipe>.py``), applied in order: each adds raw
inputs (poses, goals, obstacle points, paths) to what the earlier ones drew.
Banks are drawn on the cell's device with a seeded ``torch.Generator`` in a
few large calls; paths with a seeded NumPy generator. The program receives
only what is drawn here; the reference receives the same raw arrays.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import spec

F32 = torch.float32


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one purpose (``stream``) of one run's ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63))
    return g


def uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=F32)


def context(config: dict, seed: int, device, g=None, index: int = 0, part: int = 0, B: int = 0) -> SimpleNamespace:
    """What a recipe may read besides its own parameters: the generator, the
    seed, the pool index and the part of it, the rows, and the
    configuration."""
    params = config["params"]
    return SimpleNamespace(
        g=g, seed=int(seed), index=index, part=part, B=B, device=device, params=params, formulation=config["formulation"],
        N=int(params["N"]), n_obs=int(config["formulation"]["n_obstacle_points"]),
    )  # fmt: skip


def draw(draws: list, ctx) -> dict:
    """Apply the recipes of ``draws`` in order; returns the raw inputs."""
    raw = {}
    for d in draws:
        raw.update(spec.recipe(d["recipe"])(ctx, raw, d))
    return raw


def pool(mix: dict, config: dict, seed: int, device, chunk: int = 1024) -> list:
    """``mix["pool"]`` batches of ``mix["B"]`` rows of raw inputs on
    ``device``, drawn ``chunk`` rows at a time from one generator.

    With ``set_seed`` in the mix, every run draws the same batches from
    that seed, and ``seed`` only orders them: each run does the same work,
    so runs differ by the system's noise alone and not by how hard their
    draws are (a batch's time follows its slowest rows, so the rows stay
    in their batches)."""
    draw_seed = int(mix.get("set_seed", seed))
    g = generator(draw_seed, device, 0)
    out = []
    for i in range(mix["pool"]):
        parts = []
        for lo in range(0, mix["B"], chunk):
            ctx = context(config, draw_seed, device, g=g, index=i, part=lo // chunk, B=min(chunk, mix["B"] - lo))
            parts.append(draw(mix["draws"], ctx))
        out.append({k: torch.cat([p[k] for p in parts]) for k in parts[0]})
    if "set_seed" in mix:
        order = torch.randperm(len(out), generator=generator(seed, "cpu", 1))
        out = [out[i] for i in order.tolist()]
    return out


def live_prefix(ox, oy, far: float = 90.0):
    """Each row's live obstacle prefix: one past the last slot within
    +-``far`` m (sentinels lie beyond)."""
    live = (ox.abs() < far) | (oy.abs() < far)
    idx = torch.arange(1, ox.shape[1] + 1, device=ox.device)
    return torch.where(live, idx, 0).amax(1)


def clearance(pts, x0, goal):
    """Distance of points (B, 2) to the nearer of start and goal."""
    return torch.minimum(
        torch.linalg.vector_norm(pts - x0[:, :2], dim=1), torch.linalg.vector_norm(pts - goal[:, :2], dim=1)
    )

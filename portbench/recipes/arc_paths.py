"""Constant-curvature arc paths with the upstream motion profile (speed the
segment length over dt doubled, turn rate the yaw step halved), the robots
near their path's start with a heading error: the draws of the port's
``arc_path_fleet``, copied. Drawn with NumPy from (seed, pool index,
part of the pool). Adds
``x0`` (B, 3), ``wps`` (B, P, 2), ``yaw``, ``speed``, ``omega`` (B, P) and
``goal`` (B, 3), the path's end pose, float32 on the device."""

import numpy as np
import torch

from yardstick.traffic import F32


def draw(ctx, raw, recipe):
    rng = np.random.default_rng([ctx.seed, 1, ctx.index, ctx.part])
    dt, v_hi = float(ctx.params["dt"]), float(ctx.formulation["v_bounds"][1])
    B, P = ctx.B, recipe["waypoints"]
    f_lo, f_hi = recipe["speed_frac"]
    v_nom = rng.uniform(f_lo * v_hi, f_hi * v_hi, size=(B, 1))
    ds = v_nom * dt
    kmax = recipe["curvature"]
    kappa = rng.uniform(-kmax, kmax, size=(B, 1))
    yaw0 = rng.uniform(-np.pi, np.pi, size=(B, 1))
    s = np.arange(P)[None, :] * ds
    heading = yaw0 + kappa * s
    wx = np.cumsum(np.cos(heading) * ds, axis=1) - np.cos(heading[:, :1]) * ds
    wy = np.cumsum(np.sin(heading) * ds, axis=1) - np.sin(heading[:, :1]) * ds
    start = rng.uniform(-1.0, 1.0, size=(B, 2))
    wps = np.stack([wx + start[:, :1], wy + start[:, 1:]], axis=2)
    steps = np.diff(wps, axis=1)
    yaw = np.arctan2(steps[..., 1], steps[..., 0])
    yaw = np.concatenate([yaw, yaw[:, -1:]], axis=1)
    omega = np.diff(yaw, axis=1) / 2.0
    omega = np.concatenate([omega, omega[:, -1:]], axis=1)
    speed = np.hypot(steps[..., 0], steps[..., 1]) / dt * 2.0
    speed = np.concatenate([speed, speed[:, -1:]], axis=1)
    j = recipe["start_jitter"]
    he = recipe["heading_error"]
    x0 = np.concatenate(
        [wps[:, 0] + rng.uniform(-j, j, size=(B, 2)), yaw[:, :1] + rng.uniform(-he, he, size=(B, 1))], axis=1
    )
    out = {"x0": x0, "wps": wps, "yaw": yaw, "speed": speed, "omega": omega}
    out = {k: torch.as_tensor(v, dtype=F32, device=ctx.device) for k, v in out.items()}
    out["goal"] = torch.cat([out["wps"][:, -1], out["yaw"][:, -1:]], 1)
    return out

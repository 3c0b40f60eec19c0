"""Monte-Carlo tuning sweeps (BASELINE.json config 5), chunked, with a
checkpoint to resume from.

Port of :mod:`ros2_mpc_tpu.parallel.sweep`. The reference tunes its weights
by hand-editing one YAML and re-running a robot (config/params.yaml; no sweep
tooling exists). Here a sweep is a grid over (Q, R) scalings crossed with a
bank of randomized scenarios, solved as sharded banks over a device mesh
(:func:`~.mesh.make_bank_solver`, K1 by default), each scenario scored by
the distance of its terminal rollout state to its goal.

Checkpoint/resume: the flattened (config x scenario) bank is solved in
chunks; every finished chunk's scores are written with ``np.savez``, so an
interrupted sweep resumes at the first chunk the file does not hold.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .mesh import Sharded, make_bank_solver, make_mesh, shard_bank

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Grid over (Q, R) scalings x scenarios for the point-stabilization
    problem. ``n_configs`` = len(q_scales) * len(r_scales)."""

    q_scales: tuple = (0.25, 0.5, 1.0, 2.0, 4.0)
    r_scales: tuple = (0.25, 0.5, 1.0, 2.0, 4.0)
    scenarios_per_config: int = 64
    seed: int = 0


def build_sweep_thetas(problem, spec: SweepSpec, params=None):
    """The flattened theta bank, (n_configs * scenarios_per_config, ...), on
    the problem's device, and the (n_configs, 2) grid of (Q, R) scales.

    The poses (x, y, theta) are drawn from ``np.random.default_rng(spec.seed)``
    as the JAX package draws them, so both packages sweep one bank; any
    extra states (the smooth-actuation unicycle's velocities) start at zero.
    ``params`` is unused (the problem carries its parameters)."""
    rng = np.random.default_rng(spec.seed)
    n_cfg = len(spec.q_scales) * len(spec.r_scales)
    B = n_cfg * spec.scenarios_per_config

    x0 = np.zeros((B, problem.ocp.n_states))
    x0[:, :3] = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = np.concatenate(
        [rng.uniform(-1.5, 1.5, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))],
        axis=1,
    )
    dev = problem.default_u0.device
    tens = lambda a: torch.as_tensor(a, dtype=_F32, device=dev)  # noqa: E731
    thetas = dict(torch.func.vmap(problem.make_theta)(tens(x0), tens(goal)))

    qs, rs = np.meshgrid(spec.q_scales, spec.r_scales, indexing="ij")
    cfg = np.stack([qs.ravel(), rs.ravel()], axis=1)  # (n_cfg, 2)
    cfg_rep = np.repeat(cfg, spec.scenarios_per_config, axis=0)  # (B, 2)
    thetas["Q"] = thetas["Q"] * tens(cfg_rep[:, 0:1])
    thetas["R"] = thetas["R"] * tens(cfg_rep[:, 1:2])
    return {k: v.contiguous() for k, v in thetas.items()}, cfg


def run_sweep(
    problem,
    spec: SweepSpec = SweepSpec(),
    params=None,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    chunk_size: int = 0,
    engine="cuda",
    **engine_opts,
):
    """Evaluate the sweep; returns ``{"configs", "mean_goal_error",
    "best_config", "chunks_solved"}`` (the last: the ids of the chunks this
    call solved, the others came from the checkpoint).

    ``mesh`` defaults to :func:`~.mesh.make_mesh` (the cards; raises without
    one). With ``checkpoint_path`` set, finished chunks are written there
    (by rank 0 of a process group) and skipped on resume. ``engine`` and
    ``engine_opts`` go to :func:`~.mesh.make_bank_solver`; each chunk (every
    ``chunk_size`` scenarios, the whole bank at 0) must divide over the mesh."""
    mesh = mesh or make_mesh()
    thetas, cfg = build_sweep_thetas(problem, spec, params)
    B = thetas["x0"].shape[0]
    n_cfg = cfg.shape[0]
    per = spec.scenarios_per_config
    if chunk_size <= 0:
        chunk_size = B

    step = make_bank_solver(problem, mesh, engine=engine, **engine_opts)

    done = {}
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as ck:
            done = {int(k): ck[k] for k in ck.files}

    results, solved = [], []
    for start in range(0, B, chunk_size):
        chunk_id = start // chunk_size
        if chunk_id in done:
            results.append(done[chunk_id])
            continue
        chunk = shard_bank({k: v[start : start + chunk_size] for k, v in thetas.items()}, mesh)
        n = min(chunk_size, B - start)
        U0 = torch.zeros((n,) + tuple(problem.default_u0.shape), dtype=_F32, device=problem.default_u0.device)
        sols, _ = step(chunk, shard_bank(U0, mesh))
        # quality: distance of the terminal rollout state to the goal
        err = tuple(
            torch.linalg.vector_norm(s.X[:, -1, :2] - t["goal"][:, :2], dim=-1)
            for s, t in zip(sols.shards, chunk.shards)
        )
        arr = Sharded(err, mesh).gather("cpu").numpy()
        results.append(arr)
        done[chunk_id] = arr
        solved.append(chunk_id)
        if checkpoint_path and mesh.rank == 0:
            np.savez(checkpoint_path, **{str(k): v for k, v in done.items()})

    err_all = np.concatenate(results).reshape(n_cfg, per)
    return {
        "configs": cfg,
        "mean_goal_error": err_all.mean(axis=1),
        "best_config": cfg[int(np.argmin(err_all.mean(axis=1)))],
        "chunks_solved": solved,
    }


def main(argv=None):
    """Console entry (``cuda-mpc-sweep``): the default tuning sweep (25
    configs x 64 scenarios, N=20, K1 over every visible card) and its table."""
    import argparse

    from ..config import Params
    from ..device import resolve_device
    from ..solver import make_point_stabilization

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenarios-per-config", type=int, default=SweepSpec.scenarios_per_config)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--chunk-size", type=int, default=0, help="scenarios a chunk (0: the whole bank at once)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH", help="np.savez checkpoint to write and resume from")
    ap.add_argument(
        "--device", default=None,
        help="device of the solves (default: every visible card, refused without one; 'cpu' runs K1's plain "
             "version on eight CPU shards)",
    )  # fmt: skip
    args = ap.parse_args(argv)
    params = Params()
    prob = make_point_stabilization(params, horizon=args.horizon, device=resolve_device(args.device))
    spec = SweepSpec(scenarios_per_config=args.scenarios_per_config)
    mesh = make_mesh(device=args.device)
    out = run_sweep(prob, spec, params=params, mesh=mesh, checkpoint_path=args.checkpoint, chunk_size=args.chunk_size)
    print(f"{'Q scale':>8} {'R scale':>8} {'mean goal err [m]':>18}")
    for (q, r), e in zip(out["configs"], out["mean_goal_error"]):
        print(f"{q:8.2f} {r:8.2f} {e:18.4f}")
    print("best config (Q, R scales):", tuple(out["best_config"]))
    return out


if __name__ == "__main__":
    main()

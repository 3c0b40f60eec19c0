"""Scaling of the bank solve over a device mesh: throughput on one shard
against n shards, for each engine.

Port of :mod:`ros2_mpc_tpu.parallel.scaling_bench`. The workload is
embarrassingly parallel across scenarios, so what n shards lose against n
times one shard is the mesh's own cost: the host issuing every shard's work
in turn, and the metrics' reductions. The ceiling is the hardware under the
shards: ``min(1, distinct cards / shards)`` on the card (four shards of one
card cannot beat one shard: 1/4), ``min(1, cores / shards)`` on the CPU.

``run`` measures one engine; its one-shard bank is the n-shard bank's first
shard, so ``first_shard_equal`` says whether shard 0 of the mesh solved
exactly what one shard alone solves (it must: every engine is per scenario,
and the sampling engines draw by global scenario index). ``main()`` runs
every engine and writes the JSON artifact under ``build/`` (default
``build/SCALING.json``).

``run_distributed`` spawns two processes joined over local TCP by the gloo
backend (``torch.multiprocessing``, ``spawn``), each holding half of one
globally sharded mesh: the bank metrics and the swarm's per-tick gather
cross the process boundary.
"""

from __future__ import annotations

import json
import os
import time
import traceback

import numpy as np
import torch

# The engines of the JAX package's harness (its "pallas" is "cuda" here).
BENCH_ENGINES = ("vmap", "fast", "cuda", "mppi", "two_pass", "multistart_bank", "multistart_rescue")


def engine_options(per_device_batch: int) -> dict:
    """Each of the nine engines' options in the harness, sized for a shard of
    ``per_device_batch``. Every engine but K1's (``"cuda"``, the default
    schedule) runs a short schedule: what is measured is the mesh's
    overhead, not their quality (full-schedule throughput is the port's
    benchmark's business), and ``"vmap"`` and ``"fast"`` are plain PyTorch
    bound by the host's dispatch. ``solver_settings`` goes to the problem,
    the rest to the engine."""
    from ..solver.ilqr import SolverSettings
    from ..solver.mppi import MppiSettings

    short = SolverSettings(barrier_stages=3, iters_per_stage=2, n_alphas=4)
    sampling = MppiSettings(n_samples=32, n_iters=4)
    cap = max(1, per_device_batch // 4)
    return {
        "vmap": {"solver_settings": short},
        "fast": {"solver_settings": short},
        "cuda": {},
        "mppi": {"settings": sampling},
        "hybrid": {"settings": sampling},
        "multistart": {"settings": sampling},
        "two_pass": {"solver_settings": short, "capacity": cap, "rescue_settings": short},
        "multistart_bank": {"solver_settings": short, "swing_fracs": (1.0,)},
        "multistart_rescue": {
            "solver_settings": short, "swing_fracs": (1.0,), "capacity": cap,
            "rescue_settings": short, "polish_iters": 2,
        },
    }


def _bank(prob, B):
    """B scenarios from ``np.random.default_rng(0)``, on the problem's device."""
    rng = np.random.default_rng(0)
    dev = prob.default_u0.device
    tens = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    thetas = torch.func.vmap(prob.make_theta)(
        tens(rng.uniform(-0.3, 0.3, size=(B, 3))), tens(rng.uniform(-1.5, 1.5, size=(B, 3)))
    )
    U0 = torch.zeros((B,) + tuple(prob.default_u0.shape), dtype=torch.float32, device=dev)
    return {k: v.contiguous() for k, v in thetas.items()}, U0


def _sync(mesh):
    for d in set(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _timed(step, th, U, reps, mesh):
    """(best seconds of ``reps`` steps after a warm-up, the last result);
    the host clock around work that ends in a synchronize."""
    out = step(th, U)
    _sync(mesh)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = step(th, U)
        _sync(mesh)
        times.append(time.perf_counter() - t0)
    return min(times), out


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def _ceiling(mesh) -> float:
    units = (os.cpu_count() or 1) if mesh.devices[0].type == "cpu" else len(set(mesh.devices))
    return min(1.0, units / mesh.size)


def run(
    per_device_batch: int = 512,
    horizon: int = 20,
    reps: int = 3,
    engine="cuda",
    solver_settings=None,
    device=None,
    n_devices=None,
    **engine_opts,
):
    """One engine's throughput on one shard and on ``make_mesh(n_devices,
    device=device)`` (``device=None``: every visible card, raising without
    one), ``per_device_batch`` scenarios a shard, horizon ``horizon``
    (``Params()``, point stabilization, ``solver_settings`` or the default
    schedule). Keys as the JAX package's, and ``metrics_1dev``/
    ``metrics_ndev`` (:func:`~.mesh.bank_metrics`), ``first_shard_equal``
    and ``kernel_launches`` (K1's, both meshes, warm-ups included)."""
    from ..config import Params
    from ..solver import make_point_stabilization
    from .mesh import Mesh, make_bank_solver, make_mesh, shard_bank

    mesh_n = make_mesh(n_devices, device=device)
    prob = make_point_stabilization(Params(), horizon=horizon, settings=solver_settings, device=mesh_n.devices[0])
    n_dev = mesh_n.size
    thetas, U0 = _bank(prob, per_device_batch * n_dev)
    rates, metrics, sols, launches = {}, {}, {}, 0
    for nd, mesh in ((1, Mesh(mesh_n.devices[:1])), (n_dev, mesh_n)):
        if nd in rates:
            continue
        rows = per_device_batch * nd
        step = make_bank_solver(prob, mesh, engine=engine, **engine_opts)
        th = shard_bank({k: v[:rows] for k, v in thetas.items()}, mesh)
        secs, (out, m) = _timed(step, th, shard_bank(U0[:rows], mesh), reps, mesh)
        rates[nd], metrics[nd], sols[nd] = rows / secs, _metrics(m), out.shards[0]
        launches += sum(getattr(e, "launches", 0) for e in step.engines)
    return {
        "engine": engine,
        "devices": n_dev,
        "per_device_batch": per_device_batch,
        "horizon": horizon,
        "solves_per_s_1dev": rates[1],
        "solves_per_s_ndev": rates[n_dev],
        "scaling_efficiency": rates[n_dev] / (rates[1] * n_dev),
        "metrics_1dev": metrics[1],
        "metrics_ndev": metrics[n_dev],
        "first_shard_equal": all(torch.equal(a, b) for a, b in zip(sols[1], sols[n_dev])),
        "kernel_launches": launches,
        "contention_ceiling": _ceiling(mesh_n),
    }


def run_all_engines(per_device_batch: int = 512, horizon: int = 20, reps: int = 3, device=None, n_devices=None):
    """:func:`run` for each of :data:`BENCH_ENGINES` with
    :func:`engine_options`; the artifact records the ceiling and each
    engine's ``efficiency_vs_ceiling``."""
    opts = engine_options(per_device_batch)
    out = {"physical_cores": os.cpu_count(), "results": []}
    for engine in BENCH_ENGINES:
        r = run(per_device_batch, horizon, reps, engine=engine, device=device, n_devices=n_devices, **opts[engine])
        r["efficiency_vs_ceiling"] = min(1.0, r["scaling_efficiency"] / r["contention_ceiling"])
        out["results"].append(r)
    first = out["results"][0]
    out.update(backend=str(device or "cuda"), devices=first["devices"], contention_ceiling=first["contention_ceiling"])
    return out


# ------------------------------------------------------------ two processes


def _dist_worker(rank, world, port, cfg, queue):
    """One rank of :func:`run_distributed` (spawned): joins the gloo group,
    solves its half of a globally sharded bank through K1 and holds the
    gathered result against a one-process solve of the whole bank, runs the
    sharded swarm against the unsharded one, then times each engine (rank
    0's one-shard baseline while the other rank waits, then the global
    mesh). Puts ``(rank, result)`` on ``queue``."""
    import torch.distributed as dist

    try:
        from ..config import Params
        from ..solver import SolverSettings, make_point_stabilization
        from . import distributed
        from .fleet import circle_swarm, make_sharded_swarm_rollout, make_swarm_rollout
        from .mesh import Mesh, make_bank_solver, make_mesh, shard_bank

        device = cfg["device"]
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        info = distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo", device=device)
        mesh = make_mesh(cfg["n_devices"], device=device)
        dev = mesh.devices[0]
        local = Mesh((dev,))
        N, per, reps = cfg["horizon"], cfg["per_device_batch"], cfg["reps"]
        params = Params()
        prob = make_point_stabilization(params, horizon=N, device=dev)
        launches = 0

        # one globally sharded bank through K1 against one process's solve
        thetas, U0 = _bank(prob, per * mesh.size)
        step = make_bank_solver(prob, mesh, engine="cuda")
        sols, metrics = step(thetas, U0)
        got = sols.gather("cpu")
        ref_step = make_bank_solver(prob, local, engine="cuda")
        ref_sols, ref_metrics = ref_step(thetas, U0)
        ref = ref_sols.shards[0]
        err = float((got.U - ref.U.cpu()).abs().max())
        bit_equal = all(torch.equal(a, b.cpu()) for a, b in zip(got, ref))
        launches += step.engines[0].launches + ref_step.engines[0].launches

        # the swarm: its per-tick gather crosses the process boundary
        tiny = SolverSettings(barrier_stages=2, iters_per_stage=2, n_alphas=4)
        prob_c = make_point_stabilization(params, horizon=6, settings=tiny, reference_parity=False, device=dev)
        per_sw = max(3, min(per, 64))  # robots a shard: more than the 2 neighbors, 64 at most as the JAX worker
        th_c, U0_c = circle_swarm(prob_c, per_sw * mesh.size, jitter=0.06, device=dev)
        swarm = make_sharded_swarm_rollout(prob_c, mesh, n_ticks=cfg["swarm_ticks"], dt=params.dt, k_neighbors=2)
        res_sw = swarm(th_c, U0_c)
        plain_sw = make_swarm_rollout(prob_c, cfg["swarm_ticks"], params.dt, k_neighbors=2, device=dev)
        res_ref = plain_sw(th_c, U0_c)
        swarm_err = float((res_sw.final_states.gather("cpu") - res_ref.final_states.cpu()).abs().max())
        launches += swarm.engines[0].launches + plain_sw.engines[0].launches

        # throughput: rank 0's one shard, then the global mesh
        opts = engine_options(per)
        results = []
        for engine in cfg["engines"]:
            kw = dict(opts[engine])
            p = make_point_stabilization(params, horizon=N, settings=kw.pop("solver_settings", None), device=dev)
            th, U = _bank(p, per * mesh.size)
            base = 0.0
            dist.barrier()
            if rank == 0:
                step1 = make_bank_solver(p, local, engine=engine, **kw)
                secs, _ = _timed(step1, {k: v[:per] for k, v in th.items()}, U[:per], reps, local)
                base = per / secs
                launches += sum(getattr(e, "launches", 0) for e in step1.engines)
            dist.barrier()
            step_g = make_bank_solver(p, mesh, engine=engine, **kw)
            th_g, U_g = shard_bank(th, mesh), shard_bank(U, mesh)
            secs, _ = _timed(step_g, th_g, U_g, reps, mesh)
            launches += sum(getattr(e, "launches", 0) for e in step_g.engines)
            rate = per * mesh.size / secs
            results.append({"engine": engine, "solves_per_s_1dev": base, "solves_per_s_ndev": rate,
                            "scaling_efficiency": rate / (base * mesh.size) if base else None})  # fmt: skip

        # the swarm's throughput, robot-ticks/s, its gather in every tick
        dist.barrier()
        base = 0.0
        if rank == 0:
            th1, U1 = circle_swarm(prob_c, per_sw, jitter=0.06, device=dev)
            roll1 = make_swarm_rollout(prob_c, cfg["swarm_ticks"], params.dt, k_neighbors=2, device=dev)
            secs, _ = _timed(lambda a, b: (roll1(a, b), {}), th1, U1, reps, local)
            base = per_sw * cfg["swarm_ticks"] / secs
        dist.barrier()
        secs, _ = _timed(lambda a, b: (swarm(a, b), {}), shard_bank(th_c, mesh), shard_bank(U0_c, mesh), reps, mesh)
        rate = per_sw * mesh.size * cfg["swarm_ticks"] / secs
        results.append({"engine": "swarm_allgather", "solves_per_s_1dev": base, "solves_per_s_ndev": rate,
                        "scaling_efficiency": rate / (base * mesh.size) if base else None})  # fmt: skip
        ceiling = _ceiling(mesh)
        for r in results:
            if r["scaling_efficiency"] is not None:
                r["efficiency_vs_ceiling"] = min(1.0, r["scaling_efficiency"] / ceiling)
        queue.put((rank, {
            "mode": "2-process torch.distributed (gloo) over local TCP",
            "backend": info["backend"],
            "processes": info["process_count"],
            "global_devices": mesh.size,
            "device": str(dev),
            "per_device_batch": per,
            "horizon": N,
            "physical_cores": os.cpu_count(),
            "contention_ceiling": ceiling,
            "mean_cost": float(metrics["mean_cost"]),
            "frac_converged": float(metrics["frac_converged"]),
            "max_kkt": float(metrics["max_kkt"]),
            "metrics_local": _metrics(ref_metrics),
            "max_err_vs_local": err,
            "bit_equal_vs_local": bit_equal,
            "swarm_err_vs_local": swarm_err,
            "swarm_min_separation": float(res_sw.min_separation),
            "launches": launches,
            "results": results,
        }))  # fmt: skip
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_distributed(
    timeout: float = 600.0,
    device=None,
    n_devices=None,
    per_device_batch: int = 64,
    horizon: int = 10,
    reps: int = 3,
    engines=BENCH_ENGINES,
    swarm_ticks: int = 8,
):
    """Two processes x ``n_devices`` slots (default: one card each, both on
    ``cuda:0`` where ``device`` names it; eight on the CPU), joined by gloo
    over local TCP into one global mesh; see :func:`_dist_worker`. Returns
    rank 0's artifact: the K1 bank's and the swarm's difference from one
    process's solve (``max_err_vs_local``, ``bit_equal_vs_local``,
    ``swarm_err_vs_local``), its metrics, each engine's one-shard and
    global throughput (``results``), and every K1 launch of both ranks
    (``launches``). Both ranks are killed if they have not ended within
    ``timeout`` seconds."""
    import queue as queue_mod
    import socket

    import torch.multiprocessing as mp

    from ..device import resolve_device

    dev = str(resolve_device(device))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = {"device": dev, "n_devices": n_devices, "per_device_batch": per_device_batch, "horizon": horizon,
           "reps": reps, "engines": tuple(engines), "swarm_ticks": swarm_ticks}  # fmt: skip
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_dist_worker, args=(r, 2, port, cfg, q), daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got = {}
    try:
        while len(got) < 2:
            try:
                rank, out = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"distributed rank(s) {dead} exited with {[procs[r].exitcode for r in dead]}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the distributed ranks did not finish within {timeout} s") from None
                continue
            got[rank] = out
            if "error" in out:
                raise RuntimeError(f"distributed rank {rank} failed:\n{out['error']}")
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return got[0]


def probe_single_device_core_usage(engine="cuda", per_device_batch: int = 512, device=None):
    """How many host cores does the one-shard baseline use? Times
    :func:`run`'s one-shard solve in a subprocess as it is and pinned to one
    core (``taskset -c 0``); their ratio is the baseline's core usage, by
    which the ceiling ``cores / shards`` overstates what a CPU mesh can
    reach. Returns ``{engine, unpinned_solves_per_s, pinned_solves_per_s,
    baseline_core_usage}``."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    code = (
        "from ros2_mpc_tpu_torch.parallel.scaling_bench import run, engine_options;"
        f"o = dict(engine_options({per_device_batch})[{engine!r}]);"
        f"r = run({per_device_batch}, 20, 3, engine={engine!r}, device={device!r}, n_devices=1, **o);"
        "print('PROBE', r['solves_per_s_1dev'])"
    )
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    rates = {}
    for name, prefix in {"unpinned": [], "pinned": ["taskset", "-c", "0"]}.items():
        out = subprocess.run(prefix + [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"{name} probe failed:\n{out.stdout}\n{out.stderr}")
        rates[name] = float(next(line.split()[1] for line in out.stdout.splitlines() if line.startswith("PROBE ")))
    return {
        "engine": engine,
        "unpinned_solves_per_s": rates["unpinned"],
        "pinned_solves_per_s": rates["pinned"],
        "baseline_core_usage": rates["unpinned"] / rates["pinned"],
    }


def main(argv=None):
    """Console entry (``cuda-mpc-scaling-bench``)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-device-batch", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("build", "SCALING.json"), help="JSON artifact path")
    ap.add_argument(
        "--device", default=None,
        help="device of the shards (default: every visible card, refused without one; 'cuda:0' with "
             "--n-devices 4 puts four shards on one card; 'cpu' eight CPU shards)",
    )  # fmt: skip
    ap.add_argument("--n-devices", type=int, default=None, help="shards of the mesh (default: see --device)")
    ap.add_argument("--distributed", action="store_true", help="also run the two-process gloo measurement")
    ap.add_argument("--decompose", action="store_true", help="probe the one-shard baseline's host-core usage (taskset)")
    args = ap.parse_args(argv)
    out = run_all_engines(args.per_device_batch, args.horizon, args.reps, device=args.device, n_devices=args.n_devices)
    if args.decompose:
        out["baseline_core_usage_probe"] = [
            probe_single_device_core_usage(e, args.per_device_batch, device=args.device) for e in ("vmap", "mppi")
        ]
    if args.distributed:
        out["distributed"] = run_distributed(device=args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    for r in out["results"]:
        print(
            f"{r['engine']:>17}: shards={r['devices']} 1-shard={r['solves_per_s_1dev']:.0f}/s "
            f"n-shard={r['solves_per_s_ndev']:.0f}/s efficiency={r['scaling_efficiency'] * 100:.1f}% "
            f"(ceiling {r['contention_ceiling'] * 100:.0f}%: {r['efficiency_vs_ceiling'] * 100:.1f}%), "
            f"shard 0 equal to one shard {r['first_shard_equal']}"
        )
    for r in out.get("baseline_core_usage_probe", []):
        print(f"decompose {r['engine']}: the one-shard baseline uses {r['baseline_core_usage']:.2f} cores")
    for r in out.get("distributed", {}).get("results", []):
        print(f"dist {r['engine']:>17}: 1-shard={r['solves_per_s_1dev']:.0f}/s 2-process={r['solves_per_s_ndev']:.0f}/s")
    return out


if __name__ == "__main__":
    main()

"""Sweep K1's launch geometry on one CUDA card, or time one tree's kernels.

    python3 k1_sweep.py [--reps 5] [--out build/k1_sweep.json]
    python3 k1_sweep.py --time-only [--package-root DIR] [--reps 5]

K1's lanes per scenario (G) and scenarios per block are compile-time
constants of ``csrc/point_stab.cu``. The sweep builds one library for each
geometry, G = 8, 16, 32 lanes at 32 to 256 threads a block, by adding
``-DMPC_K1_GROUP`` and ``-DMPC_K1_SCENARIOS_PER_BLOCK`` to the port's nvcc
flags (the builds run side by side, each in its own process). For every
geometry it prints K1's registers, local memory, shared memory per block
and resident blocks per SM, checks that K1 is bit-equal to its plain
version (U, X, cost, KKT residual, n_iters and the iters / ls_rollouts
counters) on chip_smoke.py's headline and obstacle-active banks (B=4096,
N=20) and on its tick (B=1, N=30, realtime schedule), and times both banks
with CUDA events (median of ``--reps``, wrapper included) in two passes,
the second in reverse order. It writes the table as JSON to ``--out`` and
exits nonzero if any geometry was not bit-equal.

``--time-only`` times the port found under ``--package-root`` (default:
this script's directory) as it ships: K1 on both banks, K2 on
chip_smoke.py's tracking bank, and the tick's host-clock latency. It uses
only entry points that every slice of the port has, so that two trees can
be timed in one call on one card (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

GROUPS = (8, 16, 32)
THREADS = (32, 64, 128, 256)
PARALLEL_BUILDS = 6  # three nvcc processes each


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]  # fmt: skip


def _banks(inp):
    """{name: (problem, thetas)} of chip_smoke.py's main path."""
    return {
        "headline": (inp.prob, inp.th_main),
        "obstacle-active": (inp.prob_c, inp.th_obs),
        "tracking": (inp.prob_t, inp.th_trk),
    }


def time_only(dev, reps, card):
    """The shipped kernels' times: K1 on two banks, K2, and the tick."""
    import torch

    from chip_smoke import B, N, cuda_ms, main_path_inputs, tick_latency
    from ros2_mpc_tpu_torch import solver
    from ros2_mpc_tpu_torch.solver import cuda_kernel as ck
    from ros2_mpc_tpu_torch.solver.packed import make_packed_point_stab

    inp = main_path_inputs(dev)
    U0 = torch.zeros(B, N, 2, dtype=torch.float32, device=dev)
    out = {"package": str(Path(solver.__file__).resolve().parents[2]), "card": card}
    for name, (prob, th) in _banks(inp).items():
        make = ck.make_cuda_tracking_solver if name == "tracking" else ck.make_cuda_point_stab_solver
        out[name + " ms"] = cuda_ms(make(prob.ocp, prob.settings), th, U0, reps=reps)
    k1_tick = ck.make_cuda_point_stab_solver(inp.prob_tick.ocp, inp.prob_tick.settings)
    solve_tick, pack = make_packed_point_stab(inp.prob_tick, inp.params, solve_fn=ck.single_scenario(k1_tick))
    lat = tick_latency(
        solve_tick, pack, inp.prob_tick.default_u0, inp.tick_obs_x, inp.tick_obs_y, inp.tick_goal
    )
    out["tick p50 ms"], out["tick p99 ms"] = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    print(json.dumps(out), flush=True)
    return 0


def _defines(g, spb):
    return (f"-DMPC_K1_GROUP={g}", f"-DMPC_K1_SCENARIOS_PER_BLOCK={spb}")


def _build_variants(geos):
    """Build every geometry's library, PARALLEL_BUILDS at a time, each in a
    process of its own with the defines added to the port's flags."""
    code = (
        "import sys; from ros2_mpc_tpu_torch import _build; "
        "_build.NVCC_FLAGS += tuple(sys.argv[1:]); _build.build()"
    )
    root = str(Path(__file__).resolve().parent)

    def one(geo):
        proc = subprocess.run(
            [sys.executable, "-c", code, *_defines(*geo)], cwd=root, capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"build of G={geo[0]} scenarios/block={geo[1]} failed:\n{proc.stderr}")

    with ThreadPoolExecutor(PARALLEL_BUILDS) as pool:
        list(pool.map(one, geos))


def sweep(dev, reps, card, out):
    import torch

    from chip_smoke import B, N, cuda_ms, main_path_inputs
    from ros2_mpc_tpu_torch import _build
    from ros2_mpc_tpu_torch.solver import cuda_kernel as ck

    geos = [(g, t // g) for g in GROUPS for t in THREADS if t >= g]
    base_flags = _build.NVCC_FLAGS

    def use(g, spb):  # the wrappers load this geometry's library next
        _build.NVCC_FLAGS = base_flags + _defines(g, spb)
        _build.load_library.cache_clear()

    inp = main_path_inputs(dev)
    banks = _banks(inp)
    del banks["tracking"]
    tens = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    prob_tick = inp.prob_tick
    th_tick = torch.func.vmap(prob_tick.make_theta)(
        tens([[0.0, 0.0, 0.0]]), tens(inp.tick_goal[None]), tens(inp.tick_obs_x[None]), tens(inp.tick_obs_y[None])
    )
    U0 = torch.zeros(B, N, 2, dtype=torch.float32, device=dev)
    U0_tick = torch.zeros(1, prob_tick.ocp.horizon, 2, dtype=torch.float32, device=dev)

    solvers = {
        name: ck.make_cuda_point_stab_solver(p.ocp, p.settings, with_counters=True)
        for name, (p, _) in banks.items()
    }
    tick = ck.make_cuda_point_stab_solver(prob_tick.ocp, prob_tick.settings, with_counters=True)
    refs = {name: solvers[name].plain(th, U0) for name, (_, th) in banks.items()}
    ref_tick = tick.plain(th_tick, U0_tick)

    def equal(got, ref):
        (s, c), (rs, rc) = got, ref
        fields = (s.U, s.X, s.cost, s.kkt_residual, s.n_iters, c["iters"], c["ls_rollouts"])
        rfields = (rs.U, rs.X, rs.cost, rs.kkt_residual, rs.n_iters, rc["iters"], rc["ls_rollouts"])
        return all(torch.equal(a, b) for a, b in zip(fields, rfields))

    _build_variants(geos)
    rows, bad = {}, []
    for g, spb in geos:
        use(g, spb)
        info = solvers["headline"].kernel_info(B)
        eq = {name: equal(solvers[name](th, U0), refs[name]) for name, (_, th) in banks.items()}
        eq["tick"] = equal(tick(th_tick, U0_tick), ref_tick)
        torch.cuda.synchronize()
        rows[(g, spb)] = {"info": info, "bit_equal": eq, "ms": {name: [] for name in banks}}
        print(f"G={g} scenarios/block={spb}: {info}; bit-equal {eq}", flush=True)
        if not all(eq.values()):
            bad.append((g, spb))
    for order in (geos, geos[::-1]):
        for g, spb in order:
            use(g, spb)
            for name, (_, th) in banks.items():
                rows[(g, spb)]["ms"][name].append(cuda_ms(solvers[name], th, U0, reps=reps))
    print(f"K1 geometry sweep, B={B}, N={N}, ms per bank (median of {reps}, two passes) -- {card}")
    for (g, spb), row in rows.items():
        ms = {name: [round(t, 4) for t in ts] for name, ts in row["ms"].items()}
        i = row["info"]
        print(
            f"  G={g:2d} threads={g * spb:3d} spb={spb:2d} regs={i['registers']:3d} local={i['local_bytes']} "
            f"spill={i['spill_stores']} smem={i['smem_bytes']} blocks/SM={i['blocks_per_sm']:2d}  {ms}"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(
        json.dumps({"card": card, "rows": [{"group": g, "spb": s, **v} for (g, s), v in rows.items()]}, indent=1)
    )
    if bad:
        print(f"not bit-equal at {bad}", file=sys.stderr)
        return 1
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_sweep: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--out", type=Path, default=Path("build/k1_sweep.json"))
    args = ap.parse_args()
    import chip_smoke  # noqa: F401  (this script's own, before another package root goes first)

    if args.package_root:
        sys.path.insert(0, str(Path(args.package_root).resolve()))
    card = _card()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    if args.time_only:
        return time_only(dev, args.reps, card)
    return sweep(dev, args.reps, card, args.out)


if __name__ == "__main__":
    sys.exit(main())

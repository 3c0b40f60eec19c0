"""Sweep the lane-group kernels' launch geometry on one CUDA card, or time
one tree's kernels.

    python3 geometry_sweep.py [--reps 5] [--out build/geometry_sweep.json]
    python3 geometry_sweep.py --time-only [--package-root DIR] [--reps 5]

K1's and K2's lanes per scenario (G) and scenarios per block are
compile-time constants of ``csrc/point_stab.cu`` and ``csrc/tracking.cu``.
The sweep builds one library for each geometry, G = 8, 16, 32 lanes at 32
to 256 threads a block, by adding ``-DMPC_K1_GROUP``,
``-DMPC_K1_SCENARIOS_PER_BLOCK``, ``-DMPC_K2_GROUP`` and
``-DMPC_K2_SCENARIOS_PER_BLOCK`` (both kernels at the same geometry) to the
port's nvcc flags; the builds run side by side, each in its own process.
For every geometry it prints each kernel's registers, local memory, spill
stores, shared memory per block and resident blocks per SM, checks that
each kernel is bit-equal to its plain version (U, X, cost, KKT residual,
n_iters and the iters / ls_rollouts counters) on chip_smoke.py's banks
(B=4096, N=20: K1 headline and obstacle-active, K2 tracking) and ticks
(B=1, N=30, realtime schedule: K1's point tick, K2's tracking tick), and
times the three banks with CUDA events (median of ``--reps``, wrapper
included) in two passes, the second in reverse order. It writes the table
as JSON to ``--out`` and exits nonzero if any geometry was not bit-equal.

``--time-only`` times the port found under ``--package-root`` (default:
this script's directory) as it ships: K1 on both banks, K2 on the tracking
bank, and both ticks' host-clock latency. It uses only entry points that
every slice of the port has, so that two trees can be timed in one call on
one card (parent, change, change, parent).
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


def _solver(prob, **kw):
    """The bank kernel of the problem's kind."""
    from ros2_mpc_tpu_torch.solver import cuda_kernel as ck

    make = ck.make_cuda_tracking_solver if prob.kind == "tracking" else ck.make_cuda_point_stab_solver
    return make(prob.ocp, prob.settings, **kw)


def time_only(dev, reps, card):
    """The shipped kernels' times: K1 on two banks, K2, and both ticks."""
    import torch

    from chip_smoke import B, N, cuda_ms, main_path_inputs, tick_latency, tick_paths
    from ros2_mpc_tpu_torch import solver

    inp = main_path_inputs(dev)
    U0 = torch.zeros(B, N, 2, dtype=torch.float32, device=dev)
    out = {"package": str(Path(solver.__file__).resolve().parents[2]), "card": card}
    for name, (prob, th) in _banks(inp).items():
        out[name + " ms"] = cuda_ms(_solver(prob), th, U0, reps=reps)
    paths = tick_paths(inp, _solver(inp.prob_tick), _solver(inp.prob_ttick))
    for name, (solve, pack_at, U_warm) in paths.items():
        lat = tick_latency(solve, pack_at, U_warm)
        out[f"{name} p50 ms"], out[f"{name} p99 ms"] = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    print(json.dumps(out), flush=True)
    return 0


def _defines(g, spb):
    return tuple(f"-DMPC_{k}_{name}={v}" for k in ("K1", "K2") for name, v in (("GROUP", g), ("SCENARIOS_PER_BLOCK", spb)))


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

    from chip_smoke import B, N, cuda_ms, main_path_inputs, tracking_window
    from ros2_mpc_tpu_torch import _build

    geos = [(g, t // g) for g in GROUPS for t in THREADS if t >= g]
    base_flags = _build.NVCC_FLAGS

    def use(*geo):  # the wrappers load this geometry's library next
        _build.NVCC_FLAGS = base_flags + _defines(*geo)
        _build.load_library.cache_clear()

    inp = main_path_inputs(dev)
    banks = _banks(inp)
    tens = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    one = lambda make, *a: torch.func.vmap(make)(*(tens(x)[None] for x in a))  # noqa: E731  (B=1)
    N_t = inp.prob_ttick.ocp.horizon
    ticks = {  # the first tick of each tick path, from the origin
        "point tick": (
            inp.prob_tick,
            one(inp.prob_tick.make_theta, np.zeros(3), inp.tick_goal, inp.tick_obs_x, inp.tick_obs_y),
        ),
        "tracking tick": (
            inp.prob_ttick,
            one(inp.prob_ttick.make_theta, np.zeros(3), *tracking_window(0, N_t, inp.params.dt),
                inp.tick_obs_x, inp.tick_obs_y),
        ),
    }  # fmt: skip
    cases = {**banks, **ticks}
    U0s = {name: torch.zeros(th["x0"].shape[0], p.ocp.horizon, 2, device=dev) for name, (p, th) in cases.items()}
    solvers = {name: _solver(p, with_counters=True) for name, (p, _) in cases.items()}
    refs = {name: solvers[name].plain(th, U0s[name]) for name, (_, th) in cases.items()}

    def equal(got, ref):
        (s, c), (rs, rc) = got, ref
        fields = (s.U, s.X, s.cost, s.kkt_residual, s.n_iters, c["iters"], c["ls_rollouts"])
        rfields = (rs.U, rs.X, rs.cost, rs.kkt_residual, rs.n_iters, rc["iters"], rc["ls_rollouts"])
        return all(torch.equal(a, b) for a, b in zip(fields, rfields))

    _build_variants(geos)
    rows, bad = {}, []
    for geo in geos:
        use(*geo)
        info = {"K1": solvers["headline"].kernel_info(B), "K2": solvers["tracking"].kernel_info(B)}
        eq = {name: equal(solvers[name](th, U0s[name]), refs[name]) for name, (_, th) in cases.items()}
        torch.cuda.synchronize()
        rows[geo] = {"info": info, "bit_equal": eq, "ms": {name: [] for name in banks}}
        print(f"G={geo[0]} scenarios/block={geo[1]}: {info}; bit-equal {eq}", flush=True)
        if not all(eq.values()):
            bad.append(geo)
    for order in (geos, geos[::-1]):
        for geo in order:
            use(*geo)
            for name, (_, th) in banks.items():
                rows[geo]["ms"][name].append(cuda_ms(solvers[name], th, U0s[name], reps=reps))
    print(f"geometry sweep, B={B}, N={N}, ms per bank (median of {reps}, two passes) -- {card}")
    for (g, spb), row in rows.items():
        ms = {name: [round(t, 4) for t in ts] for name, ts in row["ms"].items()}
        kern = "; ".join(
            f"{k} regs={i['registers']} local={i['local_bytes']} spill={i['spill_stores']} "
            f"smem={i['smem_bytes']} blocks/SM={i['blocks_per_sm']}"
            for k, i in row["info"].items()
        )
        print(f"  G={g:2d} threads={g * spb:3d} spb={spb:2d}  {kern}  {ms}")
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
        print("geometry_sweep: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--out", type=Path, default=Path("build/geometry_sweep.json"))
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

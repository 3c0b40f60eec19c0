"""Run one cell of the port's benchmark and print its result as the last line.

    python3 portbench/run.py --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a profiled stretch of the window. Every run
checks what the window produced against the plain reference and prints each
number compared beside its limit, last on standard error and under
``checks`` in the result. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the checkout's own build and kernel caches, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "portbench_cache" / sub))
os.environ.setdefault("USE_FLAX", "0")
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "ros2_mpc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (the port's name begins with the latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )  # fmt: skip
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    from yardstick import spec as specs

    bench = specs.load_benchmark()
    spec = specs.resolve(bench, args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(
            f"portbench: needs {chips} CUDA card(s); torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 2
    return run(spec, args, torch.device("cuda", 0))


def run(spec: dict, args, device) -> int:
    """Set up, measure, check and report one run on ``device``."""
    import torch

    from yardstick import judge, trace
    from yardstick import spec as specs

    t_port = time.perf_counter()
    cell = specs.kind(spec["traffic"]["kind"])(spec, args.seed, device)
    t_setup = time.perf_counter()
    cell.setup()
    setup_s = time.perf_counter() - T_START
    phases = f"imports {t_port - T_START:.3f} s, port {t_setup - t_port:.3f} s, cell {setup_s - (t_setup - T_START):.3f} s"
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    stretch = None
    if args.trace:
        t = spec["traffic"]["trace"]
        stretch = trace.Stretch(min(t["start_after"], 0.3 * args.seconds), t["seconds"])
        stretch.prepare()
    win = cell.window(args.seconds, stretch)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    cell.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = cell.check(control=args.control)
    check_s = time.perf_counter() - t_check
    correct, checks = judge.verdict(numbers, spec["limits"]["limits"])

    metrics = {}
    if args.trace:
        run_info = cell.layer_run(stretch)
        for m in spec["per_layer"]:
            value = specs.reader(m["name"])(run_info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    dev_info = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    card = power_limit() if on_card else "no card"
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"], "metrics": metrics}
    if args.trace:
        dev_info["busy_s"] = stretch.busy_s()
        dev_info["window_s"] = stretch.window_s
        result["device"] = dev_info
        result["breakdown"] = stretch.breakdown()
    else:
        result["device"] = dev_info
    result["card"] = card
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(
        f"portbench {args.workload} seed {args.seed}: {win['attempted']} attempted, {win['failed']} failed "
        f"in {win['seconds']:.3f} s; set-up {setup_s:.3f} s ({phases}); check {check_s:.3f} s; {card}",
        file=sys.stderr,
    )
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Shared by the benchmark's CPU tests: cells shrunk to a size the CPU
holds, driven through the harness's own run loop on the port's plain
versions."""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from yardstick import spec as specs  # noqa: E402

BENCH = specs.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# a cell made of what the benchmark has, in no BENCHMARK.json entry: the
# tracking configuration under a bank mix of arc paths (K2's bank), which a
# later change adds as data files alone; held here to the CPU's limits
EXTRA = {"name": "tracking.bank_arc", "config": "tracking", "traffic": "bank_arc", "chips": 1}
EXTRA_MIX = {
    "kind": "bank", "B": 16, "pool": 2, "in_flight": 2,
    "schedule": {"barrier_stages": 4, "iters_per_stage": 3, "n_alphas": 6, "mu_init": 0.01},
    "draws": [
        {"recipe": "arc_windows", "waypoints": 64, "speed_frac": [0.3, 0.5], "curvature": 0.6,
         "start_jitter": 0.05, "heading_error": 0.4},
        {"recipe": "clusters", "n_live": 3, "spread": 0.4, "respread": 0.45, "retries": 16, "clearance": 0.3,
         "sentinel": 100.0},
    ],
    "check": {"rows": 12, "rows_per_call": 4}, "trace": {"start_after": 2.0, "seconds": 2.0},
}  # fmt: skip
EXTRA_LIMITS = {"limits": {"x_gap": 1e-4, "cost_gap": 1e-4, "kkt_gap": 1e-3, "kkt_rel_gap": 0.1, "conv_gap": 0.2}}
HARNESS_CELLS = CELLS + [EXTRA["name"]]


def tiny(cell: str) -> dict:
    """The cell's spec at a CPU size: the horizon and the banks cut, the
    rest (recipes, schedules, limits) as committed."""
    if cell == EXTRA["name"]:
        spec = specs.assemble(BENCH, EXTRA, EXTRA_LIMITS, json.loads(json.dumps(EXTRA_MIX)))
    else:
        spec = specs.resolve(BENCH, cell)
    spec["config"]["params"]["N"] = 8
    t = spec["traffic"]
    if t["kind"] == "bank":
        t.update(B=16, pool=2, check={"rows": 12, "rows_per_call": 4})
    else:
        t.update(B=12, pool=2, ticks=6, check={"robots": 5, "ticks": 4})
    return spec


@pytest.fixture
def cpu_record(monkeypatch):
    """The bank solver keeps its ``record`` on CUDA tensors only; on the CPU
    the tiny runs keep it too, so that the fleet's check has its ticks."""
    import ros2_mpc_tpu_torch.solver.cuda_kernel as ck

    call = ck.CudaBankSolver.__call__

    def recorded(self, thetas, U0s):
        out = call(self, thetas, U0s)
        if self.record is not None and U0s.device.type == "cpu":
            self.record.append((thetas, U0s, out))
        return out

    monkeypatch.setattr(ck.CudaBankSolver, "__call__", recorded)
    return ck


def run_tiny(cell: str, capsys, seconds: float = 1.0, seed: int = 2**31 + 11, control: bool = False) -> dict:
    """One run of the tiny cell on the CPU; returns the printed result."""
    import torch

    import run as runner

    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds, trace=0, control=control)
    assert runner.run(tiny(cell), args, torch.device("cpu")) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])

"""The harness's run end to end on the CPU at a tiny size: the result line,
the refusal without a card, the JAX check, the control and the faults that
must each turn ``correct`` false."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, CELLS, HARNESS_CELLS, HERE, ROOT, run_tiny, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "card", "checks"]


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, str(HERE / "run.py"), "--workload", CELLS[0], "--seed", "1", "--seconds", "1"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_harness_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]; import run; from yardstick import cells, judge, trace, ledger, spec;"
        "[spec.module(d, p.stem) for d in ('kinds', 'planners', 'recipes', 'metrics') for p in (spec.HERE / d).glob('*.py')];"
        "cells.port(); print(run.forbidden_modules())" % (str(HERE), str(ROOT))
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    sys.path[:0] = [str(HERE)]
    import run

    sys.modules["ros2_mpc_tpu_x"] = sys  # a longer name that begins alike is not the JAX package
    try:
        assert "ros2_mpc_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["ros2_mpc_tpu_x"]


@pytest.mark.parametrize("cell", HARNESS_CELLS)
def test_result_line(cell, capsys, cpu_record):
    res = run_tiny(cell, capsys)
    assert list(res) == KEYS, "checks come last"
    assert res["correct"] is True and res["attempted"] >= 1
    e2e = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == e2e
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_breakdown_from_a_trace():
    from yardstick.trace import MARK, Stretch

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": MARK, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "point_stab_kernel", "ts": 10, "dur": 50, "args": {"stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 60, "dur": 10, "args": {"stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "sum", "ts": 62, "dur": 4, "args": {"stream": 9}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::stack", "ts": 70, "dur": 25},
    ]
    s = Stretch(0, 1)
    s.parse(ev)
    s.units = 1
    assert s.window_s == pytest.approx(1e-4) and s.busy_s() == pytest.approx(6e-5)
    k1, others = s.solver_kernels("point_stab_kernel")
    assert len(k1) == 1 and [n for n, _, _ in others] == ["elementwise"]
    b = s.breakdown()
    assert b["device_ops"][0] == ["point_stab_kernel", pytest.approx(5e-5)]
    assert dict(b["idle_gaps"]) == {"host: aten::stack": pytest.approx(3e-5), "host: no traced call": pytest.approx(1e-5)}
    assert s.idle_percent() == pytest.approx(40.0)


@pytest.mark.parametrize("cell", HARNESS_CELLS)
def test_control_fails(cell, capsys, cpu_record):
    """The reference one precision down (bfloat16) in the program's place
    fails at least one number of every cell."""
    res = run_tiny(cell, capsys, control=True)
    assert res["correct"] is False
    failed = [n for n, c in res["checks"].items() if not c["value"] <= c["limit"]]
    assert failed


def _faulty(ck, monkeypatch, fault):
    call = ck.CudaBankSolver.__call__

    def broken(self, thetas, U0s):
        if fault == "unchanged":  # no iteration: the warm start comes back
            cfg = self.cfg
            self.cfg = cfg._replace(mus=(), stages=(), firsts=())
            try:
                return call(self, thetas, U0s)
            finally:
                self.cfg = cfg
        sol = call(self, thetas, U0s)
        if fault == "half":  # the second half of the bank left out, filled from the first
            h = sol.U.shape[0] // 2
            fill = lambda t: torch.cat([t[:h], t[: t.shape[0] - h]])  # noqa: E731
            return sol._replace(U=fill(sol.U), X=fill(sol.X), cost=fill(sol.cost), kkt_residual=fill(sol.kkt_residual))
        if fault == "flags":  # every residual reported across the tolerance, ten times over or under it
            k = sol.kkt_residual
            return sol._replace(kkt_residual=torch.where(k >= KKT_TOL, 0.1 * KKT_TOL, 10.0 * KKT_TOL))
        U = sol.U.clone()  # "altered": every first control moved where it is produced
        U[:, 0, 0] += 0.02
        return sol._replace(U=U)

    monkeypatch.setattr(ck.CudaBankSolver, "__call__", broken)


KKT_TOL = 1e-4  # every schedule's kkt_tol
FAULTS = [(c, f) for c in HARNESS_CELLS for f in ("unchanged", "half", "altered")]
# the banks' rate counts the reported flags: a residual reported across the
# tolerance, beyond what float32 rounding moves it, has to fail
FLAG_FAULTS = [c for c in HARNESS_CELLS if "kkt_rel_gap" in tiny(c)["limits"]["limits"]]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_turns_correct_false(cell, fault, capsys, cpu_record, monkeypatch):
    _faulty(cpu_record, monkeypatch, fault)
    res = run_tiny(cell, capsys)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", FLAG_FAULTS)
def test_misreported_residual_fails_the_flags(cell, capsys, cpu_record, monkeypatch):
    _faulty(cpu_record, monkeypatch, "flags")
    res = run_tiny(cell, capsys, seconds=2.0)
    c = res["checks"]["kkt_rel_gap"]
    assert res["correct"] is False and c["value"] > c["limit"], res["checks"]


@pytest.mark.cuda
def test_cells_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in CELLS:
        cmd = [sys.executable, str(HERE / "run.py"), "--workload", cell, "--seed", "7", "--seconds", "2"]
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True

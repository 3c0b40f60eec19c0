"""The port's telemetry against ros2_mpc_tpu.utils.telemetry, on the CPU:
the same series give the same summaries (exact: both are the same NumPy
float64 arithmetic), and ``profile_trace`` writes a ``torch.profiler``
trace where the JAX module wrote a ``jax.profiler`` one."""

import json

import numpy as np
import pytest
import torch

from ros2_mpc_tpu.utils.telemetry import Telemetry as JTelemetry
from ros2_mpc_tpu_torch.utils.telemetry import Telemetry, profile_trace


def test_telemetry_percentiles():
    """tests/test_utils.py's telemetry checks, on the port's copy."""
    t = Telemetry("x")
    for v in range(100):
        t.record(solve_s=v / 1000.0)
    p = t.percentiles("solve_s")
    assert 0.04 < p["p50"] < 0.06
    assert p["p99"] > 0.09
    s = t.summary()
    assert s["solve_s"]["max"] == 0.099


def test_telemetry_matches_jax():
    rng = np.random.default_rng(2)
    got, ref = Telemetry("tick", capacity=50), JTelemetry("tick", capacity=50)
    for lat, kkt in zip(rng.exponential(1e-3, 80), rng.uniform(0, 1e-4, 80)):
        for t in (got, ref):
            t.record(solve_s=float(lat), kkt=float(kkt), converged=bool(kkt < 5e-5))
    assert got.summary() == ref.summary()  # capacity cut both at 50 ticks
    assert got.summary()["n_ticks"] == 50
    for key in ("solve_s", "kkt", "missing"):
        np.testing.assert_array_equal(
            list(got.percentiles(key, qs=(10, 50, 99)).values()),
            list(ref.percentiles(key, qs=(10, 50, 99)).values()),
        )
    with got.timer("host_s"):
        pass
    assert len(got.series["host_s"]) == 1 and got.series["host_s"][0] >= 0.0


def test_profile_trace_cpu_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir), device="cpu") as prof:
        x = torch.ones(64, 64)
        for _ in range(3):
            x = torch.tanh(x @ x * 1e-2)
    trace = json.loads((logdir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::tanh" in names and "aten::mm" in names
    assert any(e.key == "aten::tanh" and e.count == 3 for e in prof.key_averages())


def test_profile_trace_defaults_to_the_card(tmp_path):
    """Without ``device`` the trace is of the card; with no CUDA device that
    raises rather than tracing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default traces it (chip_smoke.py)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profile_trace(str(tmp_path)):
            pass
    assert not (tmp_path / "trace.json").exists()

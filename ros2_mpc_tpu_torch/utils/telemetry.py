"""Solver/control-loop telemetry.

Port of :mod:`ros2_mpc_tpu.utils.telemetry`: every control loop records
structured per-tick metrics (solve latency, KKT residual, cost,
convergence) with p50/p99 summaries, plus an optional ``torch.profiler``
trace of the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..device import resolve_device


class Telemetry:
    def __init__(self, name: str, capacity: int = 100_000):
        self.name = name
        self.capacity = capacity
        self.series: dict[str, list] = defaultdict(list)

    def record(self, **metrics):
        for k, v in metrics.items():
            s = self.series[k]
            if len(s) < self.capacity:
                s.append(v)

    @contextlib.contextmanager
    def timer(self, key: str):
        t0 = time.perf_counter()
        yield
        self.record(**{key: time.perf_counter() - t0})

    def percentiles(self, key: str, qs=(50, 99)) -> dict:
        vals = np.asarray(self.series.get(key, []), dtype=float)
        if vals.size == 0:
            return {f"p{q}": float("nan") for q in qs}
        return {f"p{q}": float(np.percentile(vals, q)) for q in qs}

    def summary(self) -> dict:
        out = {"name": self.name, "n_ticks": len(next(iter(self.series.values()), []))}
        for key, vals in self.series.items():
            arr = np.asarray(vals, dtype=float)
            if arr.size:
                out[key] = {
                    "mean": float(arr.mean()),
                    "p50": float(np.percentile(arr, 50)),
                    "p99": float(np.percentile(arr, 99)),
                    "max": float(arr.max()),
                }
        return out


@contextlib.contextmanager
def profile_trace(logdir: str, device=None):
    """Capture a ``torch.profiler`` trace of the block: host and, on the
    card (``device=None``), CUDA activity. On exit the trace is written to
    ``logdir/trace.json`` (Chrome trace format; open in Perfetto or
    ``chrome://tracing``). Yields the profiler, whose ``key_averages()``
    sums the time by op and kernel."""
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

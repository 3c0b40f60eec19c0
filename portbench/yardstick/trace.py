"""One steady stretch of a window under ``torch.profiler``, and what the
per-layer readers take from it.

The stretch starts and ends at a synchronize, so every device activity in
it belongs to the calls issued in it. The trace is written to a temporary
file under ``TMPDIR``, parsed, and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

MARK = "portbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Stretch:
    """Profiles the part of a window from ``start_after`` seconds in, for at
    least ``length`` seconds (the loop decides where units of work end)."""

    def __init__(self, start_after: float, length: float):
        self.start_after, self.length = start_after, length
        self.state = "waiting"  # -> "on" -> "done"
        self.units = 0  # units of work (calls, rollouts, ticks) issued inside
        self.t0 = None

    def due(self, elapsed: float) -> bool:
        return self.state == "waiting" and elapsed >= self.start_after

    def over(self, now: float) -> bool:
        return self.state == "on" and now - self.t0 >= self.length

    def turn(self, now: float, t0: float) -> float:
        """Start or stop the profiler where the window loop stands; returns
        the seconds that took, which the window does not count."""
        if self.due(now - t0):
            self.start()
        elif self.over(now):
            self.stop()
        else:
            return 0.0
        return time.perf_counter() - now

    @staticmethod
    def prepare():
        """Start and stop the profiler once on a trivial op: its first start
        initialises the device tracer, which takes seconds."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self):
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.mark = record_function(MARK)
        self.mark.__enter__()
        self.t0 = time.perf_counter()
        self.state = "on"

    def stop(self):
        torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        del self.prof
        self.parse(events)
        self.state = "done"

    def parse(self, events):
        mark = [e for e in events if e.get("name") == MARK and e.get("cat") == "user_annotation"]
        if not mark:
            raise RuntimeError("the profiler's trace lacks the stretch's mark")
        self.lo = float(mark[0]["ts"])
        self.hi = self.lo + float(mark[0]["dur"])
        self.window_s = (self.hi - self.lo) / 1e6
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            if ts + dur <= self.lo or ts >= self.hi:
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                dev.append((e["name"], ts, dur, cat, (e.get("args") or {}).get("stream")))
            elif cat in HOST_CATS and e["name"] != MARK:
                host.append((e["name"], ts, dur))
        self.device = dev
        self.host = host

    # ------------------------------------------------------------ readings

    def solver_kernels(self, like: str):
        """(the solver kernel's events, the other kernels on its stream), each
        (name, ts, dur); the solver kernel's name contains ``like``."""
        mine = [(n, t, d) for n, t, d, c, _ in self.device if c == "kernel" and like in n]
        if not mine:
            return [], []
        stream = next(s for n, _, _, c, s in self.device if c == "kernel" and like in n)
        others = [(n, t, d) for n, t, d, c, s in self.device if c == "kernel" and s == stream and like not in n]
        return mine, others

    def idle_percent(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def _busy_intervals(self):
        spans = sorted((max(t, self.lo), min(t + d, self.hi)) for _, t, d, _, _ in self.device)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy_intervals()) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps'
        time by what the host was doing then, in seconds."""
        by_op = defaultdict(float)
        for n, _, d, _, _ in self.device:
            by_op[n[:160]] += d / 1e6
        gaps, prev = [], self.lo
        for a, b in self._busy_intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.hi > prev:
            gaps.append((prev, self.hi))
        # what the host was doing: the innermost traced host call that
        # spans the middle of the gap
        host = sorted(self.host, key=lambda e: e[1])
        starts = [t for _, t, _ in host]
        by_host = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            spans = [(d, n) for n, t, d in host[max(0, i - 256) : i] if t + d >= mid]
            name = "host: " + min(spans)[1][:150] if spans else "host: no traced call"
            by_host[name] += (b - a) / 1e6
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": order(by_op), "idle_gaps": order(by_host)}

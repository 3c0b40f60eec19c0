"""The program's own spans in a profiled stretch, and the device time each
issued.

The port marks its layers with ``torch.profiler`` spans named ``bank.*``,
``fleet.*`` and ``tick.*`` (``ros2_mpc_tpu_torch/utils/telemetry.py::span``);
the stretch keeps them among its host events, on the clock of the device's
records. A span's parent is the innermost program span that contains it;
its self time is its duration less its children's.

Device time is matched to spans by order, since the parsed stretch keeps no
correlation ids. The CUDA API calls (`cuda*`, `cu*`) that enqueue a device
operation (a kernel launch, an asynchronous copy or fill), taken inside
program spans in host order, pair one to one with the operations on the
program's stream in start order: one stream runs in the order it is
issued, and within the stretch the program issues every operation on its
stream inside its spans. The solver kernel, found by name, anchors each
call: they pair with the ``bank.launch`` spans in order, and between two
anchors (a segment) the counts of calls and operations must agree.

The tracer may lose device records at the stretch's ends: those of what
was launched before it was on (a whole tick's, at times), the last ones
once its buffer is full, and those its clock places past the stretch's end.
Where kernels were lost, the first one on record is placed by the
stretch's end and by time, which must agree (``_offset``). A segment whose
counts disagree holds no reading for the spans that issued into it, and a
reading per unit of work (a call, a tick) averages over the units that
issued only into segments whose counts agree. Where the placings disagree,
where fewer than nine in ten units are whole, or where no span is found,
there is no reading (``None``).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

PREFIXES = ("bank.", "fleet.", "tick.")
LAUNCH = "bank.launch"  # the span that launches the solver kernel, and nothing else
ENQUEUE = ("LaunchKernel", "Memcpy", "Memset")  # in the names of the calls that enqueue an operation
EPS = 1e-3  # us: the trace's resolution
WHOLE = 0.9  # the least share of units whose device records are all there


class Spans:
    """The stretch's program spans, in start order: ``name``, ``ts``,
    ``dur`` (us), ``parent`` (an index, or None), ``self_us``; where the
    pairing held, ``device_us``, the device time of the operations each
    span issued itself (its children's not included), and ``whole``, False
    for a span that issued into a segment whose records were lost, and for
    its ancestors."""

    def __init__(self, host):
        spans = sorted((e for e in host if e[0].startswith(PREFIXES)), key=lambda e: (e[1], -e[2]))
        self.name = [n for n, _, _ in spans]
        self.ts = [t for _, t, _ in spans]
        self.dur = [d for _, _, d in spans]
        self.parent = [None] * len(spans)
        open_ = []
        for i in range(len(spans)):
            while open_ and not self._contains(open_[-1], self.ts[i], self.dur[i]):
                open_.pop()
            self.parent[i] = open_[-1] if open_ else None
            open_.append(i)
        self.self_us = list(self.dur)
        for i, p in enumerate(self.parent):
            if p is not None:
                self.self_us[p] -= self.dur[i]
        self.device_us = self.whole = None

    def _contains(self, i, ts, dur):
        return self.ts[i] - EPS <= ts and ts + dur <= self.ts[i] + self.dur[i] + EPS

    def innermost(self, ts):
        """The innermost span open at time ``ts``, or None."""
        i = bisect.bisect_right(self.ts, ts + EPS) - 1
        i = i if i >= 0 else None
        while i is not None and not self._contains(i, ts, 0.0):
            i = self.parent[i]
        return i

    def chain(self, i):
        """Span ``i`` and its ancestors, innermost first."""
        while i is not None:
            yield i
            i = self.parent[i]

    def named(self, name: str) -> list:
        return [i for i, n in enumerate(self.name) if n == name]

    def inclusive_us(self) -> list:
        """Each span's device time with its children's."""
        out = list(self.device_us)
        for i in reversed(range(len(out))):  # a child starts after its parent
            if self.parent[i] is not None:
                out[self.parent[i]] += out[i]
        return out


def enqueue_calls(host) -> list:
    """The CUDA API calls that enqueue a device operation, as (ts, dur) in
    host order; a call made inside another (a `cu*` call under its `cuda*`
    one) counts once."""
    calls = sorted((t, d) for n, t, d in host if n.startswith("cu") and any(k in n for k in ENQUEUE))
    out = []
    for t, d in calls:
        if out and t + d <= out[-1][0] + out[-1][1] + EPS:
            continue
        out.append((t, d))
    return out


def program_stream_ops(stretch, kernel: str):
    """(the program's stream's device operations, the solver kernel's), each
    a list of (ts, dur) in start order; the program's stream is the one the
    solver kernel runs on."""
    stream = next((s for n, _, _, c, s in stretch.device if c == "kernel" and kernel in n), None)
    if stream is None:
        return [], []
    ops = sorted((t, d, kernel in n and c == "kernel") for n, t, d, c, s in stretch.device if s == stream)
    return [(t, d) for t, d, k in ops if not k], [(t, d) for t, d, k in ops if k]


def _offset(starts, anchor_ts, tail_whole):
    """The index of the launch of the first solver kernel on record, or
    None. With a kernel on record for every launch, 0. Else two placings:
    by the stretch's end, where the operations after the last kernel are as
    many as the calls after the last launch (the stretch ends at a
    synchronize); and by time, the last launch begun before the first
    kernel on record (the stretch starts at a synchronize, and the tracer
    loses what was launched before it was on; the device's clock may run
    ~0.1 ms ahead of the host's, so a kernel before every launch is the
    first's). A placing that leaves a kernel without a launch is out, and
    the placings left must agree."""
    last = len(starts) - len(anchor_ts)
    if last == 0:
        return 0
    head = max(0, bisect.bisect_right(starts, anchor_ts[0]) - 1)
    found = {o for o, ok in ((head, head <= last), (last, tail_whole)) if ok}
    return found.pop() if len(found) == 1 else None


def read(stretch, kernel: str) -> Spans:
    """The stretch's program spans, with ``device_us`` and ``whole`` filled
    where the solver kernels on record pair with the launches."""
    spans = Spans(stretch.host)
    launches = spans.named(LAUNCH)
    ops, anchors = program_stream_ops(stretch, kernel)
    if not launches or not anchors or len(anchors) > len(launches):
        return spans
    starts = [spans.ts[i] for i in launches]
    host = defaultdict(list)  # segment -> the spans of its calls
    for t, d in enqueue_calls(stretch.host):
        mid = t + 0.5 * d  # a call is placed by its midpoint
        i = spans.innermost(mid)
        if i is not None and spans.name[i] != LAUNCH:
            host[bisect.bisect_right(starts, mid)].append(i)
    anchor_ts = [t for t, _ in anchors]
    after = defaultdict(list)  # the operations after the k-th kernel on record
    for t, d in ops:
        after[bisect.bisect_right(anchor_ts, t)].append(d)
    o = _offset(starts, anchor_ts, len(host[len(starts)]) == len(after[len(anchors)]))
    if o is None:
        return spans
    dev = defaultdict(list, {o + k: v for k, v in after.items()})
    device_us = [0.0] * len(spans.name)
    lost = set(launches[:o] + launches[o + len(anchors) :])  # launches whose kernel left no record
    for k in set(host) | set(dev):
        if len(host[k]) == len(dev[k]):
            for i, d in zip(host[k], dev[k]):
                device_us[i] += d
        else:  # the spans that issued into it, and the calls on either side
            lost.update(host[k], (launches[j] for j in (k - 1, k) if 0 <= j < len(launches)))
    for i, (_, d) in zip(launches[o:], anchors):
        device_us[i] += d
    whole = [True] * len(spans.name)
    for i in lost:
        for a in spans.chain(i):
            whole[a] = False
    spans.device_us, spans.whole = device_us, whole
    return spans


def per_unit(run, outer: str, units: int, parts: tuple):
    """The device time issued inside the spans named in ``parts``, per unit
    of work (a call, a tick; the spans called ``outer``), in ms, over the
    whole units. None unless the stretch holds exactly ``units`` units."""
    spans = read(run.stretch, run.kernel)
    outers = spans.named(outer)
    if units <= 0 or len(outers) != units or spans.device_us is None:
        return None
    whole = {i for i in outers if spans.whole[i]}
    if len(whole) < WHOLE * units:
        return None
    inclusive = spans.inclusive_us()
    total = 0.0
    for i, name in enumerate(spans.name):
        if name in parts and any(a in whole for a in spans.chain(spans.parent[i])):
            total += inclusive[i]
    return total / len(whole) / 1e3

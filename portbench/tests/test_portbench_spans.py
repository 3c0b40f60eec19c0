"""The readers of the program's spans (``yardstick/spans.py`` and the
``wrapper.*`` / ``fleet.*`` metrics over it) on hand-built stretches: host
spans, the runtime calls inside them, and device operations on the
program's stream and on a side stream."""

from __future__ import annotations

import types

import pytest
from conftest import BENCH, CELLS

from yardstick import spans as S
from yardstick import spec as specs
from yardstick.trace import MARK, Stretch

K1 = "point_stab_kernel"
PROGRAM, SIDE = 7, 9
NEW = {
    "wrapper.pack_device_ms_per_call": "bank",
    "wrapper.finish_device_ms_per_call": "bank",
    "fleet.window_device_ms_per_tick": "fleet",
    "fleet.wrapper_device_ms_per_tick": "fleet",
    "fleet.plant_device_ms_per_tick": "fleet",
}


def host(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def launch(ts, name="cudaLaunchKernel"):
    return host(name, ts, 1.0, "cuda_runtime")


def op(name, ts, dur, stream=PROGRAM, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"stream": stream}}


def bank_call(t, dev_t=None, pack=(3.0, 2.0), finish=(1.5, 4.0), k1=50.0):
    """One bank call at host time t: two pack launches, the kernel's launch
    (a `cuLaunchKernel` inside the `cudaLaunchKernel`), a copy and a launch in
    the finish; its device operations from dev_t (by default as soon as
    they are issued), the kernel taking 50 us."""
    ev = [
        host("bank.call", t, 90), host("bank.pack", t + 2, 18), launch(t + 4), launch(t + 10),
        host("bank.launch", t + 22, 18), launch(t + 25), host("cuLaunchKernel", t + 25.2, 0.5, "cuda_driver"),
        host("bank.finish", t + 45, 40), launch(t + 50, "cudaMemcpyAsync"), launch(t + 60),
    ]  # fmt: skip
    d = t + 20 if dev_t is None else dev_t
    ev += [op("elementwise", d, pack[0]), op("cat", d + 5, pack[1]), op("void mpc::" + K1 + "<float>", d + 10, k1)]
    ev += [op("Memcpy DtoD", d + k1 + 11, finish[0], cat="gpu_memcpy"), op("permute copy", d + k1 + 13, finish[1])]
    return ev


def stretch(events, units):
    s = Stretch(0, 1)
    s.parse([host(MARK, 0, 10_000)] + events)
    s.units = units
    return s


def bank_run(events, units):
    return types.SimpleNamespace(kind="bank", stretch=stretch(events, units), kernel=K1, cell=None)


def side_work(t):
    """The benchmark's own work between calls: launched outside any program
    span, run on the side stream."""
    return [launch(t), op("reduce", t + 3000, 7, stream=SIDE), host("cudaEventRecord", t + 2, 1, "cuda_runtime")]


def two_calls():
    return bank_call(100) + side_work(195) + bank_call(300, 1200, pack=(1.0, 1.0), finish=(0.5, 0.5))


def test_spans_parent_and_self_time():
    sp = S.read(stretch(bank_call(100), 1), K1)
    assert sp.name == ["bank.call", "bank.pack", "bank.launch", "bank.finish"]
    assert sp.parent == [None, 0, 0, 0]
    assert sp.self_us == [90 - 18 - 18 - 40, 18, 18, 40]


@pytest.mark.parametrize("kind", ["bank", "fleet"])
def test_host_durations_per_unit(kind):
    """The traced host time of a unit of work is its outer span's duration;
    a tick's own self time is what its window, solve and plant leave."""
    if kind == "bank":
        sp, outer, dur = S.read(stretch(two_calls(), 2), K1), "bank.call", 90.0
    else:
        sp, outer, dur = S.read(fleet_run(3).stretch, K1), "fleet.tick", 190.0
    units = sp.named(outer)
    assert len(units) == (2 if kind == "bank" else 3)
    assert [sp.dur[i] for i in units] == [dur] * len(units)
    if kind == "fleet":
        assert [sp.self_us[i] for i in units] == [190.0 - 8 - 100 - 60] * 3


def test_innermost_attribution_by_order():
    sp = S.read(stretch(two_calls(), 2), K1)
    assert sp.device_us is not None
    pack, launch_, finish = (sp.named(n) for n in ("bank.pack", "bank.launch", "bank.finish"))
    assert [sp.device_us[i] for i in pack] == [5.0, 2.0]
    assert [sp.device_us[i] for i in launch_] == [50.0, 50.0]
    assert [sp.device_us[i] for i in finish] == [5.5, 1.0]
    assert all(sp.whole)
    inclusive = sp.inclusive_us()  # children included
    assert [inclusive[i] for i in sp.named("bank.call")] == [5 + 50 + 5.5, 2 + 50 + 1]


def test_readers_per_call():
    run = bank_run(two_calls(), 2)
    read = lambda m: specs.reader(m)(run)  # noqa: E731
    assert read("wrapper.pack_device_ms_per_call") == pytest.approx(7.0 / 2 / 1e3)
    assert read("wrapper.finish_device_ms_per_call") == pytest.approx(6.5 / 2 / 1e3)
    # pack + finish is what the outside reader finds beside the kernel, copies included
    outside = sum(d for n, _, d, _, s in run.stretch.device if s == PROGRAM and K1 not in n) / 2 / 1e3
    assert read("wrapper.pack_device_ms_per_call") + read("wrapper.finish_device_ms_per_call") == pytest.approx(outside)
    assert all(read(m) is None for m, kind in NEW.items() if kind == "fleet")


def test_side_stream_operations_are_ignored():
    """The side stream's operation, and its launch outside the spans, pair
    with nothing; the program's stream is the kernel's."""
    ops, anchors = S.program_stream_ops(stretch(two_calls(), 2), K1)
    assert len(anchors) == 2 and len(ops) == 8
    assert len(S.enqueue_calls(stretch(two_calls(), 2).host)) == 11  # the nested cuLaunchKernel counted once


@pytest.mark.parametrize(
    "fault",
    ["device_op_missing", "extra_launch", "units_differ", "no_spans", "launch_span_missing"],
)
def test_none_where_counts_disagree(fault):
    ev, units = two_calls(), 2
    if fault == "device_op_missing":
        ev = [e for e in ev if not (e["name"] == "cat" and e["ts"] == 1205)]
    elif fault == "extra_launch":
        ev.append(launch(320))  # inside the second call's pack, with no operation of its own
    elif fault == "units_differ":
        units = 3
    elif fault == "no_spans":  # a program without spans, as the parent's
        ev = [e for e in ev if not e["name"].startswith(S.PREFIXES)]
    else:
        ev = [e for e in ev if not (e["name"] == "bank.launch" and e["ts"] == 322)]
    run = bank_run(ev, units)
    assert specs.reader("wrapper.pack_device_ms_per_call")(run) is None
    assert specs.reader("wrapper.finish_device_ms_per_call")(run) is None
    calls = S.read(run.stretch, K1).named("bank.call")
    assert (len(calls) == units) == (fault not in ("units_differ", "no_spans"))


def test_records_lost_at_the_ends():
    """The tracer loses the first operation, and its buffer fills inside the
    last call, after its pack: the first call (its pack incomplete) and the
    last (its kernel and finish gone) hold no reading; the rest read as
    before, over the whole calls."""
    ev = []
    for c in range(30):
        call = bank_call(100 + 200 * c)
        if c == 29:
            call = [e for e in call if e["cat"] not in ("kernel", "gpu_memcpy") or e["name"] in ("elementwise", "cat")]
        ev += call
    ev = [e for e in ev if not (e["name"] == "elementwise" and e["ts"] == 120)]
    run = bank_run(ev, 30)
    sp = S.read(run.stretch, K1)
    assert [sp.whole[i] for i in sp.named("bank.call")] == [False] + [True] * 28 + [False]
    read = lambda m: specs.reader(m)(run)  # noqa: E731
    assert read("wrapper.pack_device_ms_per_call") == pytest.approx(5.0 / 1e3)
    assert read("wrapper.finish_device_ms_per_call") == pytest.approx(5.5 / 1e3)
    short = bank_run([e for e in ev if e["ts"] < 100 + 200 * 27 or e["cat"] == "user_annotation"], 30)
    assert specs.reader("wrapper.pack_device_ms_per_call")(short) is None  # 26 whole of 30: under nine in ten


def test_skewed_clocks_and_a_clipped_end():
    """The device's clock reads 15 us ahead of the host's, so each kernel
    seems to start before its launch, and the last call's finish falls
    past the stretch's end: every kernel is on record, so they pair with
    the launches in order."""
    ev = []
    for c in range(30):
        for e in bank_call(100 + 200 * c):
            if e["cat"] in ("kernel", "gpu_memcpy"):
                if c == 29 and e["name"] in ("Memcpy DtoD", "permute copy"):
                    continue
                e = dict(e, ts=e["ts"] - 15)
            ev.append(e)
    run = bank_run(ev, 30)
    sp = S.read(run.stretch, K1)
    assert [sp.whole[i] for i in sp.named("bank.call")] == [True] * 29 + [False]
    assert specs.reader("wrapper.finish_device_ms_per_call")(run) == pytest.approx(5.5 / 1e3)


def test_a_whole_call_lost_at_the_start():
    """The tracer starts late enough to lose the first call's records: the
    first kernel on record is placed after the second launch, by time and
    by the stretch's whole end alike."""
    ev = []
    for c in range(30):
        call = bank_call(100 + 200 * c)
        ev += [e for e in call if c > 0 or e["cat"] not in ("kernel", "gpu_memcpy")]
    run = bank_run(ev, 30)
    sp = S.read(run.stretch, K1)
    assert [sp.whole[i] for i in sp.named("bank.call")] == [False, False] + [True] * 28
    assert specs.reader("wrapper.pack_device_ms_per_call")(run) == pytest.approx(5.0 / 1e3)


def test_start_lost_under_a_deep_queue():
    """A kernel of 250 us, the host three calls ahead and then held by the
    queue: the tracer loses the first two calls, and the first kernel on
    record (the third call's) starts after the fifth launch, so time would
    leave kernels without a launch; the stretch's whole end places it."""
    ev = []
    for c in range(30):
        t = 100 + 100 * c if c < 3 else 300 * c - 510  # from the fourth call on, after the kernel three back
        call = bank_call(t, 120 + 300 * c, k1=250.0)
        ev += [e for e in call if c > 1 or e["cat"] not in ("kernel", "gpu_memcpy")]
    sp = S.read(stretch(ev, 30), K1)
    assert [sp.whole[i] for i in sp.named("bank.call")] == [False] * 3 + [True] * 27
    assert [sp.device_us[i] for i in sp.named("bank.launch")][2:4] == [250.0, 250.0]
    assert specs.reader("wrapper.pack_device_ms_per_call")(bank_run(ev, 30)) == pytest.approx(5.0 / 1e3)


def fleet_events(ticks):
    """One rollout of ``ticks`` ticks: a window (2 launches), the bank call,
    a plant (3 launches); a loop prologue (1 launch) and the summary (2)."""
    ev, t = [host("fleet.rollout", 0.5, 100 + 200 * ticks), launch(1)], 50.0
    dev = [op("fill", 2, 1.0)]
    for _ in range(ticks):
        ev += [host("fleet.tick", t, 190), host("fleet.window", t + 1, 8), launch(t + 2), launch(t + 5)]
        dev += [op("gather", t + 2.5, 3.0), op("where", t + 6, 1.0)]
        ev += [host("fleet.solve", t + 10, 100)] + bank_call(t + 10)
        ev += [host("fleet.plant", t + 120, 60), launch(t + 125), launch(t + 130), launch(t + 135)]
        dev += [op("rk4", t + 126, 2.0), op("shift", t + 131, 1.0), op("sum", t + 136, 0.5)]
        t += 200
    ev += [host("fleet.summary", t, 20), launch(t + 2), launch(t + 5)]
    dev += [op("norm", t + 3, 2.0), op("mean", t + 6, 1.0)]
    return ev + dev


def fleet_run(ticks, units=1, kernel=K1):
    s = stretch(fleet_events(ticks), units)
    cell = types.SimpleNamespace(mix={"ticks": ticks})
    return types.SimpleNamespace(kind="fleet", stretch=s, kernel=kernel, cell=cell)


def test_readers_per_tick():
    run = fleet_run(3)
    read = lambda m: specs.reader(m)(run)  # noqa: E731
    assert read("fleet.window_device_ms_per_tick") == pytest.approx(4.0 / 1e3)
    assert read("fleet.wrapper_device_ms_per_tick") == pytest.approx((5.0 + 5.5) / 1e3)
    assert read("fleet.plant_device_ms_per_tick") == pytest.approx(3.5 / 1e3)
    sp = S.read(run.stretch, K1)
    assert [sp.name[sp.parent[i]] for i in sp.named("bank.call")] == ["fleet.solve"] * 3
    # window + wrapper + plant + summary + the loop's prologue: all that runs beside the kernel
    other = sum(d for n, _, d, _, _ in run.stretch.device if K1 not in n) / 3 / 1e3
    parts = sum(read(m) for m in NEW if m.startswith("fleet.") and m.endswith("_device_ms_per_tick"))
    summary, rollout_self = sp.device_us[sp.named("fleet.summary")[0]], sp.device_us[sp.named("fleet.rollout")[0]]
    assert parts + (summary + rollout_self) / 3 / 1e3 == pytest.approx(other)
    assert all(read(m) is None for m, kind in NEW.items() if kind == "bank")
    assert specs.reader("fleet.plant_device_ms_per_tick")(fleet_run(3, units=2)) is None  # 3 ticks, not 2 x 3


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_metric_entries(name):
    """Each new metric has its reader, its layer's name as the benchmark
    has it, and cells of the run loop it reads."""
    m = next(e for e in BENCH["per_layer"] if e["name"] == name)
    assert callable(specs.reader(name)) and m["source"] == "device_trace" and m["unit"] == "ms"
    assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
    for cell in m["workloads"]:
        assert specs.resolve(BENCH, cell)["traffic"]["kind"] == NEW[name]
    layer = "solver/cuda_kernel.py wrappers" if NEW[name] == "bank" else "parallel/fleet.py tick loop"
    assert m["layer"] == layer

"""Bag recording + deterministic replay over the message bus — the port's
own copy of :mod:`ros2_mpc_tpu.nodes.bag`. Bus messages are NumPy (no
tensor is ever pickled), so a bag recorded on the card replays on the CPU.

The ROS ecosystem's debugging workhorse is ``rosbag``: record every topic of
a live run, replay it later against new code. The reference has nothing of
the sort — its only forensic artifacts are stale debug PNGs
(ros2_mpc/scripts/map.png etc., SURVEY.md §5 "checkpoint/resume: none").
Here the bus (nodes/bus.py) is versioned, so a bag preserves the exact
(topic, sequence, payload) stream and a replay reproduces consumer behavior
bit-for-bit: record a failing field run once, then step any node through the
identical inputs on a workstation.

* :class:`BagRecorder` — wildcard ``bus.tap`` observer; records every
  publish (optionally filtered to a topic set) with a monotonic timestamp.
  Payloads are deep-copied at record time, so later in-place mutation by the
  publisher cannot corrupt the bag.
* :func:`save_bag` / :func:`load_bag` — pickle container (messages are the
  plain dataclasses of nodes/bus.py + numpy arrays; same-version replay is
  the contract, like rosbag's).
* :func:`replay` — republish records in order onto any bus (optionally
  topic-filtered and/or time-paced).
"""

from __future__ import annotations

import copy
import dataclasses
import pickle
import time
from typing import Any, Iterable, Optional

from .bus import MessageBus


@dataclasses.dataclass
class BagRecord:
    t: float  # monotonic capture time [s]
    topic: str
    seq: int  # source-bus sequence number at capture
    msg: Any


class BagRecorder:
    """Attach with ``BagRecorder(bus)``; detach with ``stop()``."""

    def __init__(self, bus: MessageBus, topics: Optional[Iterable[str]] = None,
                 clock=time.monotonic):
        self._bus = bus
        self._topics = set(topics) if topics is not None else None
        self._clock = clock
        self.records: list[BagRecord] = []
        bus.tap(self._on_publish)

    def _on_publish(self, topic: str, msg: Any, seq: int):
        if self._topics is not None and topic not in self._topics:
            return
        self.records.append(BagRecord(self._clock(), topic, seq, copy.deepcopy(msg)))

    def stop(self) -> list[BagRecord]:
        self._bus.untap(self._on_publish)
        return self.records


def save_bag(path: str, records: list[BagRecord]):
    with open(path, "wb") as f:
        pickle.dump({"format": "tpu-mpc-bag-v1", "records": records}, f)


def load_bag(path: str) -> list[BagRecord]:
    with open(path, "rb") as f:
        data = pickle.load(f)
    if data.get("format") != "tpu-mpc-bag-v1":
        raise ValueError(f"not a tpu-mpc bag: {path}")
    return data["records"]


def replay(
    bus: MessageBus,
    records: list[BagRecord],
    topics: Optional[Iterable[str]] = None,
    realtime: bool = False,
    on_record=None,
) -> int:
    """Republish ``records`` in capture order onto ``bus``.

    ``topics`` filters what is replayed (e.g. sensors only, so live nodes
    recompute their outputs from recorded inputs). ``realtime=True`` sleeps
    to reproduce the original inter-record spacing. ``on_record(rec)`` is
    called after each publish — the hook for stepping consumers in lockstep
    with the stream. Returns the number of records published.
    """
    wanted = set(topics) if topics is not None else None
    n = 0
    prev_t = None
    for rec in records:
        if wanted is not None and rec.topic not in wanted:
            continue
        if realtime and prev_t is not None:
            time.sleep(max(0.0, rec.t - prev_t))
        prev_t = rec.t
        bus.publish(rec.topic, copy.deepcopy(rec.msg))
        if on_record is not None:
            on_record(rec)
        n += 1
    return n


def _info(records: list[BagRecord]) -> str:
    from collections import Counter

    if not records:
        return "empty bag"
    counts = Counter(r.topic for r in records)
    dur = records[-1].t - records[0].t
    lines = [f"{len(records)} records over {dur:.1f} s"]
    for topic, n in sorted(counts.items()):
        hz = n / dur if dur > 0 else float("inf")
        lines.append(f"  {topic:<22} {n:>6}  (~{hz:.1f} Hz)")
    return "\n".join(lines)


def main(argv=None):
    """Console entry (``cuda-mpc-bag``): inspect or replay a recorded run.

    ``cuda-mpc-bag info run.bag`` prints the topic histogram;
    ``cuda-mpc-bag replay run.bag --viz DIR`` re-renders the dashboard frames
    offline from the recorded topics — RViz-after-the-fact for a run that
    happened on a robot with no display attached.
    """
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("command", choices=["info", "replay"])
    ap.add_argument("bag", help="bag file (save_bag format)")
    ap.add_argument("--topics", nargs="*", default=None, help="replay only these")
    ap.add_argument("--realtime", action="store_true", help="reproduce original pacing")
    ap.add_argument("--viz", default=None, metavar="DIR",
                    help="render a dashboard frame per recorded scan into DIR")
    ap.add_argument("--viz-history", type=int, default=0,
                    help="also keep numbered frame_NNNN.png history")
    args = ap.parse_args(argv)

    records = load_bag(args.bag)
    if args.command == "info":
        print(_info(records))
        return

    bus = MessageBus()
    viz = None
    if args.viz is not None:
        from .viz_node import LiveVizNode

        viz = LiveVizNode(bus, out_dir=args.viz, history=args.viz_history)

    def on_record(rec):
        if viz is not None and rec.topic == "/scan":
            viz.tick()

    n = replay(bus, records, topics=args.topics, realtime=args.realtime,
               on_record=on_record)
    frames = f", {viz.frames} frames -> {args.viz}" if viz is not None else ""
    print(f"replayed {n} records{frames}")


if __name__ == "__main__":
    main()

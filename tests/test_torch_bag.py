"""The port's bag record/replay (``ros2_mpc_tpu_torch.nodes.bag``), mirroring
tests/test_bag.py on the CPU. A run of the port's stack is recorded once;
its bus messages are NumPy (no tensor is pickled), so a sensor-only replay
on the CPU drives a fresh costmap node to costmaps equal byte for byte to
the recorded ones."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.nodes import bag as bagmod
from ros2_mpc_tpu_torch.nodes.bag import BagRecorder, load_bag, replay, save_bag
from ros2_mpc_tpu_torch.nodes.bus import MessageBus
from ros2_mpc_tpu_torch.nodes.costmap_nodes import LocalCostmapNode
from ros2_mpc_tpu_torch.nodes.launch import build_sim_stack


@pytest.fixture(scope="module")
def records():
    """12 ticks of the point follower's stack (horizon 8) on the CPU."""
    stack = build_sim_stack(follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=8, device="cpu")
    rec = BagRecorder(stack.bus)
    stack.publish_goal(0.4, -1.6)
    for _ in range(12):
        stack.tick()
    return rec.stop()


def holds_tensor(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return True
    if dataclasses.is_dataclass(obj):
        return any(holds_tensor(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return any(holds_tensor(v) for v in obj)
    if isinstance(obj, dict):
        return any(holds_tensor(v) for v in obj.values())
    return False


def test_bag_records_all_live_topics(records):
    topics = {r.topic for r in records}
    for expected in ("/scan", "/robot_position", "cmd_vel", "/my_local_costmap", "/goal_pose"):
        assert expected in topics, f"{expected} missing from {sorted(topics)}"
    ts = [r.t for r in records]
    assert ts == sorted(ts)
    assert not any(holds_tensor(r.msg) for r in records)  # the bus carries NumPy only


def test_bag_save_load_roundtrip(records, tmp_path):
    p = tmp_path / "run.bag"
    save_bag(str(p), records)
    loaded = load_bag(str(p))
    assert len(loaded) == len(records)
    for a, b in zip(records, loaded):
        assert a.topic == b.topic and a.seq == b.seq and a.t == b.t
    for a, b in zip(records, loaded):
        if a.topic == "/scan":
            np.testing.assert_array_equal(np.asarray(a.msg.ranges), np.asarray(b.msg.ranges))
    (tmp_path / "bad.bag").write_bytes(b"\x80\x04}\x94.")  # a pickled empty dict
    with pytest.raises(ValueError, match="not a tpu-mpc bag"):
        load_bag(str(tmp_path / "bad.bag"))


def replay_costmaps(records, bus, node):
    """Replay the sensor stream, ticking ``node`` after every scan."""
    reproduced = []

    def on_record(rec):
        if rec.topic == "/scan":
            out = node.tick()
            if out.get("status", "ok").startswith("waiting"):
                return
            reproduced.append(np.asarray(bus.latest("/my_local_costmap")[0].data))

    assert replay(bus, records, topics=("/scan", "/robot_position"), on_record=on_record) > 0
    return reproduced


def test_sensor_replay_reproduces_costmaps_bitwise(records):
    """A fresh LocalCostmapNode on the CPU, stepped through the recorded
    sensors, republishes the recorded costmaps byte for byte (the recorded
    scan i feeds the costmap of tick i+1, as in tests/test_bag.py)."""
    originals = [np.asarray(r.msg.data) for r in records if r.topic == "/my_local_costmap"]
    assert len(originals) >= 5
    bus = MessageBus()
    node = LocalCostmapNode(bus, Params(), device="cpu")
    reproduced = replay_costmaps(records, bus, node)
    pairs = list(zip(originals[1:], reproduced))
    assert len(reproduced) >= len(originals) - 1 and len(pairs) >= 5
    for a, b in pairs:
        np.testing.assert_array_equal(a, b)


def test_replay_filters_topics(records):
    bus = MessageBus()
    replay(bus, records, topics=("/scan",))
    assert bus.latest("/scan")[0] is not None
    assert bus.latest("cmd_vel")[0] is None


def test_bag_cli_info_and_offline_viz(records, tmp_path, capsys):
    p = tmp_path / "run.bag"
    save_bag(str(p), records)
    bagmod.main(["info", str(p)])
    out = capsys.readouterr().out
    assert "/scan" in out and "records over" in out
    viz_dir = tmp_path / "viz"
    bagmod.main(["replay", str(p), "--viz", str(viz_dir)])
    assert "replayed" in capsys.readouterr().out
    assert os.path.exists(viz_dir / "latest.png")

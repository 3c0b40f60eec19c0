"""The port's shared-memory bus (``ros2_mpc_tpu_torch.nodes.shm_bus``, its
own build of native/shm_bus.cpp) and the multi-process node graph on it
(``nodes.multiproc``), mirroring tests/test_shm_bus.py on the CPU.

The bus tests skip where g++ cannot build the library (as the JAX suite's
do); ``run_multiprocess`` itself raises there. The run to the goal with
every role on the card is ``cuda``-marked."""

import multiprocessing
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

from ros2_mpc_tpu_torch.nodes import shm_bus
from ros2_mpc_tpu_torch.nodes.bus import Transform, Twist
from ros2_mpc_tpu_torch.nodes.shm_bus import SharedMemoryBus


@pytest.fixture
def bus_path():
    if shm_bus.load() is None:
        pytest.skip("native shm bus unavailable (no g++)")
    shm_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
    d = tempfile.mkdtemp(prefix="cuda_shmbus_test_", dir=shm_root)
    path = os.path.join(d, "bus")
    yield path
    if os.path.exists(path):
        os.unlink(path)
    os.rmdir(d)


def test_builds_into_the_port_package(bus_path):
    assert os.path.dirname(shm_bus._SO).endswith(os.path.join("ros2_mpc_tpu_torch", "_native"))
    assert os.path.basename(shm_bus._SRC) == "shm_bus.cpp" and os.path.exists(shm_bus._SO)


def test_roundtrip_versions_and_tf(bus_path):
    a, b = SharedMemoryBus(bus_path), SharedMemoryBus(bus_path)
    try:
        assert a.latest("/x") == (None, 0)
        v1 = a.publish("/x", {"arr": np.arange(7), "s": "hello"})
        msg, ver = b.latest("/x")
        assert v1 == ver == 1
        assert np.array_equal(msg["arr"], np.arange(7)) and msg["s"] == "hello"
        assert a.publish("/x", Twist(0.1, -0.2)) == 2
        msg, ver = b.latest("/x")
        assert ver == 2 and msg.linear_x == 0.1
        a.set_transform("map", "odom", Transform(x=1.5, y=-0.5))
        tf = b.lookup_transform("map", "odom")
        assert (tf.x, tf.y) == (1.5, -0.5)
        assert b.lookup_transform("map", "nowhere") is None
        b.subscribe("/x")
        b.subscribe("/x")
        assert a.subscription_count("/x") == 2
    finally:
        a.close()
        b.close()


def test_callbacks_spin_once_exactly_once(bus_path):
    a, b = SharedMemoryBus(bus_path), SharedMemoryBus(bus_path)
    try:
        got = []
        b.subscribe("/t", got.append)
        a.publish("/t", 1)
        a.publish("/t", 2)  # mailbox semantics: only the latest is seen
        assert b.spin_once() == 1 and got == [2]
        assert b.spin_once() == 0
        local = []
        b.subscribe("/u", local.append)
        b.publish("/u", "mine")
        assert local == ["mine"]
        assert b.spin_once() == 0  # own publish must not double-deliver
    finally:
        a.close()
        b.close()


def test_slot_overflow_raises(bus_path):
    a = SharedMemoryBus(bus_path, slot_bytes=4096)
    try:
        with pytest.raises(ValueError, match="slot_bytes"):
            a.publish("/big", np.zeros(10_000))
    finally:
        a.close()


def test_seqlock_no_torn_reads(bus_path):
    w, r = SharedMemoryBus(bus_path), SharedMemoryBus(bus_path)
    stop = threading.Event()

    def writer():
        k = 0
        while not stop.is_set():
            k += 1
            w.publish("/h", np.full(4096, k % 251, dtype=np.int64))

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        seen, torn = 0, []
        for _ in range(3000):
            msg, ver = r.latest("/h")
            if msg is None:
                continue
            seen += 1
            if not np.all(msg == msg[0]):
                torn.append(ver)
        assert seen > 100 and torn == []
    finally:
        stop.set()
        t.join(timeout=5)
        assert not t.is_alive()
        w.close()
        r.close()


def _child_publisher(path, n):
    bus = SharedMemoryBus(path)
    for k in range(1, n + 1):
        bus.publish("/cross", {"k": k, "payload": np.arange(k, dtype=np.float64)})
    bus.publish("/done", True)
    bus.close()


def test_cross_process_delivery(bus_path):
    bus = SharedMemoryBus(bus_path)
    p = multiprocessing.get_context("spawn").Process(target=_child_publisher, args=(bus_path, 50))
    p.start()
    try:
        p.join(timeout=60)
        assert p.exitcode == 0
        assert bus.latest("/done")[0] is True
        msg, ver = bus.latest("/cross")
        assert ver == 50 and msg["k"] == 50
        assert np.array_equal(msg["payload"], np.arange(50, dtype=np.float64))
    finally:
        if p.is_alive():
            p.terminate()
        bus.close()


def test_run_multiprocess_starts_and_stops_every_role_on_the_cpu(bus_path):
    """Every role comes up in its own process on the CPU (its nodes built and
    warmed up) and ends cleanly on the supervisor's shutdown broadcast,
    reporting its scheduler's stats over the bus. How many ticks a child
    role gets in before the shutdown, and whether the safety role's first
    heartbeat is out when the supervisor reads it, depend on how fast the
    host starts it, so only the world role's ticks are counted."""
    from ros2_mpc_tpu_torch.nodes.multiproc import run_multiprocess

    stats = run_multiprocess(
        follower="point", duration=12.0, horizon=8, role_device="cpu", safety_stop=0.2, bus_path=bus_path
    )
    assert stats["failed_roles"] == []
    assert set(stats["roles"]) == {"planner", "costmaps", "follower", "safety"}
    roles = {name: set(s["tasks"]) for name, s in stats["roles"].items()}  # None if a role did not end cleanly
    assert roles == {
        "planner": {"bus_spin", "replan"},
        "costmaps": {"bus_spin", "local_costmap", "global_costmap"},
        "follower": {"bus_spin", "control"},
        "safety": {"bus_spin", "safety_heartbeat"},
    }
    assert stats["tasks"]["lidar"]["runs"] > 0 and stats["final_pose"].shape == (3,)
    assert set(stats["safety"]) >= {"blocked", "passed"}  # the heartbeat, or its absence marked


def test_run_multiprocess_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from ros2_mpc_tpu_torch.nodes.multiproc import run_multiprocess

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_multiprocess(duration=1.0)


@pytest.mark.cuda
def test_multiprocess_nav_reaches_goal_on_the_card(bus_path):
    """tests/test_shm_bus.py::test_multiprocess_nav_reaches_goal with every
    role on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the roles run on the card (python3 chip_smoke.py)")
    from ros2_mpc_tpu_torch.nodes.multiproc import run_multiprocess

    stats = run_multiprocess(follower="point", duration=120.0, horizon=12, bus_path=bus_path)
    assert stats["goal_reached"], stats
    assert np.linalg.norm(stats["final_pose"][:2] - np.array([1.0, -1.0])) < 0.35
    assert stats["failed_roles"] == []

"""Shared-memory bus binding: multi-process transport for the node graph —
the port's own copy of :mod:`ros2_mpc_tpu.nodes.shm_bus`. The repository's
``native/shm_bus.cpp`` is compiled where it is, on first use, with g++;
the shared library is cached in ``ros2_mpc_tpu_torch/_native/``.

The reference deploys its nine nodes as separate OS processes over ROS 2 DDS
(launch/launch_all.launch.py:56-64); the in-process
:class:`~ros2_mpc_tpu_torch.nodes.bus.MessageBus` covers the single-process graph.
:class:`SharedMemoryBus` is the native multi-process equivalent: the same
publish / subscribe / latest / tf interface, backed by the C++ seqlock topic
table in ``native/shm_bus.cpp`` (one mmap'd file, latest-message-per-topic —
exactly the reference's pull idiom, ros_topics.py:38-40,83-86).

Differences from the in-process bus, by necessity of process isolation:

* Callbacks registered with :meth:`subscribe` fire on :meth:`spin_once`
  (poll-and-deliver), not at the remote publisher's call site — the same
  model as ``rclpy.spin_once`` pumping DDS callbacks. Local publishes still
  deliver synchronously, and spin_once never double-delivers a version.
* Messages cross the boundary by value (pickle), so consumers cannot mutate
  a producer's array in place.

Single-writer-per-topic (the reference's topology) is assumed; concurrent
writers on *different* topics and any number of readers are lock-free.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import subprocess
import threading
from collections import defaultdict
from typing import Any, Callable, Optional

from .bus import Transform

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "shm_bus.cpp")
_SO = os.path.join(_PKG_DIR, "_native", "libshmbus.so")


def _build() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)  # atomic: a role process loading it never sees a partial file
        return _SO
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native bus library; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not os.path.exists(_SRC):
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.shmbus_open.restype = ctypes.c_void_p
        lib.shmbus_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
        lib.shmbus_close.argtypes = [ctypes.c_void_p]
        lib.shmbus_topic.restype = ctypes.c_int
        lib.shmbus_topic.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.shmbus_publish.restype = ctypes.c_int
        lib.shmbus_publish.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.shmbus_read.restype = ctypes.c_int
        lib.shmbus_read.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.shmbus_version.restype = ctypes.c_uint32
        lib.shmbus_version.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.shmbus_subscribe.restype = ctypes.c_int
        lib.shmbus_subscribe.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.shmbus_sub_count.restype = ctypes.c_int
        lib.shmbus_sub_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _LIB = lib
        return _LIB


class SharedMemoryBus:
    """MessageBus-compatible view of one shared-memory bus file.

    Every process in the graph opens the same ``path`` with the same
    ``max_topics`` / ``slot_bytes``; whoever arrives first initializes it.
    """

    def __init__(self, path: str, max_topics: int = 128, slot_bytes: int = 1 << 20):
        lib = load()
        if lib is None:
            raise RuntimeError(
                "native shm bus unavailable (g++ missing or build failed); "
                "use nodes.bus.MessageBus for single-process graphs"
            )
        self._lib = lib
        self._h = lib.shmbus_open(path.encode(), max_topics, slot_bytes)
        if not self._h:
            raise RuntimeError(f"shmbus_open({path!r}) failed")
        self.path = path
        self._slot_bytes = slot_bytes
        self._lock = threading.RLock()
        self._topics: dict[str, int] = {}
        self._callbacks: dict[str, list[Callable[[Any], None]]] = defaultdict(list)
        self._delivered: dict[str, int] = {}  # last version fed to callbacks
        self._buf = ctypes.create_string_buffer(slot_bytes)

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        with self._lock:
            if self._h:
                self._lib.shmbus_close(self._h)
                self._h = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def unlink(self):
        """Remove the backing file (call once, after every process closed)."""
        try:
            os.unlink(self.path)
        except OSError:
            pass

    # -- internals ------------------------------------------------------------

    def _idx(self, topic: str) -> int:
        idx = self._topics.get(topic)
        if idx is None:
            idx = self._lib.shmbus_topic(self._h, topic.encode())
            if idx < 0:
                raise RuntimeError(f"shm bus topic table full or bad name: {topic!r}")
            self._topics[topic] = idx
        return idx

    def _read(self, topic: str):
        """(msg, version) — (None, 0) before the first publish."""
        idx = self._idx(topic)
        ln = ctypes.c_uint32(0)
        ver = ctypes.c_uint32(0)
        rc = self._lib.shmbus_read(
            self._h, idx, self._buf, self._slot_bytes, ctypes.byref(ln), ctypes.byref(ver)
        )
        if rc == 0:
            return None, 0
        if rc != 1:
            raise RuntimeError(f"shmbus_read({topic!r}) failed: rc={rc}")
        return pickle.loads(self._buf.raw[: ln.value]), int(ver.value)

    # -- MessageBus interface ---------------------------------------------------

    def publish(self, topic: str, msg: Any) -> int:
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        if len(data) > self._slot_bytes:
            raise ValueError(
                f"message on {topic!r} is {len(data)} bytes > slot_bytes={self._slot_bytes}"
            )
        with self._lock:
            idx = self._idx(topic)
            ver = self._lib.shmbus_publish(self._h, idx, data, len(data))
            if ver < 0:
                raise RuntimeError(f"shmbus_publish({topic!r}) failed")
            callbacks = list(self._callbacks.get(topic, ()))
            # local synchronous delivery, exactly like the in-process bus;
            # mark the version so spin_once won't re-deliver it
            self._delivered[topic] = ver
        for cb in callbacks:
            cb(msg)
        return ver

    def subscribe(self, topic: str, callback: Optional[Callable[[Any], None]] = None):
        with self._lock:
            idx = self._idx(topic)
            self._lib.shmbus_subscribe(self._h, idx)
            if callback is not None:
                self._callbacks[topic].append(callback)
                self._delivered.setdefault(topic, 0)

    def latest(self, topic: str):
        with self._lock:
            return self._read(topic)

    def subscription_count(self, topic: str) -> int:
        with self._lock:
            return max(0, self._lib.shmbus_sub_count(self._h, self._idx(topic)))

    # -- callback pump (the rclpy.spin_once analogue) -----------------------------

    def spin_once(self) -> int:
        """Deliver any not-yet-seen message versions to local callbacks.
        Returns the number of callback deliveries made."""
        with self._lock:
            work = []
            for topic, cbs in self._callbacks.items():
                if not cbs:
                    continue
                cur = int(self._lib.shmbus_version(self._h, self._idx(topic)))
                if cur > self._delivered.get(topic, 0):
                    msg, ver = self._read(topic)
                    if ver > self._delivered.get(topic, 0):
                        self._delivered[topic] = ver
                        work.append((list(cbs), msg))
        delivered = 0
        for cbs, msg in work:
            for cb in cbs:
                cb(msg)
                delivered += 1
        return delivered

    # -- tf (frames as topics) ---------------------------------------------------

    @staticmethod
    def _tf_topic(parent: str, child: str) -> str:
        return f"_tf/{parent}->{child}"

    def set_transform(self, parent: str, child: str, tf: Transform):
        self.publish(self._tf_topic(parent, child), tf)

    def lookup_transform(self, target: str, source: str) -> Optional[Transform]:
        msg, _ = self.latest(self._tf_topic(target, source))
        return msg

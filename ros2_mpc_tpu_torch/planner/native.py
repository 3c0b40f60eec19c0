"""ctypes loader for the native C++ A* core (native/astar.cpp).

The port's own copy of :mod:`ros2_mpc_tpu.planner.native`. The repository's
``native/astar.cpp`` is compiled where it is, on first use, with g++; the
shared library is cached in ``ros2_mpc_tpu_torch/_native/``. If no compiler
is available the caller falls back to the pure-NumPy heap implementation in
:mod:`ros2_mpc_tpu_torch.planner.astar_py` (same contract). This is host
code: A* runs on the CPU, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "astar.cpp")
_SO = os.path.join(_PKG_DIR, "_native", "libastar.so")


def _build() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)  # atomic: a concurrent loader never sees a partial file
        return _SO
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
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
        lib.astar_path.restype = ctypes.c_int
        lib.astar_path.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _LIB = lib
        return _LIB


def astar_path_native(weights: np.ndarray, start, goal, allow_diagonal: bool = False):
    """C++ weighted-grid A*. Returns an (L, 2) int array of (row, col) cells
    start-first, or None if the native library is unavailable, or an empty
    (0, 2) array when no path exists."""
    lib = load()
    if lib is None:
        return None
    w32 = np.ascontiguousarray(weights, dtype=np.float32)
    h, w = w32.shape
    out = np.empty((h * w * 2,), dtype=np.int32)
    n = lib.astar_path(
        w32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h,
        w,
        int(start[0]),
        int(start[1]),
        int(goal[0]),
        int(goal[1]),
        1 if allow_diagonal else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out[: 2 * n].reshape(n, 2).copy()

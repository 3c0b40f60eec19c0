"""Build the port's CUDA kernels at first use and bind them with ctypes.

``csrc/*.cu`` compile with nvcc into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

The library lands in ``build/torch_kernels/`` beside the package, named by a
hash of the sources and flags, so a changed source builds anew. ptxas's
register and spill report for each kernel is kept beside it in a ``.log``.
Nothing is downloaded: without nvcc a CUDA call raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# No --use_fast_math: it would approximate expf/logf/division and flush
# denormals, which moves the barrier terms (csrc/common.cuh). -fmad=false
# keeps every multiply and add separately rounded, as PyTorch's elementwise
# ops round them: the kernels then reproduce their plain versions bit for
# bit on the card (with contraction, a few scenarios in a thousand of a
# 4096-bank flip a line-search decision; PERF.md has the cost).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the scalar tail shared by both launch entry points (csrc/*.cu)
_SCHEDULE = [_I] * 5 + [_F] * 12  # B, N, n_obs, n_iters, n_alphas; dt ... stage_tol
_SIGNATURES = {
    # x0g w obs u0 mu stage first | U X kff kfb Ubest cost kkt iters lsro
    "mpc_point_stab_launch": [_P] * 16 + _SCHEDULE + [_I, _I, _P],  # fast, block, stream
    # x0 xref uref w obs u0 mu stage first | 9 outputs and scratch
    "mpc_tracking_launch": [_P] * 18 + _SCHEDULE + [_I, _I, _I, _P],  # fast, wrap, block, stream
    # x out n n_steps op unroll block stream
    "mpc_chain_launch": [_P, _P, _I, _I, _I, _I, _I, _P],
    "mpc_point_stab_info": [_I, _P],
    "mpc_tracking_info": [_I, _P],
    "mpc_error_string": [_I],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): ros2_mpc_tpu_torch builds its CUDA kernels "
        "from csrc/ at their first CUDA call and needs the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmpc_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if no library for these sources exists yet."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per process and source hash) and bind the kernels."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "mpc_error_string" else ctypes.c_int
    return lib

"""Build the port's CUDA kernels at first use and bind them with ctypes.

``csrc/*.cu`` compile with nvcc into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes). Each
source compiles in its own nvcc process, all started together, and the
objects are linked into the library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false -Xcompiler -fPIC -c

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
import re
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
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the scalar tail shared by both launch entry points (csrc/*.cu)
_SCHEDULE = [_I] * 5 + [_F] * 12  # B, N, n_obs, n_iters, n_alphas; dt ... stage_tol
_SIGNATURES = {
    # x0g w obs u0 mu stage first | U X cost kkt iters lsro
    "mpc_point_stab_launch": [_P] * 13 + _SCHEDULE + [_I, _P],  # fast, stream
    # x0 xref uref w obs u0 mu stage first | U X cost kkt iters lsro
    "mpc_tracking_launch": [_P] * 15 + _SCHEDULE + [_I, _I, _P],  # fast, wrap, stream
    # x out n n_steps op unroll block stream
    "mpc_chain_launch": [_P, _P, _I, _I, _I, _I, _I, _P],
    "mpc_point_stab_info": [_I] * 3 + [_P],  # B, N, n_alphas, out
    "mpc_tracking_info": [_I] * 3 + [_P],
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
    nvcc, sources = _nvcc(), sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]  # fmt: skip
    logs = [p.communicate()[0] for p in procs]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(src.name, log) for src, p, log in zip(sources, procs, logs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(("link", proc.stdout + proc.stderr))
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{name}:\n{log}" for name, log in failed))
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def spill_stores(kernel: str) -> int:
    """Bytes of spill stores that ptxas reported for the kernel whose
    mangled name contains ``kernel``, read from the build's log."""
    log = library_path().with_suffix(".log").read_text()
    pattern = rf"Function properties for \w*{kernel}\w*\s+\d+ bytes stack frame, (\d+) bytes spill stores"
    found = re.search(pattern, log)
    if found is None:
        raise RuntimeError(f"no ptxas report for {kernel} in {library_path().with_suffix('.log')}")
    return int(found.group(1))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per process and source hash) and bind the kernels."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "mpc_error_string" else ctypes.c_int
    return lib

"""Build the package's CUDA kernels on first use and load them with ctypes.

Counterpart of ``point_cloud_classifier_tpu/native/__init__.py``, which
builds the host-side C++ packers: here the sources are the Hopper kernels in
``csrc/*.cu``.  They are compiled by ``nvcc`` into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds) for
``sm_90a``, into ``native/build/`` beside this file.  The library's name
carries a hash of the sources and flags, so an edited kernel is rebuilt and
a stale build is never loaded.  Nothing is built or loaded at import time:
:func:`kernel_library` does it on the first call, on a machine with
``nvcc`` (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


@dataclass(frozen=True)
class KernelLibrary:
    """The loaded kernel library, where it lives, and how long building it
    took in this process (0.0 when an up-to-date build was found)."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if os.path.isfile(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with "
            "the CUDA toolkit (CUDA_HOME, /usr/local/cuda or PATH)"
        )
    return found


def _build(sources, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent build or a
    # build cut short never leaves a half-written library under the final name
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, target)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pcc_phi_pool.argtypes = [
        vp, vp, vp,  # points, seg, out
        i32, i32, i32, i32,  # n_points, n_features, num_segments, n_layers
        ctypes.POINTER(i32), ctypes.POINTER(i32),  # dims, kinds (host)
        ctypes.POINTER(vp), ctypes.POINTER(vp),  # weights, biases (host arrays)
        i32, i32, vp,  # act, is_bf16, stream
    ]
    lib.pcc_phi_pool.restype = i32
    lib.pcc_error_string.argtypes = [i32]
    lib.pcc_error_string.restype = ctypes.c_char_p


@functools.cache
def kernel_library() -> KernelLibrary:
    """Build (if needed) and load ``csrc/*.cu``; raises if either fails."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    target = BUILD_DIR / f"libpcc_kernels_{digest.hexdigest()[:16]}.so"
    seconds = 0.0
    if not target.exists():
        t0 = time.perf_counter()
        _build(sources, target)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    _declare(lib)
    return KernelLibrary(lib, target, seconds)


def check(code: int) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a kernel entry."""
    if code != 0:
        msg = kernel_library().lib.pcc_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (cudaError {code})")

"""Build the package's CUDA kernels on first use and load them with ctypes.

Counterpart of ``point_cloud_classifier_tpu/native/__init__.py``, which
builds the host-side C++ packers: here the sources are the Hopper kernels in
``csrc/*.cu``, with their shared ``csrc/*.cuh`` headers.  They are compiled
by ``nvcc`` into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds) for ``sm_90a``, into ``native/build/``
beside this file.  The library's name carries a hash of the sources,
headers and flags, so an edited kernel is rebuilt and a stale build is never
loaded.  Each source is compiled by its own ``nvcc``, all at once, and the
objects are then linked.  Nothing is built or loaded at import time:
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
# with this flag the sliced K1 and K2 count clocks per phase (csrc/phi_chain.cuh)
PHASE_CLOCKS_FLAG = "-DPCC_PHASE_CLOCKS"
_phase_clocks = False


@dataclass(frozen=True)
class KernelLibrary:
    """A loaded library (the CUDA kernels', or the host packers' of
    ``native/host.py``), where it lives, and how long building it took in
    this process (0.0 when an up-to-date build was found)."""

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


def _run_all(cmds) -> None:
    """Run the commands side by side; wait for every one, then raise on the
    first that failed."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in cmds
    ]
    results = [proc.communicate() for proc in procs]
    for cmd, proc, (_, stderr) in zip(cmds, procs, results):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stderr}"
            )


def _build(sources, target: Path, flags=NVCC_FLAGS) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent build or a
    # build cut short never leaves a half-written library under the final name
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    nvcc = _nvcc()
    try:
        # one nvcc per source, all started together, then one link
        _run_all([
            [nvcc, *flags, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)
        ])
        _run_all([[nvcc, *flags, "-shared", "-o", str(tmp), *map(str, objects)]])
        os.replace(tmp, target)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    phi_pool_args = [
        vp, vp, vp,  # points, seg, out
        i32, i32, i32, i32,  # n_points, n_features, num_segments, n_layers
        ctypes.POINTER(i32), ctypes.POINTER(i32),  # dims, kinds (host)
        ctypes.POINTER(vp), ctypes.POINTER(vp),  # weights, biases (host arrays)
        i32, i32, vp,  # act, is_bf16, stream
    ]
    lib.pcc_phi_pool.argtypes = phi_pool_args
    lib.pcc_phi_pool.restype = i32
    # the timing entry: the variant `take` names (1 sliced, 3 wide, 0 general)
    # where it takes the chain, else the general one
    lib.pcc_phi_pool_general.argtypes = [*phi_pool_args, i32]
    lib.pcc_phi_pool_general.restype = i32
    phi_pool_bwd_args = [
        vp, vp, vp, vp,  # points, seg, g, d_points (null: not computed)
        vp, vp, i32,  # d_params, slabs, max_blocks
        i32, i32, i32, i32,  # n_points, n_features, num_segments, n_layers
        ctypes.POINTER(i32), ctypes.POINTER(i32),  # dims, kinds (host)
        ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(vp),  # w, wᵀ (or null), b (host)
        i32, i32, vp,  # act, is_bf16, stream
    ]
    lib.pcc_phi_pool_bwd.argtypes = phi_pool_bwd_args
    lib.pcc_phi_pool_bwd.restype = i32
    # the same launch without the tf32x3 and the wide variants (timing only)
    lib.pcc_phi_pool_bwd_general.argtypes = phi_pool_bwd_args
    lib.pcc_phi_pool_bwd_general.restype = i32
    # the f32 elements of K2's scratch for a chain, P and the card's SMs
    lib.pcc_phi_pool_bwd_scratch.argtypes = [
        i32, i32, i32,  # n_points, num_segments, n_layers
        ctypes.POINTER(i32), ctypes.POINTER(i32),  # dims, kinds
        i32, i32, ctypes.POINTER(ctypes.c_longlong),  # is_bf16, max_blocks, out (written)
    ]
    lib.pcc_phi_pool_bwd_scratch.restype = i32
    # K2's recomputed hidden rows against K1's forward (a check, off the path)
    lib.pcc_phi_pool_bwd_departures.argtypes = [
        vp, vp, i32, i32, i32,  # K1's [P, W] f32, scratch, max_blocks, n_points, n_layers
        ctypes.POINTER(i32), ctypes.POINTER(i32),  # dims, kinds (host)
        i32, i32,  # is_bf16, the layer whose input rows are held (1 .. n_layers - 1)
        vp, vp,  # counts (two u64 on the card), stream
    ]
    lib.pcc_phi_pool_bwd_departures.restype = i32
    lib.pcc_phi_pool_variant.argtypes = [
        i32, ctypes.POINTER(i32), ctypes.POINTER(i32),  # n_layers, dims, kinds (host)
        i32, i32,  # is_bf16, backward (K2's choice, not K1's)
        i32,  # the entry: 1 the path, 0 the timing entries' sliced choice, -1 K1's general alone
    ]
    lib.pcc_phi_pool_variant.restype = i32
    lib.pcc_gat_attention.argtypes = [
        vp, vp, vp, vp, vp, vp,  # s_dst, s_src, in_src, in_w, xw, out
        i32, i32, i32, i32, i32,  # b, m, d, h, c
        ctypes.c_float,  # slope
        i32,  # pieces a lane (piece form) or 0 (channel form)
        i32, i32, i32, vp,  # xw_code, src_code, w_code, stream
    ]
    lib.pcc_gat_attention.restype = i32
    lib.pcc_gat_out_rows.argtypes = [
        vp, vp, vp, vp,  # in_src, in_w, out_off and out_dst (written)
        i32, i32, i32,  # b, m, d
        i32, i32, vp,  # src_code, w_code, stream
    ]
    lib.pcc_gat_out_rows.restype = i32
    lib.pcc_gat_attention_bwd.argtypes = [
        vp, vp, vp, vp, vp, vp,  # s_dst, s_src, in_src, in_w, xw, g
        vp, vp, vp,  # out_off, out_dst, stats (scratch)
        vp, vp, vp,  # ds_dst, ds_src, dxw (written)
        i32, i32, i32, i32, i32,  # b, m, d, h, c
        ctypes.c_float,  # slope
        i32, i32, i32, vp,  # xw_code, src_code, w_code, stream
    ]
    lib.pcc_gat_attention_bwd.restype = i32
    lib.pcc_inrow_aggregate.argtypes = [
        vp, vp, vp, vp,  # h, in_src, in_w, out
        i32, i32, i32, i32, i32,  # b, m, d, width, mean
        i32, i32,  # vec (channels a piece), lanes a node
        i32, i32, i32, vp,  # h_code, src_code, w_code, stream
    ]
    lib.pcc_inrow_aggregate.restype = i32
    lib.pcc_knn_select.argtypes = [
        vp, vp,  # pos, seg
        vp, vp, vp, vp, vp,  # lo, hi, pos4, kth, deg (written)
        i32, i32, i32,  # n, k, num_graphs
        vp,  # stream
    ]
    lib.pcc_knn_select.restype = i32
    lib.pcc_knn_gather.argtypes = [
        vp, vp, vp, vp, vp,  # src, pos4, seg, lo, hi
        vp, vp, vp,  # kth, deg, out (written)
        i32, i32, i32, i32, i32,  # n, width, num_graphs, mean, backward
        i32, vp,  # x_code, stream
    ]
    lib.pcc_knn_gather.restype = i32
    lib.pcc_error_string.argtypes = [i32]
    lib.pcc_error_string.restype = ctypes.c_char_p


def enable_phase_clocks() -> None:
    """Make this process build and load the kernels with their per-phase
    clocks (``PHASE_CLOCKS_FLAG``); the library then also has the two
    ``pcc_*_phase_clocks`` entries.  Call it before the first
    :func:`kernel_library`: a library already loaded is not replaced."""
    global _phase_clocks
    if kernel_library.cache_info().currsize:
        raise RuntimeError("the kernel library is already loaded")
    _phase_clocks = True


@functools.cache
def kernel_library() -> KernelLibrary:
    """Build (if needed) and load ``csrc/*.cu``; raises if either fails."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    flags = (*NVCC_FLAGS, PHASE_CLOCKS_FLAG) if _phase_clocks else NVCC_FLAGS
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    target = BUILD_DIR / f"libpcc_kernels_{digest.hexdigest()[:16]}.so"
    seconds = 0.0
    if not target.exists():
        t0 = time.perf_counter()
        _build(sources, target, flags)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    _declare(lib)
    if _phase_clocks:
        for entry in (lib.pcc_phi_pool_phase_clocks, lib.pcc_phi_pool_bwd_phase_clocks):
            entry.argtypes, entry.restype = [ctypes.c_void_p], ctypes.c_int
    return KernelLibrary(lib, target, seconds)


def check(code: int) -> None:
    """Raise on a nonzero code returned by a kernel entry: a ``cudaError_t``,
    or ``kErrTooWide`` (-1) when the chain's tile does not fit in shared
    memory."""
    if code != 0:
        msg = kernel_library().lib.pcc_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (code {code})")

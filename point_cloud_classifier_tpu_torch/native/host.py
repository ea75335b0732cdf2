"""Build the loaders' C++ packers and the S2PG edge builder on first use, and
bind them with ctypes.

Counterpart of ``point_cloud_classifier_tpu/native/__init__.py``: the port's
own sources, ``csrc/host/batch_packer.cpp`` and ``csrc/host/edge_builder.cpp``,
compiled by ``g++`` with the JAX build's flags into one shared library in
``native/build/``, beside the CUDA kernel library.  Its name carries a hash
of the sources and flags, so an edited source is rebuilt and a stale build is
never loaded.  Nothing is built at import time: :func:`host_library` builds
on the first call, to a temporary name of its own, then renames, so that
processes building at once never load a half-written library.

A failed build raises with the compiler's message; there is no quiet
fallback.  ``PCC_NATIVE=0`` in the environment (the JAX package's switch) is
the one way to ask for the numpy branch: every packer wrapper then returns
False and the loader packs with numpy, and :func:`build_event_edges_native`
returns None.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from point_cloud_classifier_tpu_torch.native import BUILD_DIR, CSRC_DIR, KernelLibrary

HOST_SRC_DIR = CSRC_DIR / "host"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 120
_build_lock = threading.Lock()


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found: the host packers are built with g++ "
            "(PCC_NATIVE=0 packs with numpy instead)"
        )
    return found


def _build(sources, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_gxx(), *GXX_FLAGS, *map(str, sources), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


_I64, _VP = ctypes.c_int64, ctypes.c_void_p


def _declare(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.build_event_edges.restype = _I64
    lib.build_event_edges.argtypes = [
        _I64, i64p, ctypes.POINTER(ctypes.c_double), i64p,  # n_steps, pids, times, step_keys
        _I64, i64p, i64p,  # n_parent_rows, child_ids, parent_ids
        i64p, i64p, _I64,  # out_src, out_dst, cap
        i64p, i64p,  # out_parentless, n_parentless
    ]
    lib.pack_pointcloud.restype = _I64
    lib.pack_pointcloud.argtypes = [
        _VP, _I64, _I64,  # flat, feat_dim, itemsize
        _VP,  # offsets
        _VP, _I64, _I64,  # idx, k, b
        _VP, _I64,  # keep_cols, n_keep
        _VP, _I64,  # fac_cols, n_fac
        _I64,  # p_pad
        _VP, _VP,  # points, event_feats
        _VP, _I64,  # seg, seg_itemsize
        _VP,  # seg_counts
    ]
    lib.pack_pointcloud_dense.restype = _I64
    lib.pack_pointcloud_dense.argtypes = [
        _VP, _I64, _I64,  # flat, feat_dim, itemsize
        _VP,  # offsets
        _VP, _I64, _I64,  # idx, k, b
        _VP, _I64,  # keep_cols, n_keep
        _VP, _I64,  # fac_cols, n_fac
        _I64,  # m
        _VP, _VP,  # points, event_feats
        _VP,  # seg_counts
    ]
    lib.pack_graph_flat.restype = _I64
    lib.pack_graph_flat.argtypes = [
        _VP, _I64, _I64,  # feats, feat_dim, itemsize
        _VP,  # node_offsets
        _VP, _VP, _VP,  # src, dst, edge_offsets
        _VP, _I64, _VP,  # weights, use_weights, mask (or null)
        _VP, _I64, _I64,  # idx, k, b
        _I64, _I64,  # n_pad, e_pad
        _VP,  # nodes
        _VP, _I64,  # node_seg, seg_itemsize
        _VP,  # seg_counts
        _VP, _VP, _I64,  # src_out, dst_out, idx_itemsize
        _VP, _VP, _I64,  # edge_w, edge_mask, w_itemsize
    ]
    lib.pack_graph_inrow.restype = _I64
    lib.pack_graph_inrow.argtypes = [
        _VP, _I64, _I64,  # feats, feat_dim, itemsize
        _VP,  # node_offsets
        _VP, _VP, _VP,  # values, keys, edge_offsets
        _VP, _I64,  # weights, use_weights
        _VP, _I64, _I64,  # idx, k, b
        _I64, _I64,  # m_pad, d_pad
        _VP, _VP,  # nodes, node_mask
        _VP, _I64,  # in_src, idx_itemsize
        _VP, _I64,  # in_w (or null), w_itemsize
        _I64,  # fill_nodes
    ]
    lib.pack_graph_dense.restype = _I64
    lib.pack_graph_dense.argtypes = [
        _VP, _I64, _I64,  # feats, feat_dim, itemsize
        _VP,  # node_offsets
        _VP, _VP, _VP,  # src, dst, edge_offsets
        _VP, _I64,  # weights (f32), use_weights
        _VP, _I64, _I64,  # idx, k, b
        _I64,  # m_pad
        _VP,  # nodes
        _VP, _I64,  # adj, adj_itemsize
        _VP,  # node_mask
    ]


@functools.cache
def _host_library() -> KernelLibrary:
    sources = sorted(HOST_SRC_DIR.glob("*.cpp"))
    if not sources:
        raise RuntimeError(f"no C++ sources under {HOST_SRC_DIR}")
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    target = BUILD_DIR / f"libpcc_host_{digest.hexdigest()[:16]}.so"
    seconds = 0.0
    if not target.exists():
        t0 = time.perf_counter()
        _build(sources, target)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    _declare(lib)
    return KernelLibrary(lib, target, seconds)


def host_library() -> KernelLibrary:
    """Build (if needed) and load ``csrc/host/*.cpp``; raises if either fails."""
    with _build_lock:  # the background loader's thread may ask at the same time
        return _host_library()


def _lib() -> Optional[ctypes.CDLL]:
    """The library, or None where ``PCC_NATIVE=0`` asks for the numpy branch."""
    return None if os.environ.get("PCC_NATIVE") == "0" else host_library().lib


def _p(a: Optional[np.ndarray], dtype=None):
    """The buffer of ``a`` (null for None): C-contiguous, and of ``dtype``
    where one is given, or the C++ side would read the wrong bytes."""
    if a is None:
        return None
    if not a.flags.c_contiguous or (dtype is not None and a.dtype != dtype):
        raise ValueError(f"packer buffer must be C-contiguous {dtype or a.dtype}, got {a.dtype}")
    return a.ctypes.data_as(_VP)


def _ids(a: np.ndarray):
    """An int16 or int32 id buffer (the wires' two index widths)."""
    if a.dtype not in (np.int16, np.int32):
        raise ValueError(f"packer id buffer must be int16 or int32, got {a.dtype}")
    return _p(a)


def _done(rc: int, what: str) -> bool:
    if rc < 0:
        raise ValueError(f"{what}: the batch does not fit the buffers it was given (code {rc})")
    return True


def _same_wire(weights: np.ndarray, out: np.ndarray, name: str) -> None:
    if weights.itemsize != out.itemsize:
        raise ValueError(
            f"wire-dtype mismatch: weights itemsize {weights.itemsize} != {name} itemsize {out.itemsize}"
        )


def pack_pointcloud_native(flat, offsets, idx, b, keep_cols, fac_cols, p_pad, points, event_feats,
                           seg, seg_counts) -> bool:
    """Fill a flat point-cloud batch (``PointCloudLoader._flat_batch``'s
    numpy branch is its plain version); False under ``PCC_NATIVE=0``.
    Outputs must hold their padding values: ``seg`` filled with ``b``, the
    rest zeros."""
    lib = _lib()
    if lib is None:
        return False
    rc = lib.pack_pointcloud(
        _p(flat), flat.shape[1], flat.itemsize, _p(offsets, np.int64),
        _p(idx, np.int64), len(idx), b,
        _p(keep_cols, np.int64), len(keep_cols), _p(fac_cols, np.int64), len(fac_cols),
        p_pad, _p(points, flat.dtype), _p(event_feats, flat.dtype),
        _ids(seg), seg.itemsize, _p(seg_counts, np.int32),
    )
    return _done(rc, "pack_pointcloud")


def pack_pointcloud_dense_native(flat, offsets, idx, b, keep_cols, fac_cols, m, points, event_feats,
                                 seg_counts) -> bool:
    """Fill a dense point-cloud batch (``PointCloudLoader._dense_batch``);
    ``points`` is the ``[b, m, Fw]`` buffer viewed as ``[b*m, Fw]``.  False
    under ``PCC_NATIVE=0``."""
    lib = _lib()
    if lib is None:
        return False
    rc = lib.pack_pointcloud_dense(
        _p(flat), flat.shape[1], flat.itemsize, _p(offsets, np.int64),
        _p(idx, np.int64), len(idx), b,
        _p(keep_cols, np.int64), len(keep_cols), _p(fac_cols, np.int64), len(fac_cols),
        m, _p(points, flat.dtype), _p(event_feats, flat.dtype), _p(seg_counts, np.int32),
    )
    return _done(rc, "pack_pointcloud_dense")


def pack_graph_flat_native(feats, node_offsets, src, dst, edge_offsets, weights, use_weights, idx, b,
                           n_pad, e_pad, nodes, node_seg, seg_counts, src_out, dst_out, edge_w,
                           edge_mask, mask=None) -> bool:
    """Fill a flat edge-list graph batch (``GraphLoader._flat_batch``).
    ``weights`` (and ``mask``, a merged multigraph's multiplicities, or None
    for 1.0) are already in the wire dtype.  False under ``PCC_NATIVE=0``."""
    lib = _lib()
    if lib is None:
        return False
    _same_wire(weights, edge_w, "edge_w")
    if mask is not None:
        _same_wire(mask, edge_mask, "edge_mask")
    rc = lib.pack_graph_flat(
        _p(feats), feats.shape[1], feats.itemsize, _p(node_offsets, np.int64),
        _p(src, np.int32), _p(dst, np.int32), _p(edge_offsets, np.int64),
        _p(weights), int(use_weights), _p(mask),
        _p(idx, np.int64), len(idx), b, n_pad, e_pad,
        _p(nodes, feats.dtype), _ids(node_seg), node_seg.itemsize, _p(seg_counts, np.int32),
        _ids(src_out), _p(dst_out, src_out.dtype), src_out.itemsize,
        _p(edge_w), _p(edge_mask, edge_w.dtype), edge_w.itemsize,
    )
    return _done(rc, "pack_graph_flat")


def pack_graph_dense_native(feats, node_offsets, src, dst, edge_offsets, weights, use_weights, idx, b,
                            m_pad, nodes, adj, node_mask) -> bool:
    """Fill the host adjacency wire (``GraphLoader._host_dense_batch``) from
    f32 ``weights``, accumulated in ``adj``'s dtype as ``np.add.at`` does.
    False under ``PCC_NATIVE=0``."""
    lib = _lib()
    if lib is None:
        return False
    rc = lib.pack_graph_dense(
        _p(feats), feats.shape[1], feats.itemsize, _p(node_offsets, np.int64),
        _p(src, np.int32), _p(dst, np.int32), _p(edge_offsets, np.int64),
        _p(weights, np.float32), int(use_weights),
        _p(idx, np.int64), len(idx), b, m_pad,
        _p(nodes, feats.dtype), _p(adj), adj.itemsize, _p(node_mask, np.float32),
    )
    return _done(rc, "pack_graph_dense")


def pack_graph_inrow_native(feats, node_offsets, src, dst, edge_offsets, weights, use_weights, idx, b,
                            m_pad, d_pad, nodes, node_mask, in_src, in_w, fill_nodes=True) -> bool:
    """Fill ``[b, m_pad, d_pad]`` per-row lists: slot ``q`` of row
    ``dst[e]`` holds the row's ``q``-th edge's ``src[e]`` and weight.
    ``dst`` is run-sorted within each graph.  ``fill_nodes`` also fills
    ``nodes`` and ``node_mask``; a None ``in_w`` writes no weights.  False
    under ``PCC_NATIVE=0``."""
    lib = _lib()
    if lib is None:
        return False
    if in_w is not None:
        _same_wire(weights, in_w, "in_w")
    rc = lib.pack_graph_inrow(
        _p(feats), feats.shape[1], feats.itemsize, _p(node_offsets, np.int64),
        _p(src, np.int32), _p(dst, np.int32), _p(edge_offsets, np.int64),
        _p(weights), int(use_weights),
        _p(idx, np.int64), len(idx), b, m_pad, d_pad,
        _p(nodes, feats.dtype), _p(node_mask, np.float32),
        _ids(in_src), in_src.itemsize, _p(in_w), weights.itemsize,
        int(fill_nodes),
    )
    return _done(rc, "pack_graph_inrow")


def build_event_edges_native(
    pids: np.ndarray,
    times: np.ndarray,
    step_keys: np.ndarray,
    parent_map: Dict[int, List[int]],
) -> Optional[np.ndarray]:
    """One event's edges ``[2, 2E]`` int64 by the C++ builder, with
    ``data.graph.build_event_edges``'s contract.  None under ``PCC_NATIVE=0``,
    or where the two could order ties differently (below): the caller then
    uses the numpy builder."""
    lib = _lib()
    if lib is None:
        return None
    pids64 = np.ascontiguousarray(pids, dtype=np.int64)
    times64 = np.ascontiguousarray(times, dtype=np.float64)
    keys64 = np.ascontiguousarray(step_keys, dtype=np.int64)
    # the numpy builder orders each particle's chain with np.argsort, whose
    # introsort is stable only on short arrays; the C++ stable_sort agrees
    # where chains are short or free of tied times, so a long chain with a
    # tie goes to numpy
    uniq, counts = np.unique(pids64, return_counts=True)
    if counts.max() > 15:
        order = np.lexsort((times64, pids64))
        sp, st = pids64[order], times64[order]
        dup = (sp[1:] == sp[:-1]) & (st[1:] == st[:-1])
        if dup.any():
            long_chains = set(uniq[counts > 15].tolist())
            if any(int(p) in long_chains for p in sp[:-1][dup]):
                return None
    pairs = [(int(child), int(p)) for child, parents in parent_map.items() for p in parents]
    child64 = np.ascontiguousarray([c for c, _ in pairs], dtype=np.int64)
    parent64 = np.ascontiguousarray([p for _, p in pairs], dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = len(pids64)
    cap = max(64, 8 * n)
    while True:
        out_src = np.empty(cap, dtype=np.int64)
        out_dst = np.empty(cap, dtype=np.int64)
        parentless = np.empty(max(n, 1), dtype=np.int64)
        n_parentless = ctypes.c_int64(0)
        rc = lib.build_event_edges(
            n, pids64.ctypes.data_as(i64p), times64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            keys64.ctypes.data_as(i64p), len(child64), child64.ctypes.data_as(i64p),
            parent64.ctypes.data_as(i64p), out_src.ctypes.data_as(i64p), out_dst.ctypes.data_as(i64p),
            cap, parentless.ctypes.data_as(i64p), ctypes.byref(n_parentless),
        )
        if rc != -1:
            break
        cap *= 4  # more edges than room: again, with more
    if rc == -2:
        raise AssertionError("Incident particle has parents, which should not happen")
    if rc == -3:
        raise AssertionError("nodes with no parents found")
    for pid in parentless[: n_parentless.value]:
        print(f"No parents exist for particle {pid}")
    return np.stack([out_src[:rc], out_dst[:rc]])

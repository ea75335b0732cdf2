"""The port's C++ batch packers (``csrc/host/batch_packer.cpp``) against its
numpy branch (``PCC_NATIVE=0``) and the JAX package's loaders: every wire
byte for byte, in keys, dtypes and values.

The point-cloud wires: flat and dense, f32 and fp16, factored event columns,
segment ids and counts, length-sorted and shuffled, empty events and a
partial final batch.  The graph wires: the flat edge list, a merged
multigraph's flat wire (mean weight, multiplicity as the mask), the in-row
lists with the out-row mirror and ``out_pos``, the host adjacency, and the
edge-slot triples (numpy on both sides, with the C++ packers around them).
Each case also checks which packers ran, so that a silent numpy branch
cannot pass for the C++ one.  ``g++`` builds the library here, as on the
card's host.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from point_cloud_classifier_tpu.data.batching import GraphLoader as JaxGraphLoader  # noqa: E402
from point_cloud_classifier_tpu.data.batching import PointCloudLoader as JaxPointCloudLoader  # noqa: E402
from point_cloud_classifier_tpu_torch.data import batching  # noqa: E402
from point_cloud_classifier_tpu_torch.data.batching import GraphLoader, PointCloudLoader  # noqa: E402
from point_cloud_classifier_tpu_torch.native import host  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKERS = ("pack_pointcloud_native", "pack_pointcloud_dense_native", "pack_graph_flat_native",
           "pack_graph_dense_native", "pack_graph_inrow_native")


@pytest.fixture
def packed(monkeypatch):
    """Counts, per packer, the calls in which the C++ packer filled the batch."""
    counts = dict.fromkeys(PACKERS, 0)

    def counting(name):
        real = getattr(batching, name)

        def call(*args, **kwargs):
            done = real(*args, **kwargs)
            counts[name] += bool(done)
            return done
        return call

    for name in PACKERS:
        monkeypatch.setattr(batching, name, counting(name))
    return counts


def _epochs(make, n=2):
    """Two epochs of batches, so that shuffled orders differ between them."""
    loader = make()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # demotions warn on every side
        return [batch for _ in range(n) for batch in loader]


def _three_ways(monkeypatch, make_ours, make_jax):
    """(C++ batches, numpy-branch batches, JAX batches), held equal."""
    native = _epochs(make_ours)
    with monkeypatch.context() as m:
        m.setenv("PCC_NATIVE", "0")
        plain = _epochs(make_ours)
    jax = _epochs(make_jax)
    for other in (plain, jax):
        assert len(native) == len(other) > 0
        for a, b in zip(native, other):
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
                assert a[key].tobytes() == b[key].tobytes(), key
    return native


def _events(seed, n, min_points=1, max_points=40, empty=()):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(int(c), 6)).astype(np.float32) for c in rng.integers(min_points, max_points, n)]
    for i in empty:
        feats[i] = np.zeros((0, 6), np.float32)
    for f in feats:
        f[:, 4] = f[0, 4] if len(f) else 0  # a column constant within each event
    return feats, rng.integers(0, 2, n).astype(np.float32)


POINT_CASES = {
    "flat f32 ids": dict(transfer_dtype="float32"),
    "flat fp16 ids": dict(transfer_dtype="float16"),
    "flat fp16 counts factored": dict(transfer_dtype="float16", seg_encoding="counts", factor_event_cols=(1, 4)),
    "flat f32 factored bucket 1.25": dict(factor_event_cols=(0,), bucket_factor=1.25, min_bucket=64),
    "flat f32 length-sorted": dict(length_sorted=True),
    "dense f32": dict(layout="dense"),
    "dense fp16 factored length-sorted": dict(layout="dense", transfer_dtype="float16",
                                              factor_event_cols=(1, 4), length_sorted=True),
    "auto fp16 flagship wire": dict(layout="auto", transfer_dtype="float16", factor_event_cols=(1,),
                                    length_sorted=True, min_bucket=64),
}


@pytest.mark.parametrize("kw", POINT_CASES.values(), ids=POINT_CASES.keys())
def test_point_cloud_wires_are_byte_identical(monkeypatch, packed, kw):
    if kw.get("layout") == "auto":  # clouds of like sizes, so that the gate ships some dense
        feats, labels = _events(0, 150, min_points=24, max_points=33, empty=(3, 20))
        b = 128
    else:
        feats, labels = _events(0, 45, empty=(3, 20))
        b = 16  # 150 % 128 and 45 % 16: partial final batches
    batches = _three_ways(
        monkeypatch,
        lambda: PointCloudLoader(feats, labels, b, shuffle=True, seed=5, **kw),
        lambda: JaxPointCloudLoader(feats, labels, b, shuffle=True, seed=5, **kw),
    )
    dense = sum(batch["points"].ndim == 3 for batch in batches)
    assert packed["pack_pointcloud_dense_native"] == dense
    assert packed["pack_pointcloud_native"] == len(batches) - dense
    if kw.get("layout") == "auto":
        assert 0 < dense < len(batches)  # both wires


def test_empty_events_and_partial_final_batch(monkeypatch, packed):
    """Events of no points write no rows and no ``event_feats`` but count 0;
    the final batch holds fewer events than slots."""
    feats, labels = _events(3, 13, empty=(0, 4, 12))
    for layout in ("flat", "dense"):
        kw = dict(layout=layout, transfer_dtype="float16", factor_event_cols=(1,))
        batches = _three_ways(
            monkeypatch,
            lambda: PointCloudLoader(feats, labels, 8, shuffle=False, **kw),
            lambda: JaxPointCloudLoader(feats, labels, 8, shuffle=False, **kw),
        )
        assert batches[1]["y_mask"].sum() == 5
    assert packed["pack_pointcloud_native"] == packed["pack_pointcloud_dense_native"] == 4


def _graphs(seed, n=18, duplicates=0, hub=0, empty_edges=(2,), zero_weight=False):
    """Seeded graphs of 1-60 nodes, about three incoming edges a node, stored
    unsorted; ``duplicates`` repeats directed edges, ``hub`` gives node 0 of
    graph 0 that many incoming edges, graphs ``empty_edges`` have none."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(n):
        nodes = int(rng.integers(1, 61))
        if g == 0 and hub:
            nodes = max(nodes, hub + 1)  # distinct sources: the hub's run is `hub` edges long
        e = 0 if g in empty_edges else 3 * nodes
        src, dst = rng.integers(0, nodes, size=e), rng.integers(0, nodes, size=e)
        keep = np.unique(dst * nodes + src, return_index=True)[1]
        src, dst = src[keep], dst[keep]
        if duplicates and len(src):
            rep = rng.integers(0, len(src), size=duplicates)
            src, dst = np.concatenate([src, src[rep]]), np.concatenate([dst, dst[rep]])
        if g == 0 and hub:
            src, dst = np.concatenate([src, np.arange(hub) % nodes]), np.concatenate([dst, np.zeros(hub, int)])
        perm = rng.permutation(len(src))
        w = rng.uniform(0.05, 1.0, size=len(src)).astype(np.float32)
        if zero_weight and g == 1:
            w[0] = 0.0
        out.append({"features": rng.normal(size=(nodes, 4)).astype(np.float32),
                    "edges": np.stack([src[perm], dst[perm]]).astype(np.int64),
                    "weights": w[perm], "label": np.int64(rng.integers(0, 2))})
    return out


# (case, graph options, loader options, the packers each batch uses)
GRAPH_CASES = {
    "flat f32": ({}, dict(layout="flat"), {"pack_graph_flat_native": 1}),
    "flat fp16 counts ones": ({}, dict(layout="flat", transfer_dtype="float16", seg_encoding="counts",
                                       use_weights=False), {"pack_graph_flat_native": 1}),
    "flat multigraph as stored": (dict(duplicates=4), dict(layout="flat", transfer_dtype="float16"),
                                  {"pack_graph_flat_native": 1}),
    "in-row f32 weights": ({}, dict(layout="dense"), {"pack_graph_inrow_native": 1}),
    "in-row fp16 multiplicities": (dict(duplicates=3), dict(layout="dense", transfer_dtype="float16",
                                                            use_weights=False), {"pack_graph_inrow_native": 1}),
    "in-row out-rows f32": (dict(duplicates=2), dict(layout="dense", emit_out_rows=True),
                            {"pack_graph_inrow_native": 3}),
    "in-row out-rows fp16 length-sorted": (dict(duplicates=2), dict(
        layout="auto", emit_out_rows=True, transfer_dtype="float16", length_sorted=True),
        {"pack_graph_inrow_native": 3}),
    "host adjacency f32": (dict(duplicates=3), dict(layout="dense", adj_wire="host"),
                           {"pack_graph_dense_native": 1}),
    "host adjacency fp16 ones": (dict(duplicates=3), dict(layout="dense", adj_wire="host",
                                                          transfer_dtype="float16", use_weights=False),
                                 {"pack_graph_dense_native": 1}),
    "edge-slot triples": (dict(hub=40), dict(layout="dense", transfer_dtype="float16"), {}),
    "merged multigraph demoted, f32": (dict(duplicates=3), dict(layout="auto", flat_if_multigraph=True),
                                       {"pack_graph_flat_native": 1}),
    "merged multigraph demoted, fp16 ones": (dict(duplicates=3), dict(
        layout="dense", flat_if_multigraph=True, transfer_dtype="float16", use_weights=False),
        {"pack_graph_flat_native": 1}),
    "zero weight demoted": (dict(zero_weight=True), dict(layout="dense", dense_w_is_existence=True),
                            {"pack_graph_flat_native": 1}),
    "merged multigraph over max_dense_bytes": (dict(duplicates=3), dict(
        layout="auto", max_dense_bytes=1, transfer_dtype="float16"), {"pack_graph_flat_native": 1}),
}


@pytest.mark.parametrize("data_kw, kw, per_batch", GRAPH_CASES.values(), ids=GRAPH_CASES.keys())
def test_graph_wires_are_byte_identical(monkeypatch, packed, data_kw, kw, per_batch):
    graphs = _graphs(1, **data_kw)
    batches = _three_ways(
        monkeypatch,
        lambda: GraphLoader(graphs, 8, shuffle=True, seed=3, **kw),
        lambda: JaxGraphLoader(graphs, 8, shuffle=True, seed=3, **kw),
    )
    want = {name: per_batch.get(name, 0) * len(batches) for name in PACKERS}
    if any("edge_slot" in batch for batch in batches):  # the hub's batch ships triples: numpy, as in the JAX loader
        triples = sum("edge_slot" in batch for batch in batches)
        assert 0 < triples < len(batches)
        want["pack_graph_inrow_native"] = len(batches) - triples
    if kw.get("emit_out_rows"):
        assert all("out_pos" in batch for batch in batches)
    assert packed == want


@pytest.mark.parametrize("emit_out_rows", [False, True], ids=["in-rows", "out-rows"])
def test_require_inrow_ships_the_hub_batch_flat(monkeypatch, packed, emit_out_rows):
    """The in-row wire that max aggregation needs: the batch of a node over
    the wire's slots ships flat, the others in rows."""
    graphs = _graphs(2, hub=40)
    kw = dict(layout="dense", require_inrow=True, emit_out_rows=emit_out_rows)
    batches = _three_ways(monkeypatch, lambda: GraphLoader(graphs, 8, shuffle=False, **kw),
                          lambda: JaxGraphLoader(graphs, 8, shuffle=False, **kw))
    flat = sum(batch["nodes"].ndim == 2 for batch in batches)
    assert flat == 2  # the hub's batch, once an epoch
    assert packed["pack_graph_flat_native"] == flat
    assert packed["pack_graph_inrow_native"] == (3 if emit_out_rows else 1) * (len(batches) - flat)


def test_fp16_host_adjacency_accumulates_duplicates_as_numpy():
    """``np.add.at`` on an f16 array rounds after every add; the packer does
    too.  Called on the raw packer: a loader merges duplicates first."""
    rng = np.random.default_rng(2)
    m, e = 8, 30
    edges = np.tile(rng.integers(0, m, size=(2, 6)), 5).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    nodes = np.zeros((1, m, 4), np.float16)
    adj = np.zeros((1, m, m), np.float16)
    node_mask = np.zeros((1, m), np.float32)
    assert host.pack_graph_dense_native(
        rng.normal(size=(m, 4)).astype(np.float16), np.array([0, m], np.int64),
        np.ascontiguousarray(edges[0]), np.ascontiguousarray(edges[1]), np.array([0, e], np.int64),
        w, True, np.array([0], np.int64), 1, m, nodes, adj, node_mask,
    )
    want = np.zeros((m, m), np.float16)
    np.add.at(want, (edges[1], edges[0]), w.astype(np.float16))
    assert adj[0].tobytes() == want.tobytes()


def test_a_packer_refuses_buffers_of_the_wrong_dtype():
    """The C++ side reads raw bytes, so the wrapper checks what it is given."""
    flat = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="C-contiguous"):
        host.pack_pointcloud_dense_native(
            flat, np.array([0, 4], np.int64), np.array([0], np.int32), 1, np.arange(3), np.zeros(0, np.int64),
            8, np.zeros((8, 3), np.float32), None, np.zeros(2, np.int32))


def test_pcc_native_0_builds_nothing_and_packs_with_numpy(monkeypatch, packed):
    monkeypatch.setenv("PCC_NATIVE", "0")
    monkeypatch.setattr(host, "host_library", lambda: pytest.fail("PCC_NATIVE=0 must not build"))
    feats, labels = _events(4, 20)
    assert len(list(PointCloudLoader(feats, labels, 8, shuffle=False, layout="auto"))) == 3
    assert list(GraphLoader(_graphs(4), 8, shuffle=False, layout="dense", emit_out_rows=True))
    assert not any(packed.values())


FAKE_GXX = """#!/bin/sh
echo "$*" >> "$(dirname "$0")/calls.log"
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case "$*" in *bad.cpp*) echo "bad.cpp:1:1: error: expected a declaration" >&2; exit 1;; esac
echo built > "$out"
"""


@pytest.fixture
def fake_gxx(tmp_path, monkeypatch):
    """A stand-in ``g++`` (a shell script that writes its ``-o`` file or fails
    on ``bad.cpp``), with the library's sources and build directory in
    ``tmp_path``."""
    gxx = tmp_path / "g++"
    gxx.write_text(FAKE_GXX)
    gxx.chmod(0o755)
    monkeypatch.setattr(host, "_gxx", lambda: str(gxx))
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host, "HOST_SRC_DIR", tmp_path / "src")
    (tmp_path / "src").mkdir()
    host._host_library.cache_clear()
    yield tmp_path
    host._host_library.cache_clear()


def test_a_failed_host_build_raises_with_the_compilers_message(fake_gxx, monkeypatch):
    """No quiet fallback: the loader raises rather than packing with numpy,
    and no library is left under any name."""
    (fake_gxx / "src" / "bad.cpp").write_text("not c++\n")
    feats, labels = _events(5, 10)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*expected a declaration"):
        list(PointCloudLoader(feats, labels, 4, shuffle=False))
    with pytest.raises(RuntimeError, match="expected a declaration"):
        list(GraphLoader(_graphs(5), 4, shuffle=False, layout="flat"))
    assert not os.listdir(fake_gxx / "build")
    monkeypatch.setenv("PCC_NATIVE", "0")  # the one way to the numpy branch
    assert len(list(PointCloudLoader(feats, labels, 4, shuffle=False))) == 3


def test_the_build_is_named_by_a_hash_of_its_sources_and_flags(fake_gxx, monkeypatch):
    """One g++ call with the JAX build's flags over every source, into a
    temporary name renamed at the end; an edited source builds anew."""
    (fake_gxx / "src" / "a.cpp").write_text("// a\n")
    (fake_gxx / "src" / "b.cpp").write_text("// b\n")
    real_cdll = host.ctypes.CDLL
    monkeypatch.setattr(host.ctypes, "CDLL", lambda path: real_cdll(None))  # the stand-in writes no library
    monkeypatch.setattr(host, "_declare", lambda lib: None)
    first = host.host_library()
    call = (fake_gxx / "calls.log").read_text().splitlines()
    assert len(call) == 1 and call[0].startswith("-O2 -shared -fPIC -std=c++17 ")
    assert "a.cpp" in call[0] and "b.cpp" in call[0] and ".tmp" in call[0]
    assert sorted(os.listdir(fake_gxx / "build")) == [first.path.name] and first.build_seconds > 0
    host._host_library.cache_clear()
    assert host.host_library().path == first.path and host.host_library().build_seconds == 0.0
    (fake_gxx / "src" / "b.cpp").write_text("// b, edited\n")
    host._host_library.cache_clear()
    assert host.host_library().path != first.path
    assert len((fake_gxx / "calls.log").read_text().splitlines()) == 2


def test_importing_the_loaders_builds_nothing():
    code = ("import point_cloud_classifier_tpu_torch.data.batching, point_cloud_classifier_tpu_torch.data.graph\n"
            "from point_cloud_classifier_tpu_torch.native import host\n"
            "print(host._host_library.cache_info().currsize)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PATH": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0"]

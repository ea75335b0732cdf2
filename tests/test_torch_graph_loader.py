"""The port's ``GraphLoader`` (dense in-row wire) against the JAX package's over
the same graphs: batches byte-identical in keys, dtypes and values, the out-row mirror
(``emit_out_rows``) included; and the batches the JAX loader would ship
another way raise in the port."""

import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from point_cloud_classifier_tpu.data.batching import GraphLoader as JaxGraphLoader  # noqa: E402
from point_cloud_classifier_tpu_torch.data import GraphLoader  # noqa: E402

WIRE_KEYS = ["nodes", "node_mask", "in_deg", "y", "y_mask", "in_src", "in_w"]
OUT_KEYS = ["out_dst", "out_w", "out_pos"]


def graphs(seed=0, n=21, duplicates=0, zero_weight=False, hub=0, big=0):
    """Seeded graphs of 1-70 nodes (``big`` of them larger), about three
    incoming edges per node, positive weights.  ``duplicates`` repeats that
    many directed edges per graph; ``hub`` gives node 0 of graph 0 that many
    incoming edges; ``zero_weight`` zeroes one weight."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(n):
        nodes = int(rng.integers(1, 71)) + (300 if g < big else 0)
        e = 0 if g == 2 else 3 * nodes
        src, dst = rng.integers(0, nodes, size=e), rng.integers(0, nodes, size=e)
        keep = np.unique(dst * nodes + src, return_index=True)[1]
        src, dst = src[keep], dst[keep]
        if duplicates and len(src):
            rep = rng.integers(0, len(src), size=duplicates)
            src, dst = np.concatenate([src, src[rep]]), np.concatenate([dst, dst[rep]])
        if g == 0 and hub:
            src = np.concatenate([src, np.arange(hub) % nodes])
            dst = np.concatenate([dst, np.zeros(hub, dtype=dst.dtype)])
        perm = rng.permutation(len(src))  # unsorted, as a cache may hold them
        w = rng.uniform(0.05, 1.0, size=len(src)).astype(np.float32)
        if zero_weight and g == 1:
            w[0] = 0.0
        out.append({
            "features": rng.normal(size=(nodes, 5)).astype(np.float32),
            "edges": np.stack([src[perm], dst[perm]]).astype(np.int64),
            "weights": w[perm],
            "label": np.int64(rng.integers(0, 2)),
        })
    return out


def _assert_batches_equal(ours, theirs, keys=WIRE_KEYS):
    """Each batch holds exactly ``keys`` (or, where ``keys`` is a list of
    lists, batch ``i`` holds ``keys[i]``), byte for byte."""
    assert len(ours) == len(theirs) > 0
    per_batch = keys if isinstance(keys[0], list) else [keys] * len(ours)
    for a, b, want in zip(ours, theirs, per_batch, strict=True):
        assert sorted(a) == sorted(b) == sorted(want)
        for k in want:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


def _both(data, epochs=1, **kw):
    ours, theirs = GraphLoader(data, **kw), JaxGraphLoader(data, adj_wire="device", **kw)
    assert len(ours) == len(theirs)
    return (
        [b for _ in range(epochs) for b in ours],
        [b for _ in range(epochs) for b in theirs],
    )


@pytest.mark.parametrize("use_weights", [True, False], ids=["weights", "multiplicities"])
@pytest.mark.parametrize("transfer_dtype", ["float32", "float16"])
@pytest.mark.parametrize("layout", ["dense", "auto"])
def test_batches_are_byte_identical(layout, transfer_dtype, use_weights):
    _assert_batches_equal(*_both(
        graphs(), batch_size=8, shuffle=False, layout=layout,
        transfer_dtype=transfer_dtype, use_weights=use_weights,
    ))


@pytest.mark.parametrize("length_sorted", [False, True], ids=["unsorted", "length-sorted"])
def test_shuffled_epochs_are_byte_identical(length_sorted):
    _assert_batches_equal(*_both(
        graphs(seed=1), epochs=3, batch_size=4, shuffle=True, layout="auto",
        length_sorted=length_sorted, n_features=4, seed=5,
    ))


@pytest.mark.parametrize("transfer_dtype", ["float32", "float16"])
def test_merged_multigraph_is_byte_identical(transfer_dtype):
    """Duplicate directed edges merge at init: summed weights, and in_deg
    counting each occurrence."""
    data = graphs(seed=2, duplicates=5)
    for use_weights in (True, False):
        ours, theirs = _both(data, batch_size=8, shuffle=False, layout="dense",
                             transfer_dtype=transfer_dtype, use_weights=use_weights)
        _assert_batches_equal(ours, theirs)
    assert any((b["in_deg"] > (b["in_w"] != 0).sum(-1)).any() for b in ours)


def test_wide_in_degree_within_the_wire_is_byte_identical():
    data = graphs(seed=3, hub=29)  # D = 32, the default max_in_degree_wire
    ours, theirs = _both(data, batch_size=8, shuffle=False, layout="dense")
    _assert_batches_equal(ours, theirs)
    assert ours[0]["in_src"].shape[-1] == 32


def test_rungs_are_multiples_of_eight():
    """An unaligned min_dense_nodes (9) is rounded up to 16, as are rungs."""
    small = [g for g in graphs(seed=4, n=60) if len(g["features"]) <= 9][:3]
    ours, theirs = _both(small + graphs(seed=4, big=1), batch_size=3, shuffle=False,
                         layout="auto", min_dense_nodes=9)
    _assert_batches_equal(ours, theirs)
    rungs = [b["nodes"].shape[1] for b in ours]
    assert rungs[0] == 16 and all(m % 8 == 0 for m in rungs)


@pytest.mark.parametrize(
    "data_kw, loader_kw, match",
    [
        (dict(zero_weight=True), dict(dense_w_is_existence=True), "exact-zero"),
        (dict(duplicates=3), dict(flat_if_multigraph=True), "duplicate"),
        (dict(big=1), dict(max_dense_bytes=8 * 300 * 300 * 4), "max_dense_bytes"),
        (dict(hub=40), dict(), "max_in_degree_wire"),
    ],
    ids=["zero-weight", "multigraph", "over-max-dense-bytes", "over-max-in-degree"],
)
def test_batches_the_jax_loader_ships_otherwise_raise(data_kw, loader_kw, match):
    """Where a gate demotes the layout or a batch leaves the in-row wire,
    the JAX loader ships flat batches or edge-slot triples; the port
    refuses with the reason."""
    data = graphs(seed=5, **data_kw)
    kw = dict(batch_size=8, shuffle=False, layout="auto", **loader_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the JAX loader warns as it demotes
        first = next(iter(JaxGraphLoader(data, **kw)))
    assert "in_src" not in first
    with pytest.raises(NotImplementedError, match=match):
        list(GraphLoader(data, **kw))


def test_dense_layout_over_max_dense_bytes_raises_as_jax_does():
    data = graphs(seed=6, big=1)
    kw = dict(batch_size=8, shuffle=False, layout="dense", max_dense_bytes=8 * 300 * 300 * 4)
    for loader in (GraphLoader(data, **kw), JaxGraphLoader(data, **kw)):
        with pytest.raises(ValueError, match="max_dense_bytes"):
            list(loader)


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(layout="flat"), "flat"),
        (dict(layout="dense", adj_wire="host"), "host"),
        (dict(layout="dense", require_inrow=True), "require_inrow"),
    ],
    ids=["flat", "host-adjacency", "require-inrow"],
)
def test_unported_wires_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        GraphLoader(graphs(n=3), batch_size=2, shuffle=False, **kw)


@pytest.mark.parametrize("use_weights", [True, False], ids=["weights", "multiplicities"])
@pytest.mark.parametrize("transfer_dtype", ["float32", "float16"])
def test_out_rows_are_byte_identical(transfer_dtype, use_weights):
    """The out-row mirror that the fused aggregation's backward reads, on a
    multigraph (merged duplicates carry summed weights or multiplicities)."""
    ours, theirs = _both(
        graphs(seed=7, duplicates=4), batch_size=8, shuffle=False, layout="dense",
        transfer_dtype=transfer_dtype, use_weights=use_weights, emit_out_rows=True,
    )
    _assert_batches_equal(ours, theirs, WIRE_KEYS + OUT_KEYS)
    half = transfer_dtype == "float16"
    assert ours[0]["out_dst"].dtype == (np.int16 if half else np.int32)
    assert ours[0]["out_w"].dtype == (np.float16 if half else np.float32)
    assert ours[0]["out_dst"].shape[-1] >= 4


def test_shuffled_out_rows_are_byte_identical():
    _assert_batches_equal(*_both(
        graphs(seed=8), epochs=2, batch_size=4, shuffle=True, layout="auto",
        n_features=4, seed=3, emit_out_rows=True,
    ), WIRE_KEYS + OUT_KEYS)


def test_batch_whose_out_degree_overflows_the_wire_ships_no_out_rows():
    """Node 0 of graph 0 sends 40 edges: more than ``max_in_degree_wire``
    out-slots, so that batch keeps its in-row lists and drops the mirror."""
    data = graphs(seed=9, big=1)  # graph 0 has over 300 nodes
    n0 = len(data[0]["features"])
    fan = np.stack([np.zeros(40, np.int64), np.arange(40) % n0])
    keep = data[0]["edges"][0] != 0  # node 0's own edges go; the fan replaces them
    edges = np.concatenate([data[0]["edges"][:, keep], fan], axis=1)
    edges = edges[:, np.unique(edges[1] * n0 + edges[0], return_index=True)[1]]
    data[0] = dict(data[0], edges=edges, weights=np.full(edges.shape[1], 0.5, np.float32))
    ours, theirs = _both(data, batch_size=8, shuffle=False, layout="dense", emit_out_rows=True)
    per_batch = [WIRE_KEYS] + [WIRE_KEYS + OUT_KEYS] * (len(ours) - 1)
    assert n0 >= 33 and len(ours) > 1
    _assert_batches_equal(ours, theirs, per_batch)


def test_out_rows_are_the_transposed_adjacency():
    """``out_dst``/``out_w`` list each node's outgoing edges, and ``out_pos``
    names each of those edges' slot in its destination's in-row list."""
    loader = GraphLoader(graphs(seed=10, duplicates=3), batch_size=8, shuffle=False,
                         layout="dense", emit_out_rows=True)
    for batch in loader:
        b, m, _ = batch["in_src"].shape
        adj_in, adj_out = np.zeros((b, m, m)), np.zeros((b, m, m))
        rows = np.arange(m)[None, :, None]
        for adj, idx, w in ((adj_in, batch["in_src"], batch["in_w"]),
                            (adj_out, batch["out_dst"], batch["out_w"])):
            np.add.at(adj, (np.arange(b)[:, None, None], rows, idx), w)
        np.testing.assert_array_equal(adj_out, np.swapaxes(adj_in, 1, 2))
        g, src, q = np.nonzero(batch["out_w"])
        dst, pos = batch["out_dst"][g, src, q], batch["out_pos"][g, src, q]
        np.testing.assert_array_equal(batch["in_src"][g, dst, pos], src)
        np.testing.assert_array_equal(batch["in_w"][g, dst, pos], batch["out_w"][g, src, q])

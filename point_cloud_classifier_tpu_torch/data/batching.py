"""Static-shape, bucketed batches in numpy: point clouds and graphs.

Counterpart of ``point_cloud_classifier_tpu/data/batching.py``, which the
port cannot import (its package ``__init__`` pulls in jax, pandas and h5py).
Batches are byte-identical to the JAX loaders': keys, dtypes and values.

- ``PointCloudLoader``, the flat wire: ``points [P_pad, F]`` with events
  contiguous and padding rows at the end, labels ``y [B, 1]`` with ``y_mask
  [B]``, and either ``seg [P_pad]`` (event index per point, padding rows get
  ``B``) or ``seg_counts [B + 1]`` (points per event, padding count last).
  ``P_pad`` is a power-of-two bucket, so the model sees a small set of
  shapes.
- ``GraphLoader``, the dense in-row wire (``layout="dense"|"auto"``,
  ``adj_wire="device"``): per-graph padded ``nodes [B, M, F]``, ``node_mask``
  and the per-occurrence in-degree ``in_deg [B, M]``, and each node's
  incoming edges ``in_src``/``in_w [B, M, D]``.  M rides the rung ladder
  (``k·2^j``, k in 8..15) rounded up to 8, D the batch's max in-degree
  rounded up to a power of two (at least 4).  ``emit_out_rows=True`` adds
  the out-row mirror ``out_dst``/``out_w``/``out_pos [B, M, Do]``.

Packing is the JAX loaders' pure-Python branch.  Not ported yet: their C++
packers; for point clouds the dense per-cloud-row layout,
``factor_event_cols``, the fp16 wire, length-sorted batching and
non-power-of-two bucket ladders; for graphs the flat edge-list wire, the
edge-slot triples, the host adjacency and ``require_inrow``.  Where the JAX
graph loader would ship one of those, the port raises
``NotImplementedError`` with the reason.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

Batch = Dict[str, np.ndarray]


def _dense_rung(n: int) -> int:
    """Smallest k·2^j ≥ n with k in 8..15 (and ≥ 8): ≤ 14% padding, about 8
    rungs per octave."""
    n = max(int(n), 8)
    j = max((n - 1).bit_length() - 4, 0)
    return -(-n // (1 << j)) << j


def _pow2_slots(max_degree: int) -> int:
    """The in-row list width D: the max in-degree rounded up to a power of
    two, at least 4."""
    return max(4, 1 << (max(max_degree, 1) - 1).bit_length())


def pow2_bucket(n: int, min_size: int = 256) -> int:
    """Smallest ``min_size * 2^k`` (rounded up to a multiple of 8) that
    covers ``n``."""
    size = min_size
    while size < n:
        size *= 2
    return -(-size // 8) * 8


class PointCloudLoader:
    """Flattened f32 point batches: ``points [P_pad, F]`` + segment ids
    (``seg_encoding="ids"``) or counts (``"counts"``).  Stores all events as
    one contiguous array plus offsets.  ``layout`` takes ``"flat"``, or
    ``"auto"`` below a batch size of 128, where the JAX loader's ``"auto"``
    always stays flat."""

    def __init__(
        self,
        event_features: Sequence[np.ndarray],
        labels: np.ndarray,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        min_bucket: int = 256,
        seg_encoding: str = "ids",
        layout: str = "flat",
    ):
        if seg_encoding not in ("ids", "counts"):
            raise ValueError("seg_encoding must be 'ids' or 'counts'")
        if layout not in ("flat", "dense", "auto"):
            raise ValueError("layout must be 'flat', 'dense', or 'auto'")
        # the JAX loader's "auto" ships a batch dense only from a batch size
        # of 128, so below that it is exactly the flat wire
        if layout == "dense" or (layout == "auto" and batch_size and batch_size >= 128):
            raise NotImplementedError(
                f"layout={layout!r} at batch size {batch_size} needs the dense "
                "per-cloud-row wire, which is not ported yet (ROADMAP Queue 1 "
                "item 5); use layout='flat'"
            )
        self.seg_encoding = seg_encoding
        counts = np.array([len(f) for f in event_features], dtype=np.int64)
        self.flat = np.ascontiguousarray(
            np.concatenate(event_features, axis=0), dtype=np.float32
        )
        self.offsets = np.ascontiguousarray(
            np.concatenate([[0], np.cumsum(counts)]), dtype=np.int64
        )
        self.counts = counts
        self.labels = np.asarray(labels, dtype=np.float32).reshape(-1)
        self.batch_size = int(batch_size) if batch_size else len(self.labels)
        self.shuffle = shuffle
        self.seed = seed
        self.min_bucket = min_bucket
        self._epoch = 0

    @property
    def n_examples(self) -> int:
        return len(self.labels)

    def __len__(self) -> int:
        return -(-self.n_examples // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        n, b = self.n_examples, self.batch_size
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(n)
            self._epoch += 1
        feat_dim = self.flat.shape[1]
        for start in range(0, n, b):
            idx = order[start : start + b]
            k = len(idx)
            total = int(self.counts[idx].sum())
            p_pad = pow2_bucket(total, self.min_bucket)
            points = np.zeros((p_pad, feat_dim), dtype=np.float32)
            seg = np.full((p_pad,), b, dtype=np.int32)
            yb = np.zeros((b, 1), dtype=np.float32)
            mask = np.zeros((b,), dtype=np.float32)
            seg_counts = np.zeros((b + 1,), dtype=np.int32)
            cursor = 0
            for slot, ev in enumerate(idx):
                lo, hi = self.offsets[ev], self.offsets[ev + 1]
                points[cursor : cursor + (hi - lo)] = self.flat[lo:hi]
                seg[cursor : cursor + (hi - lo)] = slot
                seg_counts[slot] = hi - lo
                cursor += hi - lo
            seg_counts[b] = p_pad - cursor  # padding rows → segment B
            yb[:k, 0] = self.labels[idx]
            mask[:k] = 1.0
            batch = {"points": points, "y": yb, "y_mask": mask}
            if self.seg_encoding == "counts":
                batch["seg_counts"] = seg_counts
            else:
                batch["seg"] = seg
            yield batch


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"GraphLoader: {what}; the port serves only the dense in-row wire so "
        "far (ROADMAP Queue 1, GraphNet slice 2)"
    )


class GraphLoader:
    """Batched padded graphs on the dense in-row wire.

    At construction each graph's edges are sorted by (destination, source)
    and duplicate directed edges merged: weights summed, multiplicities
    counted.  ``in_deg`` then counts each merged edge by its multiplicity
    (zero-weight edges included), so a mean divides by the per-occurrence
    in-degree.  With ``use_weights=False`` the in-row weights are the
    multiplicities.  ``transfer_dtype="float16"`` ships fp16 features and
    weights with int16 sources.

    The gates of the JAX loader are kept: ``dense_w_is_existence`` (an
    exact-zero wire weight) and ``flat_if_multigraph`` (a duplicate edge)
    demote the whole loader to the flat wire there, and raise here; so do a
    batch over ``max_dense_bytes`` under ``layout="auto"`` and a batch whose
    in-degree needs more than ``max_in_degree_wire`` slots.

    ``emit_out_rows=True`` also ships the out-row mirror, the transposed
    adjacency that the fused aggregation's backward reads: ``out_dst`` and
    ``out_w [B, M, Do]`` (each node's outgoing edges in destination order)
    and ``out_pos`` (each of those edges' slot in its destination's in-row
    list).  A batch whose out-degree needs more than ``max_in_degree_wire``
    slots ships no out-row arrays, as in the JAX loader.
    """

    def __init__(
        self,
        graphs: Sequence[Dict[str, np.ndarray]],
        batch_size: int,
        shuffle: bool,
        use_weights: bool = True,
        n_features: Optional[int] = None,
        seed: int = 0,
        min_node_bucket: int = 256,  # flat wire only
        min_edge_bucket: int = 512,  # flat wire only
        transfer_dtype: str = "float32",
        seg_encoding: str = "ids",  # flat wire only
        layout: str = "flat",
        min_dense_nodes: int = 64,
        max_dense_bytes: int = 1 << 28,
        adj_wire: str = "device",
        min_edge_bucket_dense: int = 512,  # edge-slot triples only
        length_sorted: bool = False,
        max_in_degree_wire: int = 32,
        emit_out_rows: bool = False,
        dense_w_is_existence: bool = False,
        require_inrow: bool = False,
        flat_if_multigraph: bool = False,
    ):
        if layout not in ("flat", "dense", "auto"):
            raise ValueError(f"Unknown graph layout: {layout}")
        if adj_wire not in ("host", "device"):
            raise ValueError(f"Unknown adj_wire: {adj_wire}")
        if layout == "flat":
            raise _not_ported("layout='flat' ships the flat edge-list wire")
        if adj_wire == "host":
            raise _not_ported("adj_wire='host' ships the host adjacency [B, M, M]")
        if require_inrow:
            raise _not_ported("require_inrow serves max aggregation (GraphNet slice 2)")
        self.layout = layout
        self.emit_out_rows = bool(emit_out_rows)
        self.length_sorted = bool(length_sorted)
        self.max_in_degree_wire = int(max_in_degree_wire)
        self.min_dense_nodes = min_dense_nodes
        self.max_dense_bytes = max_dense_bytes
        self.half = transfer_dtype == "float16"
        feat_dtype = np.float16 if self.half else np.float32

        feat_list, edge_list, weight_list, labels = [], [], [], []
        for g in graphs:
            feats = np.asarray(g["features"], dtype=feat_dtype)
            if n_features is not None:
                feats = feats[:, :n_features]
            feat_list.append(np.ascontiguousarray(feats))
            edge_list.append(np.asarray(g["edges"], dtype=np.int32).reshape(2, -1))
            weight_list.append(np.asarray(g["weights"], dtype=np.float32).reshape(-1))
            labels.append(np.float32(g["label"]))
        node_counts = np.array([len(f) for f in feat_list], dtype=np.int64)
        edge_counts = np.array([e.shape[1] for e in edge_list], dtype=np.int64)
        self.feat_dim = feat_list[0].shape[1] if feat_list else 0
        self.feats = np.ascontiguousarray(
            np.concatenate(feat_list, axis=0) if feat_list else np.zeros((0, 0), feat_dtype),
            dtype=feat_dtype,
        )
        flat_edges = np.concatenate(edge_list, axis=1) if edge_list else np.zeros((2, 0), np.int32)
        src = np.ascontiguousarray(flat_edges[0], dtype=np.int32)
        dst = np.ascontiguousarray(flat_edges[1], dtype=np.int32)
        weights = np.ascontiguousarray(
            np.concatenate(weight_list) if weight_list else np.zeros((0,)), dtype=np.float32
        )
        self.node_offsets = np.ascontiguousarray(
            np.concatenate([[0], np.cumsum(node_counts)]), dtype=np.int64
        )
        self.node_counts = node_counts
        self.labels = np.asarray(labels, dtype=np.float32)

        # sort each graph's edges by (dst, src) and merge duplicates
        gid = np.repeat(np.arange(len(edge_counts)), edge_counts)
        order = np.lexsort((src, dst, gid))
        gid, src, dst, weights = gid[order], src[order], dst[order], weights[order]
        self.edge_mult = np.ones(len(weights), dtype=np.float32)
        if len(src):
            first = np.concatenate(
                [[True], (gid[1:] != gid[:-1]) | (dst[1:] != dst[:-1]) | (src[1:] != src[:-1])]
            )
            starts = np.flatnonzero(first)
            src, dst = np.ascontiguousarray(src[first]), np.ascontiguousarray(dst[first])
            weights = np.add.reduceat(weights, starts).astype(np.float32)
            self.edge_mult = np.diff(np.concatenate([starts, [len(gid)]])).astype(np.float32)
            edge_counts = np.bincount(gid[first], minlength=len(edge_counts)).astype(np.int64)
        self.edges_src, self.edges_dst, self.weights = src, dst, weights
        self.edge_counts = edge_counts
        self.edge_offsets = np.ascontiguousarray(
            np.concatenate([[0], np.cumsum(edge_counts)]), dtype=np.int64
        )
        # per-occurrence in-degree per node, and each graph's max in-degree
        # (edges are (graph, dst)-sorted, so in-degrees are run lengths)
        gid = np.repeat(np.arange(len(edge_counts)), edge_counts)
        self.node_indeg = np.zeros(len(self.feats), dtype=np.float32)
        self.graph_max_indeg = np.zeros(len(edge_counts), dtype=np.int64)
        if len(dst):
            np.add.at(self.node_indeg, self.node_offsets[gid] + dst, self.edge_mult)
            first = np.concatenate([[True], (gid[1:] != gid[:-1]) | (dst[1:] != dst[:-1])])
            starts = np.flatnonzero(first)
            run_len = np.diff(np.concatenate([starts, [len(gid)]]))
            np.maximum.at(self.graph_max_indeg, gid[starts], run_len)
        self.weights_wire = self.weights.astype(np.float16) if self.half else self.weights
        self.mult_wire = self.edge_mult.astype(np.float16) if self.half else self.edge_mult
        if self.emit_out_rows:
            self._sort_out_rows()

        if dense_w_is_existence and use_weights and bool((self.weights_wire == 0).any()):
            raise _not_ported(
                "the dataset has an exact-zero edge weight, so dense attention "
                "would drop that edge (existence is w != 0) and the JAX loader "
                "demotes to the flat wire"
            )
        if flat_if_multigraph and bool((self.edge_mult > 1).any()):
            raise _not_ported(
                "the dataset has duplicate directed edges, which dense attention "
                "counts once, so the JAX loader demotes to the flat wire"
            )
        self.batch_size = int(batch_size) if batch_size else len(labels)
        self.shuffle = shuffle
        self.use_weights = use_weights
        self.seed = seed
        self._epoch = 0

    @property
    def n_examples(self) -> int:
        return len(self.labels)

    def __len__(self) -> int:
        return -(-self.n_examples // self.batch_size)

    def _dense_wire_batch(self, idx, k: int, b: int, m_pad: int) -> Batch:
        """``nodes``, ``node_mask``, ``in_deg``, ``y``, ``y_mask``, ``in_src``
        and ``in_w`` for the graphs ``idx`` in ``b`` slots of ``m_pad`` rows,
        and with ``emit_out_rows`` the out-row mirror beside them."""
        idx_t = np.int16 if (self.half and m_pad <= 32768) else np.int32
        total_edges = int(self.edge_counts[idx].sum())
        d_pad = _pow2_slots(int(self.graph_max_indeg[idx].max()) if total_edges else 0)
        if d_pad > self.max_in_degree_wire:
            raise _not_ported(
                f"a batch needs {d_pad} in-row slots > max_in_degree_wire "
                f"{self.max_in_degree_wire}, so the JAX loader ships edge-slot triples"
            )
        nodes = np.zeros((b, m_pad, self.feat_dim), dtype=self.feats.dtype)
        node_mask = np.zeros((b, m_pad), dtype=np.float32)
        in_deg = np.zeros((b, m_pad), dtype=np.float32)
        yb = np.zeros((b, 1), dtype=np.float32)
        ymask = np.zeros((b,), dtype=np.float32)
        yb[:k, 0] = self.labels[idx]
        ymask[:k] = 1.0

        for slot, g_i in enumerate(idx):
            nlo, nhi = self.node_offsets[g_i], self.node_offsets[g_i + 1]
            nodes[slot, : nhi - nlo] = self.feats[nlo:nhi]
            node_mask[slot, : nhi - nlo] = 1.0
            in_deg[slot, : nhi - nlo] = self.node_indeg[nlo:nhi]
        wire_w = self.weights_wire if self.use_weights else self.mult_wire
        in_src, in_w = self._pack_rows(
            idx, b, m_pad, d_pad, self.edges_dst,
            [(self.edges_src, idx_t), (wire_w, wire_w.dtype)],
        )
        batch = {
            "nodes": nodes,
            "node_mask": node_mask,
            "in_deg": in_deg,
            "y": yb,
            "y_mask": ymask,
            "in_src": in_src,
            "in_w": in_w,
        }
        if self.emit_out_rows:
            # the OUT-row mirror (the transposed adjacency), read by the fused
            # aggregation's backward; a batch whose out-degree needs more
            # slots than the wire allows ships none, as in the JAX loader
            do_pad = _pow2_slots(int(self.graph_max_outdeg[idx].max()) if total_edges else 0)
            if do_pad <= self.max_in_degree_wire:
                # one pass over the (graph, source) runs for all three, so slot
                # q of a node names the same edge in each; out_pos is the
                # edge's position in its destination's in-row list
                wire_w = self.weights_o_wire if self.use_weights else self.mult_o_wire
                batch["out_dst"], batch["out_w"], batch["out_pos"] = self._pack_rows(
                    idx, b, m_pad, do_pad, self.edges_src_o,
                    [(self.edges_dst_o, idx_t), (wire_w, wire_w.dtype), (self.inpos_o, idx_t)],
                )
        return batch

    def _sort_out_rows(self) -> None:
        """The out-direction copy of the merged edges, sorted by (graph,
        source, destination): ``edges_src_o``/``edges_dst_o``, their wire
        weights and multiplicities, each edge's position in its destination's
        in-row list (``inpos_o``) and each graph's largest out-degree."""
        gid = np.repeat(np.arange(len(self.edge_counts)), self.edge_counts)
        order = np.lexsort((self.edges_dst, self.edges_src, gid))
        self.edges_src_o = np.ascontiguousarray(self.edges_src[order])
        self.edges_dst_o = np.ascontiguousarray(self.edges_dst[order])
        self.weights_o_wire = np.ascontiguousarray(self.weights_wire[order])
        self.mult_o_wire = np.ascontiguousarray(self.mult_wire[order])
        self.inpos_o = np.zeros(0, np.int32)
        self.graph_max_outdeg = np.zeros(len(self.edge_counts), dtype=np.int64)
        if not len(gid):
            return
        # in-row positions: run indices within the (graph, dst)-sorted runs
        first = np.concatenate(
            [[True], (gid[1:] != gid[:-1]) | (self.edges_dst[1:] != self.edges_dst[:-1])]
        )
        pos_in = np.arange(len(gid)) - np.flatnonzero(first)[np.cumsum(first) - 1]
        self.inpos_o = np.ascontiguousarray(pos_in[order].astype(np.int32))
        gid_o = gid[order]
        first = np.concatenate(
            [[True], (gid_o[1:] != gid_o[:-1]) | (self.edges_src_o[1:] != self.edges_src_o[:-1])]
        )
        starts = np.flatnonzero(first)
        run_len = np.diff(np.concatenate([starts, [len(gid_o)]]))
        np.maximum.at(self.graph_max_outdeg, gid_o[starts], run_len)

    def _pack_rows(self, idx, b, m_pad, d_pad, keys, columns):
        """``[B, M, D]`` per-row lists, one for each ``(per-edge array, wire
        dtype)`` of ``columns``: slot ``q`` of row ``keys[e]`` holds the row's
        ``q``-th edge's entry of each array.  ``keys`` is run-sorted within
        each graph: the destinations of the (destination, source) order give
        the in-row lists, the sources of the out-direction order the out-row
        mirror."""
        spans = [(self.edge_offsets[g_i], self.edge_offsets[g_i + 1]) for g_i in idx]
        key_l = np.concatenate(
            [keys[lo:hi].astype(np.int64) + slot * m_pad for slot, (lo, hi) in enumerate(spans)]
        )
        # slot q of a row holds its q-th edge in the sorted order
        counts = np.bincount(key_l, minlength=b * m_pad)
        starts = np.concatenate([[0], np.cumsum(counts)])
        pos = np.arange(len(key_l)) - starts[key_l]
        packed = []
        for per_edge, dtype in columns:
            out = np.zeros((b, m_pad, d_pad), dtype=dtype)
            out.reshape(b * m_pad, d_pad)[key_l, pos] = np.concatenate(
                [per_edge[lo:hi] for lo, hi in spans]
            )
            packed.append(out)
        return packed

    def __iter__(self) -> Iterator[Batch]:
        n, b = self.n_examples, self.batch_size
        order = np.arange(n)
        rng = None
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            order = rng.permutation(n)
            self._epoch += 1
        starts = np.arange(0, n, b)
        if self.length_sorted:
            # stable sort by node count, batch neighbours, shuffle batch order
            order = order[np.argsort(self.node_counts[order], kind="stable")]
            if rng is not None:
                rng.shuffle(starts)
        itemsize = 2 if self.half else 4
        for start in starts:
            idx = order[start : start + b]
            m_pad = max(self.min_dense_nodes, _dense_rung(int(self.node_counts[idx].max())))
            m_pad = -(-m_pad // 8) * 8
            dense_bytes = b * m_pad * m_pad * itemsize
            if dense_bytes > self.max_dense_bytes:
                if self.layout == "dense":
                    raise ValueError(
                        f"dense graph batch needs {dense_bytes/2**20:.0f} MB "
                        f"(B={b}, M={m_pad}) > max_dense_bytes "
                        f"{self.max_dense_bytes/2**20:.0f} MB; use "
                        "layout='auto' to fall back to the flat layout"
                    )
                raise _not_ported(
                    f"a batch of {dense_bytes/2**20:.0f} MB (B={b}, M={m_pad}) is over "
                    "max_dense_bytes, so the JAX loader ships it on the flat wire"
                )
            yield self._dense_wire_batch(idx, len(idx), b, m_pad)

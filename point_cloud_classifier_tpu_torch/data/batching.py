"""Static-shape, bucketed batches in numpy: tabular rows, point clouds and graphs.

Counterpart of ``point_cloud_classifier_tpu/data/batching.py``, which the
port cannot import (its package ``__init__`` pulls in jax, pandas and h5py).
Batches are byte-identical to the JAX loaders': keys, dtypes and values.

- ``TabularLoader``: fixed ``x [B, F]`` f32 with ``y [B, 1]`` and ``y_mask
  [B]``; only the final partial batch is padded (masked rows of zeros), and a
  shuffled loader permutes the rows from ``default_rng(seed + epoch)``.
- ``PointCloudLoader``, the flat wire: ``points [P_pad, F]`` with events
  contiguous and padding rows at the end, labels ``y [B, 1]`` with ``y_mask
  [B]``, and either ``seg [P_pad]`` (event index per point, padding rows get
  ``B``) or ``seg_counts [B + 1]`` (points per event, padding count last).
  ``P_pad`` is a bucket of the ``pow2_bucket`` ladder, so the model sees a
  small set of shapes.  Its dense per-cloud-row wire (``layout="dense"``, or
  ``"auto"`` per batch) ships ``points [B, M, F]`` with ``seg_counts``; the
  fp16 wire, factored event columns (``event_feats``), other bucket ladders
  and length-sorted batching apply to both.
- ``GraphLoader``, the dense in-row wire (``layout="dense"|"auto"``,
  ``adj_wire="device"``): per-graph padded ``nodes [B, M, F]``, ``node_mask``
  and the per-occurrence in-degree ``in_deg [B, M]``, and each node's
  incoming edges ``in_src``/``in_w [B, M, D]``.  M rides the rung ladder
  (``k·2^j``, k in 8..15) rounded up to 8, D the batch's max in-degree
  rounded up to a power of two (at least 4).  ``emit_out_rows=True`` adds
  the out-row mirror ``out_dst``/``out_w``/``out_pos [B, M, Do]``.
  A batch whose in-degree needs more than ``max_in_degree_wire`` slots
  ships the edge-slot triples ``edge_slot``/``edge_dst``/``edge_src``/
  ``edge_w`` instead of the in-row lists; ``adj_wire="host"`` ships the
  adjacency ``adj [B, M, M]`` itself.
- ``GraphLoader``, the flat edge-list wire (``layout="flat"``, or a batch or
  a whole loader demoted from ``dense``/``auto``): ``nodes [n_pad, F]`` with
  graphs contiguous and padding rows at the end, global ``src``/``dst
  [e_pad]`` with ``edge_w`` and ``edge_mask`` (padded edges self-loop on the
  last node, which is always padding), ``y``/``y_mask``, and ``node_seg
  [n_pad]`` (padding rows get ``B``) or ``node_seg_counts [B + 1]``.
  ``n_pad`` and ``e_pad`` are power-of-two buckets of ``total_nodes + 1`` and
  ``total_edges``.

Each wire is packed by the C++ packers of ``csrc/host/batch_packer.cpp``
(built with ``g++`` into ``native/build/`` at first use, ``native/host.py``)
wherever the JAX loaders call their own; the edge-slot triples stay numpy, as
there.  ``PCC_NATIVE=0`` in the environment selects the vectorized numpy
branch instead, the packers' plain version: the bytes are the same.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from point_cloud_classifier_tpu_torch.native.host import (
    pack_graph_dense_native,
    pack_graph_flat_native,
    pack_graph_inrow_native,
    pack_pointcloud_dense_native,
    pack_pointcloud_native,
)

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


def pow2_bucket(n: int, min_size: int = 256, factor: float = 2.0) -> int:
    """Smallest ``min_size * factor^k`` (rounded up to a multiple of 8) that
    covers ``n``.  ``factor=2.0`` is the power-of-two ladder; a smaller one
    (1.25, say) trades a few more shapes for less padding."""
    if factor <= 1.0:
        # `size *= factor` could never reach n
        raise ValueError(f"bucket factor must be > 1.0, got {factor}")
    size = float(min_size)
    while size < n:
        size *= factor
    return -(-int(round(size)) // 8) * 8


class TabularLoader:
    """Fixed-size feature-matrix batches; the final partial batch is
    mask-padded."""

    def __init__(self, X: np.ndarray, y: np.ndarray, batch_size: int, shuffle: bool, seed: int = 0):
        self.X = np.ascontiguousarray(X, dtype=np.float32)
        self.y = np.asarray(y, dtype=np.float32).reshape(-1)
        self.batch_size = int(batch_size) if batch_size else len(self.y)
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    @property
    def n_examples(self) -> int:
        return len(self.y)

    def __len__(self) -> int:
        return -(-self.n_examples // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        n, b = self.n_examples, self.batch_size
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(n)
            self._epoch += 1
        for start in range(0, n, b):
            idx = order[start : start + b]
            k = len(idx)
            x = np.zeros((b, self.X.shape[1]), dtype=np.float32)
            yb = np.zeros((b, 1), dtype=np.float32)
            mask = np.zeros((b,), dtype=np.float32)
            x[:k] = self.X[idx]
            yb[:k, 0] = self.y[idx]
            mask[:k] = 1.0
            yield {"x": x, "y": yb, "y_mask": mask}


class PointCloudLoader:
    """Point batches on the flat or the dense per-cloud-row wire.

    Stores all events as one contiguous array plus offsets.  Options, as in
    the JAX loader:

    - ``transfer_dtype="float16"``: fp16 features and, below 32,767 events a
      batch, int16 segment ids (the model casts on the device);
    - ``factor_event_cols``: feature columns constant within an event (such
      as ``energy_total``) leave ``points`` and ship once per event as
      ``event_feats [B + 1, C]``, in ascending column order;
    - ``bucket_factor``: the ``pow2_bucket`` ladder's step for ``P_pad``;
    - ``length_sorted``: events stably sorted by size before batching, so
      that neighbours share a batch, and the batch order shuffled from the
      same generator;
    - ``layout="dense"``: ``points [B, M, Fw]`` with each event's points at
      the start of its row and ``seg_counts [B + 1]`` (the last entry counts
      the in-row padding); M is the rung ladder's ``k·2^j`` (k in 8..15) at
      the batch's largest event.  ``"auto"`` ships a batch dense when ``B ≥
      128`` and ``B·M`` is within 10% of the flat ``P_pad``, else flat.
    """

    def __init__(
        self,
        event_features: Sequence[np.ndarray],
        labels: np.ndarray,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        min_bucket: int = 256,
        transfer_dtype: str = "float32",
        seg_encoding: str = "ids",
        factor_event_cols: Sequence[int] = (),
        bucket_factor: float = 2.0,
        length_sorted: bool = False,
        layout: str = "flat",
    ):
        if seg_encoding not in ("ids", "counts"):
            raise ValueError("seg_encoding must be 'ids' or 'counts'")
        if layout not in ("flat", "dense", "auto"):
            raise ValueError("layout must be 'flat', 'dense', or 'auto'")
        self.layout = layout
        self.seg_encoding = seg_encoding
        self.factor_event_cols = tuple(sorted(factor_event_cols))
        self.bucket_factor = float(bucket_factor)
        self.length_sorted = bool(length_sorted)
        self.half = transfer_dtype == "float16"
        counts = np.array([len(f) for f in event_features], dtype=np.int64)
        self.flat = np.ascontiguousarray(
            np.concatenate(event_features, axis=0),
            dtype=np.float16 if self.half else np.float32,
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

    def _gather(self, idx, keep64, fac64, event_feats):
        """The numpy branch: the rows of the events ``idx`` in order, the kept
        columns only ``[total, Fw]``, with each event's size and first row in
        that order; each non-empty event's factored columns (from its first
        row) go into ``event_feats``."""
        sizes = self.counts[idx]
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        total = int(sizes.sum())
        # the concatenation of the ranges [offset_e, offset_e + n_e)
        src = np.repeat(self.offsets[idx] - starts, sizes) + np.arange(total, dtype=np.int64)
        rows = self.flat[np.ix_(src, keep64)]
        if event_feats is not None:
            nonempty = sizes > 0
            event_feats[: len(idx)][nonempty] = self.flat[self.offsets[idx][nonempty]][:, fac64]
        return rows, sizes, starts

    def _buffers(self, idx, b: int, fac64):
        """``idx`` as int64, the labels ``y``/``y_mask``, ``event_feats [b + 1,
        C]`` zeroed (None without factored columns) and ``seg_counts``."""
        k = len(idx)
        yb = np.zeros((b, 1), dtype=np.float32)
        mask = np.zeros((b,), dtype=np.float32)
        yb[:k, 0] = self.labels[idx]
        mask[:k] = 1.0
        event_feats = np.zeros((b + 1, len(fac64)), dtype=self.flat.dtype) if len(fac64) else None
        seg_counts = np.zeros((b + 1,), dtype=np.int32)
        return np.ascontiguousarray(idx, dtype=np.int64), yb, mask, event_feats, seg_counts

    def _dense_batch(self, idx, b: int, m: int, keep64, fac64) -> Batch:
        idx64, yb, mask, event_feats, seg_counts = self._buffers(idx, b, fac64)
        points = np.zeros((b, m, len(keep64)), dtype=self.flat.dtype)
        if not pack_pointcloud_dense_native(self.flat, self.offsets, idx64, b, keep64, fac64, m,
                                            points.reshape(b * m, len(keep64)), event_feats, seg_counts):
            rows, sizes, starts = self._gather(idx, keep64, fac64, event_feats)
            k, total = len(idx), len(rows)
            points[
                np.repeat(np.arange(k, dtype=np.int64), sizes),
                np.arange(total, dtype=np.int64) - np.repeat(starts, sizes),
            ] = rows
            seg_counts[:k] = sizes
            seg_counts[b] = b * m - total  # the in-row padding
        batch = {"points": points, "y": yb, "y_mask": mask, "seg_counts": seg_counts}
        if event_feats is not None:
            batch["event_feats"] = event_feats
        return batch

    def _flat_batch(self, idx, b: int, p_pad: int, keep64, fac64) -> Batch:
        idx64, yb, mask, event_feats, seg_counts = self._buffers(idx, b, fac64)
        points = np.zeros((p_pad, len(keep64)), dtype=self.flat.dtype)
        seg = np.full((p_pad,), b, dtype=np.int16 if (self.half and b < 32767) else np.int32)
        if not pack_pointcloud_native(self.flat, self.offsets, idx64, b, keep64, fac64, p_pad,
                                      points, event_feats, seg, seg_counts):
            rows, sizes, _ = self._gather(idx, keep64, fac64, event_feats)
            k, total = len(idx), len(rows)
            points[:total] = rows
            seg[:total] = np.repeat(np.arange(k), sizes)
            seg_counts[:k] = sizes
            seg_counts[b] = p_pad - total  # padding rows → segment B
        batch = {"points": points, "y": yb, "y_mask": mask}
        if event_feats is not None:
            batch["event_feats"] = event_feats
        if self.seg_encoding == "counts":
            batch["seg_counts"] = seg_counts
        else:
            batch["seg"] = seg
        return batch

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
            # stable sort by size, batch neighbours, shuffle the batch order
            order = order[np.argsort(self.counts[order], kind="stable")]
            if rng is not None:
                rng.shuffle(starts)
        fac64 = np.asarray(self.factor_event_cols, dtype=np.int64)
        keep64 = np.asarray(
            [c for c in range(self.flat.shape[1]) if c not in self.factor_event_cols],
            dtype=np.int64,
        )
        for start in starts:
            idx = order[start : start + b]
            p_pad = pow2_bucket(int(self.counts[idx].sum()), self.min_bucket, self.bucket_factor)
            if self.layout != "flat":
                m_rung = _dense_rung(int(self.counts[idx].max()) if len(idx) else 1)
                # auto: dense when the batch is large enough for the row pool
                # to pay and its rows hold no more than ~10% more points than
                # the flat bucket (the JAX loader's measured gate)
                if self.layout == "dense" or (b >= 128 and b * m_rung <= p_pad + p_pad // 10):
                    yield self._dense_batch(idx, b, m_rung, keep64, fac64)
                    continue
            yield self._flat_batch(idx, b, p_pad, keep64, fac64)


class GraphLoader:
    """Batched padded graphs on the dense wires (``layout="dense"`` or
    ``"auto"``) or the flat edge-list wire (``layout="flat"``).

    The pure flat wire keeps each graph's edges as stored, one entry per
    occurrence: ``edge_w`` is the weight (1 with ``use_weights=False``) and
    ``edge_mask`` 1 on real edges.  ``transfer_dtype="float16"`` there ships
    fp16 features, weights and masks, int16 ``node_seg`` and, up to 32,768
    rows, int16 ``src``/``dst``.

    Under ``dense``/``auto`` each graph's edges are sorted at construction by
    (destination, source) and duplicate directed edges merged: weights
    summed, multiplicities counted.  ``in_deg`` then counts each merged edge
    by its multiplicity (zero-weight edges included), so a mean divides by
    the per-occurrence in-degree.  With ``use_weights=False`` the dense
    weights are the multiplicities.  ``transfer_dtype="float16"`` ships fp16
    features and weights with int16 sources.  A flat batch of such a loader
    carries the merged edges; over a multigraph its ``edge_w`` is the merged
    weight over the multiplicity (1 with ``use_weights=False``) and its
    ``edge_mask`` the multiplicity, which keeps sums, means, max, GAT and the
    SAG score per occurrence.

    Where the JAX loader ships another wire, so does this one, with its
    warnings: ``dense_w_is_existence`` (an exact-zero wire weight) and
    ``flat_if_multigraph`` (a duplicate edge) demote the whole loader to the
    flat wire; under ``auto`` a batch over ``max_dense_bytes`` ships flat; a
    batch whose in-degree needs more than ``max_in_degree_wire`` slots ships
    the edge-slot triples, or, with ``require_inrow`` (the in-row wire
    that max aggregation needs), the flat wire, as does a batch whose
    out-degree overflows under ``emit_out_rows`` (one warning per loader).
    ``adj_wire="host"`` ships the adjacency, and under ``require_inrow``
    demotes the loader to the flat wire.

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
        if seg_encoding not in ("ids", "counts"):
            raise ValueError("seg_encoding must be 'ids' or 'counts'")
        self.require_inrow = bool(require_inrow)
        self._warned_inrow_fallback = False
        if self.require_inrow and layout in ("dense", "auto") and adj_wire == "host":
            warnings.warn(
                "GraphLoader(require_inrow=True): the host adjacency wire "
                "never carries in-row lists — demoting layout to 'flat'",
                stacklevel=2,
            )
            layout = "flat"
        self.layout = layout
        self.adj_wire = adj_wire
        self.min_edge_bucket_dense = min_edge_bucket_dense
        self.seg_encoding = seg_encoding
        self.min_node_bucket = min_node_bucket
        self.min_edge_bucket = min_edge_bucket
        # the out-rows belong to the dense wire: the flat one never ships them
        self.emit_out_rows = bool(emit_out_rows) and layout != "flat"
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
        self.batch_size = int(batch_size) if batch_size else len(labels)
        self.shuffle = shuffle
        self.use_weights = use_weights
        self.seed = seed
        self._epoch = 0
        if layout == "flat":
            # the edges as stored: no sort, no merge, multiplicity 1 each
            self.edges_src, self.edges_dst, self.weights = src, dst, weights
            self.edge_counts = edge_counts
            self.edge_offsets = np.ascontiguousarray(
                np.concatenate([[0], np.cumsum(edge_counts)]), dtype=np.int64
            )
            self.edge_mult = np.ones(len(weights), dtype=np.float32)
            self.weights_wire = weights.astype(np.float16) if self.half else weights
            self.mult_wire = self.edge_mult.astype(np.float16) if self.half else self.edge_mult
            self.flat_fallback_w = None
            return

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
        # a flat batch of a merged multigraph: the merged weight over the
        # multiplicity, and the multiplicity as the mask, restore the
        # per-occurrence semantics of the pure flat wire
        multigraph = bool((self.edge_mult > 1).any())
        self.flat_fallback_w = None
        if multigraph:
            self.flat_fallback_w = np.ascontiguousarray(
                (self.weights / self.edge_mult).astype(self.weights_wire.dtype)
                if use_weights
                else np.ones_like(self.mult_wire)
            )
        # the dense wire encodes existence as w != 0: a weighted dataset with
        # an exact-zero wire weight would lose that edge from dense attention
        if dense_w_is_existence and use_weights and bool((self.weights_wire == 0).any()):
            warnings.warn(
                "GraphLoader: dataset contains an exact-zero edge weight; "
                "dense attention would drop that edge (existence is w != 0)"
                " — demoting layout to 'flat' for exactness",
                stacklevel=2,
            )
            self.layout = "flat"
        # dense attention and the dense SAG score count a merged edge once
        # where the flat wire counts each occurrence
        if flat_if_multigraph and self.layout != "flat" and multigraph:
            warnings.warn(
                "GraphLoader: dataset contains duplicate directed edges; "
                "dense attention/SAG-score semantics count a merged edge "
                "once where the flat path counts each occurrence — "
                "demoting layout to 'flat' for exactness",
                stacklevel=2,
            )
            self.layout = "flat"

    @property
    def n_examples(self) -> int:
        return len(self.labels)

    def __len__(self) -> int:
        return -(-self.n_examples // self.batch_size)

    def _max_slots(self, idx, per_graph) -> int:
        """The list width D of the graphs ``idx`` for a per-graph max degree."""
        return _pow2_slots(int(per_graph[idx].max()) if int(self.edge_counts[idx].sum()) else 0)

    def _dense_nodes(self, idx, k: int, b: int, m_pad: int) -> Batch:
        """``nodes`` and ``node_mask`` zeroed (a packer fills them), and
        ``in_deg``, ``y`` and ``y_mask`` of the graphs ``idx`` in ``b``
        slots of ``m_pad`` rows: what every dense wire ships."""
        nodes = np.zeros((b, m_pad, self.feat_dim), dtype=self.feats.dtype)
        node_mask = np.zeros((b, m_pad), dtype=np.float32)
        in_deg = np.zeros((b, m_pad), dtype=np.float32)
        yb = np.zeros((b, 1), dtype=np.float32)
        ymask = np.zeros((b,), dtype=np.float32)
        yb[:k, 0] = self.labels[idx]
        ymask[:k] = 1.0
        for slot, g_i in enumerate(idx):
            nlo, nhi = self.node_offsets[g_i], self.node_offsets[g_i + 1]
            in_deg[slot, : nhi - nlo] = self.node_indeg[nlo:nhi]
        return {"nodes": nodes, "node_mask": node_mask, "in_deg": in_deg, "y": yb, "y_mask": ymask}

    def _fill_nodes(self, idx, batch: Batch) -> None:
        """The numpy branch of the node rows: each graph's features and mask
        at the start of its slot."""
        for slot, g_i in enumerate(idx):
            nlo, nhi = self.node_offsets[g_i], self.node_offsets[g_i + 1]
            batch["nodes"][slot, : nhi - nlo] = self.feats[nlo:nhi]
            batch["node_mask"][slot, : nhi - nlo] = 1.0

    def _dense_wire_batch(self, idx, k: int, b: int, m_pad: int) -> Batch:
        """The dense wire of the graphs ``idx`` in ``b`` slots of ``m_pad``
        rows with the adjacency made on the device: the in-row lists
        ``in_src``/``in_w`` (and with ``emit_out_rows`` the out-row mirror),
        or, where they would need more than ``max_in_degree_wire`` slots, the
        edge-slot triples."""
        idx_t = np.int16 if (self.half and m_pad <= 32768) else np.int32
        d_pad = self._max_slots(idx, self.graph_max_indeg)
        batch = self._dense_nodes(idx, k, b, m_pad)
        wire_w = self.weights_wire if self.use_weights else self.mult_wire
        if d_pad > self.max_in_degree_wire:
            self._fill_nodes(idx, batch)  # numpy here, as in the JAX loader
            return {**batch, **self._edge_slots(idx, b, idx_t, wire_w)}
        batch["in_src"], batch["in_w"] = self._pack_rows(
            idx, b, m_pad, d_pad, self.edges_dst,
            [(self.edges_src, idx_t), (wire_w, wire_w.dtype)], fill=batch,
        )
        if self.emit_out_rows:
            # the OUT-row mirror (the transposed adjacency), read by the fused
            # aggregation's backward; a batch whose out-degree needs more
            # slots than the wire allows ships none, as in the JAX loader
            do_pad = self._max_slots(idx, self.graph_max_outdeg)
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

    def _edge_slots(self, idx, b: int, idx_t, wire_w) -> Batch:
        """The edge-slot triples of the graphs ``idx``: each merged edge's
        slot, local destination and source and its wire weight, in the
        stored (graph, destination, source) order, strictly ascending, then
        padding at the out-of-range slot ``b``."""
        spans = [(self.edge_offsets[g_i], self.edge_offsets[g_i + 1]) for g_i in idx]
        total = sum(int(hi - lo) for lo, hi in spans)
        e_pad = pow2_bucket(max(total, 1), self.min_edge_bucket_dense)
        slot_t = np.int16 if (self.half and b < 32767) else np.int32
        out = {
            "edge_src": np.zeros((e_pad,), dtype=idx_t),
            "edge_dst": np.zeros((e_pad,), dtype=idx_t),
            "edge_slot": np.full((e_pad,), b, dtype=slot_t),
            "edge_w": np.zeros((e_pad,), dtype=wire_w.dtype),
        }
        cursor = 0
        for slot, (lo, hi) in enumerate(spans):
            end = cursor + int(hi - lo)
            out["edge_src"][cursor:end] = self.edges_src[lo:hi]
            out["edge_dst"][cursor:end] = self.edges_dst[lo:hi]
            out["edge_slot"][cursor:end] = slot
            out["edge_w"][cursor:end] = wire_w[lo:hi]
            cursor = end
        return out

    def _host_dense_batch(self, idx, k: int, b: int, m_pad: int) -> Batch:
        """``adj_wire="host"``: the adjacency ``adj [B, M, M]`` itself, row
        ``i`` holding node ``i``'s incoming (merged) weights, or
        multiplicities with ``use_weights=False``."""
        batch = self._dense_nodes(idx, k, b, m_pad)
        small_t = np.float16 if self.half else np.float32
        adj = np.zeros((b, m_pad, m_pad), dtype=small_t)
        per_edge = self.weights if self.use_weights else self.edge_mult
        if not pack_graph_dense_native(
            self.feats, self.node_offsets, self.edges_src, self.edges_dst, self.edge_offsets,
            per_edge, True, np.ascontiguousarray(idx, dtype=np.int64), b, m_pad,
            batch["nodes"], adj, batch["node_mask"],
        ):
            self._fill_nodes(idx, batch)
            for slot, g_i in enumerate(idx):
                lo, hi = self.edge_offsets[g_i], self.edge_offsets[g_i + 1]
                np.add.at(adj[slot], (self.edges_dst[lo:hi], self.edges_src[lo:hi]),
                          per_edge[lo:hi].astype(small_t))
        return {**batch, "adj": adj}

    def _flat_batch(self, idx, k: int, b: int) -> Batch:
        """The flat edge-list wire for the graphs ``idx`` in ``b`` slots."""
        total_nodes = int(self.node_counts[idx].sum())
        total_edges = int(self.edge_counts[idx].sum())
        n_pad = pow2_bucket(total_nodes + 1, self.min_node_bucket)
        e_pad = pow2_bucket(max(total_edges, 1), self.min_edge_bucket)
        seg_dtype = np.int16 if (self.half and b < 32767) else np.int32
        idx_dtype = np.int16 if (self.half and n_pad <= 32768) else np.int32
        small_dtype = np.float16 if self.half else np.float32
        nodes = np.zeros((n_pad, self.feat_dim), dtype=self.feats.dtype)
        node_seg = np.full((n_pad,), b, dtype=seg_dtype)
        # padded edges self-loop on the last (always padding) node
        src = np.full((e_pad,), n_pad - 1, dtype=idx_dtype)
        dst = np.full((e_pad,), n_pad - 1, dtype=idx_dtype)
        edge_w = np.zeros((e_pad,), dtype=small_dtype)
        edge_mask = np.zeros((e_pad,), dtype=small_dtype)
        yb = np.zeros((b, 1), dtype=np.float32)
        ymask = np.zeros((b,), dtype=np.float32)
        seg_counts = np.zeros((b + 1,), dtype=np.int32)
        wire_w = self.weights_wire if self.use_weights else self.mult_wire
        mask_w = None
        if self.flat_fallback_w is not None:
            wire_w, mask_w = self.flat_fallback_w, self.mult_wire
        if not pack_graph_flat_native(
            self.feats, self.node_offsets, self.edges_src, self.edges_dst, self.edge_offsets,
            wire_w, True, np.ascontiguousarray(idx, dtype=np.int64), b, n_pad, e_pad,
            nodes, node_seg, seg_counts, src, dst, edge_w, edge_mask, mask_w,
        ):
            node_cursor = edge_cursor = 0
            for slot, g_i in enumerate(idx):
                nlo, nhi = self.node_offsets[g_i], self.node_offsets[g_i + 1]
                elo, ehi = self.edge_offsets[g_i], self.edge_offsets[g_i + 1]
                n_i, e_i = nhi - nlo, ehi - elo
                nodes[node_cursor : node_cursor + n_i] = self.feats[nlo:nhi]
                node_seg[node_cursor : node_cursor + n_i] = slot
                seg_counts[slot] = n_i
                src[edge_cursor : edge_cursor + e_i] = self.edges_src[elo:ehi] + node_cursor
                dst[edge_cursor : edge_cursor + e_i] = self.edges_dst[elo:ehi] + node_cursor
                edge_w[edge_cursor : edge_cursor + e_i] = wire_w[elo:ehi]
                edge_mask[edge_cursor : edge_cursor + e_i] = 1.0 if mask_w is None else mask_w[elo:ehi]
                node_cursor += n_i
                edge_cursor += e_i
            seg_counts[b] = n_pad - node_cursor  # padding nodes → segment B
        yb[:k, 0] = self.labels[idx]
        ymask[:k] = 1.0
        batch = {
            "nodes": nodes,
            "src": src,
            "dst": dst,
            "edge_w": edge_w,
            "edge_mask": edge_mask,
            "y": yb,
            "y_mask": ymask,
        }
        if self.seg_encoding == "counts":
            batch["node_seg_counts"] = seg_counts
        else:
            batch["node_seg"] = node_seg
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

    def _pack_rows(self, idx, b, m_pad, d_pad, keys, columns, fill=None):
        """``[B, M, D]`` per-row lists, one for each ``(per-edge array, wire
        dtype)`` of ``columns``: slot ``q`` of row ``keys[e]`` holds the row's
        ``q``-th edge's entry of each array.  ``keys`` is run-sorted within
        each graph: the destinations of the (destination, source) order give
        the in-row lists, the sources of the out-direction order the out-row
        mirror.  ``columns`` are an index column, the wire weights, then any
        more index columns; ``fill``, a batch from ``_dense_nodes``, also
        gets its node rows.

        The C++ packer makes one pass for the first two columns and one for
        each further one (the out-row mirror: ``out_dst``/``out_w``, then
        ``out_pos``); the numpy branch one pass for all."""
        packed = [np.zeros((b, m_pad, d_pad), dtype=dtype) for _, dtype in columns]
        (values, _), (weights, _) = columns[:2]
        idx64 = np.ascontiguousarray(idx, dtype=np.int64)
        nodes, node_mask = (fill["nodes"], fill["node_mask"]) if fill else (None, None)

        def native(per_edge, out, out_w, fill_nodes):
            return pack_graph_inrow_native(
                self.feats, self.node_offsets, per_edge, keys, self.edge_offsets, weights, True,
                idx64, b, m_pad, d_pad, nodes, node_mask, out, out_w, fill_nodes,
            )

        if native(values, packed[0], packed[1], fill is not None):
            for (more, _), out in zip(columns[2:], packed[2:]):
                native(more, out, None, False)
            return packed
        if fill is not None:
            self._fill_nodes(idx, fill)
        spans = [(self.edge_offsets[g_i], self.edge_offsets[g_i + 1]) for g_i in idx]
        key_l = np.concatenate(
            [keys[lo:hi].astype(np.int64) + slot * m_pad for slot, (lo, hi) in enumerate(spans)]
        )
        # slot q of a row holds its q-th edge in the sorted order
        counts = np.bincount(key_l, minlength=b * m_pad)
        starts = np.concatenate([[0], np.cumsum(counts)])
        pos = np.arange(len(key_l)) - starts[key_l]
        for (per_edge, _), out in zip(columns, packed):
            out.reshape(b * m_pad, d_pad)[key_l, pos] = np.concatenate(
                [per_edge[lo:hi] for lo, hi in spans]
            )
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
            if self.layout != "flat":
                m_pad = max(self.min_dense_nodes, _dense_rung(int(self.node_counts[idx].max())))
                m_pad = -(-m_pad // 8) * 8
                dense_bytes = b * m_pad * m_pad * itemsize
                inrow_ok = not self.require_inrow or self._inrow_fits(idx)
                if dense_bytes <= self.max_dense_bytes and inrow_ok:
                    dense = self._dense_wire_batch if self.adj_wire == "device" else self._host_dense_batch
                    yield dense(idx, len(idx), b, m_pad)
                    continue
                if self.layout == "dense" and inrow_ok:
                    raise ValueError(
                        f"dense graph batch needs {dense_bytes/2**20:.0f} MB "
                        f"(B={b}, M={m_pad}) > max_dense_bytes "
                        f"{self.max_dense_bytes/2**20:.0f} MB; use "
                        "layout='auto' to fall back to the flat layout"
                    )
            yield self._flat_batch(idx, len(idx), b)

    def _inrow_fits(self, idx) -> bool:
        """``require_inrow``: whether the graphs ``idx`` fit the in-row wire
        (and the out-row mirror under ``emit_out_rows``); a batch that does
        not ships flat, with one warning per loader."""
        fits = self._max_slots(idx, self.graph_max_indeg) <= self.max_in_degree_wire
        if fits and self.emit_out_rows:
            fits = self._max_slots(idx, self.graph_max_outdeg) <= self.max_in_degree_wire
        if not fits and not self._warned_inrow_fallback:
            warnings.warn(
                "GraphLoader(require_inrow=True): a batch's "
                "in/out-degree overflows max_in_degree_wire "
                f"({self.max_in_degree_wire}) — shipping the "
                "flat layout for such batches",
                stacklevel=3,
            )
            self._warned_inrow_fallback = True
        return fits

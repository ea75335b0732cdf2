"""Static-shape, bucketed point-cloud batches on the flat wire (numpy).

Counterpart of the flat branch of
``point_cloud_classifier_tpu/data/batching.py``, which the port cannot
import (its package ``__init__`` pulls in jax, pandas and h5py).  Batches are
byte-identical to the JAX loader's: ``points [P_pad, F]`` with events
contiguous and padding rows at the end, labels ``y [B, 1]`` with ``y_mask
[B]``, and either ``seg [P_pad]`` (event index per point, padding rows get
``B``) or ``seg_counts [B + 1]`` (points per event, padding count last).
``P_pad`` is a power-of-two bucket, so the model sees a small set of shapes.

Packing is the JAX loader's pure-Python branch.  Not ported yet: its C++
packer, the dense per-cloud-row layout, ``factor_event_cols``, the fp16
wire, length-sorted batching and non-power-of-two bucket ladders.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

Batch = Dict[str, np.ndarray]


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
    one contiguous array plus offsets."""

    def __init__(
        self,
        event_features: Sequence[np.ndarray],
        labels: np.ndarray,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        min_bucket: int = 256,
        seg_encoding: str = "ids",
    ):
        if seg_encoding not in ("ids", "counts"):
            raise ValueError("seg_encoding must be 'ids' or 'counts'")
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

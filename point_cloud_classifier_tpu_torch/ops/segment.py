"""Segment reductions over the flat point wire.

Counterpart of ``point_cloud_classifier_tpu/ops/segment.py``.  Segment ids
index rows of a ``[num_segments, ...]`` output; the loaders give padding
points the id ``B``, so ``num_segments = B + 1`` isolates them.  The JAX
package wrote these as one-hot contractions because they suited the TPU;
here they are PyTorch's scatter ops, held to the same values.  Ids must lie
in ``[0, num_segments)``.
"""

from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets (in data's dtype)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_count(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """f32 number of elements per segment."""
    ones = torch.ones(
        segment_ids.shape, dtype=torch.float32, device=segment_ids.device
    )
    return segment_sum(ones, segment_ids, num_segments)


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment elementwise max; empty segments give 0 (a -inf would
    poison the masked loss downstream)."""
    shape = (num_segments,) + tuple(data.shape[1:])
    index = segment_ids.long().reshape((-1,) + (1,) * (data.ndim - 1))
    out = torch.full(shape, float("-inf"), dtype=data.dtype, device=data.device)
    out.scatter_reduce_(0, index.expand_as(data), data, reduce="amax")
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def spread_by_segment(
    values: torch.Tensor, segment_ids: torch.Tensor, dtype: torch.dtype = None
) -> torch.Tensor:
    """Per-segment rows ``[S, C]`` → per-element rows ``[N, C]`` in ``dtype``
    (the values' own by default): row ``i`` is ``values[segment_ids[i]]``,
    cast.  Exact, as the JAX package's one-hot product is: each output row is
    one value."""
    values = values if dtype is None else values.to(dtype)
    return values.index_select(0, segment_ids.long())


def counts_to_segment_ids(counts: torch.Tensor, total: int) -> torch.Tensor:
    """Per-segment counts ``[S]`` → sorted int32 ids ``[total]``: the id of
    element ``i`` is the number of cumulative segment ends ``≤ i``."""
    ends = counts.to(torch.int64).cumsum(0)
    i = torch.arange(total, dtype=torch.int64, device=counts.device)
    return torch.searchsorted(ends, i, right=True).to(torch.int32)

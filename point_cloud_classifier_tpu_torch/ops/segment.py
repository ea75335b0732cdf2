"""Segment reductions over the flat point wire.

Counterpart of ``point_cloud_classifier_tpu/ops/segment.py``.  Segment ids
index rows of a ``[num_segments, ...]`` output; the loaders give padding
points the id ``B``, so ``num_segments = B + 1`` isolates them.  The JAX
package wrote these as one-hot contractions because they suited the TPU;
here they are PyTorch's scatter ops, held to the same values.  Ids must lie
in ``[0, num_segments)``.

The graph wire's flat edge lists use the rest: :func:`segment_softmax` (GAT
attention over each node's incoming edges), :func:`segment_rank_desc` (SAG
pooling's per-graph top-k) and :func:`segment_count` with a validity mask.

Every op writes out of place into a fresh buffer, so it runs under
``torch.func.vmap`` over a sweep's arms, where the values carry an arm axis
and the ids (the shared batch's) do not; no op reads a value to the host.
"""

from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets (in data's dtype)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    # out of place: under torch.func.vmap the data may carry an arm axis
    # that the fresh buffer has not
    return out.index_add(0, segment_ids.long(), data)


def segment_count(
    segment_ids: torch.Tensor, num_segments: int, valid: torch.Tensor = None
) -> torch.Tensor:
    """f32 number of elements per segment; with ``valid``, the sum of each
    segment's ``valid`` values (0/1 masks count the kept elements)."""
    ones = torch.ones(
        segment_ids.shape, dtype=torch.float32, device=segment_ids.device
    )
    if valid is not None:
        ones = ones * valid
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment mean in ``data``'s dtype, empty segments 0: the sum
    divided in f32 by the count floored at 1, then cast once.  Integer data
    therefore truncates towards zero, as the JAX package's does."""
    total = segment_sum(data, segment_ids, num_segments)
    counts = torch.clamp(segment_count(segment_ids, num_segments), min=1.0)
    out = total.float() / counts.reshape((-1,) + (1,) * (total.ndim - 1))
    return out.to(total.dtype)


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment elementwise max; empty segments give 0 (a -inf would
    poison the masked loss downstream)."""
    shape = (num_segments,) + tuple(data.shape[1:])
    index = segment_ids.long().reshape((-1,) + (1,) * (data.ndim - 1))
    out = torch.full(shape, float("-inf"), dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(0, index.expand_as(data), data, reduce="amax")
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


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    valid: torch.Tensor = None,
) -> torch.Tensor:
    """Softmax of ``logits`` within each segment, in their dtype.  ``valid``
    (broadcast against the logits) leaves masked elements out of both the
    max and the sum: they are filled with ``finfo.min`` and give 0.  A
    segment's max that is not finite counts as 0, and the denominator is
    floored at ``finfo.tiny``, so a segment with no valid element gives 0s."""
    info = torch.finfo(logits.dtype)
    masked = logits if valid is None else torch.where(valid > 0, logits, info.min)
    seg_max = segment_max(masked, segment_ids, num_segments)  # non-finite → 0
    ids = segment_ids.long()
    exp = torch.exp(masked - seg_max.index_select(0, ids))
    if valid is not None:
        exp = exp * valid
    denom = torch.clamp(segment_sum(exp, segment_ids, num_segments), min=info.tiny)
    return exp / denom.index_select(0, ids)


def segment_rank_desc(
    score: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    valid: torch.Tensor,
) -> torch.Tensor:
    """int32 rank of each element within its segment by descending score (0
    the highest); ties break by element index and invalid elements rank
    after every valid one.  The order is the JAX package's ``jnp.lexsort``
    over (segment, key), the key ``-score`` on valid elements and
    ``finfo.max`` on invalid ones, built from two stable sorts: by key, then
    by segment."""
    n = score.shape[0]
    key = torch.where(valid > 0, -score, torch.finfo(score.dtype).max)
    by_key = torch.sort(key, stable=True).indices
    order = by_key[torch.sort(segment_ids[by_key], stable=True).indices]
    seg_sorted = segment_ids.long()[order]
    idx = torch.arange(n, device=score.device)
    # the first sorted position of each segment: its count's exclusive prefix
    # sum (the ids' own counts: sorting permutes them), summed on the device
    # without reading the largest id back (bincount would: a CUDA graph of
    # the train step cannot hold that)
    ids = segment_ids.long()
    counts = torch.zeros(num_segments, dtype=torch.long, device=score.device).index_add(
        0, ids, torch.ones_like(ids))
    first = torch.cumsum(counts, 0) - counts
    # a scatter, not an indexed store: under torch.func.vmap the order
    # carries an arm axis that the fresh buffer has not
    ranks = torch.zeros(n, dtype=torch.int32, device=score.device)
    return ranks.scatter(0, order, (idx - first[seg_sorted]).to(torch.int32))

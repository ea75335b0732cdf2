"""The dense graph wire's in-row lists → a batched adjacency (plain PyTorch).

Counterpart of ``inrow_adjacency_xla`` in
``point_cloud_classifier_tpu/ops/inrow_graph.py``.  ``in_src``/``in_w
[B, M, D]`` hold each node's incoming-edge sources and weights
(``data/batching.GraphLoader``); row ``i`` of the adjacency holds node
``i``'s incoming-edge weights.  It is built by D compare passes, as in the
JAX package: padding slots carry ``w = 0`` and add nothing wherever they
point, and a source outside ``[0, M)`` matches no column.

Not ported yet: the fused in-row aggregation kernel K6
(``_inrow_aggregate_impl``, opt-in ``GraphNet(fused_inrow=True)``) and
``inrow_max_aggregate`` (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch


def inrow_adjacency(
    in_src: torch.Tensor, in_w: torch.Tensor, m: int, dtype: torch.dtype
) -> torch.Tensor:
    """``[B, M, M]`` adjacency of ``dtype`` from the in-row lists, summed
    slot by slot in ``dtype`` as the JAX version sums them."""
    src = in_src.long()
    w = in_w.to(dtype)
    iota = torch.arange(m, device=in_src.device)
    adj = torch.zeros((in_src.shape[0], in_src.shape[1], m), dtype=dtype, device=in_src.device)
    for d in range(in_src.shape[-1]):
        adj = adj + (src[:, :, d, None] == iota).to(dtype) * w[:, :, d, None]
    return adj

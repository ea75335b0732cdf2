"""The dense graph wire's in-row lists: the batched adjacency, and the fused
neighbour aggregation — plain PyTorch, and kernel K6.

Counterpart of ``point_cloud_classifier_tpu/ops/inrow_graph.py``.
``in_src``/``in_w [B, M, D]`` hold each node's incoming-edge sources and
weights (``data/batching.GraphLoader``); row ``i`` of the adjacency holds node
``i``'s incoming-edge weights.

- :func:`inrow_adjacency` (``inrow_adjacency_xla``) builds the adjacency by D
  compare passes, as in the JAX package: padding slots carry ``w = 0`` and add
  nothing wherever they point, and a source outside ``[0, M)`` matches no
  column;
- :func:`inrow_aggregate_plain` (``inrow_aggregate_xla``) is the semantics
  contract of the aggregation: the adjacency in ``h``'s dtype, the product
  ``adj @ h`` summed in f32, ``mean`` divided by the count of ``in_w != 0``
  floored at 1, the output in ``h``'s dtype.  It is the CPU path and what K6
  is held to on the card;
- :func:`inrow_aggregate` is the entry point, an autograd Function
  (``inrow_aggregate``'s ``custom_vjp``).  Forward: the aggregation over the
  in-row lists.  Backward: ``adjᵀ @ g`` is the same aggregation over the
  OUT-row lists (``out_dst``/``out_w``, each node's outgoing edges, from
  ``GraphLoader(emit_out_rows=True)``), always ``"add"``; for ``"mean"`` the
  cotangent is divided by the forward degree first.  On a CUDA tensor both
  directions launch ``csrc/inrow_aggregate.cu`` (K6, which replaces the TPU
  kernel of ``_inrow_aggregate_impl``) or raise; on a CPU tensor, or inside
  ``force_plain``, both take :func:`inrow_aggregate_plain`.
  ``inrow_aggregate.launches`` counts K6's forward launches and
  ``inrow_aggregate.bwd_launches`` its backward ones.  The cotangent of
  ``in_w`` (a row gather and a dot) is plain PyTorch, computed only when
  ``in_w`` requires a gradient.

The TPU kernel's power-of-two ``M`` and row-tile rules are VMEM limits and do
not carry over: K6 takes any ``M`` and any ``D`` up to 32.

Not ported yet: ``inrow_gather`` and ``inrow_max_aggregate`` (ROADMAP Queue
1, GraphNet slice 2).
"""

from __future__ import annotations

import torch

from point_cloud_classifier_tpu_torch.ops.dispatch import use_cuda_kernels

# the wire's list types and the dtype codes of the C entries, shared with ops/gat.py
_MAX_SLOTS = 32  # csrc/graph_rows.cuh kMaxSlots: one lane per slot
_H_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SRC_CODES = {torch.int32: 0, torch.int16: 1}
_W_CODES = {torch.float32: 0, torch.float16: 1}


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


def _check_aggr(aggr: str) -> None:
    if aggr not in ("add", "mean"):
        # loud: the weighted sum "works" for any string, and GraphNet passes
        # local_pooling straight through
        raise ValueError(f"inrow_aggregate supports 'add'/'mean', got {aggr!r}")


def _degree(in_w: torch.Tensor) -> torch.Tensor:
    """``[B, M, 1]`` f32 count of nonzero weights per row, floored at 1."""
    return torch.clamp((in_w != 0).float().sum(dim=2), min=1.0)[..., None]


def inrow_aggregate_plain(h, in_src, in_w, aggr: str = "add"):
    """``adj @ h`` over the adjacency of the in-row lists, ``[B, M, H]`` in
    ``h``'s dtype: the plain version of K6."""
    _check_aggr(aggr)
    adj = inrow_adjacency(in_src, in_w, h.shape[1], h.dtype)
    out = torch.matmul(adj.float(), h.float())
    if aggr == "mean":
        out = out / _degree(in_w)
    return out.to(h.dtype)


class _InrowAggregateFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, in_src, in_w, out_dst, out_w, aggr):
        # h is an activation per convolution and only in_w's cotangent reads it
        keep_h = h if ctx.needs_input_grad[2] else None
        ctx.save_for_backward(keep_h, in_src, in_w, out_dst, out_w)
        ctx.aggr = aggr
        return _aggregate(h, in_src, in_w, aggr, backward=False)

    @staticmethod
    def backward(ctx, g):
        h, in_src, in_w, out_dst, out_w = ctx.saved_tensors
        if out_dst is None or out_w is None:
            raise ValueError(
                "inrow_aggregate backward needs the out-row lists "
                "(out_dst/out_w); GraphLoader(emit_out_rows=True) ships them"
            )
        if ctx.aggr == "mean":
            # out = (A @ h) / deg with deg piecewise-constant in the weights,
            # so the division folds into the upstream cotangent once
            g = (g.float() / _degree(in_w)).to(g.dtype)
        dh = din_w = None
        if ctx.needs_input_grad[0]:
            # adjᵀ @ g: the same aggregation over the out-row lists, always "add"
            dh = _aggregate(g, out_dst, out_w, "add", backward=True)
        if ctx.needs_input_grad[2]:
            # d out[b, i] / d in_w[b, i, d] = h[b, src_d]: a row gather and a dot
            src = in_src.long().clamp(0, h.shape[1] - 1)
            rows = torch.arange(h.shape[0], device=h.device)[:, None, None]
            gathered = h[rows, src].float()  # [B, M, D, H]
            din_w = (gathered * g.float()[:, :, None, :]).sum(dim=-1).to(in_w.dtype)
        return dh, None, din_w, None, None, None


def inrow_aggregate(h, in_src, in_w, out_dst=None, out_w=None, aggr: str = "add"):
    """Fused in-row neighbour aggregation ``[B, M, H]`` in ``h``'s dtype,
    differentiable in ``h`` and ``in_w``.  ``out_dst``/``out_w`` only route
    the backward; pass ``None`` for inference-only use (a backward then
    raises)."""
    _check_aggr(aggr)
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"inrow_aggregate takes CPU or CUDA tensors, got {h.device}")
    return _InrowAggregateFn.apply(h, in_src, in_w, out_dst, out_w, aggr)


inrow_aggregate.launches = 0
inrow_aggregate.bwd_launches = 0


def _aggregate(h, src, w, aggr: str, backward: bool):
    """One aggregation over ``(src, w)``: K6 on a CUDA tensor, the plain
    version on a CPU one (or inside ``force_plain``)."""
    if not use_cuda_kernels(h):
        return inrow_aggregate_plain(h, src, w, aggr)
    return _inrow_aggregate_cuda(h, src, w, aggr, backward)


def _check_operands(h, in_src, in_w):
    """Raise on anything K6 does not take."""
    if h.dtype not in _H_CODES:
        raise TypeError(f"K6 takes f32 or bf16 h, got {h.dtype}")
    if in_src.dtype not in _SRC_CODES or in_w.dtype not in _W_CODES:
        raise TypeError(
            f"K6 takes int32/int16 sources and f32/f16 weights, got {in_src.dtype} "
            f"and {in_w.dtype}"
        )
    if h.ndim != 3 or in_src.ndim != 3:
        raise ValueError("K6 takes [B, M, H] features and [B, M, D] lists")
    if tuple(in_src.shape[:2]) != tuple(h.shape[:2]) or in_w.shape != in_src.shape:
        raise ValueError(
            f"K6 shapes disagree: h {tuple(h.shape)}, sources {tuple(in_src.shape)}, "
            f"weights {tuple(in_w.shape)}"
        )
    if in_src.shape[-1] > _MAX_SLOTS:
        raise ValueError(f"K6 takes at most {_MAX_SLOTS} slots per row, got {in_src.shape[-1]}")
    if in_src.device != h.device or in_w.device != h.device:
        raise ValueError("K6's operands must all lie on one device")


def _inrow_aggregate_cuda(h, in_src, in_w, aggr: str = "add", backward: bool = False):
    """K6: the CUDA counterpart of :func:`inrow_aggregate_plain`, same
    contract.  ``backward`` only says which launch count the launch adds to."""
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    _check_aggr(aggr)
    _check_operands(h, in_src, in_w)
    out = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    if h.numel() == 0:
        return out
    h, in_src, in_w = h.contiguous(), in_src.contiguous(), in_w.contiguous()
    b, m, width = h.shape
    lib = kernel_library().lib
    with torch.cuda.device(h.device):
        code = lib.pcc_inrow_aggregate(
            h.data_ptr(),
            in_src.data_ptr(),
            in_w.data_ptr(),
            out.data_ptr(),
            b,
            m,
            in_src.shape[-1],
            width,
            int(aggr == "mean"),
            _H_CODES[h.dtype],
            _SRC_CODES[in_src.dtype],
            _W_CODES[in_w.dtype],
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    check(code)
    if backward:
        inrow_aggregate.bwd_launches += 1
    else:
        inrow_aggregate.launches += 1
    return out

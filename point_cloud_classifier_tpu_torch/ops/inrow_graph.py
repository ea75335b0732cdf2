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
  ``inrow_aggregate.bwd_launches`` its backward ones.  Under
  ``torch.func.vmap`` (a sweep's arms) each arm launches K6 on its own, both
  ways.  The cotangent of
  ``in_w`` (a row gather and a dot) is plain PyTorch, computed only when
  ``in_w`` requires a gradient.

The TPU kernel's power-of-two ``M`` and row-tile rules are VMEM limits and do
not carry over: K6 takes any ``M``, any ``D`` up to 32 and any width.
:func:`aggregate_form` is where the host chooses how K6 lays a shape out on
a warp: two neighbouring 16-byte pieces of a row a lane (8 f32 or 16 bf16
channels) where the row has two or more such pieces, else two channels a
lane; a node takes the least power of two of lanes that covers its row, up
to 32, and a warp serves 32 / that many nodes.  Width 128: 16 lanes a node
in f32 (two nodes a warp), 8 in bf16 (four); width 4 (conv1's input
features): 2 lanes a node, 16 nodes a warp, in both.

Max aggregation, which no adjacency product gives, is plain PyTorch, as in
the JAX package (no TPU kernel serves it):

- :func:`inrow_max_aggregate`: ``max_d in_w·h[src_d]`` over the slots with
  ``in_w != 0``, 0 on a row whose slots are all masked, folded slot by slot
  with ``torch.maximum`` in the JAX package's order.  A tie therefore splits
  its gradient as ``jnp.maximum`` splits it, half to each side at each fold
  (an ``amax`` over the slots would give 1/n to each of n ties);
- :func:`inrow_gather`: the per-slot row gather ``values[b, in_src[b, i,
  d]]``, an autograd Function whose backward is a gather over the out-row
  mirror (``out_dst``, ``out_pos``, ``out_w != 0``), never a scatter.
"""

from __future__ import annotations

import torch

from point_cloud_classifier_tpu_torch.ops.dispatch import (
    per_arm,
    require_plain_tensors,
    use_cuda_kernels,
)

# the wire's list types and the dtype codes of the C entries, shared with ops/gat.py
_MAX_SLOTS = 32  # csrc/graph_rows.cuh kMaxSlots: one lane per slot
_H_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SRC_CODES = {torch.int32: 0, torch.int16: 1}
_W_CODES = {torch.float32: 0, torch.float16: 1}


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def aggregate_form(width: int, dtype: torch.dtype, aligned: bool = True) -> tuple[int, int]:
    """``(channels a piece, lanes a node)`` of K6 for rows of ``width``
    values of ``dtype``: 16-byte pieces where the row splits into two or
    more of them and lies at a 16-byte address (``aligned``), else one
    channel a piece; two neighbouring pieces a lane, over the least power of
    two of lanes that covers the row, at most 32 (a wider row takes several
    turns)."""
    vec = 16 // dtype.itemsize
    if width % vec or width < 2 * vec or not aligned:
        vec = 1
    return vec, min(32, _pow2_at_least(-(-width // vec // 2)))


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
    def forward(h, in_src, in_w, out_dst, out_w, aggr):
        return _aggregate(h, in_src, in_w, aggr, backward=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, in_src, in_w, out_dst, out_w, aggr = inputs
        # h is an activation per convolution and only in_w's cotangent reads it
        keep_h = h if ctx.needs_input_grad[2] else None
        ctx.save_for_backward(keep_h, in_src, in_w, out_dst, out_w)
        ctx.aggr = aggr

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
            dh = _AggregateFn.apply(g, out_dst, out_w, "add", True)
        if ctx.needs_input_grad[2]:
            # d out[b, i] / d in_w[b, i, d] = h[b, src_d]: a row gather and a dot
            src = in_src.long().clamp(0, h.shape[1] - 1)
            rows = torch.arange(h.shape[0], device=h.device)[:, None, None]
            gathered = h[rows, src].float()  # [B, M, D, H]
            din_w = (gathered * g.float()[:, :, None, :]).sum(dim=-1).to(in_w.dtype)
        return dh, None, din_w, None, None, None

    @staticmethod
    def vmap(info, in_dims, h, in_src, in_w, out_dst, out_w, aggr):
        def one(a, b, c, d, e):
            return _InrowAggregateFn.apply(a, b, c, d, e, aggr)

        return per_arm(one, info, in_dims[:5], h, in_src, in_w, out_dst, out_w)


class _AggregateFn(torch.autograd.Function):
    """One aggregation (:func:`_aggregate`) as a Function, for the backward
    of :class:`_InrowAggregateFn`: its ``vmap`` rule unbinds the arm axis
    before K6 sees a tensor.  Not differentiable itself."""

    @staticmethod
    def forward(h, src, w, aggr, backward):
        return _aggregate(h, src, w, aggr, backward)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, h, src, w, aggr, backward):
        def one(a, b, c):
            return _AggregateFn.apply(a, b, c, aggr, backward)

        return per_arm(one, info, in_dims[:3], h, src, w)


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
    require_plain_tensors(h, in_src, in_w)


def _inrow_aggregate_cuda(h, in_src, in_w, aggr: str = "add", backward: bool = False, form=None):
    """K6: the CUDA counterpart of :func:`inrow_aggregate_plain`, same
    contract.  ``backward`` only says which launch count the launch adds to;
    ``form``, a ``(channels a piece, lanes a node)`` pair, overrides
    :func:`aggregate_form`'s choice (to time the others)."""
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    _check_aggr(aggr)
    _check_operands(h, in_src, in_w)
    out = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    if h.numel() == 0:
        return out
    h, in_src, in_w = h.contiguous(), in_src.contiguous(), in_w.contiguous()
    b, m, width = h.shape
    vec, lanes = form or aggregate_form(width, h.dtype, h.data_ptr() % 16 == 0)
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
            vec,
            lanes,
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


def inrow_max_aggregate(h, in_src, in_w, out_dst=None, out_pos=None, out_w=None):
    """Masked neighbour max ``[B, M, H]`` in ``h``'s dtype: ``agg[b, i] =
    max_d in_w[b, i, d] · h[b, in_src[b, i, d]]`` in f32 over the slots with
    ``in_w != 0``, 0 where every slot is masked.  Each slot's rows are
    gathered exactly (the JAX package's one-hot product, whose rows hold one
    nonzero; a source outside ``[0, M)`` gathers zeros), and the running max
    folds slot by slot.  ``out_dst``/``out_pos``/``out_w`` are accepted and
    not read, as in the JAX package."""
    b, m, c = h.shape
    src = in_src.long()
    inside = (src >= 0) & (src < m)
    src = src.clamp(0, m - 1)
    agg = None
    for d in range(in_src.shape[-1]):
        rows = torch.gather(h, 1, src[:, :, d, None].expand(b, m, c)).float()
        rows = torch.where(inside[:, :, d, None], rows, 0.0)
        w_d = in_w[:, :, d, None].float()
        m_d = torch.where(w_d != 0, rows * w_d, float("-inf"))
        agg = m_d if agg is None else torch.maximum(agg, m_d)
    return torch.where(torch.isfinite(agg), agg, 0.0).to(h.dtype)


class _InrowGatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, in_src, out_dst, out_pos, out_valid):
        ctx.save_for_backward(in_src, out_dst, out_pos, out_valid)
        ctx.values_dtype = values.dtype
        return _gather_rows(values, in_src)

    @staticmethod
    def backward(ctx, g):
        in_src, out_dst, out_pos, out_valid = ctx.saved_tensors
        if out_dst is None or out_pos is None or out_valid is None:
            raise ValueError(
                "inrow_gather backward needs the out-row mirror (out_dst/"
                "out_pos/out_w); GraphLoader(emit_out_rows=True) ships it"
            )
        b, m, d = in_src.shape
        c = g.shape[-1]
        q = out_dst.shape[-1]
        # node j's q-th outgoing edge sits in slot out_pos of row out_dst
        flat = out_dst.long() * d + out_pos.long()  # [B, M, Q]
        picked = torch.gather(
            g.reshape(b, m * d, c), 1, flat.reshape(b, m * q, 1).expand(b, m * q, c)
        ).reshape(b, m, q, c)
        # the out-row weights mark padding with 0; the route needs validity only
        mask = (out_valid != 0).float()
        dvalues = (picked.float() * mask[..., None]).sum(dim=2).to(ctx.values_dtype)
        return dvalues, None, None, None, None


def _gather_rows(values, idx):
    """``out[b, i, d] = values[b, idx[b, i, d]]``, ``[B, M, D, C]``."""
    b, m, d = idx.shape
    c = values.shape[-1]
    flat = idx.long().reshape(b, m * d, 1).expand(b, m * d, c)
    return torch.gather(values, 1, flat).reshape(b, m, d, c)


def inrow_gather(values, in_src, out_dst=None, out_pos=None, out_valid=None):
    """Per-slot row gather ``[B, M, D, C]``: ``out[b, i, d] = values[b,
    in_src[b, i, d]]``, differentiable in ``values``.  The backward sums each
    node's cotangent over its outgoing slots, ``Σ_q g[b, out_dst[b, j, q],
    out_pos[b, j, q]]`` where ``out_valid != 0``: a gather, where plain
    autograd would scatter.  The mirror only routes the backward; pass None
    for inference (a backward then raises).  The upstream cotangent must be
    0 on padding slots (``in_w == 0``), which the out-rows never visit:
    every masked use (attention weights, a ``w != 0`` gate) makes it so."""
    return _InrowGatherFn.apply(values, in_src, out_dst, out_pos, out_valid)

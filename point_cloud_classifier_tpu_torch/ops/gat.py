"""GATv1 attention over the dense in-row wire: plain PyTorch, and kernel K3.

Counterpart of ``point_cloud_classifier_tpu/ops/gat_pallas.py``:

- :func:`gat_attention_masked` — the masked-softmax formulation over an
  explicit ``[B, M, M]`` bool mask (``gat_attention_masked``);
- :func:`gat_attention_plain` — the in-row oracle (``_adj_mask_xla`` +
  ``gat_attention_xla``): the mask is ``adj | eye`` from the in-row lists,
  so a slot counts when ``w != 0``, an explicit self-edge collapses into the
  self-loop, and a source repeated in a later slot counts once.  It is the
  CPU path, the semantics contract, and what K3 is held to on the card;
- :func:`gat_attention_bwd_plain` — the closed-form backward of the oracle
  (``ds_dst``, ``ds_src``, ``dxw`` from the output's cotangent), equal to the
  CPU autograd of :func:`gat_attention_plain`; what K4 is held to on the card;
- :func:`gat_out_rows` — the mirror of the in-row lists that K4 reads: per
  graph and source node, the destinations that attend to it, ascending, as
  offsets ``[B, M + 1]`` and a list ``[B, M·D]``.  On a CUDA tensor it
  launches the mirror kernel of ``csrc/gat_attention_bwd.cu`` or raises;
  :func:`gat_out_rows_plain` is its plain version.  The same rule as the
  attention decides which slots count.  ``gat_out_rows.launches`` counts the
  kernel's launches.  Under ``torch.func.vmap`` each arm's mirror is built
  on its own where the lists carry the arm axis (a sweep's keep-masked
  lists after SAG), once where they do not;
- :func:`gat_attention` — the entry point.  A CPU tensor takes the plain
  version under autograd; a CUDA tensor goes through an autograd Function
  whose forward launches ``csrc/gat_attention.cu`` (K3, which replaces both
  forms of the TPU forward, ``_fwd_impl``'s slot and dense ``pallas_call``s)
  and whose backward launches ``csrc/gat_attention_bwd.cu`` (K4, which
  replaces both forms of ``_bwd_impl``), or raises.  K4 sums every gradient
  as a gather in a fixed order over the mirror, so it gives the same bits on
  every run; it builds the mirror itself unless the caller hands one in (one
  mirror serves every attention over the same lists).
  ``gat_attention.launches`` counts K3's launches and
  ``gat_attention.bwd_launches`` K4's.  The Function's own CPU version is
  the plain one with the closed-form backward; under ``torch.func.vmap``
  (a sweep's arms) each arm launches K3 and K4 on its own.

Per head ``h`` and node ``i``: ``α_ij = softmax_j(LeakyReLU(s_dst[i, h] +
s_src[j, h]))`` over the masked ``j``, and ``out[i, h-block] = Σ_j α_ij ·
xw[j, h-block]``.  Rounding follows the JAX oracle: logits, softmax and the
sum in f32, ``α`` rounded to ``xw``'s dtype before it multiplies, the
output in ``xw``'s dtype.  The scores are f32 ``[B, M, H]``; ``xw`` is
``[B, M, C]`` with heads concatenated (``C = H · dh``).  The backward rounds
where that forward's autograd rounds: ``dα = <g_i, xw_j>`` to ``xw``'s dtype
(the cotangent of the rounded ``α``), the rounded ``α`` in ``dxw``, the
softmax backward with the f32 ``α``, LeakyReLU's derivative 1 at ``z >= 0``.

:func:`attention_form` is where the host chooses K3's form for a shape.
The piece form serves two nodes a warp, 16 lanes a node, one or two 16-byte
pieces of a row (4 f32 or 8 bf16 channels each) a lane: rows of up to 32
pieces, a power of two of them a head (and a multiple of the pieces a lane),
where ``H · span <= 32`` (``span``, the least power of two >= D: the
softmax's lanes a head).  The configs' shape (C = 128, H = 4, D = 8) takes
it with two pieces a lane in f32 and one in bf16.  Every other shape (D = 32
with several heads, a head of a width that splits into no power of two of
pieces, rows of more than 32 pieces or off 16-byte addresses) takes the
channel form, a warp a node and a channel a lane.

The TPU layout knobs ``PCC_GAT_KERNEL``, ``PCC_GAT_SOFTMAX``,
``PCC_GAT_SCORE_CHUNK``, ``PCC_GAT_DAL`` and ``PCC_GAT_GB`` pick between
Pallas forms of one function; K3 is one kernel and reads none of them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from point_cloud_classifier_tpu_torch.ops.dispatch import (
    per_arm,
    require_plain_tensors,
    use_cuda_kernels,
)
from point_cloud_classifier_tpu_torch.ops.inrow_graph import (
    _MAX_SLOTS,
    _SRC_CODES,
    _W_CODES,
    _pow2_at_least,
    inrow_adjacency,
)

SLOPE = 0.2  # torch_geometric GATConv's default negative_slope


def _leaky_relu(z: torch.Tensor, slope: float) -> torch.Tensor:
    # jax.nn.leaky_relu's form (z >= 0 keeps z), not F.leaky_relu's z > 0
    return torch.where(z >= 0, z, slope * z)


def adjacency_mask(in_src: torch.Tensor, in_w: torch.Tensor, m: int) -> torch.Tensor:
    """``[B, M, M]`` bool adjacency-or-self-loop mask from the in-row lists."""
    adj = inrow_adjacency(in_src, (in_w != 0).float(), m, torch.float32)
    return (adj > 0) | torch.eye(m, dtype=torch.bool, device=in_src.device)[None]


def gat_attention_masked(s_dst, s_src, mask, xw, slope: float = SLOPE):
    """GATv1 attention over an explicit ``[B, M, M]`` bool mask (self-loops
    already in it); differentiable in the scores and ``xw``."""
    b, m, h = s_dst.shape
    c = xw.shape[-1]
    xwr = xw.reshape(b, m, h, c // h)
    outs = []
    for head in range(h):  # the head loop bounds the [B, M, M] temporaries
        e = _leaky_relu(
            s_dst[:, :, None, head].float() + s_src[:, None, :, head].float(), slope
        )
        e = e.masked_fill(~mask, float("-inf"))
        e = e - e.amax(dim=2, keepdim=True).detach()
        p = torch.exp(e) * mask
        alpha = p / torch.clamp(p.sum(dim=2, keepdim=True), min=1e-16)
        # α rounded to xw's dtype, then an f32 product and sum (exact
        # products of two bf16 values, as with preferred_element_type=f32)
        outs.append(torch.matmul(alpha.to(xw.dtype).float(), xwr[:, :, head].float()))
    return torch.stack(outs, dim=2).reshape(b, m, c).to(xw.dtype)


def gat_attention_plain(s_dst, s_src, in_src, in_w, xw, slope: float = SLOPE):
    """The in-row oracle: :func:`gat_attention_masked` over ``adj | eye``."""
    return gat_attention_masked(
        s_dst, s_src, adjacency_mask(in_src, in_w, s_dst.shape[1]), xw, slope
    )


def gat_attention_bwd_plain(s_dst, s_src, in_src, in_w, xw, g, slope: float = SLOPE):
    """``(ds_dst, ds_src, dxw)`` of :func:`gat_attention_plain` for the
    output cotangent ``g [B, M, C]``: the scores' gradients f32 ``[B, M, H]``,
    ``dxw`` in ``xw``'s dtype.  Per head, over the masked ``j``:
    ``dα_ij = <g_i, xw_j>``, ``dz_ij = α_ij (dα_ij − Σ_k α_ik dα_ik) ·
    LeakyReLU'(z_ij)``, ``ds_dst[i] = Σ_j dz_ij``, ``ds_src[j] = Σ_i dz_ij``,
    ``dxw[j] = Σ_i α_ij g_i`` (the self-loop is on the mask's diagonal)."""
    b, m, h = s_dst.shape
    c = xw.shape[-1]
    mask = adjacency_mask(in_src, in_w, m)
    xwr = xw.float().reshape(b, m, h, c // h)
    gr = g.to(xw.dtype).float().reshape(b, m, h, c // h)
    ds_dst, ds_src, dxw = [], [], []
    for head in range(h):  # the head loop bounds the [B, M, M] temporaries
        z = s_dst[:, :, None, head].float() + s_src[:, None, :, head].float()
        e = _leaky_relu(z, slope).masked_fill(~mask, float("-inf"))
        p = torch.exp(e - e.amax(dim=2, keepdim=True)) * mask
        alpha = p / torch.clamp(p.sum(dim=2, keepdim=True), min=1e-16)
        g_h, xw_h = gr[:, :, head], xwr[:, :, head]
        dal = torch.matmul(g_h, xw_h.transpose(1, 2)).to(xw.dtype).float()
        dz = alpha * (dal - (alpha * dal).sum(dim=2, keepdim=True))
        dz = dz * torch.where(z >= 0, 1.0, slope)
        ds_dst.append(dz.sum(dim=2))
        ds_src.append(dz.sum(dim=1))
        dxw.append(torch.matmul(alpha.to(xw.dtype).float().transpose(1, 2), g_h))
    return (
        torch.stack(ds_dst, dim=2),
        torch.stack(ds_src, dim=2),
        torch.stack(dxw, dim=2).reshape(b, m, c).to(xw.dtype),
    )


class GatMirror(NamedTuple):
    """The in-row lists seen from the sources: the destinations that attend to
    source ``j`` of graph ``b`` are ``out_dst[b, out_off[b, j]:out_off[b, j +
    1]]``, ascending; ``out_dst`` holds -1 behind a graph's last entry."""

    out_off: torch.Tensor  # [B, M + 1] int32
    out_dst: torch.Tensor  # [B, M·D] int32


def gat_out_rows_plain(in_src: torch.Tensor, in_w: torch.Tensor) -> GatMirror:
    """The plain version of the mirror: the off-diagonal of
    :func:`adjacency_mask`, transposed and listed."""
    b, m, d = in_src.shape
    mask = adjacency_mask(in_src, in_w, m) & ~torch.eye(m, dtype=torch.bool, device=in_src.device)
    by_source = mask.transpose(1, 2)  # [B, source, destination]
    out_off = torch.zeros((b, m + 1), dtype=torch.int32, device=in_src.device)
    out_off[:, 1:] = by_source.sum(dim=2).cumsum(dim=1)
    out_dst = torch.full((b, m * d), -1, dtype=torch.int32, device=in_src.device)
    # nonzero lists (graph, source, destination) in that order: each source's
    # destinations ascending, the sources of a graph one after the other
    graph, _, dst = by_source.nonzero(as_tuple=True)
    first = torch.zeros(b + 1, dtype=torch.long, device=in_src.device)
    first[1:] = out_off[:, m].long().cumsum(dim=0)
    at = torch.arange(graph.shape[0], device=in_src.device) - first[graph]
    out_dst[graph, at] = dst.to(torch.int32)
    return GatMirror(out_off, out_dst)


class _GatOutRowsFn(torch.autograd.Function):
    """The mirror as a Function, so that it has a ``vmap`` rule: after SAG
    each arm of a sweep has its own keep-masked lists, and the rule builds
    each arm's mirror on its own (``nonzero`` and the kernel alike take one
    arm's lists)."""

    @staticmethod
    def forward(in_src, in_w):
        if use_cuda_kernels(in_src):
            return tuple(_gat_out_rows_cuda(in_src, in_w))
        return tuple(gat_out_rows_plain(in_src, in_w))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def vmap(info, in_dims, in_src, in_w):
        return per_arm(_GatOutRowsFn.apply, info, in_dims, in_src, in_w)


def gat_out_rows(in_src: torch.Tensor, in_w: torch.Tensor) -> GatMirror:
    """The mirror of the in-row lists, for K4: build it once per batch and hand
    it to every :func:`gat_attention` over the same lists."""
    if in_src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gat_out_rows takes CPU or CUDA tensors, got {in_src.device}")
    return GatMirror(*_GatOutRowsFn.apply(in_src, in_w))


gat_out_rows.launches = 0


def gat_backward_mirror(in_src: torch.Tensor, in_w: torch.Tensor) -> Optional[GatMirror]:
    """The mirror for the callers of :func:`gat_attention` that share one over
    several calls: :func:`gat_out_rows` where K4 will read it (lists on the
    card, gradients recorded), None where the plain version differentiates
    itself and needs none."""
    if not (torch.is_grad_enabled() and use_cuda_kernels(in_src)):
        return None
    return gat_out_rows(in_src, in_w)


class _GatAttentionFn(torch.autograd.Function):
    """K3 forward and K4 backward (:class:`_GatAttentionBwdFn`) on CUDA
    tensors; the plain version and its closed-form backward on CPU ones (and
    inside ``force_plain``), which the CPU tests drive.  The mirror rides as
    two optional tensors.  Under ``torch.func.vmap`` each arm takes its own
    launch (``ops/dispatch.per_arm``), with its own mirror where the lists
    carry the arm axis."""

    @staticmethod
    def forward(s_dst, s_src, in_src, in_w, xw, slope, out_off, out_dst):
        if use_cuda_kernels(xw):
            return _gat_attention_cuda(s_dst, s_src, in_src, in_w, xw, slope)
        return gat_attention_plain(s_dst, s_src, in_src, in_w, xw, slope)

    @staticmethod
    def setup_context(ctx, inputs, output):
        s_dst, s_src, in_src, in_w, xw, slope, out_off, out_dst = inputs
        ctx.save_for_backward(s_dst, s_src, in_src, in_w, xw, out_off, out_dst)
        ctx.slope = slope

    @staticmethod
    def backward(ctx, g):
        s_dst, s_src, in_src, in_w, xw, out_off, out_dst = ctx.saved_tensors
        grads = _GatAttentionBwdFn.apply(s_dst, s_src, in_src, in_w, xw, g, ctx.slope, out_off, out_dst)
        need = ctx.needs_input_grad
        ds_dst, ds_src, dxw = (d if need[i] else None for d, i in zip(grads, (0, 1, 4)))
        return ds_dst, ds_src, None, None, dxw, None, None, None

    @staticmethod
    def vmap(info, in_dims, s_dst, s_src, in_src, in_w, xw, slope, out_off, out_dst):
        def one(a, b, c, d, e, f, h):
            return _GatAttentionFn.apply(a, b, c, d, e, slope, f, h)

        dims = (*in_dims[:5], *in_dims[6:])
        return per_arm(one, info, dims, s_dst, s_src, in_src, in_w, xw, out_off, out_dst)


class _GatAttentionBwdFn(torch.autograd.Function):
    """``(ds_dst, ds_src, dxw)``: K4 (over the mirror where one is given) on
    CUDA tensors, :func:`gat_attention_bwd_plain` on CPU ones (and inside
    ``force_plain``).  Not differentiable itself."""

    @staticmethod
    def forward(s_dst, s_src, in_src, in_w, xw, g, slope, out_off, out_dst):
        if use_cuda_kernels(xw):
            mirror = GatMirror(out_off, out_dst) if out_off is not None else None
            return _gat_attention_bwd_cuda(s_dst, s_src, in_src, in_w, xw, g, slope, mirror)
        return gat_attention_bwd_plain(s_dst, s_src, in_src, in_w, xw, g, slope)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, s_dst, s_src, in_src, in_w, xw, g, slope, out_off, out_dst):
        def one(a, b, c, d, e, f, h, i):
            return _GatAttentionBwdFn.apply(a, b, c, d, e, f, slope, h, i)

        dims = (*in_dims[:6], *in_dims[7:])
        return per_arm(one, info, dims, s_dst, s_src, in_src, in_w, xw, g, out_off, out_dst)


def gat_attention(
    s_dst, s_src, in_src, in_w, xw, slope: float = SLOPE, mirror: Optional[GatMirror] = None
):
    """GATv1 attention ``[B, M, C]`` in ``xw``'s dtype, differentiable in the
    scores and ``xw``: K3 (and K4 backward) on a CUDA tensor,
    :func:`gat_attention_plain` under autograd on a CPU one (or inside
    ``force_plain``).  ``mirror``, where given, is :func:`gat_out_rows` of the
    same ``in_src`` and ``in_w``; K4 then builds none.  Only its shape is
    checked against the lists: the caller answers for the mirror being theirs
    (a mirror of other lists of the same shape gives wrong ``ds_src`` and
    ``dxw`` without an error)."""
    if xw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gat_attention takes CPU or CUDA tensors, got {xw.device}")
    if not use_cuda_kernels(xw):
        return gat_attention_plain(s_dst, s_src, in_src, in_w, xw, slope)
    return _GatAttentionFn.apply(s_dst, s_src, in_src, in_w, xw, slope, *(mirror or (None, None)))


gat_attention.launches = 0
gat_attention.bwd_launches = 0

_XW_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_form(heads: int, channels: int, slots: int, dtype: torch.dtype,
                   aligned: bool = True) -> int:
    """K3's form for ``[B, M, channels]`` rows of ``dtype`` in ``heads``
    heads over ``slots`` in-row slots: the piece form's pieces a lane (1 or
    2), or 0 for the channel form.  ``aligned``: the rows lie at 16-byte
    addresses."""
    vec = 16 // dtype.itemsize
    dh = channels // heads
    per_head, pieces = dh // vec, channels // vec
    per = 1 if pieces <= 16 else 2
    if (
        not aligned
        or dh % vec
        or per_head & (per_head - 1)
        or per_head % per
        or pieces > 32
        or heads * _pow2_at_least(slots) > 32
    ):
        return 0
    return per


def _check_operands(s_dst, s_src, in_src, in_w, xw):
    """Raise on anything K3 and K4 do not take."""
    if xw.dtype not in _XW_CODES:
        raise TypeError(f"K3 takes f32 or bf16 xw, got {xw.dtype}")
    if in_src.dtype not in _SRC_CODES or in_w.dtype not in _W_CODES:
        raise TypeError(
            f"K3 takes int32/int16 in_src and f32/f16 in_w, got {in_src.dtype} "
            f"and {in_w.dtype}"
        )
    if s_dst.dtype != torch.float32 or s_src.dtype != torch.float32:
        raise TypeError("K3 takes f32 scores s_dst and s_src")
    if xw.ndim != 3 or s_dst.ndim != 3 or in_src.ndim != 3:
        raise ValueError("K3 takes [B, M, H] scores, [B, M, D] lists and [B, M, C] xw")
    b, m, h = s_dst.shape
    c, d = xw.shape[-1], in_src.shape[-1]
    if (
        tuple(s_src.shape) != (b, m, h)
        or tuple(xw.shape[:2]) != (b, m)
        or tuple(in_src.shape) != (b, m, d)
        or tuple(in_w.shape) != (b, m, d)
    ):
        raise ValueError(
            f"K3 shapes disagree: s_dst {tuple(s_dst.shape)}, s_src "
            f"{tuple(s_src.shape)}, in_src {tuple(in_src.shape)}, in_w "
            f"{tuple(in_w.shape)}, xw {tuple(xw.shape)}"
        )
    if h < 1 or c % h != 0:
        raise ValueError(f"K3 needs C ({c}) to be a multiple of H ({h})")
    if d > _MAX_SLOTS:
        raise ValueError(f"K3 takes at most {_MAX_SLOTS} in-row slots, got {d}")
    if any(t.device != xw.device for t in (s_dst, s_src, in_src, in_w)):
        raise ValueError("K3's operands must all lie on one device")
    require_plain_tensors(s_dst, s_src, in_src, in_w, xw)


def _gat_attention_cuda(s_dst, s_src, in_src, in_w, xw, slope: float = SLOPE, form=None):
    """K3: the CUDA counterpart of :func:`gat_attention_plain`, same contract.
    ``form`` overrides :func:`attention_form`'s choice (to time the others; a
    piece form the shape does not fit raises)."""
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    _check_operands(s_dst, s_src, in_src, in_w, xw)
    b, m, h = s_dst.shape
    out = torch.empty(xw.shape, dtype=xw.dtype, device=xw.device)
    if b * m == 0:
        return out
    s_dst, s_src = s_dst.contiguous(), s_src.contiguous()
    in_src, in_w, xw = in_src.contiguous(), in_w.contiguous(), xw.contiguous()
    d, c = in_src.shape[-1], xw.shape[-1]
    if form is None:
        form = attention_form(h, c, d, xw.dtype, xw.data_ptr() % 16 == 0)
    lib = kernel_library().lib
    with torch.cuda.device(xw.device):
        code = lib.pcc_gat_attention(
            s_dst.data_ptr(),
            s_src.data_ptr(),
            in_src.data_ptr(),
            in_w.data_ptr(),
            xw.data_ptr(),
            out.data_ptr(),
            b,
            m,
            d,
            h,
            c,
            float(slope),
            form,
            _XW_CODES[xw.dtype],
            _SRC_CODES[in_src.dtype],
            _W_CODES[in_w.dtype],
            torch.cuda.current_stream(xw.device).cuda_stream,
        )
    check(code)
    gat_attention.launches += 1
    return out


def _check_lists(in_src, in_w):
    """Raise on lists the mirror kernel does not take."""
    if in_src.dtype not in _SRC_CODES or in_w.dtype not in _W_CODES:
        raise TypeError(
            f"the mirror takes int32/int16 in_src and f32/f16 in_w, got {in_src.dtype} "
            f"and {in_w.dtype}"
        )
    if in_src.ndim != 3 or in_w.shape != in_src.shape or in_w.device != in_src.device:
        raise ValueError(
            f"the mirror takes in_src and in_w [B, M, D] on one device, got "
            f"{tuple(in_src.shape)} on {in_src.device} and {tuple(in_w.shape)} on {in_w.device}"
        )
    if in_src.shape[-1] > _MAX_SLOTS:
        raise ValueError(f"the mirror takes at most {_MAX_SLOTS} in-row slots, got {in_src.shape[-1]}")
    require_plain_tensors(in_src, in_w)


def _gat_out_rows_cuda(in_src, in_w) -> GatMirror:
    """The mirror kernel: the CUDA counterpart of :func:`gat_out_rows_plain`,
    same contract."""
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    _check_lists(in_src, in_w)
    b, m, d = in_src.shape
    out_off = torch.empty((b, m + 1), dtype=torch.int32, device=in_src.device)
    out_dst = torch.empty((b, m * d), dtype=torch.int32, device=in_src.device)
    if b * m == 0:
        return GatMirror(out_off.zero_(), out_dst)
    in_src, in_w = in_src.contiguous(), in_w.contiguous()
    lib = kernel_library().lib
    with torch.cuda.device(in_src.device):
        code = lib.pcc_gat_out_rows(
            in_src.data_ptr(), in_w.data_ptr(), out_off.data_ptr(), out_dst.data_ptr(),
            b, m, d, _SRC_CODES[in_src.dtype], _W_CODES[in_w.dtype],
            torch.cuda.current_stream(in_src.device).cuda_stream,
        )
    check(code)
    gat_out_rows.launches += 1
    return GatMirror(out_off, out_dst)


def _gat_attention_bwd_cuda(
    s_dst, s_src, in_src, in_w, xw, g, slope: float = SLOPE, mirror: Optional[GatMirror] = None
):
    """K4: the CUDA counterpart of :func:`gat_attention_bwd_plain`, same
    contract.  ``ds_src`` and ``dxw`` are gathered per source over ``mirror``
    (built here when none is given), summed in f32 registers in a fixed order
    and written once, ``dxw`` in ``xw``'s dtype."""
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    _check_operands(s_dst, s_src, in_src, in_w, xw)
    require_plain_tensors(g, *(mirror or ()))
    if g.shape != xw.shape or g.device != xw.device:
        raise ValueError(
            f"K4 takes a cotangent of xw's shape on its device, got {tuple(g.shape)} "
            f"on {g.device} for {tuple(xw.shape)} on {xw.device}"
        )
    b, m, h = s_dst.shape
    d = in_src.shape[-1]
    ds_dst = torch.empty((b, m, h), dtype=torch.float32, device=xw.device)
    ds_src = torch.empty((b, m, h), dtype=torch.float32, device=xw.device)
    dxw = torch.empty(xw.shape, dtype=xw.dtype, device=xw.device)
    if b * m == 0:
        return ds_dst, ds_src, dxw
    if mirror is None:
        mirror = _gat_out_rows_cuda(in_src, in_w)
    elif tuple(mirror.out_off.shape) != (b, m + 1) or tuple(mirror.out_dst.shape) != (b, m * d):
        raise ValueError(
            f"the mirror is of other lists: offsets {tuple(mirror.out_off.shape)} and list "
            f"{tuple(mirror.out_dst.shape)} for in_src {tuple(in_src.shape)}"
        )
    # what stage B needs of each (destination, head): maximum, denominator,
    # Σ α dα and s_dst
    stats = torch.empty((b, m, h, 4), dtype=torch.float32, device=xw.device)
    s_dst, s_src = s_dst.contiguous(), s_src.contiguous()
    in_src, in_w, xw = in_src.contiguous(), in_w.contiguous(), xw.contiguous()
    g = g.to(xw.dtype).contiguous()
    lib = kernel_library().lib
    with torch.cuda.device(xw.device):
        code = lib.pcc_gat_attention_bwd(
            s_dst.data_ptr(),
            s_src.data_ptr(),
            in_src.data_ptr(),
            in_w.data_ptr(),
            xw.data_ptr(),
            g.data_ptr(),
            mirror.out_off.data_ptr(),
            mirror.out_dst.data_ptr(),
            stats.data_ptr(),
            ds_dst.data_ptr(),
            ds_src.data_ptr(),
            dxw.data_ptr(),
            b,
            m,
            d,
            h,
            xw.shape[-1],
            float(slope),
            _XW_CODES[xw.dtype],
            _SRC_CODES[in_src.dtype],
            _W_CODES[in_w.dtype],
            torch.cuda.current_stream(xw.device).cuda_stream,
        )
    check(code)
    gat_attention.bwd_launches += 1
    return ds_dst, ds_src, dxw

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
- :func:`gat_attention` — the entry point.  A CPU tensor takes the plain
  version under autograd; a CUDA tensor goes through an autograd Function
  whose forward launches ``csrc/gat_attention.cu`` (K3, which replaces both
  forms of the TPU forward, ``_fwd_impl``'s slot and dense ``pallas_call``s)
  and whose backward launches ``csrc/gat_attention_bwd.cu`` (K4, which
  replaces both forms of ``_bwd_impl``), or raises.
  ``gat_attention.launches`` counts K3's launches and
  ``gat_attention.bwd_launches`` K4's.

Per head ``h`` and node ``i``: ``α_ij = softmax_j(LeakyReLU(s_dst[i, h] +
s_src[j, h]))`` over the masked ``j``, and ``out[i, h-block] = Σ_j α_ij ·
xw[j, h-block]``.  Rounding follows the JAX oracle: logits, softmax and the
sum in f32, ``α`` rounded to ``xw``'s dtype before it multiplies, the
output in ``xw``'s dtype.  The scores are f32 ``[B, M, H]``; ``xw`` is
``[B, M, C]`` with heads concatenated (``C = H · dh``).  The backward rounds
where that forward's autograd rounds: ``dα = <g_i, xw_j>`` to ``xw``'s dtype
(the cotangent of the rounded ``α``), the rounded ``α`` in ``dxw``, the
softmax backward with the f32 ``α``, LeakyReLU's derivative 1 at ``z >= 0``.

The TPU layout knobs ``PCC_GAT_KERNEL``, ``PCC_GAT_SOFTMAX``,
``PCC_GAT_SCORE_CHUNK``, ``PCC_GAT_DAL`` and ``PCC_GAT_GB`` pick between
Pallas forms of one function; K3 is one kernel and reads none of them.
"""

from __future__ import annotations

import torch

from point_cloud_classifier_tpu_torch.ops.dispatch import use_cuda_kernels
from point_cloud_classifier_tpu_torch.ops.inrow_graph import (
    _MAX_SLOTS,
    _SRC_CODES,
    _W_CODES,
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


class _GatAttentionFn(torch.autograd.Function):
    """K3 forward, K4 backward, on CUDA tensors."""

    @staticmethod
    def forward(ctx, s_dst, s_src, in_src, in_w, xw, slope):
        ctx.save_for_backward(s_dst, s_src, in_src, in_w, xw)
        ctx.slope = slope
        return _gat_attention_cuda(s_dst, s_src, in_src, in_w, xw, slope)

    @staticmethod
    def backward(ctx, g):
        grads = _gat_attention_bwd_cuda(*ctx.saved_tensors, g, ctx.slope)
        need = ctx.needs_input_grad
        ds_dst, ds_src, dxw = (d if need[i] else None for d, i in zip(grads, (0, 1, 4)))
        return ds_dst, ds_src, None, None, dxw, None


def gat_attention(s_dst, s_src, in_src, in_w, xw, slope: float = SLOPE):
    """GATv1 attention ``[B, M, C]`` in ``xw``'s dtype, differentiable in the
    scores and ``xw``: K3 (and K4 backward) on a CUDA tensor,
    :func:`gat_attention_plain` under autograd on a CPU one (or inside
    ``force_plain``)."""
    if xw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gat_attention takes CPU or CUDA tensors, got {xw.device}")
    if not use_cuda_kernels(xw):
        return gat_attention_plain(s_dst, s_src, in_src, in_w, xw, slope)
    return _GatAttentionFn.apply(s_dst, s_src, in_src, in_w, xw, slope)


gat_attention.launches = 0
gat_attention.bwd_launches = 0

_XW_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _gat_attention_cuda(s_dst, s_src, in_src, in_w, xw, slope: float = SLOPE):
    """K3: the CUDA counterpart of :func:`gat_attention_plain`, same contract."""
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    _check_operands(s_dst, s_src, in_src, in_w, xw)
    b, m, h = s_dst.shape
    out = torch.empty(xw.shape, dtype=xw.dtype, device=xw.device)
    if b * m == 0:
        return out
    s_dst, s_src = s_dst.contiguous(), s_src.contiguous()
    in_src, in_w, xw = in_src.contiguous(), in_w.contiguous(), xw.contiguous()
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
            in_src.shape[-1],
            h,
            xw.shape[-1],
            float(slope),
            _XW_CODES[xw.dtype],
            _SRC_CODES[in_src.dtype],
            _W_CODES[in_w.dtype],
            torch.cuda.current_stream(xw.device).cuda_stream,
        )
    check(code)
    gat_attention.launches += 1
    return out


def _gat_attention_bwd_cuda(s_dst, s_src, in_src, in_w, xw, g, slope: float = SLOPE):
    """K4: the CUDA counterpart of :func:`gat_attention_bwd_plain`, same
    contract.  ``ds_src`` and ``dxw`` are summed with f32 atomics into zeroed
    f32 buffers, and ``dxw`` is rounded to ``xw``'s dtype once afterwards."""
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    _check_operands(s_dst, s_src, in_src, in_w, xw)
    if g.shape != xw.shape or g.device != xw.device:
        raise ValueError(
            f"K4 takes a cotangent of xw's shape on its device, got {tuple(g.shape)} "
            f"on {g.device} for {tuple(xw.shape)} on {xw.device}"
        )
    b, m, h = s_dst.shape
    ds_dst = torch.empty((b, m, h), dtype=torch.float32, device=xw.device)
    ds_src = torch.zeros((b, m, h), dtype=torch.float32, device=xw.device)
    dxw = torch.zeros(xw.shape, dtype=torch.float32, device=xw.device)
    if b * m == 0:
        return ds_dst, ds_src, dxw.to(xw.dtype)
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
            ds_dst.data_ptr(),
            ds_src.data_ptr(),
            dxw.data_ptr(),
            b,
            m,
            in_src.shape[-1],
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
    return ds_dst, ds_src, dxw.to(xw.dtype)

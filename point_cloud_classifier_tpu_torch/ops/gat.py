"""GATv1 attention over the dense in-row wire: plain PyTorch, and kernel K3.

Counterpart of ``point_cloud_classifier_tpu/ops/gat_pallas.py``:

- :func:`gat_attention_masked` — the masked-softmax formulation over an
  explicit ``[B, M, M]`` bool mask (``gat_attention_masked``);
- :func:`gat_attention_plain` — the in-row oracle (``_adj_mask_xla`` +
  ``gat_attention_xla``): the mask is ``adj | eye`` from the in-row lists,
  so a slot counts when ``w != 0``, an explicit self-edge collapses into the
  self-loop, and a source repeated in a later slot counts once.  It is the
  CPU path, the semantics contract, and what K3 is held to on the card;
- :func:`gat_attention` — the entry point.  A CPU tensor takes the plain
  version; a CUDA tensor launches ``csrc/gat_attention.cu`` (K3, which
  replaces both forms of the TPU forward, ``_fwd_impl``'s slot and dense
  ``pallas_call``s) or raises.  ``gat_attention.launches`` counts its
  launches.  K3 has no backward yet: a CUDA call whose inputs need a
  gradient raises until K4 lands with the GraphNet training slice.

Per head ``h`` and node ``i``: ``α_ij = softmax_j(LeakyReLU(s_dst[i, h] +
s_src[j, h]))`` over the masked ``j``, and ``out[i, h-block] = Σ_j α_ij ·
xw[j, h-block]``.  Rounding follows the JAX oracle: logits, softmax and the
sum in f32, ``α`` rounded to ``xw``'s dtype before it multiplies, the
output in ``xw``'s dtype.  The scores are f32 ``[B, M, H]``; ``xw`` is
``[B, M, C]`` with heads concatenated (``C = H · dh``).

The TPU layout knobs ``PCC_GAT_KERNEL``, ``PCC_GAT_SOFTMAX``,
``PCC_GAT_SCORE_CHUNK``, ``PCC_GAT_DAL`` and ``PCC_GAT_GB`` pick between
Pallas forms of one function; K3 is one kernel and reads none of them.
"""

from __future__ import annotations

import torch

from point_cloud_classifier_tpu_torch.ops.dispatch import use_cuda_kernels
from point_cloud_classifier_tpu_torch.ops.inrow_graph import inrow_adjacency

SLOPE = 0.2  # torch_geometric GATConv's default negative_slope
_MAX_SLOTS = 32  # csrc/gat_attention.cu kMaxSlots: one lane per slot


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


def gat_attention(s_dst, s_src, in_src, in_w, xw, slope: float = SLOPE):
    """GATv1 attention ``[B, M, C]`` in ``xw``'s dtype: K3 on a CUDA tensor,
    :func:`gat_attention_plain` on a CPU one (or inside ``force_plain``)."""
    if xw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gat_attention takes CPU or CUDA tensors, got {xw.device}")
    if not use_cuda_kernels(xw):
        return gat_attention_plain(s_dst, s_src, in_src, in_w, xw, slope)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (s_dst, s_src, xw)):
        raise NotImplementedError(
            "K3 (gat_attention) has no backward on the card yet: its backward, "
            "kernel K4, comes with the GraphNet training slice (ROADMAP Queue 1 "
            "item 1); run GAT under torch.no_grad() or on the CPU"
        )
    return _gat_attention_cuda(s_dst, s_src, in_src, in_w, xw, slope)


gat_attention.launches = 0

_XW_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SRC_CODES = {torch.int32: 0, torch.int16: 1}
_W_CODES = {torch.float32: 0, torch.float16: 1}


def _check_operands(s_dst, s_src, in_src, in_w, xw):
    """Raise on anything K3 does not take."""
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

"""Post-training int8 evaluation of the DeepSets φ chain.

Counterpart of ``point_cloud_classifier_tpu/ops/quant.py``, with its scheme
kept to the letter, so that the integer codes and the s32 sums are the JAX
package's exactly:

- weights: symmetric int8 per output channel, the scale from each column's
  f32 abs-max (``quantize_cols``), quantized at every call so that
  checkpoints stay f32;
- activations: symmetric int8 per row, the scale from each row's f32 abs-max
  (``quantize_rows``);
- a scale is ``max(amax, 1e-8) / 127`` and a code ``round(x / scale)``
  (halves to even, as ``jnp.round``), clipped to ±127: an all-zero row (the
  dense wire's padding) gets the epsilon scale and codes 0;
- the product accumulates in s32 (``torch._int_mm``), is rescaled as
  ``acc · s_x · s_w`` in f32, in that order, then gets the bias in f32 and
  is cast to the compute dtype.

``torch._int_mm`` on the card takes more than 16 rows and an inner and an
outer dimension that are multiples of 8 (the configs' first layer has 6
inputs).  :func:`int8_matmul` pads the codes with zeros up to that on every
device and for every shape: a zero code adds nothing to an s32 sum, so the
padding is exact and there is one route.  It hands the weight codes over in
column-major order, the s8 tensor cores' own layout: on an H100 cuBLASLt
refuses a row-major ``[K, 256]`` operand at some inner dimensions and row
counts (``CUBLAS_STATUS_NOT_SUPPORTED`` at K = 8 and 16), takes the
column-major one at every shape, and runs it faster (``chip_smoke.py``
phase 25 times both; PERF.md §6).  The quantize passes are plain PyTorch; no
host read is made, so the chain runs inside a CUDA graph and traces under
``torch.export``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from point_cloud_classifier_tpu_torch.ops.activations import resolve_activation

Spec = Tuple[Tuple[str, bool], ...]

_QMAX = 127.0
# what torch._int_mm takes on the card: rows > 16, inner and outer
# dimensions multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def _quantize(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric abs-max int8 along ``axis``: ``x ≈ q · scale`` (scale f32,
    kept as a size-1 axis)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    # a tensor divisor: on the card a division by a Python number multiplies
    # by its reciprocal, which can round a scale an ulp off the quotient
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, _QMAX)
    q = torch.clamp(torch.round(x32 / scale), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 (activations): ``scale: [P, 1]`` f32."""
    return _quantize(x, axis=-1)


def quantize_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 (weights): ``scale: [1, N]`` f32 (abs-max
    over the input axis)."""
    return _quantize(w, axis=0)


def int_mm_operands(xq: torch.Tensor, wq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What :func:`int8_matmul` hands ``torch._int_mm`` for codes ``[P, K] ×
    [K, N]``: both zero-padded (rows to more than 16, K and N to multiples
    of 8), the first row-major, the second column-major."""
    p, k = xq.shape
    dk = -k % _ALIGN
    xp = F.pad(xq, (0, dk, 0, max(0, _MIN_ROWS - p))).contiguous()
    wp = F.pad(wq.t(), (0, dk, 0, -wq.shape[1] % _ALIGN)).contiguous().t()
    return xp, wp


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact s32 product ``xq @ wq`` of int8 codes ``[P, K] × [K, N]``
    by ``torch._int_mm`` (:func:`int_mm_operands`)."""
    return torch._int_mm(*int_mm_operands(xq, wq))[: xq.shape[0], : wq.shape[1]]


def int8_linear(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, out_dtype: torch.dtype
) -> torch.Tensor:
    """``x @ w + b`` through the s8 product: ``x [P, K]`` quantized per row,
    ``w [K, N]`` per output channel, the s32 sums rescaled by both scales."""
    xq, sx = quantize_rows(x)
    wq, sw = quantize_cols(w)
    out = int8_matmul(xq, wq).float() * sx * sw
    if b is not None:
        out = out + b.float()
    return out.to(out_dtype)


def phi_forward_int8(points, spec: Spec, params: Sequence, activation: str) -> torch.Tensor:
    """The DeepSets φ chain with every linear through :func:`int8_linear`;
    the activation and the residual add run in the points' dtype, and the
    residual carries stay unquantized.  Layer norm raises ``ValueError``
    (DeepSets keeps such chains in float).  The bare final linear runs only
    when its weights are present (``len(params) == len(spec) + 1``); the
    hidden-only form backs the post-pool placement, where it runs per event
    in f32 after pooling."""
    act = resolve_activation(activation)
    h = points
    for (kind, has_ln), layer in zip(spec, params):
        if has_ln:
            raise ValueError("phi_forward_int8 does not support layer_norm")
        w, b = layer[0], layer[1]
        out = act(int8_linear(h, w, b, h.dtype))
        h = h + out if kind == "residual" else out
    if len(params) == len(spec):
        return h
    wf, bf = params[-1][0], params[-1][1]
    return int8_linear(h, wf, bf, h.dtype)

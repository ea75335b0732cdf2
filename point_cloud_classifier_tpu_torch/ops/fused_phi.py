"""The φ chain and its pooling: plain PyTorch, and the fused CUDA kernel K1.

Counterpart of ``point_cloud_classifier_tpu/ops/fused_phi.py``:

- :func:`phi_hidden`, :func:`phi_forward`, :func:`phi_pool_plain` — the plain
  versions (``phi_hidden_xla``, ``phi_forward_xla``, ``phi_pool_xla``).  They
  are the semantics contract, the CPU path, and what the kernel is checked
  against on the card.
- :func:`phi_pool` — the fused forward.  A CPU tensor takes
  :func:`phi_pool_plain`; a CUDA tensor launches the hand-written Hopper
  kernel ``csrc/phi_pool.cu`` (which replaces ``phi_pool_pallas``) or
  raises.  ``phi_pool.launches`` counts its launches.

φ layer spec: a tuple of ``("plain" | "residual", has_ln)`` entries.
``params`` holds one ``(w [in, out], b[, ln_scale, ln_bias])`` per spec entry,
optionally followed by the bare final linear ``(w, b)``: the hidden-only form
(``len(params) == len(spec)``) serves DeepSets' post-pool placement, where the
final linear runs per event after pooling.

Rounding follows the JAX package: each dot accumulates in f32 and is cast to
the compute dtype, then gets its bias added in that dtype; the activation
and the residual add run in that dtype; pooling is in f32.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from point_cloud_classifier_tpu_torch.ops.activations import (
    gelu_variant,
    resolve_activation,
)
from point_cloud_classifier_tpu_torch.ops.segment import segment_sum

Spec = Tuple[Tuple[str, bool], ...]

# -- plain PyTorch --------------------------------------------------------------


def _apply_layer(h, kind, has_ln, w, b, ln_scale, ln_bias, act):
    out = torch.matmul(h, w.to(h.dtype)) + b.to(h.dtype)
    if has_ln:
        f32 = out.float()
        mean = f32.mean(dim=-1, keepdim=True)
        var = ((f32 - mean) ** 2).mean(dim=-1, keepdim=True)
        out = ((f32 - mean) * torch.rsqrt(var + 1e-5) * ln_scale + ln_bias).to(
            h.dtype
        )
    if kind == "residual":
        return h + act(out)
    return act(out)


def phi_hidden(points, spec: Spec, params: Sequence, activation: str):
    """The φ chain without the bare final linear (``len(params) == len(spec)``)."""
    act = resolve_activation(activation)
    h = points
    for (kind, has_ln), layer in zip(spec, params):
        w, b, *ln = layer
        ln_scale, ln_bias = ln if ln else (None, None)
        h = _apply_layer(h, kind, has_ln, w, b, ln_scale, ln_bias, act)
    return h


def phi_forward(points, spec: Spec, params: Sequence, activation: str):
    """Per-point features ``[P, H]``; the bare final linear runs when its
    params are present (``len(params) == len(spec) + 1``)."""
    h = phi_hidden(points, spec, params[: len(spec)], activation)
    if len(params) == len(spec):
        return h
    wf, bf = params[-1][0], params[-1][1]
    return torch.matmul(h, wf.to(h.dtype)) + bf.to(h.dtype)


def phi_pool_plain(
    points, seg, spec: Spec, params: Sequence, activation: str, num_segments: int
):
    """φ then f32 segment sums ``[num_segments, H]`` — the semantics contract."""
    h = phi_forward(points, spec, params, activation)
    return segment_sum(h.float(), seg, num_segments)


# -- K1: the CUDA kernel ---------------------------------------------------------

_KINDS = {"plain": 0, "residual": 1}
_BARE_LINEAR = 2
_ACTS = {"relu": 0, "silu": 1, "tanh": 2}
_QUICK_GELU, _GELU_TANH = 3, 4
_MAX_LAYERS = 8  # csrc/phi_pool.cu kMaxLayers
_MAX_WIDTH = 3628  # an 8-row tile's two f32 buffers in 227 KB of shared memory


def _activation_code(activation: str) -> int:
    if activation == "gelu":
        return _QUICK_GELU if gelu_variant() == "quick" else _GELU_TANH
    if activation not in _ACTS:
        raise ValueError(f"Unknown activation: {activation}")
    return _ACTS[activation]


def phi_pool(
    points, seg, spec: Spec, params: Sequence, activation: str, num_segments: int
):
    """Fused φ + f32 segment sums ``[num_segments, H]``.

    CPU tensors take :func:`phi_pool_plain`.  CUDA tensors launch K1, which
    takes no layer norm and has no backward yet: anything it cannot compute
    raises rather than falling back.
    """
    if points.device.type == "cpu":
        return phi_pool_plain(points, seg, spec, params, activation, num_segments)
    if points.device.type != "cuda":
        raise ValueError(f"phi_pool takes CPU or CUDA tensors, got {points.device}")
    return _phi_pool_cuda(points, seg, spec, params, activation, num_segments)


phi_pool.launches = 0


def _phi_pool_cuda(points, seg, spec, params, activation, num_segments):
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    if any(has_ln for _, has_ln in spec):
        raise ValueError("K1 takes no layer norm: LN specs use phi_pool_plain")
    if len(params) not in (len(spec), len(spec) + 1):
        raise ValueError("params must hold one entry per spec layer (+ final)")
    if len(params) > _MAX_LAYERS:
        raise ValueError(f"K1 takes at most {_MAX_LAYERS} layers")
    if torch.is_grad_enabled() and (
        points.requires_grad
        or any(t.requires_grad for layer in params for t in layer[:2])
    ):
        raise NotImplementedError(
            "K1 has no backward yet (the fused backward K2 is still to be "
            "ported); run eval under torch.no_grad() or inference_mode()"
        )
    if points.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes f32 or bf16 points, got {points.dtype}")
    if points.ndim != 2 or tuple(seg.shape) != (points.shape[0],):
        raise ValueError(
            f"points must be [P, F] and seg [P], got {tuple(points.shape)} "
            f"and {tuple(seg.shape)}"
        )
    if seg.dtype != torch.int32 or seg.device != points.device:
        raise TypeError("seg must be int32 on the points' device")

    dtype, device = points.dtype, points.device
    weights = [layer[0].to(device=device, dtype=dtype).contiguous() for layer in params]
    biases = [layer[1].to(device=device, dtype=dtype).contiguous() for layer in params]
    dims = [points.shape[1]]
    for w, b in zip(weights, biases):
        if w.ndim != 2 or w.shape[0] != dims[-1] or tuple(b.shape) != (w.shape[1],):
            raise ValueError(
                f"layer shapes do not chain: w {tuple(w.shape)}, b "
                f"{tuple(b.shape)} after width {dims[-1]}"
            )
        dims.append(w.shape[1])
    if max(dims) > _MAX_WIDTH:
        raise ValueError(f"K1 takes widths up to {_MAX_WIDTH}, got {max(dims)}")
    kinds = [_KINDS[kind] for kind, _ in spec] + [_BARE_LINEAR] * (
        len(params) - len(spec)
    )

    out = torch.zeros((num_segments, dims[-1]), dtype=torch.float32, device=device)
    n_points = points.shape[0]
    if n_points == 0:
        return out
    points, seg = points.contiguous(), seg.contiguous()
    n = len(params)
    lib = kernel_library().lib
    with torch.cuda.device(device):
        code = lib.pcc_phi_pool(
            points.data_ptr(),
            seg.data_ptr(),
            out.data_ptr(),
            n_points,
            points.shape[1],
            num_segments,
            n,
            (ctypes.c_int * (n + 1))(*dims),
            (ctypes.c_int * n)(*kinds),
            (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights]),
            (ctypes.c_void_p * n)(*[b.data_ptr() for b in biases]),
            _activation_code(activation),
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(code)
    phi_pool.launches += 1
    return out

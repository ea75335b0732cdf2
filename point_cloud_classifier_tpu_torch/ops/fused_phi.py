"""The φ chain and its pooling: plain PyTorch, and the fused CUDA kernels.

Counterpart of ``point_cloud_classifier_tpu/ops/fused_phi.py``:

- :func:`phi_hidden`, :func:`phi_forward`, :func:`phi_pool_plain` — the plain
  versions (``phi_hidden_xla``, ``phi_forward_xla``, ``phi_pool_xla``).  They
  are the semantics contract, the CPU path, and what the kernel is checked
  against on the card.
- :func:`phi_pool_bwd_plain` — the backward of :func:`phi_pool_plain` in
  closed form, layer by layer, as K2 computes it (the counterpart of
  ``phi_pool_bwd_pallas``'s contract).
- :func:`phi_pool_tf32x3_plain`, :func:`phi_pool_bwd_tf32x3_plain` —
  :func:`phi_pool_plain` and :func:`phi_pool_bwd_plain` with every product
  taken as f32 K1's and K2's tf32x3 variants take it (each operand split
  into two TF32 values, three partial products summed in f32); tests only.
- :func:`phi_pool` — the differentiable fused op (``_PhiPoolFn``).  A CPU
  tensor takes the plain forward and backward; a CUDA tensor launches the
  hand-written Hopper kernels ``csrc/phi_pool.cu`` (K1, which replaces
  ``phi_pool_pallas``) and ``csrc/phi_pool_bwd.cu`` (K2, which replaces
  ``phi_pool_bwd_pallas``) or raises.  ``phi_pool.launches`` and
  ``phi_pool.bwd_launches`` count their launches.  The variants are chosen
  in C by the chain's shape, the element type and the kernel alone: in f32
  the tf32x3 one (products on the tensor cores, each operand split into two
  TF32 values): K1 for chains of widths up to 1024 in multiples of 8, K2
  for the DeepSets chain at 256–1024 in multiples of 64 (a row pass writing
  ``h1`` and ``dz`` to a ``[P, W]`` f32 scratch, one block a tile at 256,
  then a ``d_W`` pass) and the tail's one bare layer of 256–1024 a side (a
  ``d_W`` pass over the points and the gathered cotangent, a row product
  for ``d_points``); in bf16 the wide one (one block a 64-row tile up to
  width 256, clusters of two or four blocks up to 1024, bf16 products on
  the tensor cores): K1 for chains up to 1024 in multiples of 8, over
  points of at most 8 features or a multiple of 8 (the tail's ``[P, H]``
  rows), K2 for the DeepSets chain at 256–1024 (a row pass writing ``dz``
  and the first layer's values, K1's bit for bit, to a ``[P, W]`` bf16
  scratch, then a ``d_W`` pass) and the tail's one bare layer of 256–1024
  a side (the cotangent rounded to bf16, a ``d_W`` pass over the points
  and its gathered rows, a row product for ``d_points``); the sliced one
  (a cluster of four blocks a tile, tensor cores in bf16) at the DeepSets
  chain of a narrow first layer and one 256 -> 256 layer only through the
  timing entries (``general=True``); the general one for every other
  chain; ``phi_pool.variant`` and ``phi_pool.bwd_variant`` name the last
  launch's.
  Under ``torch.func.vmap`` (a sweep's arms) each arm launches its own K1
  and K2 (``ops/dispatch.per_arm``);
- :func:`kernel_takes_chain` — whether the general variants' 8-row tiles of
  a chain fit in shared memory, K2's being the larger: the rule by which
  DeepSets routes a chain to the kernels or to the plain path before any
  launch.

φ layer spec: a tuple of ``("plain" | "residual", has_ln)`` entries.
``params`` holds one ``(w [in, out], b[, ln_scale, ln_bias])`` per spec entry,
optionally followed by the bare final linear ``(w, b)``: the hidden-only form
(``len(params) == len(spec)``) serves DeepSets' post-pool placement, where the
final linear runs per event after pooling.

Rounding follows the JAX package: each dot accumulates in f32 and is cast to
the compute dtype, then gets its bias added in that dtype; the activation
and the residual add run in that dtype; pooling is in f32.  The backward
rounds to the compute dtype where a tensor of that dtype is formed: the
gathered cotangent, ``dz = d_out ⊙ act'(z)`` (the product taken in f32),
each ``dz Wᵀ`` (accumulated in f32) and each residual add; ``d_W`` and
``d_b`` accumulate in f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from point_cloud_classifier_tpu_torch.ops.activations import (
    gelu_variant,
    resolve_activation,
)
from point_cloud_classifier_tpu_torch.ops.dispatch import (
    per_arm,
    require_plain_tensors,
    use_cuda_kernels,
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


def phi_hidden(points, spec: Spec, params: Sequence, activation: str, remat: bool = False):
    """The φ chain without the bare final linear (``len(params) == len(spec)``).
    ``remat`` recomputes each layer in the backward on its own
    (``torch.utils.checkpoint``, non-reentrant): only the layers' inputs are
    kept, and one layer's activations live again at a time."""
    act = resolve_activation(activation)
    h = points
    for (kind, has_ln), layer in zip(spec, params):
        w, b, *ln = layer
        ln_scale, ln_bias = ln if ln else (None, None)
        if remat:
            h = checkpoint(_apply_layer, h, kind, has_ln, w, b, ln_scale, ln_bias, act, use_reentrant=False)
        else:
            h = _apply_layer(h, kind, has_ln, w, b, ln_scale, ln_bias, act)
    return h


def phi_forward(points, spec: Spec, params: Sequence, activation: str, remat: bool = False):
    """Per-point features ``[P, H]``; the bare final linear runs when its
    params are present (``len(params) == len(spec) + 1``).  ``remat`` as
    :func:`phi_hidden`'s (the bare linear keeps only its input anyway)."""
    h = phi_hidden(points, spec, params[: len(spec)], activation, remat)
    if len(params) == len(spec):
        return h
    wf, bf = params[-1][0], params[-1][1]
    return torch.matmul(h, wf.to(h.dtype)) + bf.to(h.dtype)


def phi_pool_plain(
    points, seg, spec: Spec, params: Sequence, activation: str, num_segments: int
):
    """φ then f32 segment sums ``[num_segments, H]`` — the semantics contract
    (f64 sums for f64 points, which the gradient checks use)."""
    h = phi_forward(points, spec, params, activation)
    return segment_sum(h.to(torch.promote_types(h.dtype, torch.float32)), seg, num_segments)


def tf32_round(t):
    """f32 values rounded to TF32 as ``cvt.rna.tf32.f32`` rounds them: to
    the nearest value with 10 explicit mantissa bits, ties away from zero.
    On the bits: IEEE f32 is sign and magnitude, so adding half of the 13
    dropped bits' range to the pattern and clearing them rounds the
    magnitude (a carry runs into the exponent as it should)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3_matmul(h, w, passes: int = 3):
    """``h @ w`` for f32 operands as the tf32x3 variant of K1 forms it: each
    operand split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, and the
    partial products ``hi·hi + hi·lo + lo·hi`` (``lo·lo`` left out), each
    exact in f32 (two 11-bit significands) and summed in f32.  ``passes=1``
    takes ``hi·hi`` alone: a one-pass TF32 product."""
    h_hi, w_hi = tf32_round(h), tf32_round(w)
    if passes == 1:
        return h_hi @ w_hi
    h_lo, w_lo = tf32_round(h - h_hi), tf32_round(w - w_hi)
    return h_hi @ w_hi + (h_hi @ w_lo + h_lo @ w_hi)


def phi_forward_tf32x3(points, spec: Spec, params: Sequence, activation: str, passes: int = 3):
    """:func:`phi_forward` (no layer norm, f32) with every layer's product
    taken by :func:`tf32x3_matmul`; the bias, the activation and the
    residual add as :func:`phi_forward` takes them."""
    if points.dtype != torch.float32 or any(has_ln for _, has_ln in spec):
        raise ValueError("the tf32x3 products are f32 K1's: f32 points, no layer norm")
    act = resolve_activation(activation)
    kinds = [kind for kind, _ in spec] + ["linear"] * (len(params) - len(spec))
    h = points
    for kind, layer in zip(kinds, params):
        out = tf32x3_matmul(h, layer[0].float(), passes) + layer[1].float()
        if kind == "linear":
            h = out
        else:
            h = h + act(out) if kind == "residual" else act(out)
    return h


def phi_pool_tf32x3_plain(
    points, seg, spec: Spec, params: Sequence, activation: str, num_segments: int
):
    """What f32 K1's tf32x3 variant computes, in plain PyTorch: the φ chain
    of :func:`phi_forward_tf32x3`, then f32 segment sums.  It models the
    variant's products (their rounding), not its order of sums nor its
    epilogue's approximate sigmoid (~1e-7); tests and ``chip_smoke.py``
    hold it against the kernel and the JAX package, and the port's path
    never calls it."""
    h = phi_forward_tf32x3(points, spec, params, activation)
    return segment_sum(h, seg, num_segments)


def _act_grad(z, activation: str):
    """The derivative of the activation at ``z``, in ``z``'s dtype (callers
    pass f32 or f64); the same formulas as K2's ``act_grad``."""
    if activation == "relu":
        return (z > 0).to(z.dtype)
    if activation == "tanh":
        t = torch.tanh(z)
        return 1 - t * t
    if activation == "silu":
        s = torch.sigmoid(z)
        return s * (1 + z * (1 - s))
    if activation != "gelu":
        raise ValueError(f"Unknown activation: {activation}")
    if gelu_variant() == "quick":
        s = torch.sigmoid(1.702 * z)
        return s + 1.702 * z * s * (1 - s)
    c = 0.7978845608028654
    t = torch.tanh(c * (z + 0.044715 * z * z * z))
    return 0.5 * (1 + t) + 0.5 * z * (1 - t * t) * c * (1 + 3 * 0.044715 * z * z)


def phi_pool_bwd_plain(
    points,
    seg,
    g,
    spec: Spec,
    params: Sequence,
    activation: str,
    num_segments: int,
    with_points: bool = True,
):
    """The backward of :func:`phi_pool_plain` in closed form: ``(d_points,
    [d_w0, d_b0, d_w1, d_b1, …])`` for the f32 cotangent ``g [S, H]`` of the
    pooled sums.

    ``d_points`` is in the compute dtype (``None`` unless ``with_points``);
    ``d_w [in, out]`` and ``d_b`` are f32 (f64 for f64 inputs) for every
    layer, the bare final linear included when present.  Layer by layer, as
    K2 computes it: recompute the chain keeping each pre-activation ``z``;
    gather ``d_h[p] = g[seg[p]]`` (zero for ids ≥ ``num_segments``); then
    ``dz = d_out ⊙ act'(z)`` (bare linear: ``dz = d_out``), ``d_w = h_inᵀ
    dz``, ``d_b = Σ dz`` and ``d_in = dz Wᵀ`` (``+ d_out`` for a residual
    layer).  Layer norm has no closed form here and raises."""
    if any(has_ln for _, has_ln in spec):
        raise ValueError("phi_pool_bwd_plain takes no layer norm")
    dtype = points.dtype
    acc = torch.promote_types(dtype, torch.float32)
    act = resolve_activation(activation)
    kinds = [kind for kind, _ in spec] + ["linear"] * (len(params) - len(spec))

    h, inputs, pre = points, [], []
    for kind, layer in zip(kinds, params):
        w, b = layer[0].to(dtype), layer[1].to(dtype)
        z = torch.matmul(h, w) + b
        inputs.append(h)
        pre.append(z)
        if kind == "linear":
            h = z
        else:
            h = h + act(z) if kind == "residual" else act(z)

    seg = seg.long()
    valid = (seg >= 0) & (seg < num_segments)
    d_out = g.to(dtype)[seg.clamp(0, num_segments - 1)]
    d_out = torch.where(valid[:, None], d_out, torch.zeros_like(d_out))
    grads = []
    for layer_idx in reversed(range(len(params))):
        kind, z = kinds[layer_idx], pre[layer_idx]
        if kind == "linear":
            dz = d_out
        else:
            dz = (d_out.to(acc) * _act_grad(z.to(acc), activation)).to(dtype)
        grads[:0] = [inputs[layer_idx].to(acc).t() @ dz.to(acc), dz.to(acc).sum(0)]
        if layer_idx == 0 and not with_points:
            d_out = None
            break
        d_in = torch.matmul(dz, params[layer_idx][0].to(dtype).t())
        d_out = d_in + d_out if kind == "residual" else d_in
    return d_out, grads


def phi_pool_bwd_tf32x3_plain(
    points,
    seg,
    g,
    spec: Spec,
    params: Sequence,
    activation: str,
    num_segments: int,
    with_points: bool = True,
    passes: int = 3,
):
    """What f32 K2's tf32x3 variant computes, in plain PyTorch:
    :func:`phi_pool_bwd_plain`'s closed form with every product (the
    recompute, ``d_w = h_inᵀ dz`` and ``dz Wᵀ``) taken by
    :func:`tf32x3_matmul` (``passes=1``: one-pass TF32).  It models the variant's products, not its order of sums
    nor its approximate sigmoid (~1e-7); the variant forms the first layer's
    ``d_w``, the biases' sums and ``d_points`` of the DeepSets chain by f32
    multiply-adds (~1e-6 apart from this).  Tests and ``chip_smoke.py`` hold
    it against the kernel and the JAX package; the port's path never calls
    it."""
    if points.dtype != torch.float32 or any(has_ln for _, has_ln in spec):
        raise ValueError("the tf32x3 products are f32 K2's: f32 points, no layer norm")
    mm = functools.partial(tf32x3_matmul, passes=passes)
    act = resolve_activation(activation)
    kinds = [kind for kind, _ in spec] + ["linear"] * (len(params) - len(spec))
    h, inputs, pre = points, [], []
    for kind, layer in zip(kinds, params):
        z = mm(h, layer[0].float()) + layer[1].float()
        inputs.append(h)
        pre.append(z)
        if kind == "linear":
            h = z
        else:
            h = h + act(z) if kind == "residual" else act(z)

    seg = seg.long()
    valid = (seg >= 0) & (seg < num_segments)
    d_out = g.float()[seg.clamp(0, num_segments - 1)]
    d_out = torch.where(valid[:, None], d_out, torch.zeros_like(d_out))
    grads = []
    for layer_idx in reversed(range(len(params))):
        kind, z = kinds[layer_idx], pre[layer_idx]
        dz = d_out if kind == "linear" else d_out * _act_grad(z, activation)
        grads[:0] = [mm(inputs[layer_idx].t(), dz), dz.sum(0)]
        if layer_idx == 0 and not with_points:
            return None, grads
        d_in = mm(dz, params[layer_idx][0].float().t())
        d_out = d_in + d_out if kind == "residual" else d_in
    return d_out, grads

# -- K1 and K2: the CUDA kernels --------------------------------------------------

_KINDS = {"plain": 0, "residual": 1}
_BARE_LINEAR = 2
_ACTS = {"relu": 0, "silu": 1, "tanh": 2}
_QUICK_GELU, _GELU_TANH = 3, 4
_MAX_LAYERS = 8  # csrc/phi_chain.cuh kMaxLayers
_MAX_SMEM = 232448  # csrc/phi_chain.cuh kMaxSmem: 227 KB a block
_MIN_ROWS = 8  # the general variants' narrowest tile


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def kernel_takes_chain(dims: Sequence[int], kinds: Sequence[str]) -> bool:
    """Whether K1 and K2 take a chain of widths ``dims`` (input first) and
    layer kinds ``kinds`` (``"plain"``, ``"residual"``, ``"linear"`` for the
    bare final linear): at most ``_MAX_LAYERS`` layers, and the general
    variants' tiles of 8 rows within 227 KB of shared memory, as their C
    entries size them.  K1 keeps two f32 rows of the widest layer a row
    (``csrc/phi_pool.cu:smem_bytes``); K2 keeps every layer's input, every
    activated layer's pre-activation and two gradient rows of the widest
    output (``csrc/phi_pool_bwd.cu:BwdLayout``), each rounded up to 4 floats,
    so K2 refuses first: φ [1024] × 4 (post-pool placement) is the narrowest
    DeepSets chain it cannot hold.  The sliced variants serve chains whose
    general tiles fit."""
    if len(kinds) > _MAX_LAYERS:
        return False
    k1 = 2 * _MIN_ROWS * _round4(max(dims)) * 4 + _MIN_ROWS * 4
    cols = sum(_round4(d) for d in dims[:-1])
    cols += sum(_round4(d) for d, kind in zip(dims[1:], kinds) if kind != "linear")
    cols += 2 * max((_round4(d) for d in dims[1:]), default=0)
    k2 = _MIN_ROWS * cols * 4 + _MIN_ROWS * 4
    return max(k1, k2) <= _MAX_SMEM


def _activation_code(activation: str) -> int:
    if activation == "gelu":
        return _QUICK_GELU if gelu_variant() == "quick" else _GELU_TANH
    if activation not in _ACTS:
        raise ValueError(f"Unknown activation: {activation}")
    return _ACTS[activation]


class _PhiPoolFn(torch.autograd.Function):
    """K1 forward and K2 backward on CUDA tensors, the plain versions on CPU
    ones (and inside ``force_plain``).  Like the JAX custom VJP it saves only
    its inputs: the backward recomputes the chain, and no ``[P, H]``
    activation is kept.  The weights and biases arrive as flat tensor
    arguments so that autograd sees them.  Under ``torch.func.vmap`` each arm
    takes its own launch (:func:`~point_cloud_classifier_tpu_torch.ops.dispatch.per_arm`),
    and the backward is :class:`_PhiPoolBwdFn`, which has the same rule."""

    @staticmethod
    def forward(points, seg, spec, activation, num_segments, *flat):
        params = tuple(zip(flat[0::2], flat[1::2]))
        if use_cuda_kernels(points):
            return _phi_pool_cuda(points, seg, spec, params, activation, num_segments)
        return phi_pool_plain(points, seg, spec, params, activation, num_segments)

    @staticmethod
    def setup_context(ctx, inputs, output):
        points, seg, spec, activation, num_segments, *flat = inputs
        ctx.save_for_backward(points, seg, *flat)
        ctx.spec, ctx.activation, ctx.num_segments = spec, activation, num_segments

    @staticmethod
    def backward(ctx, g):
        points, seg, *flat = ctx.saved_tensors
        with_points = ctx.needs_input_grad[0]
        d_points, *grads = _PhiPoolBwdFn.apply(
            points, seg, g, ctx.spec, ctx.activation, ctx.num_segments, with_points, *flat
        )
        # each gradient in its parameter's dtype (_reassemble_param_grads)
        d_flat = [
            d.reshape(t.shape).to(t.dtype) if need else None
            for d, t, need in zip(grads, flat, ctx.needs_input_grad[5:])
        ]
        return (d_points if with_points else None, None, None, None, None, *d_flat)

    @staticmethod
    def vmap(info, in_dims, points, seg, spec, activation, num_segments, *flat):
        def one(p, s, *f):
            return _PhiPoolFn.apply(p, s, spec, activation, num_segments, *f)

        return per_arm(one, info, (in_dims[0], in_dims[1], *in_dims[5:]), points, seg, *flat)


class _PhiPoolBwdFn(torch.autograd.Function):
    """``(d_points, d_w0, d_b0, …)`` of :class:`_PhiPoolFn`: K2 on CUDA
    tensors, :func:`phi_pool_bwd_plain` on CPU ones (and inside
    ``force_plain``).  ``d_points`` is an empty tensor unless
    ``with_points``.  Not differentiable itself."""

    @staticmethod
    def forward(points, seg, g, spec, activation, num_segments, with_points, *flat):
        params = tuple(zip(flat[0::2], flat[1::2]))
        bwd = _phi_pool_bwd_cuda if use_cuda_kernels(points) else phi_pool_bwd_plain
        d_points, grads = bwd(
            points, seg, g, spec, params, activation, num_segments, with_points=with_points
        )
        return (points.new_zeros(0) if d_points is None else d_points, *grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, points, seg, g, spec, activation, num_segments, with_points, *flat):
        def one(p, s, gg, *f):
            return _PhiPoolBwdFn.apply(p, s, gg, spec, activation, num_segments, with_points, *f)

        return per_arm(one, info, (*in_dims[:3], *in_dims[7:]), points, seg, g, *flat)


def phi_pool(
    points, seg, spec: Spec, params: Sequence, activation: str, num_segments: int
):
    """Fused φ + f32 segment sums ``[num_segments, H]``, differentiable in
    ``points`` and every weight and bias.

    CPU tensors (and any inside ``force_plain``) take
    :func:`phi_pool_plain` forward and :func:`phi_pool_bwd_plain` backward;
    CUDA tensors launch K1 forward and K2 backward.  Layer-norm specs have no
    kernel: off the kernels they take :func:`phi_pool_plain` under autograd,
    and on them they raise, as does anything else the kernels cannot compute
    (:func:`kernel_takes_chain`) — there is no fallback.
    """
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"phi_pool takes CPU or CUDA tensors, got {points.device}")
    if any(has_ln for _, has_ln in spec):
        if use_cuda_kernels(points):
            raise ValueError("K1 takes no layer norm: LN specs use phi_pool_plain")
        return phi_pool_plain(points, seg, spec, params, activation, num_segments)
    flat = [t for layer in params for t in layer[:2]]
    return _PhiPoolFn.apply(points, seg, tuple(spec), activation, num_segments, *flat)


phi_pool.launches = 0
phi_pool.bwd_launches = 0
# the variant ("sliced", "tf32x3", "wide" or "general") that the last K1 and K2 launch took
phi_pool.variant = None
phi_pool.bwd_variant = None


def _kernel_operands(points, seg, spec, params):
    """Validate what K1 and K2 take; returns ``(weights, biases, dims,
    kinds)`` with the weights and biases in the points' dtype on its device."""
    if any(has_ln for _, has_ln in spec):
        raise ValueError("K1 takes no layer norm: LN specs use phi_pool_plain")
    if len(params) not in (len(spec), len(spec) + 1):
        raise ValueError("params must hold one entry per spec layer (+ final)")
    if len(params) > _MAX_LAYERS:
        raise ValueError(f"K1 takes at most {_MAX_LAYERS} layers")
    if points.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes f32 or bf16 points, got {points.dtype}")
    if points.ndim != 2 or tuple(seg.shape) != (points.shape[0],):
        raise ValueError(
            f"points must be [P, F] and seg [P], got {tuple(points.shape)} "
            f"and {tuple(seg.shape)}"
        )
    if seg.dtype != torch.int32 or seg.device != points.device:
        raise TypeError("seg must be int32 on the points' device")
    require_plain_tensors(points, seg, *(t for layer in params for t in layer[:2]))

    dtype, device = points.dtype, points.device
    weights = [layer[0].to(device=device, dtype=dtype) for layer in params]
    # on 4-byte boundaries at least: the wide variants read a bias pair at a time
    biases = _weights([layer[1].to(device=device, dtype=dtype) for layer in params])
    dims = [points.shape[1]]
    for w, b in zip(weights, biases):
        if w.ndim != 2 or w.shape[0] != dims[-1] or tuple(b.shape) != (w.shape[1],):
            raise ValueError(
                f"layer shapes do not chain: w {tuple(w.shape)}, b "
                f"{tuple(b.shape)} after width {dims[-1]}"
            )
        dims.append(w.shape[1])
    # how wide a chain each kernel takes is decided by its C entry, which
    # refuses a tile that does not fit in shared memory (check() raises)
    kinds = [_KINDS[kind] for kind, _ in spec] + [_BARE_LINEAR] * (
        len(params) - len(spec)
    )
    return weights, biases, dims, kinds


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _weights(weights):
    """The weights (or biases) contiguous and on 16-byte boundaries: the
    wide variants copy W into shared memory 16 bytes at a time."""
    weights = [w.contiguous() for w in weights]
    return [w.clone() if w.data_ptr() % 16 else w for w in weights]


@functools.lru_cache(maxsize=None)
def kernel_variant(
    dims: tuple, kinds: tuple, bf16: bool, backward: bool, general: bool = False, take: str = "sliced"
) -> str:
    """Which variant K1 (``backward`` false) or K2 (true) takes for a chain
    on the card, ``"sliced"``, ``"tf32x3"`` (f32), ``"wide"`` (bf16) or
    ``"general"``: the C entry's own choice (``pcc_phi_pool_variant``), made
    from the chain's shape, the element type and the kernel alone
    (``csrc/phi_pool.cu:tf32x3_plan``, ``csrc/phi_tf32.cuh:bwd_tf32x3_plan``,
    ``csrc/phi_wide.cuh:wide_plan``, ``csrc/phi_chain.cuh:takes_sliced``).
    ``general``: the choice of the timing entries, which take the sliced
    variant where it takes the chain, else the general one
    (``_phi_pool_cuda(general=True)``, ``_phi_pool_bwd_cuda(general=True)``);
    K1's also the general one alone (``take="general"``)."""
    from point_cloud_classifier_tpu_torch.native import kernel_library

    n = len(kinds)
    code = kernel_library().lib.pcc_phi_pool_variant(
        n, (ctypes.c_int * (n + 1))(*dims), (ctypes.c_int * n)(*kinds), int(bf16), int(backward),
        1 if not general else {"sliced": 0, "general": -1}[take],
    )
    return _VARIANTS.get(code, "general")


_VARIANTS = {1: "sliced", 2: "tf32x3", 3: "wide"}  # pcc_phi_pool_variant's codes; 0 general


def _phi_pool_cuda(points, seg, spec, params, activation, num_segments, general=False, take="sliced"):
    """K1.  ``general`` launches the timing entry (``pcc_phi_pool_general``),
    to time the variants side by side: the sliced variant (bf16, the
    DeepSets chain of φ 256) where ``take`` is ``"sliced"`` and it takes the
    chain, else the general one; the port's path never sets it."""
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    weights, biases, dims, kinds = _kernel_operands(points, seg, spec, params)
    weights = _weights(weights)
    device = points.device
    out = torch.zeros((num_segments, dims[-1]), dtype=torch.float32, device=device)
    n_points = points.shape[0]
    if n_points == 0:
        return out
    points, seg = points.contiguous(), seg.contiguous()
    if points.data_ptr() % 16:
        points = points.clone()  # the wide variant copies rows of wide points 16 bytes at a time
    n = len(params)
    lib = kernel_library().lib
    if general:
        def entry(*args):
            return lib.pcc_phi_pool_general(*args, int(take == "sliced"))
    else:
        entry = lib.pcc_phi_pool
    with torch.cuda.device(device):
        code = entry(
            points.data_ptr(),
            seg.data_ptr(),
            out.data_ptr(),
            n_points,
            points.shape[1],
            num_segments,
            n,
            (ctypes.c_int * (n + 1))(*dims),
            (ctypes.c_int * n)(*kinds),
            _pointers(weights),
            _pointers(biases),
            _activation_code(activation),
            int(points.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(code)
    phi_pool.launches += 1
    phi_pool.variant = kernel_variant(
        tuple(dims), tuple(kinds), points.dtype == torch.bfloat16, False, general, take
    )
    return out


def _phi_pool_bwd_cuda(
    points, seg, g, spec, params, activation, num_segments, with_points=True, general=False,
    departures=None,
):
    """K2: the CUDA counterpart of :func:`phi_pool_bwd_plain`, same contract.
    ``general`` leaves the tf32x3 and the wide variants out
    (``pcc_phi_pool_bwd_general``), to time them side by side with what
    served their chains before: the sliced variant (a 4-block cluster a
    tile) at the DeepSets chain of φ 256, in f32 and bf16, and the general one wherever
    else they run; the port's path never sets it.  ``departures``, a pair
    ``(refs, counts)`` on the card, holds the recomputed hidden rows against
    K1's own forward after the launch (``pcc_phi_pool_bwd_departures``): of
    the one-block wide form (bf16, the DeepSets chain at φ 256: h1) or the
    tf32x3 variant (f32, the DeepSets chain of S square layers: h1 … h_S).
    ``refs[l - 1]`` is K1's own values of the chain's first ``l`` layers,
    pooled one segment a point (``[P, W]`` f32; ``chip_smoke.py:k1_rows``),
    and of the zeroed int64 ``counts [2 · len(refs)]``, ``[2(l - 1)]`` gets
    the values of h_l that differ, ``[2(l - 1) + 1]`` the largest difference
    of one in units of 2^-24.  A check; the port's path never sets it
    either."""
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    weights, biases, dims, kinds = _kernel_operands(points, seg, spec, params)
    require_plain_tensors(g)
    device = points.device
    if g.device != device or tuple(g.shape) != (num_segments, dims[-1]):
        raise ValueError(
            f"g must be [{num_segments}, {dims[-1]}] on {device}, got "
            f"{tuple(g.shape)} on {g.device}"
        )
    sizes = [(i * o, o) for i, o in zip(dims[:-1], dims[1:])]
    flat = torch.empty(sum(a + b for a, b in sizes), dtype=torch.float32, device=device)
    d_points = torch.empty_like(points, memory_format=torch.contiguous_format) if with_points else None
    n_points = points.shape[0]
    if n_points == 0:
        flat.zero_()
    else:
        # the sliced and the wide variants read one [in, out] copy for both
        # products; the general one wants [out, in] as well, for dz Wᵀ
        bf16 = points.dtype == torch.bfloat16
        variant = kernel_variant(tuple(dims), tuple(kinds), bf16, True, general)
        w_fwd = _weights(weights)
        w_bwd = [w.t().contiguous() for w in weights] if variant == "general" else None
        points, seg, g = points.contiguous(), seg.contiguous(), g.float().contiguous()
        if variant in ("tf32x3", "wide"):
            # their d_W passes copy rows of the points (and the f32 tail's of
            # g) 16 bytes at a time
            points, g = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (points, g))
        # one f32 slab of every d_w and d_b per block (general) or cluster
        # (sliced) of the persistent grid; the wide and tf32x3 variants'
        # cluster slabs, their [P, W] h1 and dz2 (bf16, f32) and their d_W
        # partials (the tail's: its d_W and d_b partials, and in bf16 g
        # rounded to bf16)
        max_blocks = torch.cuda.get_device_properties(device).multi_processor_count
        n = len(params)
        lib = kernel_library().lib
        n_scratch = ctypes.c_longlong(flat.numel() * max_blocks)  # the general variant's slabs
        if not general:
            check(lib.pcc_phi_pool_bwd_scratch(
                n_points, num_segments, n, (ctypes.c_int * (n + 1))(*dims), (ctypes.c_int * n)(*kinds), int(bf16),
                max_blocks, ctypes.byref(n_scratch),
            ))
        slabs = torch.empty(n_scratch.value, dtype=torch.float32, device=device)
        entry = lib.pcc_phi_pool_bwd_general if general else lib.pcc_phi_pool_bwd
        with torch.cuda.device(device):
            code = entry(
                points.data_ptr(),
                seg.data_ptr(),
                g.data_ptr(),
                d_points.data_ptr() if with_points else None,
                flat.data_ptr(),
                slabs.data_ptr(),
                max_blocks,
                n_points,
                points.shape[1],
                num_segments,
                n,
                (ctypes.c_int * (n + 1))(*dims),
                (ctypes.c_int * n)(*kinds),
                _pointers(w_fwd),
                _pointers(w_bwd) if w_bwd is not None else None,
                _pointers(biases),
                _activation_code(activation),
                int(points.dtype == torch.bfloat16),
                torch.cuda.current_stream(device).cuda_stream,
            )
        check(code)
        phi_pool.bwd_launches += 1
        phi_pool.bwd_variant = variant
        if departures is not None:
            refs, counts = departures
            if tuple(counts.shape) != (2 * len(refs),) or counts.dtype != torch.int64:
                raise ValueError(f"counts must be [{2 * len(refs)}] int64, got {tuple(counts.shape)}")
            for layer, ref in enumerate(refs, 1):
                if tuple(ref.shape) != (n_points, dims[1]) or ref.dtype != torch.float32:
                    raise ValueError(f"refs[{layer - 1}] must be [{n_points}, {dims[1]}] f32, got {tuple(ref.shape)}")
                ref = ref.contiguous()
                with torch.cuda.device(device):
                    check(lib.pcc_phi_pool_bwd_departures(
                        ref.data_ptr(), slabs.data_ptr(), max_blocks, n_points, n,
                        (ctypes.c_int * (n + 1))(*dims), (ctypes.c_int * n)(*kinds), int(bf16), layer,
                        counts[2 * (layer - 1):].data_ptr(), torch.cuda.current_stream(device).cuda_stream,
                    ))
    grads, offset = [], 0
    for (i, o), (wsize, bsize) in zip(zip(dims[:-1], dims[1:]), sizes):
        grads.append(flat[offset : offset + wsize].view(i, o))
        grads.append(flat[offset + wsize : offset + wsize + bsize])
        offset += wsize + bsize
    return d_points, grads

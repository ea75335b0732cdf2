"""The port's bf16 φ backward at wide chains, and the card's bf16 products.

``phi_pool_bwd_plain`` (the closed form that the CUDA kernel K2 computes) in
bf16 at φ [1024, 1024] goes against the JAX package's bf16 backward
(``jax.vjp`` of ``phi_pool_xla``) on the same seeded numpy inputs, and at
φ [256, 256], [384, 384] and [1024, 1024] against itself with each bf16 product's
contraction summed as two f32 halves, and with each d_W summed over chunks
of the points, then the chunks in order: the same roundings, the sums in
another order.  That spread is what the card's bf16 bound on K2 against
``phi_pool_bwd_plain`` (1e-3 relative Frobenius, chip_smoke.py) rests on.

On the card the port sums every bf16 product in f32 as the JAX package's
dots do: taking the card turns off PyTorch's
``allow_bf16_reduced_precision_reduction``, under which cuBLAS adds split-K
partial sums in bf16 (``models/wrapper.resolve_device``).  The last tests
hold that rule here, with the card's presence faked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.ops import fused_phi as jax_phi  # noqa: E402
from point_cloud_classifier_tpu_torch.models import wrapper  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi  # noqa: E402
from point_cloud_classifier_tpu_torch.parallel import mesh  # noqa: E402

SPEC = (("plain", False), ("residual", False))
B, P = 5, 128
# the JAX package's bf16 backward rounds at other points (autodiff rounds
# every primitive's cotangent, the closed form once per dz, dz Wᵀ and
# residual add): tests/test_torch_fused_phi_bwd.py's BF16_FRO
BF16_FRO = 1e-2
# the same roundings with each bf16 product summed in another order: a sum
# can land on the neighbouring bf16 value (2^-8 relative) now and then
REORDER_FRO = 1e-3
MATMUL = torch.matmul
MATMUL_OP = torch.Tensor.__matmul__


def _inputs(width, seed=0):
    """Seeded points, sorted seg ids (padding rows get id B; event 2 is
    empty), params (w [in, out], b) and an f32 cotangent with a zero
    padding row, so that both sides get the same one."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(P, 6)).astype(np.float32)
    seg = np.sort(rng.integers(0, B + 1, size=P)).astype(np.int32)
    seg[seg == 2] = 3
    params, last = [], 6
    for _ in SPEC:
        w = (rng.normal(size=(last, width)) * last**-0.5).astype(np.float32)
        bias = (rng.normal(size=(width,)) * 0.1).astype(np.float32)
        params.append((w, bias))
        last = width
    g = rng.normal(size=(B + 1, width)).astype(np.float32)
    g[-1] = 0.0
    return pts, seg, tuple(params), g


def _port(pts, seg, params, g, activation):
    d_points, grads = fused_phi.phi_pool_bwd_plain(
        torch.from_numpy(pts).to(torch.bfloat16), torch.from_numpy(seg), torch.from_numpy(g), SPEC,
        tuple((torch.from_numpy(w), torch.from_numpy(b)) for w, b in params), activation, B + 1,
    )
    assert d_points.dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in grads)
    return [d_points.float().numpy()] + [t.numpy() for t in grads]


def _jax_vjp(pts, seg, params, g, activation):
    jparams = tuple((jnp.asarray(w), jnp.asarray(b), None, None) for w, b in params)

    def f(x, prm):
        return jax_phi.phi_pool_xla(x, jnp.asarray(seg), SPEC, prm, activation, B + 1)

    _, vjp = jax.vjp(f, jnp.asarray(pts).astype(jnp.bfloat16), jparams)
    d_points, d_params = vjp(jnp.asarray(g))
    return [np.asarray(d_points, np.float32)] + [
        np.asarray(t, np.float32) for layer in d_params for t in layer if t is not None
    ]


def _split_sum_matmul(a, b):
    """``a @ b`` for bf16 operands as two f32 halves of the contraction,
    added, then rounded to bf16 once: the products are exact in f32, so
    only the order of the sums differs from one f32 sum."""
    if a.dtype != torch.bfloat16:
        return MATMUL(a, b)
    half = a.shape[-1] // 2
    lo = MATMUL(a[..., :half].float(), b[:half].float())
    return (lo + MATMUL(a[..., half:].float(), b[half:].float())).to(torch.bfloat16)


def _chunked_rows_matmul(counts, chunk):
    """``a @ b`` with, for an f32 product whose contraction runs over the P
    point rows (each layer's ``d_w = h_inᵀ dz``), f32 sums over chunks of
    ``chunk`` rows, then the chunks added in order; every other product as
    it was.  ``counts`` gains one for each product it reorders."""

    def matmul(a, b):
        if a.dtype != torch.float32 or a.dim() != 2 or a.shape[1] != P:
            return MATMUL_OP(a, b)
        counts.append(1)
        out = MATMUL_OP(a[:, :chunk], b[:chunk])
        for r in range(chunk, P, chunk):
            out = out + MATMUL_OP(a[:, r : r + chunk], b[r : r + chunk])
        return out

    return matmul


def _fro(out, ref):
    return [np.linalg.norm(a.astype(np.float64) - r.astype(np.float64)) / np.linalg.norm(r.astype(np.float64))
            for a, r in zip(out, ref, strict=True)]


# The smooth activations.  relu's derivative is a step: a pre-activation
# within a bf16 step of 0 lands on opposite sides in the two packages'
# forwards, and the cotangent entry it gates flips whole.  At this width
# d_b1, a bare sum of gated cotangents, then reads about 1e-2 from
# jax.vjp's and from phi_pool_bwd_pallas's alike, so relu is held at width
# 16 in tests/test_torch_fused_phi_bwd.py, against an f64 run below, and by
# the order of sums.
@pytest.mark.parametrize("activation", ["gelu", "silu", "tanh"])
def test_bf16_backward_at_width_1024_matches_jax_vjp(activation):
    pts, seg, params, g = _inputs(1024)
    out, ref = _port(pts, seg, params, g, activation), _jax_vjp(pts, seg, params, g, activation)
    assert [a.shape for a in out] == [r.shape for r in ref]
    assert max(_fro(out, ref)) <= BF16_FRO


def test_relu_bf16_backward_at_width_1024_is_no_further_from_f64_than_jax_vjp():
    """At relu, width 1024, each of the port's bf16 gradients is at least
    as near the exact backward (phi_pool_bwd_plain in f64 on the bf16
    inputs: points, weights and biases rounded to bf16, then widened) as
    jax.vjp's: d_b1 reads 8.5e-3 against jax.vjp's 1.4e-2."""
    pts, seg, params, g = _inputs(1024)
    out, ref = _port(pts, seg, params, g, "relu"), _jax_vjp(pts, seg, params, g, "relu")

    def exact(a):
        return torch.from_numpy(a).to(torch.bfloat16).double()

    d_points, grads = fused_phi.phi_pool_bwd_plain(
        exact(pts), torch.from_numpy(seg), torch.from_numpy(g).double(), SPEC,
        tuple((exact(w), exact(b)) for w, b in params), "relu", B + 1,
    )
    f64 = [d_points.numpy()] + [t.numpy() for t in grads]
    port, jax_side = _fro(out, f64), _fro(ref, f64)
    assert all(a <= r for a, r in zip(port, jax_side, strict=True)), (port, jax_side)
    assert jax_side[-1] - port[-1] >= 4e-3


@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("width", [256, 384, 1024])
def test_bf16_backward_moves_little_with_the_order_of_its_sums(monkeypatch, width, activation):
    pts, seg, params, g = _inputs(width, seed=1)
    out = _port(pts, seg, params, g, activation)
    monkeypatch.setattr(torch, "matmul", _split_sum_matmul)
    reordered = _port(pts, seg, params, g, activation)
    monkeypatch.undo()
    assert max(_fro(out, reordered)) <= REORDER_FRO


# Each d_W summed over chunks of 32 of the points in f32, then the chunks
# in order (dz still rounded to bf16 as before), against the one f32 sum:
# within REORDER_FRO; and against jax.vjp at φ [1024, 1024] within BF16_FRO
# (gelu: relu's d_b1 reads 1e-2 from jax.vjp whatever the order, see above).
@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("width", [256, 384, 1024])
def test_bf16_backward_moves_little_when_d_w_is_summed_in_chunks_of_points(monkeypatch, width, activation):
    pts, seg, params, g = _inputs(width, seed=1)
    out = _port(pts, seg, params, g, activation)
    counts = []
    monkeypatch.setattr(torch.Tensor, "__matmul__", _chunked_rows_matmul(counts, 32))
    chunked = _port(pts, seg, params, g, activation)
    monkeypatch.undo()
    assert len(counts) == len(SPEC)  # both layers' d_w were reordered
    assert max(_fro(out, chunked)) <= REORDER_FRO
    if width == 1024 and activation == "gelu":
        assert max(_fro(chunked, _jax_vjp(pts, seg, params, g, activation))) <= BF16_FRO


@pytest.fixture
def reduced_reduction(monkeypatch):
    """PyTorch's default (bf16 split-K partial sums may round to bf16),
    restored after the test."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction", True)
    return monkeypatch


@pytest.mark.parametrize("resolve", [wrapper.resolve_device, mesh.resolve_device], ids=["wrapper", "mesh"])
def test_taking_the_card_sums_bf16_products_in_f32(reduced_reduction, resolve):
    reduced_reduction.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve().type == "cuda"
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    assert resolve("cuda:0") == torch.device("cuda", 0)
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


def test_the_cpu_leaves_the_cuda_setting_alone(reduced_reduction):
    assert wrapper.resolve_device("cpu").type == "cpu"
    assert mesh.rank_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is True
    reduced_reduction.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wrapper.resolve_device()
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is True

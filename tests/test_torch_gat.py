"""The port's GAT attention (``ops/gat.py``) and in-row adjacency
(``ops/inrow_graph.py``) against the JAX package's, from the same seeded
numpy inputs: the XLA oracle and both Pallas kernel forms in interpret mode,
forward at f32 to 1e-5; the CPU autograd of the plain version against
``jax.grad`` of the oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_classifier_tpu.ops import gat_pallas as jax_gat  # noqa: E402
from point_cloud_classifier_tpu.ops.inrow_graph import inrow_adjacency_xla  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import gat  # noqa: E402
from point_cloud_classifier_tpu_torch.ops.dispatch import force_plain, use_cuda_kernels  # noqa: E402
from point_cloud_classifier_tpu_torch.ops.inrow_graph import inrow_adjacency  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
# gradients: the same math, summed in other orders
GRAD = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed=0, b=3, m=64, d=4, h=4, dh=8, frac=0.5, id_pool=None, isolated=0):
    """Scores, in-row lists and xw.  ``id_pool`` draws sources from a tiny
    pool, so most rows hold duplicate sources and self-edges; the first
    ``isolated`` nodes of each graph get no valid slot."""
    rng = np.random.default_rng(seed)
    s_dst = rng.normal(size=(b, m, h)).astype(np.float32)
    s_src = rng.normal(size=(b, m, h)).astype(np.float32)
    in_src = rng.integers(0, id_pool or m, size=(b, m, d)).astype(np.int32)
    in_w = (rng.random((b, m, d)) * (rng.random((b, m, d)) < frac)).astype(np.float32)
    in_w[:, :isolated] = 0.0
    xw = rng.normal(size=(b, m, h * dh)).astype(np.float32)
    return s_dst, s_src, in_src, in_w, xw


CASES = {
    "random": dict(seed=0),
    "dedupe-self-edges-zero-w": dict(seed=7, b=2, m=32, d=8, h=2, id_pool=6, frac=0.7),
    "isolated": dict(seed=3, isolated=9),
    "d8": dict(seed=4, b=2, m=40, d=8, frac=0.8),
    "one-head": dict(seed=5, b=2, m=16, h=1, dh=16),
}


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("slope", [0.2, 0.01])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_oracle(case, slope):
    arrays = _inputs(**CASES[case])
    want = np.asarray(jax_gat.gat_attention_xla(*map(jnp.asarray, arrays), slope))
    got = gat.gat_attention_plain(*_torch(*arrays), slope)
    assert got.dtype == torch.float32 and got.shape == arrays[-1].shape
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("form", ["slot", "dense"])
@pytest.mark.parametrize("slope", [0.2, 0.01])
@pytest.mark.parametrize("case", ["random", "dedupe-self-edges-zero-w", "isolated", "d8"])
def test_plain_matches_both_interpret_kernel_forms(monkeypatch, case, slope, form):
    """K3s and K3d, the two TPU forms K3 replaces, run in interpret mode."""
    monkeypatch.setenv("PCC_GAT_KERNEL", form)
    arrays = _inputs(**CASES[case])
    want = np.asarray(jax_gat.gat_attention_fused(*map(jnp.asarray, arrays), slope, True))
    got = gat.gat_attention_plain(*_torch(*arrays), slope)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_isolated_and_padding_nodes_return_their_own_row():
    s_dst, s_src, in_src, in_w, xw = _torch(*_inputs(seed=2, frac=0.0))
    np.testing.assert_allclose(
        gat.gat_attention_plain(s_dst, s_src, in_src, in_w, xw).numpy(), xw.numpy(), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("wire", ["f32-int32", "f16-int16"])
def test_adjacency_matches_jax(wire):
    _, _, in_src, in_w, _ = _inputs(seed=8, d=8, frac=0.6, id_pool=20)
    if wire == "f16-int16":
        in_src, in_w = in_src.astype(np.int16), in_w.astype(np.float16)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(inrow_adjacency_xla(jnp.asarray(in_src), jnp.asarray(in_w), 64, jdtype))
        got = inrow_adjacency(*_torch(in_src, in_w), 64, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    want = np.asarray(jax_gat._adj_mask_xla(jnp.asarray(in_src), jnp.asarray(in_w), 64))
    np.testing.assert_array_equal(gat.adjacency_mask(*_torch(in_src, in_w), 64).numpy(), want)


def test_bf16_xw_matches_jax_oracle():
    """α is rounded to bf16 before an f32 product and sum on both sides."""
    s_dst, s_src, in_src, in_w, xw = _inputs(seed=9, d=8, frac=0.8)
    want = jax_gat.gat_attention_xla(
        *map(jnp.asarray, (s_dst, s_src, in_src, in_w)), jnp.asarray(xw, jnp.bfloat16)
    )
    got = gat.gat_attention_plain(*_torch(s_dst, s_src, in_src, in_w), torch.from_numpy(xw).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    # one bf16 ulp of the output where the f32 sums round apart
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-8, atol=1e-6)


@pytest.mark.parametrize("case", ["random", "dedupe-self-edges-zero-w", "isolated"])
def test_plain_autograd_matches_jax_grad(case):
    """The backward that K4 will be held to: d s_dst, d s_src and d xw."""
    s_dst, s_src, in_src, in_w, xw = _inputs(**CASES[case])
    cot = np.random.default_rng(13).normal(size=xw.shape).astype(np.float32)

    def loss(sd, ss, x):
        return jnp.sum(jax_gat.gat_attention_xla(sd, ss, jnp.asarray(in_src), jnp.asarray(in_w), x) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (s_dst, s_src, xw)))
    leaves = [t.requires_grad_() for t in _torch(s_dst, s_src, xw)]
    out = gat.gat_attention_plain(leaves[0], leaves[1], *_torch(in_src, in_w), leaves[2])
    (out * torch.from_numpy(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD)


def test_entry_point_on_cpu_takes_the_plain_version():
    arrays = _torch(*_inputs(seed=1))
    assert not use_cuda_kernels(arrays[-1])
    before = gat.gat_attention.launches
    out = gat.gat_attention(*arrays)
    with force_plain():
        again = gat.gat_attention(*arrays)
    assert gat.gat_attention.launches == before
    torch.testing.assert_close(out, gat.gat_attention_plain(*arrays), rtol=0, atol=0)
    torch.testing.assert_close(again, out, rtol=0, atol=0)


def test_kernel_operand_checks():
    s_dst, s_src, in_src, in_w, xw = _torch(*_inputs(seed=1, d=4))
    gat._check_operands(s_dst, s_src, in_src.short(), in_w.half(), xw.bfloat16())
    with pytest.raises(TypeError, match="f32 or bf16 xw"):
        gat._check_operands(s_dst, s_src, in_src, in_w, xw.half())
    with pytest.raises(TypeError, match="int32/int16"):
        gat._check_operands(s_dst, s_src, in_src.long(), in_w, xw)
    with pytest.raises(ValueError, match="multiple of H"):
        gat._check_operands(s_dst[..., :3], s_src[..., :3], in_src, in_w, xw[..., :10])
    wide = torch.zeros(*in_src.shape[:2], 33, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 32"):
        gat._check_operands(s_dst, s_src, wide, wide.float(), xw)

"""The port's GAT attention (``ops/gat.py``) and in-row adjacency
(``ops/inrow_graph.py``) against the JAX package's, from the same seeded
numpy inputs: the XLA oracle and both Pallas kernel forms in interpret mode,
forward at f32 to 1e-5; the CPU autograd of the plain version against
``jax.grad`` of the oracle; and the closed-form backward
(``gat_attention_bwd_plain``, what kernel K4 is held to on a card) against that
autograd, against ``jax.grad`` of the oracle and against both Pallas backward
forms in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

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


def _bwd_plain(arrays, cot, slope, dtype=torch.float32):
    s_dst, s_src, in_src, in_w, xw = _torch(*arrays)
    return gat.gat_attention_bwd_plain(
        s_dst, s_src, in_src, in_w, xw.to(dtype), torch.from_numpy(cot).to(dtype), slope
    )


def _cotangent(shape, seed=13):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slope", [0.2, 0.01])
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_plain_autograd(case, slope, dtype):
    """The closed form rounds where autograd of the plain forward rounds, so
    in bf16 the two differ by f32 sum orders only: dxw within one bf16 ulp."""
    arrays = _inputs(**CASES[case])
    cot = _cotangent(arrays[-1].shape)
    s_dst, s_src, in_src, in_w, xw = _torch(*arrays)
    leaves = [s_dst.requires_grad_(), s_src.requires_grad_(), xw.to(dtype).requires_grad_()]
    out = gat.gat_attention_plain(leaves[0], leaves[1], in_src, in_w, leaves[2], slope)
    assert out.dtype == dtype
    out.backward(torch.from_numpy(cot).to(dtype))
    got = _bwd_plain(arrays, cot, slope, dtype)
    assert [g.dtype for g in got] == [torch.float32, torch.float32, dtype]
    tol = GRAD if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-4)
    for leaf, g in zip(leaves, got):
        assert g.shape == leaf.shape
        np.testing.assert_allclose(g.float().numpy(), leaf.grad.float().numpy(), **tol)


@pytest.mark.parametrize("slope", [0.2, 0.01])
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_jax_grad(case, slope):
    arrays = _inputs(**CASES[case])
    s_dst, s_src, in_src, in_w, xw = arrays
    cot = _cotangent(xw.shape)

    def loss(sd, ss, x):
        return jnp.sum(jax_gat.gat_attention_xla(sd, ss, jnp.asarray(in_src), jnp.asarray(in_w), x, slope) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (s_dst, s_src, xw)))
    for g, w in zip(_bwd_plain(arrays, cot, slope), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


@pytest.mark.parametrize("form", ["slot", "dense"])
@pytest.mark.parametrize("slope", [0.2, 0.01])
@pytest.mark.parametrize("case", ["random", "dedupe-self-edges-zero-w", "isolated", "d8"])
def test_bwd_plain_matches_both_interpret_backward_forms(monkeypatch, case, slope, form):
    """K4s and K4d, the two TPU backward forms K4 replaces, in interpret mode."""
    monkeypatch.setenv("PCC_GAT_KERNEL", form)
    arrays = _inputs(**CASES[case])
    s_dst, s_src, in_src, in_w, xw = arrays
    cot = _cotangent(xw.shape)

    def loss(sd, ss, x):
        out = jax_gat.gat_attention_fused(sd, ss, jnp.asarray(in_src), jnp.asarray(in_w), x, slope, True)
        return jnp.sum(out * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (s_dst, s_src, xw)))
    for g, w in zip(_bwd_plain(arrays, cot, slope), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


def test_bwd_plain_on_rows_without_a_kept_slot():
    """A row that attends to itself only: no score gradient, dxw = g."""
    arrays = _inputs(seed=2, frac=0.0)
    cot = _cotangent(arrays[-1].shape)
    ds_dst, ds_src, dxw = _bwd_plain(arrays, cot, 0.2)
    assert ds_dst.abs().max() == 0 and ds_src.abs().max() == 0
    np.testing.assert_allclose(dxw.numpy(), cot, rtol=1e-6, atol=1e-7)


def test_leaky_relu_derivative_keeps_one_at_zero():
    """z == 0 takes derivative 1, as jax.nn.leaky_relu's z >= 0 form."""
    s = torch.zeros(1, 2, 1)
    in_src = torch.tensor([[[1], [0]]], dtype=torch.int32)
    in_w = torch.ones(1, 2, 1)
    xw = torch.tensor([[[1.0], [3.0]]])
    g = torch.tensor([[[1.0], [0.0]]])
    ds_dst, ds_src, _ = gat.gat_attention_bwd_plain(s, s, in_src, in_w, xw, g, 0.2)
    # α = 1/2 each; dα = (1, 3); dz = α (dα − ᾱ) · 1 = (−1/2, +1/2) at z = 0
    np.testing.assert_allclose(ds_src[0, :, 0].numpy(), [-0.5, 0.5], rtol=1e-6)
    assert float(ds_dst.abs().max()) < 1e-7


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


def test_entry_point_on_cpu_differentiates_through_the_plain_version():
    arrays = _inputs(seed=1)
    cot = _cotangent(arrays[-1].shape)
    s_dst, s_src, in_src, in_w, xw = _torch(*arrays)
    leaves = [s_dst.requires_grad_(), s_src.requires_grad_(), xw.requires_grad_()]
    before = gat.gat_attention.bwd_launches
    gat.gat_attention(leaves[0], leaves[1], in_src, in_w, leaves[2]).backward(torch.from_numpy(cot))
    assert gat.gat_attention.bwd_launches == before
    for leaf, g in zip(leaves, _bwd_plain(arrays, cot, 0.2)):
        np.testing.assert_allclose(leaf.grad.numpy(), g.numpy(), **GRAD)


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


def _out_rows_brute_force(in_src, in_w):
    """The mirror by the kernels' slot rule, slot by slot in numpy: a slot
    counts when ``w != 0``, its source lies in ``[0, M)`` and is not the node
    itself, and no earlier counting slot of the node names the same source."""
    b, m, d = in_src.shape
    out_off = np.zeros((b, m + 1), np.int32)
    out_dst = np.full((b, m * d), -1, np.int32)
    for g in range(b):
        lists = [[] for _ in range(m)]
        for i in range(m):
            seen = set()
            for slot in range(d):
                j = int(in_src[g, i, slot])
                if float(in_w[g, i, slot]) != 0.0 and 0 <= j < m and j != i and j not in seen:
                    seen.add(j)
                    lists[j].append(i)  # i ascends, so each list does
        flat = [i for dests in lists for i in dests]
        out_off[g, 1:] = np.cumsum([len(dests) for dests in lists])
        out_dst[g, : len(flat)] = flat
    return out_off, out_dst


MIRROR_CASES = {
    **CASES,
    "d32-tiny-id-pool": dict(seed=8, b=2, m=20, d=32, id_pool=5, frac=0.9),
    "no-slots": dict(seed=9, b=2, m=12, d=0),
    "all-zero-weights": dict(seed=10, b=1, m=9, frac=0.0),
}


@pytest.mark.parametrize("wire", ["f32-int32", "f16-int16"])
@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_out_rows_plain_matches_the_slot_rule(case, wire):
    _, _, in_src, in_w, _ = _inputs(**MIRROR_CASES[case])
    in_src = in_src.copy()
    if in_src.size:
        # sources outside [0, M) match no node, whatever their weight
        in_src[:, ::3, :1] = -1
        in_src[:, 1::5, -1:] = in_src.shape[1] + 2
    if wire == "f16-int16":
        in_src, in_w = in_src.astype(np.int16), in_w.astype(np.float16)
    mirror = gat.gat_out_rows(*_torch(in_src, in_w))
    want_off, want_dst = _out_rows_brute_force(in_src, in_w)
    assert mirror.out_off.dtype == torch.int32 and mirror.out_dst.dtype == torch.int32
    np.testing.assert_array_equal(mirror.out_off.numpy(), want_off)
    np.testing.assert_array_equal(mirror.out_dst.numpy(), want_dst)


def test_out_rows_are_the_attention_mask_transposed():
    """Every (destination, source) pair of ``adjacency_mask`` off the diagonal
    is in the mirror once, and nothing else is."""
    _, _, in_src, in_w, _ = _inputs(**CASES["dedupe-self-edges-zero-w"])
    in_src, in_w = _torch(in_src, in_w)
    b, m, _ = in_src.shape
    mirror = gat.gat_out_rows(in_src, in_w)
    rebuilt = torch.zeros((b, m, m), dtype=torch.bool)
    for g in range(b):
        for j in range(m):
            dests = mirror.out_dst[g, mirror.out_off[g, j]:mirror.out_off[g, j + 1]].long()
            assert torch.equal(dests, dests.unique())  # ascending, no repeats
            rebuilt[g, dests, j] = True
    want = gat.adjacency_mask(in_src, in_w, m) & ~torch.eye(m, dtype=torch.bool)
    assert torch.equal(rebuilt, want)


def test_cpu_attention_ignores_a_mirror_and_launches_nothing():
    arrays = _torch(*_inputs(seed=11))
    mirror = gat.gat_out_rows(arrays[2], arrays[3])
    with_mirror = gat.gat_attention(*arrays, mirror=mirror)
    assert torch.equal(with_mirror, gat.gat_attention(*arrays))
    assert gat.gat_out_rows.launches == 0 and gat.gat_attention.bwd_launches == 0


def test_mirror_operand_checks():
    _, _, in_src, in_w, _ = _torch(*_inputs(seed=12))
    with pytest.raises(TypeError, match="int32/int16 in_src"):
        gat._check_lists(in_src.long(), in_w)
    with pytest.raises(ValueError, match=r"\[B, M, D\]"):
        gat._check_lists(in_src, in_w[:, :, :2])
    with pytest.raises(ValueError, match="at most 32"):
        gat._check_lists(in_src.repeat(1, 1, 9), in_w.repeat(1, 1, 9))


# K3's form per shape, chosen on the host: (heads, channels, slots, dtype) ->
# pieces a lane of the piece form (two nodes a warp, 16 lanes a node), 0 for
# the channel form
ATTENTION_FORMS = {
    "config f32: two pieces a lane": ((4, 128, 8, torch.float32), 2),
    "config bf16: one piece a lane": ((4, 128, 8, torch.bfloat16), 1),
    "d4 bf16": ((4, 128, 4, torch.bfloat16), 1),
    "no slots": ((4, 128, 0, torch.float32), 2),
    "three heads of 32": ((3, 96, 8, torch.float32), 2),
    "one head of 8 pieces": ((1, 32, 8, torch.float32), 1),
    "d32 one head": ((1, 128, 32, torch.float32), 2),
    "d32 four heads: softmax lanes over 32": ((4, 128, 32, torch.float32), 0),
    "head of 25 channels": ((4, 100, 8, torch.float32), 0),
    "head of 6 pieces": ((4, 192, 4, torch.bfloat16), 0),
    "eight heads of two pieces": ((8, 128, 4, torch.bfloat16), 1),
    "32 heads of one piece, two pieces a lane": ((32, 128, 1, torch.float32), 0),
    "three heads of 5": ((3, 15, 5, torch.float32), 0),
    "80 pieces": ((2, 320, 4, torch.float32), 0),
}


@pytest.mark.parametrize("case", list(ATTENTION_FORMS))
def test_attention_form_per_shape(case):
    (heads, channels, slots, dtype), per = ATTENTION_FORMS[case]
    assert gat.attention_form(heads, channels, slots, dtype) == per
    # rows off 16-byte addresses take the channel form
    assert gat.attention_form(heads, channels, slots, dtype, aligned=False) == 0

"""The port's CUDA kernels on a card: K1, K2, K3, K4 and K6 against their
plain versions, the DeepSets kernel route against its plain route, serving
and training, and the GraphNet routes (GAT through K3 and K4, GraphConv
through K6) against their plain routes, serving and one train step.

These tests need a CUDA card and skip without one.  They import neither jax
nor the JAX package, so they run on a machine that has only PyTorch; there,
skip the repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_classifier_tpu_torch.models import DeepSets, GraphNet  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi, gat, inrow_graph  # noqa: E402
from point_cloud_classifier_tpu_torch.ops.dispatch import force_plain  # noqa: E402

SPEC = (("plain", False), ("residual", False))
# max |kernel − plain| / max(1, max |plain|): f32 sums in another order
# (sequential FMAs and atomics against cuBLAS and index_add); bf16 values
# that round to the neighbouring bf16 value after a reordered dot.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K2 against phi_pool_bwd_plain, per gradient tensor.  f32: max |Δ| /
# max(1, max |plain|) and relative Frobenius (sums in another order).  bf16:
# relative Frobenius (a reordered f32 dot can round dz or dz Wᵀ to the
# neighbouring bf16 value, and the next layer carries it on).  The largest
# readings over these cases on an H100 (80GB HBM3, 700 W): max relative
# 7.6e-7 and relative Frobenius 4.5e-7 in f32, relative Frobenius 1.7e-4 in
# bf16 (quick gelu).
BWD_F32_REL, BWD_F32_FRO, BWD_BF16_FRO = 1e-4, 1e-5, 1e-3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, p=1001, b=7, width=256, final=False, seed=0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.normal(size=(p, 6)).astype(np.float32)).to(dev, dtype)
    seg = np.sort(rng.integers(0, b + 1, size=p)).astype(np.int32)
    seg[seg == 2] = 3  # event 2 is empty; rows with id b are padding
    params, last = [], 6
    for _ in range(len(SPEC) + int(final)):
        w = (rng.normal(size=(last, width)) * last**-0.5).astype(np.float32)
        bias = (rng.normal(size=(width,)) * 0.1).astype(np.float32)
        params.append((torch.from_numpy(w).to(dev), torch.from_numpy(bias).to(dev)))
        last = width
    return pts, torch.from_numpy(seg).to(dev), tuple(params), b + 1


@pytest.mark.gpu
@pytest.mark.parametrize("final", [False, True], ids=["hidden-only", "full"])
@pytest.mark.parametrize("activation", ["gelu", "relu", "silu", "tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain(dtype, activation, final):
    dev = _cuda()
    pts, seg, params, s = _inputs(dev, dtype, final=final)
    before = fused_phi.phi_pool.launches
    out = fused_phi.phi_pool(pts, seg, SPEC, params, activation, s)
    torch.cuda.synchronize()
    assert fused_phi.phi_pool.launches == before + 1
    ref = fused_phi.phi_pool_plain(pts, seg, SPEC, params, activation, s)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= TOL[dtype] * max(1.0, ref.abs().max().item())


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_compute():
    dev = _cuda()
    pts, seg, params, s = _inputs(dev, torch.float32)
    with pytest.raises(ValueError, match="layer norm"):
        fused_phi.phi_pool(pts, seg, (("plain", True), ("residual", False)), params, "gelu", s)
    with pytest.raises(TypeError, match="int32"):
        fused_phi.phi_pool(pts, seg.long(), SPEC, params, "gelu", s)
    g = torch.zeros(s + 1, 256, device=dev)
    with pytest.raises(ValueError, match="g must be"):
        fused_phi._phi_pool_bwd_cuda(pts, seg, g, SPEC, params, "gelu", s)


@pytest.mark.gpu
def test_each_kernel_refuses_a_chain_too_wide_for_its_tile():
    """Each C entry decides what fits: at width 2,048 K1's two buffers fit
    an 8-row tile and K2's five do not; at 4,096 neither fits."""
    dev = _cuda()
    pts, seg, params, s = _inputs(dev, torch.float32, p=64, width=2048)
    fused_phi.phi_pool(pts, seg, SPEC, params, "gelu", s)
    g = torch.zeros(s, 2048, device=dev)
    with pytest.raises(RuntimeError, match="too wide"):
        fused_phi._phi_pool_bwd_cuda(pts, seg, g, SPEC, params, "gelu", s)
    pts, seg, params, s = _inputs(dev, torch.float32, p=64, width=4096)
    with pytest.raises(RuntimeError, match="too wide"):
        fused_phi.phi_pool(pts, seg, SPEC, params, "gelu", s)


@pytest.mark.gpu
@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_deep_sets_kernel_route_matches_plain_route(pooling):
    dev = _cuda()
    cfg = dict(
        input_dim=6, phi_layers=[256, 256], rho_layers=[256], output_dim=1,
        activation="gelu", layer_norm=False, residual_block=True, pooling=pooling,
    )
    pts, seg, _, s = _inputs(dev, torch.float32)
    batch = {"points": pts, "seg": seg, "y": torch.zeros(s - 1, 1, device=dev)}
    model = DeepSets(**cfg).to(dev).eval()
    plain = DeepSets(**cfg, fused_phi="off").to(dev).eval()
    plain.load_state_dict(model.state_dict())
    before = fused_phi.phi_pool.launches
    with torch.no_grad():
        out, ref = model(batch), plain(batch)
    assert fused_phi.phi_pool.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("with_points", [True, False], ids=["d_points", "no-d_points"])
@pytest.mark.parametrize("final", [False, True], ids=["hidden-only", "full"])
@pytest.mark.parametrize(
    "activation, gelu",
    [("gelu", "quick"), ("gelu", "exact"), ("relu", "quick"), ("silu", "quick"), ("tanh", "quick")],
    ids=["quick-gelu", "tanh-gelu", "relu", "silu", "tanh"],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernel_matches_plain(monkeypatch, dtype, activation, gelu, final, with_points):
    dev = _cuda()
    monkeypatch.setenv("PCC_GELU", gelu)
    pts, seg, params, s = _inputs(dev, dtype, final=final)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(s, 256)).astype(np.float32)).to(dev)
    before = fused_phi.phi_pool.bwd_launches
    d_points, grads = fused_phi._phi_pool_bwd_cuda(
        pts, seg, g, SPEC, params, activation, s, with_points=with_points
    )
    torch.cuda.synchronize()
    assert fused_phi.phi_pool.bwd_launches == before + 1
    ref_points, ref_grads = fused_phi.phi_pool_bwd_plain(
        pts, seg, g, SPEC, params, activation, s, with_points=with_points
    )
    assert (d_points is None) == (not with_points)
    pairs = list(zip(grads, ref_grads))
    if with_points:
        assert d_points.dtype == dtype
        pairs.append((d_points.float(), ref_points.float()))
    for out, ref in pairs:
        assert out.shape == ref.shape and out.dtype == torch.float32
        fro = (out - ref).norm().item() / ref.norm().item()
        if dtype == torch.float32:
            scale = max(1.0, ref.abs().max().item())
            assert (out - ref).abs().max().item() <= BWD_F32_REL * scale
            assert fro <= BWD_F32_FRO
        else:
            assert fro <= BWD_BF16_FRO


@pytest.mark.gpu
def test_cuda_backward_launches_k2_and_never_the_plain_version(monkeypatch):
    dev = _cuda()

    def refuse(*args, **kwargs):
        raise AssertionError("the plain backward ran on a CUDA tensor")

    monkeypatch.setattr(fused_phi, "phi_pool_bwd_plain", refuse)
    pts, seg, params, s = _inputs(dev, torch.float32)
    params = tuple((w.requires_grad_(), b.requires_grad_()) for w, b in params)
    launches = (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches)
    fused_phi.phi_pool(pts, seg, SPEC, params, "gelu", s).sum().backward()
    torch.cuda.synchronize()
    assert (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches) == (
        launches[0] + 1, launches[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for layer in params for t in layer)


@pytest.mark.gpu
def test_fit_step_kernel_route_matches_plain_route():
    from point_cloud_classifier_tpu_torch.models import ModelWrapper

    dev = _cuda()
    cfg = dict(
        input_dim=6, phi_layers=[256, 256], rho_layers=[256], output_dim=1,
        activation="gelu", layer_norm=False, residual_block=True, pooling="mean",
    )
    pts, seg, _, s = _inputs(dev, torch.float32)
    rng = np.random.default_rng(2)
    batch = {
        "points": pts.cpu().numpy(), "seg": seg.cpu().numpy(),
        "y": rng.integers(0, 2, size=(s - 1, 1)).astype(np.float32),
        "y_mask": np.ones(s - 1, np.float32),
    }
    kernel = ModelWrapper(DeepSets(**cfg), 1e-3, 1, optimizer="adamw", device="cuda")
    plain = ModelWrapper(DeepSets(**cfg, fused_phi="off"), 1e-3, 1, optimizer="adamw", device="cuda")
    plain.model.load_state_dict(kernel.model.state_dict())
    before = fused_phi.phi_pool.bwd_launches
    losses = [kernel.train_step(batch), plain.train_step(batch)]
    torch.cuda.synchronize()
    assert fused_phi.phi_pool.bwd_launches == before + 1
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-5, atol=1e-6)
    # the gradients the step took (Adam's first step is lr·sign(g), which
    # a reordered sum can flip for a gradient near 0, so compare g itself)
    for (name, p), q in zip(kernel.model.named_parameters(), plain.model.parameters()):
        scale = max(1e-12, q.grad.abs().max().item())
        assert (p.grad - q.grad).abs().max().item() <= 1e-4 * scale, name


# K3 against gat_attention_plain: max |Δ| / max(1, max |plain|); bf16 also
# relative Frobenius (an α or an output computed in another order can land
# on the neighbouring bf16 value).  The same bounds as chip_smoke.py, set
# from its readings on an H100 (80GB HBM3, 700 W).
GAT_F32_REL, GAT_BF16_REL, GAT_BF16_FRO = 1e-6, 8e-3, 1e-3


def _gat_inputs(dev, dtype, b=3, m=45, d=8, h=4, c=128, id_pool=None, frac=0.6, isolated=0,
                wire="f32-int32", seed=0):
    rng = np.random.default_rng(seed)
    in_src = rng.integers(0, id_pool or m, size=(b, m, d)).astype(np.int32)
    in_w = (rng.random((b, m, d)) * (rng.random((b, m, d)) < frac)).astype(np.float32)
    in_w[:, :isolated] = 0.0
    if wire == "f16-int16":
        in_src, in_w = in_src.astype(np.int16), in_w.astype(np.float16)
    s_dst, s_src = (torch.from_numpy(rng.normal(size=(b, m, h)).astype(np.float32)).to(dev) for _ in range(2))
    xw = torch.from_numpy(rng.normal(size=(b, m, c)).astype(np.float32)).to(dev, dtype)
    return s_dst, s_src, torch.from_numpy(in_src).to(dev), torch.from_numpy(in_w).to(dev), xw


GAT_CASES = {
    "ragged-d4": dict(b=5, m=37, d=4),
    "d8": dict(m=61, d=8),
    "d32-dedupe-self-edges": dict(m=45, d=32, id_pool=6),
    "isolated": dict(m=40, isolated=9),
    "f16-int16-wire": dict(m=64, wire="f16-int16"),
    "one-head": dict(m=24, h=1, c=32),
    "m1": dict(b=2, m=1, d=4),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GAT_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gat_kernel_matches_plain(dtype, case):
    dev = _cuda()
    args = _gat_inputs(dev, dtype, **GAT_CASES[case])
    before = gat.gat_attention.launches
    out = gat.gat_attention(*args)
    torch.cuda.synchronize()
    assert gat.gat_attention.launches == before + 1
    ref = gat.gat_attention_plain(*args)
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype
    diff = (out.double() - ref.double())
    rel = diff.abs().max().item() / max(1.0, ref.abs().max().item())
    if dtype == torch.float32:
        assert rel <= GAT_F32_REL
    else:
        assert rel <= GAT_BF16_REL and diff.norm().item() <= GAT_BF16_FRO * ref.double().norm().item()
    if GAT_CASES[case].get("isolated"):
        torch.testing.assert_close(out[:, :9], args[-1][:, :9], rtol=0, atol=GAT_F32_REL * 4)


# K4 against gat_attention_bwd_plain, per gradient (ds_dst, ds_src, dxw):
# max |Δ| / max(1, max |plain|) and relative Frobenius.  f32: the same f32
# math, the dots, the softmax sums and the atomic adds in other orders.
# bf16: dα and α are rounded to bf16 on both sides, so a dot summed in
# another order can land on the neighbouring bf16 value (2^-8 relative) and
# the softmax backward carries it on (the bf16 bounds allow two such steps).
# The same bounds as chip_smoke.py, set from its readings on an H100 (80GB
# HBM3, 700 W): f32 max relative 7.7e-7 and relative Frobenius 4.1e-7; bf16
# max relative 7.5e-4 and relative Frobenius 7.0e-5.
GAT_BWD_F32_REL, GAT_BWD_F32_FRO, GAT_BWD_BF16_REL, GAT_BWD_BF16_FRO = 1e-5, 1e-5, 8e-3, 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GAT_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gat_backward_kernel_matches_plain(dtype, case):
    dev = _cuda()
    args = _gat_inputs(dev, dtype, **GAT_CASES[case])
    g = torch.from_numpy(np.random.default_rng(5).normal(size=tuple(args[-1].shape)).astype(np.float32)).to(dev, dtype)
    before = gat.gat_attention.bwd_launches
    got = gat._gat_attention_bwd_cuda(*args, g)
    torch.cuda.synchronize()
    assert gat.gat_attention.bwd_launches == before + 1
    want = gat.gat_attention_bwd_plain(*args, g)
    for out, ref in zip(got, want, strict=True):
        assert out.shape == ref.shape and out.dtype == ref.dtype and torch.isfinite(out).all()
        diff = out.double() - ref.double()
        rel = diff.abs().max().item() / max(1.0, ref.abs().max().item())
        fro = diff.norm().item() / max(ref.double().norm().item(), 1e-30)
        if dtype == torch.float32:
            assert rel <= GAT_BWD_F32_REL and fro <= GAT_BWD_F32_FRO
        else:
            assert rel <= GAT_BWD_BF16_REL and fro <= GAT_BWD_BF16_FRO
    if GAT_CASES[case].get("isolated"):
        # a row with no kept slot attends to itself only: no score gradient of
        # its own, and only neighbours that list it add to its ds_src
        assert got[0][:, :9].abs().max().item() == 0.0


@pytest.mark.gpu
def test_gat_function_differentiates_on_the_card_and_refuses_bad_operands(monkeypatch):
    dev = _cuda()

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    s_dst, s_src, in_src, in_w, xw = _gat_inputs(dev, torch.float32)
    ref_leaves = [t.clone().requires_grad_() for t in (s_dst, s_src, xw)]
    gat.gat_attention_plain(ref_leaves[0], ref_leaves[1], in_src, in_w, ref_leaves[2]).square().sum().backward()
    monkeypatch.setattr(gat, "gat_attention_plain", refuse)
    monkeypatch.setattr(gat, "gat_attention_bwd_plain", refuse)
    leaves = [t.clone().requires_grad_() for t in (s_dst, s_src, xw)]
    launches = (gat.gat_attention.launches, gat.gat_attention.bwd_launches)
    gat.gat_attention(leaves[0], leaves[1], in_src, in_w, leaves[2]).square().sum().backward()
    torch.cuda.synchronize()
    assert (gat.gat_attention.launches, gat.gat_attention.bwd_launches) == (launches[0] + 1, launches[1] + 1)
    for leaf, ref in zip(leaves, ref_leaves):
        scale = max(1.0, ref.grad.abs().max().item())
        assert (leaf.grad - ref.grad).abs().max().item() <= 1e-5 * scale
    with torch.no_grad():
        gat.gat_attention(s_dst, s_src, in_src, in_w, xw)  # no gradient asked for: K3 alone
    assert gat.gat_attention.bwd_launches == launches[1] + 1
    with pytest.raises(TypeError, match="int32/int16"):
        gat.gat_attention(s_dst, s_src, in_src.long(), in_w, xw)
    with pytest.raises(ValueError, match="at most 32"):
        wide = torch.zeros(*in_src.shape[:2], 33, dtype=torch.int32, device=dev)
        gat.gat_attention(s_dst, s_src, wide, wide.float(), xw)
    with pytest.raises(ValueError, match="cotangent of xw's shape"):
        gat._gat_attention_bwd_cuda(s_dst, s_src, in_src, in_w, xw, xw[:, :, :64])


# K6 against inrow_aggregate_plain: max |Δ| / max(1, max |plain|).  f32: the
# same products summed over the D slots in slot order against a matrix
# product's order.  bf16: exact f32 products of bf16 values on both sides and
# one rounding of the output, so the two differ by at most one bf16 value
# (2^-8 relative) where the f32 sums round apart.  Set from chip_smoke.py's
# readings on an H100 (80GB HBM3, 700 W).
INROW_F32_REL, INROW_BF16_REL = 1e-6, 8e-3

INROW_CASES = {
    "config-like": dict(b=4, m=288, d=8, width=128),
    "d32-f16-int16-wire": dict(b=2, m=96, d=32, width=128, wire="f16-int16", frac=0.4),
    "isolated": dict(b=2, m=40, d=8, width=128, isolated=9),
    "ragged-m37-width-48": dict(b=5, m=37, d=4, width=48),
    "m1": dict(b=2, m=1, d=4, width=16),
}


def _inrow_inputs(dev, dtype, b, m, d, width, wire="f32-int32", isolated=0, duplicates=False,
                  frac=0.6, seed=0):
    """Features, in-row lists and their out-row mirror.  Without
    ``duplicates`` no source repeats within a row, as in the loader's merged
    batches (repeated sources sum in h's dtype in the plain version and in
    f32 in the kernel: equal in f32 only); with them, sources come from a
    pool of 6 ids and no mirror is built."""
    rng = np.random.default_rng(seed)
    if duplicates:
        in_src = rng.integers(0, min(m, 6), size=(b, m, d)).astype(np.int32)
    else:
        pool = np.arange(max(m, d))
        in_src = np.stack([np.stack([rng.permutation(pool)[:d] % m for _ in range(m)]) for _ in range(b)])
        in_src = in_src.astype(np.int32)
    in_w = (rng.random((b, m, d)) * (rng.random((b, m, d)) < frac)).astype(np.float32)
    if m < d and not duplicates:  # fewer nodes than slots: keep one slot per distinct source
        in_w[..., m:] = 0.0
    in_w[:, :isolated] = 0.0
    if wire == "f16-int16":
        in_w = in_w.astype(np.float16)
    adj = np.zeros((b, m, m), np.float64)
    np.add.at(adj, (np.arange(b)[:, None, None], np.arange(m)[None, :, None], in_src), in_w.astype(np.float64))
    adj_t = np.swapaxes(adj, 1, 2)
    d_out = 4 if duplicates else max(4, int((adj_t != 0).sum(axis=2).max()))
    assert d_out <= 32
    out_dst = np.zeros((b, m, d_out), np.int32)
    out_w = np.zeros((b, m, d_out), in_w.dtype)
    for g in range(b):
        for row in range(m):
            cols = np.flatnonzero(adj_t[g, row])[:d_out]
            out_dst[g, row, : len(cols)] = cols
            out_w[g, row, : len(cols)] = adj_t[g, row, cols]
    if wire == "f16-int16":
        in_src, out_dst = in_src.astype(np.int16), out_dst.astype(np.int16)
    h = torch.from_numpy(rng.normal(size=(b, m, width)).astype(np.float32)).to(dev, dtype)
    return (h, *(torch.from_numpy(a).to(dev) for a in (in_src, in_w, out_dst, out_w)))


@pytest.mark.gpu
@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("case", list(INROW_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_inrow_kernel_matches_plain_forward_and_backward(dtype, case, aggr):
    dev = _cuda()
    h, in_src, in_w, out_dst, out_w = _inrow_inputs(dev, dtype, **INROW_CASES[case])
    g = torch.from_numpy(np.random.default_rng(6).normal(size=tuple(h.shape)).astype(np.float32)).to(dev, dtype)
    tol = INROW_F32_REL if dtype == torch.float32 else INROW_BF16_REL
    before = (inrow_graph.inrow_aggregate.launches, inrow_graph.inrow_aggregate.bwd_launches)
    h.requires_grad_()
    out = inrow_graph.inrow_aggregate(h, in_src, in_w, out_dst, out_w, aggr)
    (dh,) = torch.autograd.grad(out, h, g)
    torch.cuda.synchronize()
    assert (inrow_graph.inrow_aggregate.launches, inrow_graph.inrow_aggregate.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    # the Function inside force_plain(): inrow_aggregate_plain over the
    # in-rows, and over the out-rows for the backward, with the Function's
    # own rounding (for "mean" the cotangent over the degree, in h's dtype)
    ref_h = h.detach().clone().requires_grad_()
    with force_plain():
        ref = inrow_graph.inrow_aggregate(ref_h, in_src, in_w, out_dst, out_w, aggr)
        (ref_dh,) = torch.autograd.grad(ref, ref_h, g)
    torch.testing.assert_close(ref, inrow_graph.inrow_aggregate_plain(h.detach(), in_src, in_w, aggr), rtol=0, atol=0)
    if dtype == torch.float32:  # and that backward is the plain version's autograd
        auto_h = h.detach().clone().requires_grad_()
        (auto_dh,) = torch.autograd.grad(inrow_graph.inrow_aggregate_plain(auto_h, in_src, in_w, aggr), auto_h, g)
        assert (ref_dh - auto_dh).abs().max().item() <= 1e-5 * max(1.0, auto_dh.abs().max().item())
    for got, want in ((out.detach(), ref.detach()), (dh, ref_dh)):
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        rel = (got.double() - want.double()).abs().max().item() / max(1.0, want.abs().max().item())
        assert rel <= tol
    if INROW_CASES[case].get("isolated"):
        assert out[:, :9].abs().max().item() == 0.0  # no incoming edge: the empty sum


@pytest.mark.gpu
def test_inrow_kernel_sums_duplicate_sources_in_f32():
    dev = _cuda()
    h, in_src, in_w, _, _ = _inrow_inputs(dev, torch.float32, b=3, m=45, d=8, width=128, duplicates=True)
    with torch.no_grad():
        out = inrow_graph.inrow_aggregate(h, in_src, in_w)
        ref = inrow_graph.inrow_aggregate_plain(h, in_src, in_w)
    assert (out - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.gpu
def test_inrow_function_launches_k6_and_never_the_plain_version(monkeypatch):
    dev = _cuda()

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(inrow_graph, "inrow_aggregate_plain", refuse)
    h, in_src, in_w, out_dst, out_w = _inrow_inputs(dev, torch.float32, b=2, m=40, d=8, width=128)
    before = (inrow_graph.inrow_aggregate.launches, inrow_graph.inrow_aggregate.bwd_launches)
    with torch.no_grad():
        inrow_graph.inrow_aggregate(h, in_src, in_w)
    h.requires_grad_()
    inrow_graph.inrow_aggregate(h, in_src, in_w, out_dst, out_w, "mean").sum().backward()
    torch.cuda.synchronize()
    assert (inrow_graph.inrow_aggregate.launches, inrow_graph.inrow_aggregate.bwd_launches) == (
        before[0] + 2, before[1] + 1)
    with pytest.raises(ValueError, match="needs the out-row lists"):
        inrow_graph.inrow_aggregate(h, in_src, in_w).sum().backward()
    with pytest.raises(TypeError, match="f32 or bf16 h"):
        inrow_graph.inrow_aggregate(h.detach().half(), in_src, in_w)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gat_graph_net_kernel_route_matches_plain_route(compute_dtype):
    """GraphNet at full width on a dense in-row batch: two K3 launches per
    forward, logits as on the plain route."""
    from point_cloud_classifier_tpu_torch.data import GraphLoader
    from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs

    dev = _cuda()
    graphs = lineage_graphs(np.random.default_rng(4), 8, 40, 90)
    batch = next(iter(GraphLoader(graphs, 8, shuffle=False, layout="dense", use_weights=False)))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    model = GraphNet(input_dim=4, hidden_dim=128, output_dim=1, activation="tanh", use_gat=True,
                     deepchem_style=True, compute_dtype=compute_dtype,
                     generator=torch.Generator().manual_seed(0)).to(dev).eval()
    before = gat.gat_attention.launches
    with torch.no_grad():
        out = model(batch)
        with force_plain():
            ref = model(batch)
    assert gat.gat_attention.launches == before + 2
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "model, counts",
    [(dict(use_gat=True), (2, 2, 0, 0)), (dict(fused_inrow=True), (0, 0, 2, 1)),
     (dict(fused_inrow=True, local_pooling="mean"), (0, 0, 2, 1)), ({}, (0, 0, 0, 0))],
    ids=["gat", "graphconv-add-fused", "graphconv-mean-fused", "graphconv-add"],
)
def test_graph_net_train_step_kernel_route_matches_plain_route(model, counts):
    """One train step at full width from the same weights on the kernel
    route and inside ``force_plain()``: the launch counts (conv1's input needs
    no gradient, so K6 runs backward once), the loss and every gradient."""
    from point_cloud_classifier_tpu_torch.data import GraphLoader
    from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs
    from point_cloud_classifier_tpu_torch.models import ModelWrapper

    _cuda()
    graphs = lineage_graphs(np.random.default_rng(4), 8, 40, 90)
    batch = next(iter(GraphLoader(graphs, 8, shuffle=False, layout="dense",
                                  use_weights=not model.get("use_gat"), emit_out_rows=True)))
    cfg = dict(input_dim=4, hidden_dim=128, output_dim=1, activation="tanh", deepchem_style=True, **model)
    kernel = ModelWrapper(GraphNet(**cfg, generator=torch.Generator().manual_seed(0)), 1e-3, 1, device="cuda")
    plain = ModelWrapper(GraphNet(**cfg, generator=torch.Generator().manual_seed(1)), 1e-3, 1, device="cuda")
    plain.model.load_state_dict(kernel.model.state_dict())

    def launches():
        return (gat.gat_attention.launches, gat.gat_attention.bwd_launches,
                inrow_graph.inrow_aggregate.launches, inrow_graph.inrow_aggregate.bwd_launches)

    before = launches()
    loss = kernel.train_step(batch)
    after = launches()
    with force_plain():
        ref = plain.train_step(batch)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(after, before)) == counts and launches() == after
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-6)
    for (name, p), q in zip(kernel.model.named_parameters(), plain.model.parameters()):
        scale = max(1e-12, q.grad.abs().max().item())
        assert (p.grad - q.grad).abs().max().item() <= 1e-4 * scale, name
    for key, value in kernel.model.state_dict().items():
        if "running" in key:
            torch.testing.assert_close(value, plain.model.state_dict()[key], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_fused_graph_net_without_out_rows_serves_through_k6_and_refuses_to_train(local_pooling, monkeypatch):
    """A batch without out-row lists never reaches the adjacency route: the
    eval forward launches K6 twice, and a train-mode forward raises."""
    from point_cloud_classifier_tpu_torch.data import GraphLoader
    from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs
    from point_cloud_classifier_tpu_torch.models import graph_net

    dev = _cuda()
    graphs = lineage_graphs(np.random.default_rng(4), 8, 40, 90)
    batch = next(iter(GraphLoader(graphs, 8, shuffle=False, layout="dense", use_weights=True)))
    assert "out_dst" not in batch
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    cfg = dict(input_dim=4, hidden_dim=128, output_dim=1, activation="tanh", deepchem_style=True,
               local_pooling=local_pooling)
    fused = GraphNet(**cfg, fused_inrow=True, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    plain = GraphNet(**cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        ref = plain(batch)
    monkeypatch.setattr(graph_net, "inrow_adjacency", None)  # the adjacency route would fail
    before = inrow_graph.inrow_aggregate.launches
    with torch.no_grad():
        out = fused(batch)
    assert inrow_graph.inrow_aggregate.launches == before + 2
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="emit_out_rows=True"):
        fused(batch, train=True)

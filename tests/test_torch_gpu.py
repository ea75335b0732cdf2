"""The port's CUDA kernels on a card: K1, K2 and K3 against their plain
versions, the DeepSets kernel route against its plain route, serving and
training, and the GraphNet GAT route against its plain route.

These tests need a CUDA card and skip without one.  They import neither jax
nor the JAX package, so they run on a machine that has only PyTorch; there,
skip the repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_classifier_tpu_torch.models import DeepSets, GraphNet  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi, gat  # noqa: E402
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


@pytest.mark.gpu
def test_gat_kernel_refuses_gradients_and_bad_operands():
    dev = _cuda()
    s_dst, s_src, in_src, in_w, xw = _gat_inputs(dev, torch.float32)
    with pytest.raises(NotImplementedError, match="K4"):
        gat.gat_attention(s_dst, s_src, in_src, in_w, xw.requires_grad_())
    with torch.no_grad():
        gat.gat_attention(s_dst, s_src, in_src, in_w, xw)  # no gradient asked for
    with pytest.raises(TypeError, match="int32/int16"):
        gat.gat_attention(s_dst, s_src, in_src.long(), in_w, xw.detach())
    with pytest.raises(ValueError, match="at most 32"):
        wide = torch.zeros(*in_src.shape[:2], 33, dtype=torch.int32, device=dev)
        gat.gat_attention(s_dst, s_src, wide, wide.float(), xw.detach())


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

"""The port's CUDA kernels on a card: K1, K2, K3, K4, K5 and K6 against their
plain versions, the DeepSets kernel route against its plain route, serving
and training, on the flat and the dense wire, the resident cache and the
prefetch on the card, and the GraphNet routes (GAT through K3 and K4, GraphConv
through K6, kNN GraphConv through K5, and GAT with SAG through K3 and K4 over
keep-masked lists and a second mirror) against their plain routes, serving
and one train step, the wires without a kernel (flat edge lists, the kNN
edge-list arm, edge-slot triples) against the CPU, and each kernel's ``vmap``
rule (a sweep's arms under ``torch.func.vmap(grad)``, K = 1, 2 and 4)
against the same vmapped step under ``force_plain()``; ``int8_linear`` on the
card against the CPU, the int8 eval window's capture, and an artifact
exported on the card's host served on the card and on the CPU.

These tests need a CUDA card and skip without one.  They import neither jax
nor the JAX package, so they run on a machine that has only PyTorch; there,
skip the repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_classifier_tpu_torch.models import DeepSets, GraphNet  # noqa: E402
from point_cloud_classifier_tpu_torch.models.wrapper import resolve_device  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi, gat, inrow_graph, knn  # noqa: E402
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
# bf16 (quick gelu); chip_smoke.py's width-1024 case reads 2.3e-4 in bf16,
# with each bf16 product summed in f32 on both sides (_cuda: resolve_device).
BWD_F32_REL, BWD_F32_FRO, BWD_BF16_FRO = 1e-4, 1e-5, 1e-3
# the share of h1 values where the one-block wide K2's recompute (bf16, φ 256:
# a tensor-core first layer) may differ from the forward of bf16 K1's sliced
# variant (f32 FMAs; the timing entry's at that chain): where the two f32
# values fall on either side of a bf16 rounding boundary (docs/parity_torch.md
# §16; at most 14 of 16,777,216 read on an H100); chip_smoke.py holds the
# flagship batch to it too.  Against the path's K1 there, the wide variant's
# one block a tile (the same first layer's code), no value may differ.
H1_DEPARTURE_SHARE = 1e-5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    # as the port's entry points take the card: bf16 products sum in f32
    # (allow_bf16_reduced_precision_reduction off), the plain versions' too
    return resolve_device("cuda")


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


# Shapes that the 64-row tiles of the sliced and tf32x3 variants put at risk
# (fewer points than a tile, a tile exactly, one over, two tiles), chains that
# the sliced variant does not take (other widths, a bare final linear), and
# the widths where the tf32x3 variant takes a cluster of two blocks (384,
# 512) and of four on 32-row tiles (1024; one point an event there:
# test_f32_kernel_takes_tf32x3_at_wide_chains).  At 384, 512 and 1024 bf16
# K1 and K2 take the wide variant (test_wide_bf16_kernels_match_plain), and
# K2's dz·Wᵀ contracts over 1,024, where cuBLAS splits the plain version's.
SHAPE_CASES = {
    "p37": dict(p=37, b=3), "p64": dict(p=64, b=3), "p65": dict(p=65, b=3),
    "p128": dict(p=128, b=5), "p1": dict(p=1, b=1), "w64": dict(width=64),
    "w384": dict(width=384), "w512-p300": dict(width=512, p=300), "w512": dict(width=512),
    "w1024": dict(width=1024), "final": dict(final=True),
}


def _variant(case, dtype, backward):
    """f32 K1 takes the tf32x3 variant at every case here (widths up to 1024
    in multiples of 32), f32 K2 at the DeepSets chain of widths 256 to 1024
    (one block a tile at 256); bf16 K2 the wide one at the DeepSets chain of
    widths 256 to 1024 (one block a tile at 256), bf16 K1 the wide one at
    every case (one block a tile up to 256); every other launch the general
    one."""
    width = SHAPE_CASES[case].get("width", 256)
    deep_sets = width >= 256 and not SHAPE_CASES[case].get("final", False)
    if dtype == torch.float32 and (not backward or deep_sets):
        return "tf32x3"
    if dtype == torch.bfloat16 and not backward:
        return "wide"
    return "wide" if dtype == torch.bfloat16 and deep_sets else "general"


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SHAPE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_shapes_match_plain_and_take_their_variant(dtype, case):
    dev = _cuda()
    pts, seg, params, s = _inputs(dev, dtype, **SHAPE_CASES[case])
    out = fused_phi.phi_pool(pts, seg, SPEC, params, "gelu", s)
    torch.cuda.synchronize()
    assert fused_phi.phi_pool.variant == _variant(case, dtype, False)
    ref = fused_phi.phi_pool_plain(pts, seg, SPEC, params, "gelu", s)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= TOL[dtype] * max(1.0, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("width", [512, 1024])
def test_f32_kernel_takes_tf32x3_at_wide_chains(width, activation):
    """f32 K1 at the widths where its tf32x3 variant spans a cluster (two
    blocks a 64-row tile at 512, four a 32-row tile at 1024), against the
    plain version within K1's f32 bound; the pooled sums of one point an
    event (nothing averages a product's rounding away) as well."""
    dev = _cuda()
    for p, b in ((300, 7), (256, 255)):
        pts, seg, params, s = _inputs(dev, torch.float32, p=p, b=b, width=width)
        if b == 255:
            seg = torch.arange(p, dtype=torch.int32, device=dev)  # one point an event
        out = fused_phi.phi_pool(pts, seg, SPEC, params, activation, s)
        torch.cuda.synchronize()
        assert fused_phi.phi_pool.variant == "tf32x3"
        ref = fused_phi.phi_pool_plain(pts, seg, SPEC, params, activation, s)
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max().item() <= TOL[torch.float32] * max(1.0, ref.abs().max().item())


# bf16 chains of the wide variants: 64-row tiles, a cluster of two blocks up
# to width 512 and of four up to 1024; the ragged cases are one point, a
# tile less one, a tile and one, and 1,001 points, each with a padding id
# (>= S) among them
WIDE_POINTS = (1, 63, 65, 1001)


def _wide_inputs(dev, p, width, residual, seed):
    """Inputs with a padding id past S in the middle of the rows, and the
    rows the kernels pool (phi_pool_plain takes ids below S alone)."""
    pts, seg, params, s = _inputs(dev, torch.bfloat16, p=p, b=max(1, min(7, p)), width=width, seed=seed)
    seg = seg.clone()
    seg[p // 2] = s + 3
    spec = (("plain", False), ("residual" if residual else "plain", False))
    return pts, seg, params, s, spec, seg < s


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["gelu", "relu", "silu", "tanh"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("width", [256, 384, 512, 768, 1024])
def test_wide_bf16_kernels_match_plain(width, residual, activation):
    """bf16 K1 and K2 on their wide variants (one block a tile at width 256)
    against phi_pool_plain and
    phi_pool_bwd_plain (K1 within TOL, K2 with and without d_points within
    BWD_BF16_FRO), a second K2 launch bit-equal, at every ragged P."""
    dev = _cuda()
    for p in WIDE_POINTS:
        pts, seg, params, s, spec, pooled = _wide_inputs(dev, p, width, residual, seed=p)
        out = fused_phi.phi_pool(pts, seg, spec, params, activation, s)
        torch.cuda.synchronize()
        assert fused_phi.phi_pool.variant == "wide"
        ref = fused_phi.phi_pool_plain(pts[pooled], seg[pooled], spec, params, activation, s)
        assert out.shape == ref.shape and torch.isfinite(out).all()
        assert (out - ref).abs().max().item() <= TOL[torch.bfloat16] * max(1.0, ref.abs().max().item()), p
        g = torch.from_numpy(np.random.default_rng(p).normal(size=(s, width)).astype(np.float32)).to(dev)
        for with_points in (True, False):
            runs = [fused_phi._phi_pool_bwd_cuda(pts, seg, g, spec, params, activation, s, with_points=with_points)
                    for _ in range(2)]
            torch.cuda.synchronize()
            assert fused_phi.phi_pool.bwd_variant == "wide"
            ref_points, ref_grads = fused_phi.phi_pool_bwd_plain(
                pts, seg, g, spec, params, activation, s, with_points=with_points)
            got = ([runs[0][0]] if with_points else []) + list(runs[0][1])
            again = ([runs[1][0]] if with_points else []) + list(runs[1][1])
            want = ([ref_points] if with_points else []) + list(ref_grads)
            assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True)), (p, with_points)
            for a, r in zip(got, want, strict=True):
                assert a.shape == r.shape and torch.isfinite(a).all()
                fro = (a.double() - r.double()).norm().item() / max(r.double().norm().item(), 1e-30)
                assert fro <= BWD_BF16_FRO, (p, with_points, fro)


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["gelu", "relu", "silu", "tanh"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_wide_k2_h1_departs_from_k1_forward_rarely(residual, activation):
    """bf16 K2's one-block wide form at φ 256 recomputes h1 through the wide
    K1's first layer (the same product and epilogue code): against the
    path's K1 at that chain, the wide variant's one block a tile, no value
    of h1 differs; against the sliced variant (the timing entry), whose
    first layer sums f32 FMAs, the share stays within H1_DEPARTURE_SHARE,
    and the check sees the forms' differences where there are most (a check
    that read nothing would count none).  K1's own
    h1 is its forward over the chain with a residual second layer of zero
    weights, pooled one segment a point (_k1_h1).  At bench.py's flagship
    batch (B=256, P=65,536) and a ragged one."""
    dev = _cuda()
    for p, b in ((65_536, 256), (1001, 7)):
        pts, seg, params, s = _inputs(dev, torch.bfloat16, p=p, b=b, seed=p)
        spec = (("plain", False), ("residual" if residual else "plain", False))
        g = torch.from_numpy(np.random.default_rng(p).normal(size=(s, 256)).astype(np.float32)).to(dev)
        for take, k1_variant in ((None, "wide"), ("sliced", "sliced")):
            ref = _k1_h1(pts, params, activation, take)
            assert fused_phi.phi_pool.variant == k1_variant
            counts = torch.zeros(2, dtype=torch.int64, device=dev)
            fused_phi._phi_pool_bwd_cuda(pts, seg, g, spec, params, activation, s, with_points=False,
                                         departures=([ref], counts))
            torch.cuda.synchronize()
            assert fused_phi.phi_pool.bwd_variant == "wide"
            departed, diff = counts.tolist()
            diff /= 2**24
            print(f"h1 departures from K1 [{k1_variant}] {activation} {spec[1][0]} P={p}: {departed} of "
                  f"{p * 256}, share {departed / (p * 256):.3e}, the largest difference {diff:.3e}")
            if k1_variant == "wide":
                assert departed == 0, (p, departed, diff)
            else:
                assert departed <= H1_DEPARTURE_SHARE * p * 256, (p, departed, diff)
                if p == 65_536 and activation == "gelu":
                    assert departed > 0 and diff > 0, (departed, diff)


def _k1_h1(pts, params, activation, take=None):
    """bf16 K1's own values of the DeepSets chain's first layer, [P, 256]
    f32: K1 over the chain with a residual second layer of zero weights and
    bias (its values h1 + act(0) = h1), one segment a point (each sum 0 +
    v).  The path's variant, or the timing entry's ``take``."""
    p = pts.shape[0]
    zero = tuple(torch.zeros_like(t) for t in params[1])
    ids = torch.arange(p, dtype=torch.int32, device=pts.device)
    chain = ((("plain", False), ("residual", False)), (params[0], zero))
    if take is None:
        return fused_phi.phi_pool(pts, ids, *chain, activation, p)
    return fused_phi._phi_pool_cuda(pts, ids, *chain, activation, p, general=True, take=take)


# bf16 chains of the wide variant's one block a tile (widths up to 256):
# (the points' width, φ widths, a bare final linear)
ONE_BLOCK_CHAINS = {
    "config": (6, [256, 256], False),
    "config+final": (6, [256, 256], True),
    "w64": (6, [64, 64], False),
    "w8-one-layer": (6, [8], False),
    "points24-w64": (24, [64, 64], False),
    "points256-w128": (256, [128, 256], False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["gelu", "relu", "silu", "tanh"])
@pytest.mark.parametrize("chain", list(ONE_BLOCK_CHAINS))
def test_one_block_bf16_k1_matches_plain(chain, activation):
    """bf16 K1's wide variant at one block a 64-row tile (W resident where
    the chain's weights fit) against phi_pool_plain, at a ragged P and the
    flagship's, points of at most 8 features and wider ones (into h)."""
    dev = _cuda()
    in_dim, widths, final = ONE_BLOCK_CHAINS[chain]
    for p, b in ((1001, 7), (65_536, 256)):
        rng = np.random.default_rng(p)
        pts = torch.from_numpy(rng.normal(size=(p, in_dim)).astype(np.float32)).to(dev, torch.bfloat16)
        seg = torch.from_numpy(np.sort(rng.integers(0, b + 1, size=p)).astype(np.int32)).to(dev)
        params, last = [], in_dim
        for width in widths + ([widths[-1]] if final else []):
            params.append((torch.from_numpy((rng.normal(size=(last, width)) * last**-0.5).astype(np.float32)).to(dev),
                           torch.from_numpy((rng.normal(size=(width,)) * 0.1).astype(np.float32)).to(dev)))
            last = width
        spec = tuple(("residual" if i and widths[i] == widths[i - 1] else "plain", False) for i in range(len(widths)))
        out = fused_phi.phi_pool(pts, seg, spec, tuple(params), activation, b + 1)
        torch.cuda.synchronize()
        assert fused_phi.phi_pool.variant == "wide"
        ref = fused_phi.phi_pool_plain(pts, seg, spec, tuple(params), activation, b + 1)
        assert out.shape == ref.shape and torch.isfinite(out).all()
        assert (out - ref).abs().max().item() <= TOL[torch.bfloat16] * max(1.0, ref.abs().max().item()), p


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["gelu", "relu", "silu", "tanh"])
def test_timing_entry_takes_the_sliced_k1_at_phi_256(activation):
    """The sliced K1 stays reachable through the timing entry
    (``_phi_pool_cuda(general=True)``) at the DeepSets chain of φ 256 in
    bf16, where the path takes the wide variant's one block a tile: against
    phi_pool_plain within bf16's TOL, both layers and the pool, at ragged P
    and the flagship's."""
    dev = _cuda()
    for p, b in ((1, 1), (65, 3), (1001, 7), (65_536, 256)):
        pts, seg, params, s = _inputs(dev, torch.bfloat16, p=p, b=b)
        out = fused_phi._phi_pool_cuda(pts, seg, SPEC, params, activation, s, general=True)
        torch.cuda.synchronize()
        assert fused_phi.phi_pool.variant == "sliced"
        ref = fused_phi.phi_pool_plain(pts, seg, SPEC, params, activation, s)
        assert out.shape == ref.shape and torch.isfinite(out).all()
        assert (out - ref).abs().max().item() <= TOL[torch.bfloat16] * max(1.0, ref.abs().max().item()), p


@pytest.mark.gpu
def test_chains_outside_the_wide_plans_keep_their_variants():
    """f32 chains at the wide widths (K1 and K2 tf32x3), bf16 at width 256
    (K1 and K2 wide: one block a tile), a bf16 bare final linear at 1024
    (K1 wide, K2 general: the wide K2 takes the DeepSets chain and the tail
    alone) and bf16 at 2048 (general); the timing entries' choice at width
    256 (the sliced variant in both types, and K1's take="general")."""
    dev = _cuda()
    variant = fused_phi.kernel_variant
    for dtype, width, k1, k2 in ((torch.float32, 512, "tf32x3", "tf32x3"),
                                 (torch.float32, 1024, "tf32x3", "tf32x3"),
                                 (torch.bfloat16, 256, "wide", "wide"),
                                 (torch.bfloat16, 2048, "general", "general")):
        dims, kinds = (6, width, width), (0, 1)
        bf16 = dtype == torch.bfloat16
        assert (variant(dims, kinds, bf16, False), variant(dims, kinds, bf16, True)) == (k1, k2), (dtype, width)
    assert variant((6, 1024, 1024, 1024), (0, 1, 2), True, False) == "wide"
    assert variant((6, 1024, 1024, 1024), (0, 1, 2), True, True) == "general"
    assert variant((6, 256, 256), (0, 1), False, True) == "tf32x3"
    for bf16 in (False, True):
        assert variant((6, 256, 256), (0, 1), bf16, True, general=True) == "sliced"
        assert variant((6, 512, 512), (0, 1), bf16, True, general=True) == "general"
    assert variant((6, 256, 256), (0, 1), True, False, general=True) == "sliced"
    assert variant((6, 256, 256), (0, 1), True, False, general=True, take="general") == "general"
    assert variant((256, 256), (2,), True, True) == "wide"  # the bf16 tail's K2
    pts, seg, params, s = _inputs(dev, torch.bfloat16, width=1024, final=True)
    out = fused_phi.phi_pool(pts, seg, SPEC, params, "gelu", s)
    assert fused_phi.phi_pool.variant == "wide"
    ref = fused_phi.phi_pool_plain(pts, seg, SPEC, params, "gelu", s)
    assert (out - ref).abs().max().item() <= TOL[torch.bfloat16] * max(1.0, ref.abs().max().item())


# f32 chains of K2's tf32x3 variant: (input width, φ widths or the bare
# layer's [in, out], square layers residual).  The DeepSets chain of one
# square layer at 256 (one block a 64-row tile), 512 (a cluster of two
# blocks, 64-row tiles), 640 and 1024 (four, 32-row tiles), plain or
# residual; the sweep's chains of none, two and three square layers
# (sweep.py: φ [d] × n, d 128 to 1024, n 1 to 4; all but [1024] × 4): at 128
# (one block a tile), 256, 512 and 1024, plain and residual; the tail's bare
# layer at [256, 256] (one block a slice of d_points' columns, 64-row tiles)
# and [512, 1024] (two, 32-row tiles).  At the wide cases' ragged P, each
# with a padding id past S.
TF32X3_BWD_CHAINS = {
    "phi256": (6, [256, 256], True), "phi256-plain": (6, [256, 256], False),
    "phi512": (6, [512, 512], True), "phi640-plain": (6, [640, 640], False),
    "phi1024": (6, [1024, 1024], True), "tail256": (256, [256], None),
    "tail512x1024": (512, [1024], None),
    "phi128x1": (6, [128], False), "phi128x2": (6, [128] * 2, True), "phi128x3": (6, [128] * 3, True),
    "phi256x4-plain": (6, [256] * 4, False), "phi512x3": (6, [512] * 3, True),
    "phi1024x1": (6, [1024], False),
    # held in gelu and silu alone (test_f32_backward_at_the_sweeps_deepest_chains)
    "phi512x4-plain": (6, [512] * 4, False), "phi1024x3": (6, [1024] * 3, True),
}
DEEPEST = ("phi512x4-plain", "phi1024x3")


def _deep_sets_spec(n, residual):
    """A plain first layer, then n - 1 square layers, residual or plain."""
    return (("plain", False),) + (("residual" if residual else "plain", False),) * (n - 1)


def _tf32x3_bwd_inputs(dev, chain, p):
    in_dim, widths, residual = TF32X3_BWD_CHAINS[chain]
    rng = np.random.default_rng(p)
    b = max(1, min(7, p))
    pts = torch.from_numpy(rng.normal(size=(p, in_dim)).astype(np.float32)).to(dev)
    seg = np.sort(rng.integers(0, b + 1, size=p)).astype(np.int32)
    seg[p // 2] = b + 4  # a padding id past S
    params, last = [], in_dim
    for width in widths:
        w = (rng.normal(size=(last, width)) * last**-0.5).astype(np.float32)
        bias = (rng.normal(size=(width,)) * 0.1).astype(np.float32)
        params.append((torch.from_numpy(w).to(dev), torch.from_numpy(bias).to(dev)))
        last = width
    spec = () if residual is None else _deep_sets_spec(len(widths), residual)
    g = torch.from_numpy(rng.normal(size=(b + 1, last)).astype(np.float32)).to(dev)
    return pts, torch.from_numpy(seg).to(dev), tuple(params), b + 1, spec, g


def _off_relu_kink(pts, seg, spec, params, margin=1e-5):
    """The points and their ids without the points that have a pre-activation
    within ``margin`` · max(1, max |z|) of relu's kink in any layer (z from
    an f64 forward).  There two f32 evaluations of the chain that round
    apart by ~1e-6, as K2's 3xTF32 products and cuBLAS's f32 ones do, can
    take relu's gate the two ways, and one flipped gate moves the point's
    whole row of d_W; away from it every gate is the same in both."""
    h, keep = pts.double(), torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    for (kind, _), (w, b) in zip(spec, params):
        z = h @ w.double() + b.double()
        keep &= (z.abs() > margin * max(1.0, z.abs().max().item())).all(1)
        h = h + z.clamp_min(0) if kind == "residual" else z.clamp_min(0)
    return pts[keep].contiguous(), seg[keep].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["gelu", "silu", "relu"])
@pytest.mark.parametrize("chain", [c for c in TF32X3_BWD_CHAINS if c not in DEEPEST])
def test_f32_backward_takes_tf32x3_and_repeats_bit_for_bit(chain, activation):
    """f32 K2 on its tf32x3 variant against phi_pool_bwd_plain, with and
    without d_points, every gradient within BWD_F32_REL and BWD_F32_FRO,
    and a second launch bit-equal, at every ragged P.  For relu the points
    with a pre-activation at its kink are left out of both sides
    (``_off_relu_kink``: at most 15% of them here): there the gate may fall
    either way under any two roundings of the chain, and at φ 1024 these
    inputs hold such points at P = 63 and 1001 (docs/parity_torch.md
    §17); every other point is held to the same bounds."""
    dev = _cuda()
    for p in WIDE_POINTS:
        pts, seg, params, s, spec, g = _tf32x3_bwd_inputs(dev, chain, p)
        if activation == "relu":
            pts, seg = _off_relu_kink(pts, seg, spec, params)
            assert pts.shape[0] >= 0.85 * p, (p, pts.shape[0])
        for with_points in (True, False):
            runs = [fused_phi._phi_pool_bwd_cuda(pts, seg, g, spec, params, activation, s, with_points=with_points)
                    for _ in range(2)]
            torch.cuda.synchronize()
            assert fused_phi.phi_pool.bwd_variant == "tf32x3"
            dims = (pts.shape[1], *(w.shape[1] for w, _ in params))
            kinds = tuple(fused_phi._KINDS[kind] for kind, _ in spec) or (fused_phi._BARE_LINEAR,)
            assert fused_phi.kernel_variant(dims, kinds, False, True) == "tf32x3"
            ref_points, ref_grads = fused_phi.phi_pool_bwd_plain(
                pts, seg, g, spec, params, activation, s, with_points=with_points)
            got = ([runs[0][0]] if with_points else []) + list(runs[0][1])
            again = ([runs[1][0]] if with_points else []) + list(runs[1][1])
            want = ([ref_points] if with_points else []) + list(ref_grads)
            assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True)), (p, with_points)
            for a, r in zip(got, want, strict=True):
                assert a.shape == r.shape and torch.isfinite(a).all()
                assert (a - r).abs().max().item() <= BWD_F32_REL * max(1.0, r.abs().max().item()), p
                fro = (a.double() - r.double()).norm().item() / max(r.double().norm().item(), 1e-30)
                assert fro <= BWD_F32_FRO, (p, with_points, fro)


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["gelu", "silu"])
@pytest.mark.parametrize("chain", DEEPEST)
def test_f32_backward_at_the_sweeps_deepest_chains(chain, activation):
    """test_f32_backward_takes_tf32x3_and_repeats_bit_for_bit at φ [512] × 4
    plain and [1024] × 3 residual, in the sweep's activations (sweep.py
    samples gelu and silu).  Relu is not held here: these chains give each
    point 2,048 and 3,072 pre-activations, and over 15% of the points (16.7%
    at [1024] × 3, P = 1001) have one within _off_relu_kink's margin, where
    the gate may fall either way under any two roundings of the chain."""
    test_f32_backward_takes_tf32x3_and_repeats_bit_for_bit(chain, activation)


@pytest.mark.gpu
@pytest.mark.parametrize("with_points", [True, False], ids=["d_points", "no-d_points"])
@pytest.mark.parametrize("case", list(SHAPE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernel_shapes_match_plain_and_repeat_bit_for_bit(dtype, case, with_points):
    dev = _cuda()
    pts, seg, params, s = _inputs(dev, dtype, **SHAPE_CASES[case])
    width = params[-1][0].shape[1]
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(s, width)).astype(np.float32)).to(dev)
    runs = [
        fused_phi._phi_pool_bwd_cuda(pts, seg, g, SPEC, params, "gelu", s, with_points=with_points)
        for _ in range(2)
    ]
    torch.cuda.synchronize()
    assert fused_phi.phi_pool.bwd_variant == _variant(case, dtype, True)
    ref_points, ref_grads = fused_phi.phi_pool_bwd_plain(
        pts, seg, g, SPEC, params, "gelu", s, with_points=with_points)
    (d_points, grads), (d_points_2, grads_2) = runs
    # every sum of K2 runs in a fixed order: two runs give the same bits
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_2, strict=True))
    pairs = list(zip(grads, ref_grads, strict=True))
    if with_points:
        assert torch.equal(d_points, d_points_2)
        pairs.append((d_points.float(), ref_points.float()))
    for out, ref in pairs:
        assert out.shape == ref.shape and torch.isfinite(out).all()
        fro = (out - ref).norm().item() / max(ref.norm().item(), 1e-30)
        if dtype == torch.float32:
            assert (out - ref).abs().max().item() <= BWD_F32_REL * max(1.0, ref.abs().max().item())
            assert fro <= BWD_F32_FRO
        else:
            assert fro <= BWD_BF16_FRO


@pytest.mark.gpu
def test_cuda_forward_launches_k1_and_never_the_plain_version(monkeypatch):
    dev = _cuda()

    def refuse(*args, **kwargs):
        raise AssertionError("the plain forward ran on a CUDA tensor")

    monkeypatch.setattr(fused_phi, "phi_pool_plain", refuse)
    # the wide variant (bf16), the tf32x3 one (f32), then the general one by
    # shape (wider than the tf32x3 variant's 1024)
    for dtype, kwargs in ((torch.bfloat16, dict()), (torch.float32, dict()),
                          (torch.float32, dict(width=2048, p=64))):
        pts, seg, params, s = _inputs(dev, dtype, **kwargs)
        before = fused_phi.phi_pool.launches
        out = fused_phi.phi_pool(pts, seg, SPEC, params, "gelu", s)
        torch.cuda.synchronize()
        assert fused_phi.phi_pool.launches == before + 1 and torch.isfinite(out).all()


@pytest.mark.gpu
def test_backward_allocates_no_per_point_activation():
    """K2 keeps every [P, H] array on the chip but the scratch its plan
    names.  The sliced variant (the timing entry's at φ 256) allocates the
    gradients and one slab per cluster, nothing that grows with P·H; the
    one-block tf32x3 form there allocates beyond the gradients exactly the
    scratch that pcc_phi_pool_bwd_scratch reports: its [P, 256] f32 h1 and
    dz2, which its d_W pass reads (docs/parity_torch.md §17), the cluster
    slabs and the d_W partials."""
    import ctypes

    from point_cloud_classifier_tpu_torch.native import kernel_library

    dev = _cuda()
    p = 65536
    pts, seg, params, s = _inputs(dev, torch.float32, p=p, b=255)
    g = torch.ones(s, 256, device=dev)
    n_param = sum(w.numel() + b.numel() for w, b in params)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = ctypes.c_longlong(0)
    assert kernel_library().lib.pcc_phi_pool_bwd_scratch(
        p, s, 2, (ctypes.c_int * 3)(6, 256, 256), (ctypes.c_int * 2)(0, 1), 0, sms, ctypes.byref(scratch)) == 0
    assert scratch.value >= 2 * p * 256  # h1 and dz2
    for general, variant, bound in ((True, "sliced", 4 * n_param * (sms + 2) + (1 << 20)),
                                    (False, "tf32x3", 4 * (n_param + scratch.value) + (1 << 20))):
        fused_phi._phi_pool_bwd_cuda(pts, seg, g, SPEC, params, "gelu", s, with_points=False, general=general)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fused_phi._phi_pool_bwd_cuda(pts, seg, g, SPEC, params, "gelu", s, with_points=False, general=general)
        torch.cuda.synchronize()
        assert fused_phi.phi_pool.bwd_variant == variant
        assert torch.cuda.max_memory_allocated() - base <= bound, variant
    assert p * 256 * 4 > 4 * n_param * (sms + 2) + (1 << 20)  # one [P, H] f32 would not fit the sliced bound


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_timing_entry_takes_the_sliced_k2_at_phi_256(dtype):
    """The sliced K2 stays reachable through the timing entry
    (``_phi_pool_bwd_cuda(general=True)``) at the DeepSets chain of φ 256,
    in both types: against phi_pool_bwd_plain within the K2 bounds, with and
    without d_points, a second launch bit-equal, at ragged P."""
    dev = _cuda()
    for p, b in ((1, 1), (65, 3), (1001, 7)):
        pts, seg, params, s = _inputs(dev, dtype, p=p, b=b)
        g = torch.from_numpy(np.random.default_rng(p).normal(size=(s, 256)).astype(np.float32)).to(dev)
        for with_points in (True, False):
            runs = [fused_phi._phi_pool_bwd_cuda(pts, seg, g, SPEC, params, "gelu", s, with_points=with_points,
                                                 general=True) for _ in range(2)]
            torch.cuda.synchronize()
            assert fused_phi.phi_pool.bwd_variant == "sliced"
            ref_points, ref_grads = fused_phi.phi_pool_bwd_plain(
                pts, seg, g, SPEC, params, "gelu", s, with_points=with_points)
            got = ([runs[0][0]] if with_points else []) + list(runs[0][1])
            again = ([runs[1][0]] if with_points else []) + list(runs[1][1])
            want = ([ref_points] if with_points else []) + list(ref_grads)
            assert all(torch.equal(a, c) for a, c in zip(got, again, strict=True)), (p, with_points)
            for a, r in zip(got, want, strict=True):
                a, r = a.double(), r.double()
                assert a.shape == r.shape and torch.isfinite(a).all()
                fro = (a - r).norm().item() / max(r.norm().item(), 1e-30)
                if dtype == torch.float32:
                    assert (a - r).abs().max().item() <= BWD_F32_REL * max(1.0, r.abs().max().item()), p
                    assert fro <= BWD_F32_FRO, (p, with_points, fro)
                else:
                    assert fro <= BWD_BF16_FRO, (p, with_points, fro)


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


def _dense_wire_batch(b=16, transfer_dtype="float32", factored=(1,), seed=0, max_points=40):
    """A host batch of the dense per-cloud-row wire from the port's loader:
    event 2 empty, one event filling its row, column 1 constant per event."""
    from point_cloud_classifier_tpu_torch.data import PointCloudLoader

    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_points, size=b)
    sizes[2], sizes[0] = 0, max_points
    events = [rng.normal(size=(int(n), 6)).astype(np.float32) for n in sizes]
    for e in events:
        e[:, 1] = rng.normal()
    loader = PointCloudLoader(events, rng.integers(0, 2, size=b), b, False, layout="dense",
                              transfer_dtype=transfer_dtype, factor_event_cols=factored)
    return next(iter(loader))


@pytest.mark.gpu
@pytest.mark.parametrize("m_pad", [0, 64, 80], ids=["full-rows", "in-row-padding-64", "in-row-padding"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_on_dense_ids_match_the_masked_row_sum(dtype, m_pad):
    """K1 over the dense wire's flattened rows and its made ids against the
    plain dense pool (a masked row sum), and K2 against its plain version on
    the same ids; the padding id B is skipped by both kernels."""
    from point_cloud_classifier_tpu_torch.models.deep_sets import dense_segment_ids

    dev = _cuda()
    b, m = 64, 256 + m_pad
    rng = np.random.default_rng(3)
    counts = torch.from_numpy(rng.integers(m - 96, m + 1, size=b).astype(np.int32)).to(dev)
    counts[1] = 0
    pts = torch.from_numpy(rng.normal(size=(b * m, 6)).astype(np.float32)).to(dev, dtype)
    _, _, params, _ = _inputs(dev, dtype)
    ids = dense_segment_ids(counts, m)
    out = fused_phi.phi_pool(pts, ids, SPEC, params, "gelu", b + 1)
    h = fused_phi.phi_forward(pts, SPEC, params, "gelu").float().reshape(b, m, -1)
    mask = (torch.arange(m, device=dev)[None, :] < counts[:, None]).float()
    ref = torch.einsum("bm,bmh->bh", mask, h)
    torch.cuda.synchronize()
    assert out.shape == (b + 1, 256)
    assert (out[:b] - ref).abs().max().item() <= TOL[dtype] * max(1.0, ref.abs().max().item())
    assert fused_phi.phi_pool.variant == ("wide" if dtype == torch.bfloat16 else "tf32x3")
    g = torch.from_numpy(rng.normal(size=(b + 1, 256)).astype(np.float32)).to(dev)
    got = fused_phi._phi_pool_bwd_cuda(pts, ids, g, SPEC, params, "gelu", b + 1)
    want = fused_phi.phi_pool_bwd_plain(pts, ids, g, SPEC, params, "gelu", b + 1)
    assert fused_phi.phi_pool.bwd_variant == ("wide" if dtype == torch.bfloat16 else "tf32x3")
    for x, y in zip([got[0], *got[1]], [want[0], *want[1]], strict=True):
        fro = ((x.double() - y.double()).norm() / y.double().norm()).item()
        assert fro <= (BWD_F32_FRO if dtype == torch.float32 else BWD_BF16_FRO)


@pytest.mark.gpu
@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_deep_sets_dense_wire_kernel_route_matches_plain_route(compute_dtype, pooling):
    """The flagship wire (dense rows, fp16 in bf16, column 1 factored) at
    config widths: one train-mode forward and backward through K1 and K2
    against the plain dense route, logits and every gradient."""
    dev = _cuda()
    cfg = dict(input_dim=6, phi_layers=[256, 256], rho_layers=[256], output_dim=1,
               activation="gelu", layer_norm=False, residual_block=True, pooling=pooling,
               compute_dtype=compute_dtype, factored_cols=(1,))
    wire = "float16" if compute_dtype == "bfloat16" else "float32"
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _dense_wire_batch(transfer_dtype=wire).items()}
    assert batch["points"].ndim == 3
    model = DeepSets(**cfg).to(dev).train()
    plain = DeepSets(**cfg, fused_phi="off").to(dev).train()
    plain.load_state_dict(model.state_dict())
    before = (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches)
    outs = []
    for net in (model, plain):
        logits = net(batch, train=True)
        logits.sum().backward()
        outs.append(logits.detach())
    torch.cuda.synchronize()
    assert (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches) == (before[0] + 1, before[1] + 1)
    if compute_dtype == "bfloat16":
        assert (fused_phi.phi_pool.variant, fused_phi.phi_pool.bwd_variant) == ("wide", "wide")
    else:
        assert (fused_phi.phi_pool.variant, fused_phi.phi_pool.bwd_variant) == ("tf32x3", "tf32x3")
    bound = 1e-4 if compute_dtype == "float32" else 3e-2
    assert (outs[0] - outs[1]).abs().max().item() <= bound * max(1.0, outs[1].abs().max().item())
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        scale = max(1.0, q.grad.abs().max().item()) if compute_dtype == "bfloat16" else max(
            1e-12, q.grad.abs().max().item())
        assert (p.grad - q.grad).abs().max().item() <= bound * scale, name


@pytest.mark.gpu
@pytest.mark.parametrize("size", [1, 2, 4])
def test_prefetch_on_a_side_stream_gives_the_host_batches_in_order(size):
    from point_cloud_classifier_tpu_torch.data.prefetch import prefetch_to_device

    dev = _cuda()
    host = [_dense_wire_batch(transfer_dtype="float16", seed=i) for i in range(6)]
    got = []
    for batch in prefetch_to_device(iter(host), size=size, device=dev):
        assert all(t.device.type == "cuda" for t in batch.values())
        # work on the consumer's stream while later copies are in flight
        got.append({k: (v.float() * 1).cpu() if v.is_floating_point() else v.cpu() for k, v in batch.items()})
    assert len(got) == len(host)
    for a, b in zip(got, host):
        for k, v in b.items():
            assert torch.equal(a[k], torch.from_numpy(v).to(a[k].dtype)), k


@pytest.mark.gpu
@pytest.mark.parametrize("upload_chunk", [1, 4])
def test_resident_cache_keeps_the_batches_on_the_card(upload_chunk):
    from point_cloud_classifier_tpu_torch.data.resident import ResidentCache

    _cuda()
    host = [_dense_wire_batch(transfer_dtype="float16", seed=i) for i in range(6)]
    cache = ResidentCache(host, upload_chunk=upload_chunk, shuffle_seed=1)
    first, second = list(cache), list(cache)
    assert cache.cached and all(t.device.type == "cuda" for b in first + second for t in b.values())
    for a, b in zip(first, host):
        for k, v in b.items():
            assert np.array_equal(a[k].cpu().numpy(), v), k
    order = [next(i for i, f in enumerate(first) if f["points"] is b["points"]) for b in second]
    assert sorted(order) == list(range(6))


@pytest.mark.gpu
@pytest.mark.parametrize("env", [{}, {"PCC_PREFETCH": "1", "PCC_BG_LOADER": "1"}],
                         ids=["resident", "prefetch"])
def test_fit_on_the_card_through_each_pipeline(env, monkeypatch):
    from point_cloud_classifier_tpu_torch.models import ModelWrapper

    _cuda()
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = dict(input_dim=6, phi_layers=[64, 64], rho_layers=[64], output_dim=1,
               activation="gelu", layer_norm=False, residual_block=True, pooling="mean",
               factored_cols=(1,))
    host = [_dense_wire_batch(transfer_dtype="float16", seed=i) for i in range(4)]
    wrapper = ModelWrapper(DeepSets(**cfg), 1e-3, 2, optimizer="adamw", device_resident=not env,
                           device="cuda")
    before = fused_phi.phi_pool.bwd_launches
    wrapper.fit(host, host)
    assert fused_phi.phi_pool.bwd_launches == before + 8
    loss, _ = wrapper._evaluate(host)
    assert np.isfinite(loss)


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
    # shapes the 16-byte pieces do not fit: a channel at a time
    "three-heads-c15": dict(m=19, d=5, h=3, c=15),
    "two-heads-c320": dict(b=1, m=20, d=4, h=2, c=320),
    "config-shape": dict(b=2, m=288, d=8),
    "three-heads-c96": dict(m=29, d=8, h=3, c=96),
    "four-heads-c100": dict(m=23, d=8, h=4, c=100),
    "d32-f16-int16-wire": dict(m=50, d=32, wire="f16-int16", frac=0.4),
}
# the form each case takes in f32 and in bf16 (ops/gat.py:attention_form):
# pieces a lane of the piece form, 0 for the channel form
GAT_FORMS = {
    "ragged-d4": (2, 1), "d8": (2, 1), "d32-dedupe-self-edges": (0, 0), "isolated": (2, 1),
    "f16-int16-wire": (2, 1), "one-head": (1, 1), "m1": (2, 1), "three-heads-c15": (0, 0),
    "two-heads-c320": (0, 0), "config-shape": (2, 1), "three-heads-c96": (2, 1),
    "four-heads-c100": (0, 0), "d32-f16-int16-wire": (0, 0),
}


def _gat_form(case, dtype):
    kw = {"d": 8, "h": 4, "c": 128, **GAT_CASES[case]}
    return gat.attention_form(kw["h"], kw["c"], kw["d"], dtype)


@pytest.mark.parametrize("case", list(GAT_CASES))
def test_gat_cases_take_the_forms_named(case):
    """The card tests' cases reach every form of K3: the piece form with one
    and with two pieces a lane, and the channel form (the choice is the
    host's, checked here too)."""
    assert (_gat_form(case, torch.float32), _gat_form(case, torch.bfloat16)) == GAT_FORMS[case]
    assert {per for pair in GAT_FORMS.values() for per in pair} == {0, 1, 2}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GAT_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gat_kernel_repeats_bit_for_bit(dtype, case):
    """No atomics and one order of operations: the same inputs give the same bits."""
    dev = _cuda()
    args = _gat_inputs(dev, dtype, **GAT_CASES[case])
    first = gat.gat_attention(*args)
    second = gat.gat_attention(*args)
    assert torch.equal(first, second)


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
@pytest.mark.parametrize("dtype,form", [(torch.float32, 2), (torch.float32, 0), (torch.bfloat16, 1),
                                        (torch.bfloat16, 2), (torch.bfloat16, 0)],
                         ids=["f32-two-pieces", "f32-channel-form", "bf16-one-piece", "bf16-two-pieces",
                              "bf16-channel-form"])
def test_gat_kernel_every_form_matches_plain_at_the_config_shape(dtype, form):
    """Each form K3 can take at C = 128, H = 4, D = 8 (the one the host
    chooses and those it does not), on an odd number of rows."""
    dev = _cuda()
    args = _gat_inputs(dev, dtype, b=3, m=95, d=8)
    out = gat._gat_attention_cuda(*args, form=form)
    ref = gat.gat_attention_plain(*args)
    diff = out.double() - ref.double()
    rel = diff.abs().max().item() / max(1.0, ref.abs().max().item())
    if dtype == torch.float32:
        assert rel <= GAT_F32_REL
    else:
        assert rel <= GAT_BF16_REL and diff.norm().item() <= GAT_BF16_FRO * ref.double().norm().item()
    if form:  # the piece forms share one order of operations
        assert torch.equal(out, gat.gat_attention(*args))


# K4 against gat_attention_bwd_plain, per gradient (ds_dst, ds_src, dxw):
# max |Δ| / max(1, max |plain|) and relative Frobenius.  f32: the same f32
# math, the dots, the softmax sums and the sums over a source's destinations in
# other orders than a matrix product's (K4's own order is fixed).
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
    before = (gat.gat_attention.bwd_launches, gat.gat_out_rows.launches)
    got = gat._gat_attention_bwd_cuda(*args, g)
    torch.cuda.synchronize()
    # K4 once, over a mirror of its own
    assert (gat.gat_attention.bwd_launches, gat.gat_out_rows.launches) == (before[0] + 1, before[1] + 1)
    # a mirror handed in is read, and gives the same bits, run after run
    mirror = gat.gat_out_rows(args[2], args[3])
    for _ in range(2):
        again = gat._gat_attention_bwd_cuda(*args, g, mirror=mirror)
        assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))
    assert gat.gat_out_rows.launches == before[1] + 2
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
@pytest.mark.parametrize("case", list(GAT_CASES))
def test_gat_out_rows_kernel_matches_plain(case):
    """The mirror of the in-row lists, exactly: offsets, ascending lists, -1
    behind the last entry; out-of-range sources match no node."""
    dev = _cuda()
    _, _, in_src, in_w, _ = _gat_inputs(dev, torch.float32, **GAT_CASES[case])
    in_src = in_src.clone()
    in_src[:, ::3, :1] = -1
    in_src[:, 1::5, -1:] = in_src.shape[1] + 2
    before = gat.gat_out_rows.launches
    mirror = gat.gat_out_rows(in_src, in_w)
    torch.cuda.synchronize()
    assert gat.gat_out_rows.launches == before + 1
    want = gat.gat_out_rows_plain(in_src, in_w)
    for got, ref in zip(mirror, want, strict=True):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    with pytest.raises(TypeError, match="int32/int16 in_src"):
        gat.gat_out_rows(in_src.long(), in_w)


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
    with pytest.raises(ValueError, match="mirror is of other lists"):
        other = gat.gat_out_rows(in_src[:, :-1], in_w[:, :-1])
        gat._gat_attention_bwd_cuda(s_dst, s_src, in_src, in_w, xw, xw, mirror=other)


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
    # conv1's width (the input features): a lane a node in f32, a channel a
    # lane in bf16
    "width-4": dict(b=4, m=288, d=8, width=4),
    "ragged-m37-width-4": dict(b=5, m=37, d=4, width=4),
    "d32-f16-int16-wire-width-4": dict(b=2, m=96, d=32, width=4, wire="f16-int16", frac=0.4),
    "isolated-width-4": dict(b=2, m=40, d=8, width=4, isolated=9),
    # widths the 16-byte pieces do not fit, and rows of more than 32 pieces
    "width-5": dict(b=3, m=45, d=8, width=5),
    "width-260": dict(b=2, m=40, d=8, width=260),
}
# the layout each case takes in f32 and in bf16 (ops/inrow_graph.py:aggregate_form):
# (channels a piece, lanes a node), two pieces a lane
INROW_FORMS = {
    "config-like": ((4, 16), (8, 8)), "d32-f16-int16-wire": ((4, 16), (8, 8)), "isolated": ((4, 16), (8, 8)),
    "ragged-m37-width-48": ((4, 8), (8, 4)), "m1": ((4, 2), (8, 1)), "width-4": ((1, 2), (1, 2)),
    "ragged-m37-width-4": ((1, 2), (1, 2)), "d32-f16-int16-wire-width-4": ((1, 2), (1, 2)),
    "isolated-width-4": ((1, 2), (1, 2)), "width-5": ((1, 4), (1, 4)), "width-260": ((4, 32), (1, 32)),
}


@pytest.mark.parametrize("case", list(INROW_CASES))
def test_inrow_cases_take_the_forms_named(case):
    """The card tests' cases reach every layout of K6: 16-byte pieces and a
    channel a piece; a lane a node, several nodes a warp, a node a warp; rows
    that take several turns."""
    width = INROW_CASES[case]["width"]
    got = tuple(inrow_graph.aggregate_form(width, dtype) for dtype in (torch.float32, torch.bfloat16))
    assert got == INROW_FORMS[case]
    layouts = [form for pair in INROW_FORMS.values() for form in pair]
    assert {vec for vec, _ in layouts} == {1, 4, 8} and {1, 2, 32} <= {lanes for _, lanes in layouts}


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
@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_inrow_kernel_sums_duplicate_sources_in_f32_a_lane_a_node(aggr):
    dev = _cuda()
    h, in_src, in_w, _, _ = _inrow_inputs(dev, torch.float32, b=3, m=45, d=8, width=4, duplicates=True)
    with torch.no_grad():
        out = inrow_graph.inrow_aggregate(h, in_src, in_w, aggr=aggr)
        ref = inrow_graph.inrow_aggregate_plain(h, in_src, in_w, aggr)
    assert (out - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(INROW_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_inrow_kernel_repeats_bit_for_bit(dtype, case):
    """Forward and backward sum in slot order with no atomics: the same
    inputs give the same bits."""
    dev = _cuda()
    h, in_src, in_w, out_dst, out_w = _inrow_inputs(dev, dtype, **INROW_CASES[case])
    for aggr in ("add", "mean"):
        fwd = [inrow_graph._inrow_aggregate_cuda(h, in_src, in_w, aggr) for _ in range(2)]
        assert torch.equal(*fwd)
    bwd = [inrow_graph._inrow_aggregate_cuda(h, out_dst, out_w, "add", backward=True) for _ in range(2)]
    assert torch.equal(*bwd)


@pytest.mark.gpu
@pytest.mark.parametrize("form", [(None, 32), (None, 8), (None, 1), (1, 32), (1, 4), (1, 1)],
                         ids=["pieces-32-lanes", "pieces-8-lanes", "pieces-1-lane", "channels-32-lanes",
                              "channels-4-lanes", "channels-1-lane"])
@pytest.mark.parametrize("width", [128, 4, 260])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_inrow_kernel_every_layout_gives_the_chosen_bits(dtype, width, form):
    """K6 in layouts the host does not choose (more or fewer lanes a node,
    rows in more turns, a channel a piece), forward and backward: the same
    sums in the same order, so the same bits as the chosen layout."""
    dev = _cuda()
    h, in_src, in_w, out_dst, out_w = _inrow_inputs(dev, dtype, b=3, m=45, d=8, width=width)
    vec = form[0] or inrow_graph.aggregate_form(width, dtype)[0]  # None: the chosen piece
    for lists in ((in_src, in_w), (out_dst, out_w)):
        for aggr in ("add", "mean"):
            chosen = inrow_graph._inrow_aggregate_cuda(h, *lists, aggr)
            other = inrow_graph._inrow_aggregate_cuda(h, *lists, aggr, form=(vec, form[1]))
            assert torch.equal(chosen, other)


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
    before = (gat.gat_attention.launches, gat.gat_out_rows.launches)
    with torch.no_grad():
        out = model(batch)
        with force_plain():
            ref = model(batch)
    # no backward will run, so no mirror is built
    assert (gat.gat_attention.launches, gat.gat_out_rows.launches) == (before[0] + 2, before[1])
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "model, counts",
    [(dict(use_gat=True), (2, 2, 1, 0, 0)), (dict(fused_inrow=True), (0, 0, 0, 2, 1)),
     (dict(fused_inrow=True, local_pooling="mean"), (0, 0, 0, 2, 1)), ({}, (0, 0, 0, 0, 0)),
     (dict(use_gat=True, sag_pool=True), (2, 2, 2, 0, 0)), (dict(sag_pool=True), (0, 0, 0, 0, 0)),
     (dict(local_pooling="max"), (0, 0, 0, 0, 0)), (dict(local_pooling="max", sag_pool=True), (0, 0, 0, 0, 0))],
    ids=["gat", "graphconv-add-fused", "graphconv-mean-fused", "graphconv-add", "gat-sag", "graphconv-sag",
         "max", "max-sag"],
)
def test_graph_net_train_step_kernel_route_matches_plain_route(model, counts):
    """One train step at full width from the same weights on the kernel
    route and inside ``force_plain()``: the launch counts (GAT: K3 and K4
    twice each over one mirror of the lists, and with SAG over two, conv2's
    built from the keep-masked lists; conv1's input needs no gradient, so K6
    runs backward once), the loss and every gradient."""
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
        return (gat.gat_attention.launches, gat.gat_attention.bwd_launches, gat.gat_out_rows.launches,
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


def _keep_masked(in_src, in_w, seed):
    """The in-row weights of the edges between kept nodes, as SAG leaves them
    for conv2: ``w · keep[src] · keep[dst]``, half the nodes kept."""
    b, m, _ = in_src.shape
    rng = np.random.default_rng(seed)
    keep = torch.from_numpy((rng.random((b, m)) < 0.5).astype(np.float32)).to(in_src.device)
    keep_src = torch.gather(keep, 1, in_src.long().reshape(b, -1)).reshape(in_src.shape)
    return in_w * (keep_src * keep[:, :, None]).to(in_w.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["d8", "config-shape", "f16-int16-wire", "d32-dedupe-self-edges"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gat_kernels_over_keep_masked_lists_match_plain(dtype, case):
    """K3 and K4 on in-row weights masked as SAG masks them (rows and
    sources dropped, so many rows keep only their self-loop) against
    ``gat_attention_plain`` and ``gat_attention_bwd_plain``, K4 reading the
    mirror of the masked lists; a mirror of the unmasked lists, handed in,
    gives other gradients without an error, which is why conv2 builds its
    own."""
    dev = _cuda()
    s_dst, s_src, in_src, in_w, xw = _gat_inputs(dev, dtype, **GAT_CASES[case])
    masked = _keep_masked(in_src, in_w, seed=3)
    assert (masked == 0).sum() > (in_w == 0).sum()
    args = (s_dst, s_src, in_src, masked, xw)
    out, ref = gat.gat_attention(*args), gat.gat_attention_plain(*args)
    g = torch.from_numpy(np.random.default_rng(6).normal(size=tuple(xw.shape)).astype(np.float32)).to(dev, dtype)
    got = gat._gat_attention_bwd_cuda(*args, g, mirror=gat.gat_out_rows(in_src, masked))
    want = gat.gat_attention_bwd_plain(*args, g)
    bounds = {torch.float32: (GAT_F32_REL, GAT_BWD_F32_REL, GAT_BWD_F32_FRO),
              torch.bfloat16: (GAT_BF16_REL, GAT_BWD_BF16_REL, GAT_BWD_BF16_FRO)}[dtype]
    assert (out.double() - ref.double()).abs().max().item() <= bounds[0] * max(1.0, ref.abs().max().item())
    for a, b in zip(got, want, strict=True):
        diff = a.double() - b.double()
        assert diff.abs().max().item() <= bounds[1] * max(1.0, b.abs().max().item())
        assert diff.norm().item() <= bounds[2] * max(b.double().norm().item(), 1e-30)
    stale = gat._gat_attention_bwd_cuda(*args, g, mirror=gat.gat_out_rows(in_src, in_w))
    assert not all(torch.allclose(a.float(), b.float(), rtol=1e-2, atol=1e-3) for a, b in zip(stale, want))


@pytest.mark.gpu
def test_gat_sag_train_step_reads_a_second_mirror(monkeypatch):
    """GAT + SAG on the in-row wire, one train step at full width: the model
    builds a mirror of the lists for conv1 and a second one of the
    keep-masked lists for conv2, and its gradients equal the plain route's.
    (A stale mirror's extra terms land on dropped sources, whose features
    SAG has zeroed, so they would change no parameter's gradient here;
    ``test_gat_kernels_over_keep_masked_lists_match_plain`` shows that they
    change K4's own gradients.)"""
    from point_cloud_classifier_tpu_torch.data import GraphLoader
    from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs
    from point_cloud_classifier_tpu_torch.models import graph_net

    dev = _cuda()
    graphs = lineage_graphs(np.random.default_rng(8), 8, 40, 90)
    batch = next(iter(GraphLoader(graphs, 8, shuffle=False, layout="dense", use_weights=False)))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    cfg = dict(input_dim=4, hidden_dim=128, output_dim=1, activation="tanh", deepchem_style=True,
               use_gat=True, sag_pool=True)
    model = GraphNet(**cfg, generator=torch.Generator().manual_seed(0)).to(dev)

    def grads():
        model.zero_grad()
        model(batch, train=True).sum().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    built = []
    mirror = graph_net.gat_backward_mirror
    monkeypatch.setattr(graph_net, "gat_backward_mirror", lambda s, w: built.append(w) or mirror(s, w))
    got = grads()
    assert len(built) == 2 and torch.equal(built[0], batch["in_w"]) and (built[1] != built[0]).any()
    with force_plain():
        want = grads()
    for key, g in got.items():
        assert (g - want[key]).abs().max().item() <= 1e-4 * max(1e-12, want[key].abs().max().item()), key


@pytest.mark.gpu
@pytest.mark.parametrize(
    "model, layout",
    [(dict(local_pooling="add"), "flat"), (dict(local_pooling="mean"), "flat"),
     (dict(local_pooling="max"), "flat"), (dict(use_gat=True), "flat"),
     (dict(use_gat=True, sag_pool=True), "flat"), (dict(knn_k=8, use_gat=True), "flat"),
     (dict(knn_k=8, sag_pool=True), "flat"), (dict(knn_k=8, local_pooling="max"), "flat"),
     (dict(local_pooling="mean"), "slots"), (dict(use_gat=True), "slots")],
    ids=["flat-add", "flat-mean", "flat-max", "flat-gat", "flat-gat-sag", "knn-gat", "knn-sag", "knn-max",
         "slots-mean", "slots-gat"],
)
def test_graph_net_wires_without_kernels_train_on_the_card_as_on_the_cpu(model, layout):
    """The flat edge-list wire, the kNN edge-list arm and the edge-slot
    triples run PyTorch's scatters and gathers on the card: one train step
    at full width gives the CPU's loss and gradients (f32 sums in other
    orders), and launches no kernel."""
    from point_cloud_classifier_tpu_torch.data import GraphLoader
    from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs
    from point_cloud_classifier_tpu_torch.models import ModelWrapper

    _cuda()
    graphs = lineage_graphs(np.random.default_rng(9), 8, 40, 90, position_grid=1 / 64)
    kw = dict(layout="flat") if layout == "flat" else dict(layout="dense", max_in_degree_wire=2)
    batch = next(iter(GraphLoader(graphs, 8, shuffle=False, **kw)))
    assert ("edge_slot" in batch) == (layout == "slots")
    cfg = dict(input_dim=4, hidden_dim=128, output_dim=1, activation="tanh", deepchem_style=True, **model)
    card = ModelWrapper(GraphNet(**cfg, generator=torch.Generator().manual_seed(0)), 1e-3, 1, device="cuda")
    cpu = ModelWrapper(GraphNet(**cfg, generator=torch.Generator().manual_seed(0)), 1e-3, 1, device="cpu")
    before = (gat.gat_attention.launches, knn.knn_select.launches, inrow_graph.inrow_aggregate.launches)
    loss, ref = card.train_step(batch), cpu.train_step(batch)
    torch.cuda.synchronize()
    assert (gat.gat_attention.launches, knn.knn_select.launches, inrow_graph.inrow_aggregate.launches) == before
    torch.testing.assert_close(loss.cpu(), ref, rtol=1e-5, atol=1e-6)
    for (name, p), q in zip(card.model.named_parameters(), cpu.model.parameters()):
        scale = max(1e-12, q.grad.abs().max().item())
        assert (p.grad.cpu() - q.grad).abs().max().item() <= 1e-4 * scale, name


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


# K5 against knn_aggregate_plain: the distance is formed in one order of
# operations on both sides, so thresholds and degrees are equal exactly and
# only the f32 sums over the neighbours run in another order (index order
# against a matrix product's).  bf16: exact f32 sums of bf16 values rounded
# once on both sides, at most one bf16 value apart.
KNN_F32_REL, KNN_BF16_REL = 1e-5, 8e-3
KNN_CASES = {
    # (nodes per graph low, high, graphs, padding rows, grid step or None, width)
    "ragged": (20, 60, 7, 13, None, 128),
    "tiny graphs": (1, 6, 40, 5, None, 128),
    "coarse grid ties": (30, 50, 5, 9, 0.5, 128),
    "long padding tail": (10, 30, 4, 700, None, 128),
    "width 4": (20, 60, 7, 13, None, 4),
    "width 200": (20, 40, 3, 2, None, 200),
}


def _knn_inputs(dev, dtype, case, seed=0):
    lo, hi, graphs, padding, grid, width = KNN_CASES[case]
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi + 1, size=graphs)
    n = int(sizes.sum()) + padding
    seg = np.full(n, graphs, dtype=np.int32)
    seg[: sizes.sum()] = np.repeat(np.arange(graphs, dtype=np.int32), sizes)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    if grid:
        pos = (np.round(pos / grid) * grid).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32)).to(dev, dtype)
    return x, torch.from_numpy(pos).to(dev), torch.from_numpy(seg).to(dev), graphs, g


def _knn_rel(out, ref):
    return (out.double() - ref.double()).abs().max().item() / max(1.0, ref.double().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("case", list(KNN_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_knn_kernel_matches_plain_forward_and_backward(dtype, case, aggr, k):
    dev = _cuda()
    x, pos, seg, graphs, g = _knn_inputs(dev, dtype, case)
    before = (knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches)
    leaf = x.clone().requires_grad_()
    out = knn.knn_aggregate(leaf, pos, seg, k, graphs, aggr)
    (dx,) = torch.autograd.grad(out, leaf, g)
    torch.cuda.synchronize()
    assert (knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = knn.knn_aggregate_plain(x, pos, seg, k, graphs, aggr)
    ref_dx = knn.knn_aggregate_bwd_plain(g, pos, seg, k, graphs, aggr)
    assert out.dtype == dx.dtype == dtype and out.shape == dx.shape == x.shape
    bound = KNN_F32_REL if dtype == torch.float32 else KNN_BF16_REL
    assert _knn_rel(out.detach(), ref) <= bound and _knn_rel(dx, ref_dx) <= bound
    # the selection itself: ranges, points, degrees and thresholds equal exactly
    plan, ref_plan = knn.knn_select(pos, seg, k, graphs), knn.knn_select_plain(pos, seg, k, graphs)
    assert all(torch.equal(a, b) for a, b in zip(plan.tensors(), ref_plan.tensors(), strict=True))
    # and with the plan handed in: no selection, the same bits
    selections = knn.knn_select.launches
    out_plan = knn.knn_aggregate(leaf, pos, seg, k, graphs, aggr, plan=plan)
    (dx_plan,) = torch.autograd.grad(out_plan, leaf, g)
    assert knn.knn_select.launches == selections
    assert torch.equal(out_plan, out) and torch.equal(dx_plan, dx)
    if case == "coarse grid ties":
        assert plan.deg.max().item() > k
    assert not out[seg == graphs].any() and not dx[seg == graphs].any()


@pytest.mark.gpu
def test_knn_kernel_takes_unsorted_and_int16_segment_ids():
    """Membership is by id, whatever the order: a shuffled batch scans wider
    ranges and gives the plain version's rows."""
    dev = _cuda()
    x, pos, seg, graphs, g = _knn_inputs(dev, torch.float32, "ragged", seed=3)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(len(seg))).to(dev)
    x, pos, seg = x[perm].contiguous(), pos[perm].contiguous(), seg[perm].to(torch.int16)
    leaf = x.clone().requires_grad_()
    out = knn.knn_aggregate(leaf, pos, seg, 8, graphs, "mean")
    (dx,) = torch.autograd.grad(out, leaf, g)
    assert _knn_rel(out.detach(), knn.knn_aggregate_plain(x, pos, seg, 8, graphs, "mean")) <= KNN_F32_REL
    assert _knn_rel(dx, knn.knn_aggregate_bwd_plain(g, pos, seg, 8, graphs, "mean")) <= KNN_F32_REL
    # ids outside [0, num_graphs] fall into the nearest bucket, as in the plain version
    wild = seg.to(torch.int32).clone()
    wild[::7], wild[3::11] = -2, graphs + 5
    plan, ref_plan = knn.knn_select(pos, wild, 8, graphs), knn.knn_select_plain(pos, wild, 8, graphs)
    assert all(torch.equal(a, b) for a, b in zip(plan.tensors(), ref_plan.tensors(), strict=True))
    out = knn.knn_aggregate(x, pos, wild, 8, graphs, "add")
    assert _knn_rel(out, knn.knn_aggregate_plain(x, pos, wild, 8, graphs, "add")) <= KNN_F32_REL


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8, 16, 20])
@pytest.mark.parametrize("case", list(KNN_CASES))
def test_knn_selection_kernel_matches_plain(case, k):
    """Every path of the selection kernel (the smallest distances in
    registers up to k = 8 and up to 16, rounds above) gives the plain
    version's ranges, points, thresholds and degrees exactly."""
    dev = _cuda()
    _, pos, seg, graphs, _ = _knn_inputs(dev, torch.float32, case)
    before = knn.knn_select.launches
    plan = knn._knn_select_cuda(pos, seg, k, graphs)
    torch.cuda.synchronize()
    assert knn.knn_select.launches == before + 1
    ref_plan = knn.knn_select_plain(pos, seg, k, graphs)
    for got, ref in zip(plan.tensors(), ref_plan.tensors(), strict=True):
        assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 5, 12, 36, 260])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_knn_kernel_takes_any_width_and_one_long_graph(dtype, width):
    """Widths that are no multiple of 16 bytes, narrower than a warp's 32
    pieces and wider; one graph longer than the selection's shared-memory
    stage (1,024 candidates)."""
    dev = _cuda()
    rng = np.random.default_rng(width)
    n = 2500
    pos = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    seg = torch.from_numpy(np.r_[np.zeros(2300), np.ones(150), np.full(50, 2)].astype(np.int32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32)).to(dev, dtype)
    plan, ref_plan = knn.knn_select(pos, seg, 8, 2), knn.knn_select_plain(pos, seg, 8, 2)
    assert all(torch.equal(a, b) for a, b in zip(plan.tensors(), ref_plan.tensors(), strict=True))
    bound = KNN_F32_REL if dtype == torch.float32 else KNN_BF16_REL
    for aggr in ("add", "mean"):
        out = knn._knn_aggregate_cuda(x, plan, aggr)
        dx = knn._knn_aggregate_bwd_cuda(x, plan, aggr)
        assert _knn_rel(out, knn.knn_aggregate_plain(x, pos, seg, 8, 2, aggr)) <= bound
        assert _knn_rel(dx, knn.knn_aggregate_bwd_plain(x, pos, seg, 8, 2, aggr)) <= bound


@pytest.mark.gpu
def test_knn_function_launches_k5_and_never_the_plain_version(monkeypatch):
    dev = _cuda()

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    x, pos, seg, graphs, g = _knn_inputs(dev, torch.float32, "ragged")
    monkeypatch.setattr(knn, "knn_aggregate_plain", refuse)
    monkeypatch.setattr(knn, "knn_aggregate_bwd_plain", refuse)
    monkeypatch.setattr(knn, "_adjacency_rows", refuse)  # no [rows, N] block either
    monkeypatch.setattr(knn, "knn_select_plain", refuse)
    before = (knn.knn_select.launches, knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches)
    with torch.no_grad():
        knn.knn_aggregate(x, pos, seg, 8, graphs)
    x.requires_grad_()
    knn.knn_aggregate(x, pos, seg, 8, graphs, "mean").sum().backward()
    torch.cuda.synchronize()
    assert (knn.knn_select.launches, knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches) == (
        before[0] + 2, before[1] + 2, before[2] + 1)
    with pytest.raises(TypeError, match="f32 or bf16"):
        knn.knn_aggregate(x.detach().half(), pos, seg, 8, graphs)
    with pytest.raises(ValueError, match="disagree on N"):
        knn.knn_aggregate(x.detach(), pos[:-1], seg, 8, graphs)


def _knn_flat_batch(seg_encoding="ids"):
    from point_cloud_classifier_tpu_torch.data import GraphLoader
    from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs

    graphs = lineage_graphs(np.random.default_rng(4), 8, 40, 90)
    return next(iter(GraphLoader(graphs, 8, shuffle=False, layout="flat", use_weights=False,
                                 seg_encoding=seg_encoding)))


@pytest.mark.gpu
@pytest.mark.parametrize("seg_encoding", ["ids", "counts"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_knn_graph_net_kernel_route_matches_plain_route(compute_dtype, seg_encoding):
    """GraphNet(knn_k=8) at full width on a flat batch: one selection and two
    K5 aggregations per forward, logits as on the plain route."""
    dev = _cuda()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _knn_flat_batch(seg_encoding).items()}
    model = GraphNet(input_dim=4, hidden_dim=128, output_dim=1, activation="tanh", knn_k=8,
                     deepchem_style=True, compute_dtype=compute_dtype,
                     generator=torch.Generator().manual_seed(0)).to(dev).eval()
    before = (knn.knn_select.launches, knn.knn_aggregate.launches)
    with torch.no_grad():
        out = model(batch)
        with force_plain():
            ref = model(batch)
    assert (knn.knn_select.launches, knn.knn_aggregate.launches) == (before[0] + 1, before[1] + 2)
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_knn_graph_net_train_step_kernel_route_matches_plain_route(local_pooling):
    """One train step at full width from the same weights on the kernel route
    and inside ``force_plain()``: one selection, K5 twice forward and once
    backward (conv1's input needs no gradient), the loss and every gradient;
    the edge arrays stay on the host."""
    from point_cloud_classifier_tpu_torch.models import ModelWrapper

    _cuda()
    batch = _knn_flat_batch()
    cfg = dict(input_dim=4, hidden_dim=128, output_dim=1, activation="tanh", deepchem_style=True,
               knn_k=8, local_pooling=local_pooling)
    kernel = ModelWrapper(GraphNet(**cfg, generator=torch.Generator().manual_seed(0)), 1e-3, 1, device="cuda")
    plain = ModelWrapper(GraphNet(**cfg, generator=torch.Generator().manual_seed(1)), 1e-3, 1, device="cuda")
    plain.model.load_state_dict(kernel.model.state_dict())
    assert sorted(kernel._put(batch)) == ["node_seg", "nodes", "y", "y_mask"]
    def counts():
        return (knn.knn_select.launches, knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches)

    before = counts()
    loss = kernel.train_step(batch)
    after = counts()
    with force_plain():
        ref = plain.train_step(batch)
    torch.cuda.synchronize()
    assert after == (before[0] + 1, before[1] + 2, before[2] + 1)
    assert counts() == after
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-6)
    for (name, p), q in zip(kernel.model.named_parameters(), plain.model.parameters()):
        scale = max(1e-12, q.grad.abs().max().item())
        assert (p.grad - q.grad).abs().max().item() <= 1e-4 * scale, name


# -- the tabular models and the command line on the card -----------------------


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no-bn"])
def test_fcn_on_the_card_matches_the_cpu(bn):
    from point_cloud_classifier_tpu_torch.data import TabularLoader
    from point_cloud_classifier_tpu_torch.models import FullyConnectedNet
    from point_cloud_classifier_tpu_torch.models.wrapper import masked_bce

    dev = _cuda()
    rng = np.random.default_rng(0)
    batch = next(iter(TabularLoader(rng.normal(size=(27, 9)), rng.integers(0, 2, 27), 32, shuffle=False)))
    grads = []
    for device in ("cpu", dev):
        net = FullyConnectedNet(9, [32, 32, 64], bn, 1, generator=torch.Generator().manual_seed(1)).to(device)
        tensors = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        logits = net(tensors, train=True)
        masked_bce(logits, tensors["y"], tensors["y_mask"]).backward()
        grads.append([logits.detach().cpu()] + [p.grad.cpu() for p in net.parameters()]
                     + [b.cpu() for b in net.buffers()] + [net(tensors, train=False).detach().cpu()])
    for cpu, card in zip(*grads):
        torch.testing.assert_close(card, cpu, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_logistic_regression_fit_on_the_card_matches_the_cpu(tmp_path):
    from point_cloud_classifier_tpu_torch.data.synthetic import write_s2pt_cache
    from point_cloud_classifier_tpu_torch.data.tabular import Step2PointTabular
    from point_cloud_classifier_tpu_torch.models import LogRegression

    _cuda()
    write_s2pt_cache(str(tmp_path), seed=0)
    train = Step2PointTabular(str(tmp_path)).get_train_loader()
    card, cpu = LogRegression().fit(train), LogRegression(device="cpu").fit(train)
    assert card.device.type == "cuda" and card.coef_.dtype == np.float32
    np.testing.assert_allclose(card.coef_, cpu.coef_, rtol=0, atol=2e-4)
    np.testing.assert_allclose(card.intercept_, cpu.intercept_, rtol=0, atol=2e-4)
    assert 0 < card.n_iter_ < card.max_iter


@pytest.mark.gpu
def test_command_line_trains_and_evaluates_deep_sets_on_the_card(tmp_path):
    import json
    import os

    from point_cloud_classifier_tpu_torch.cli import main
    from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache
    from point_cloud_classifier_tpu_torch.utils.config import save_config

    _cuda()
    os.makedirs(tmp_path / "configs")
    save_config({"meta": {"model_name": "", "dataset_name": ""}, "dataset": {"data_dir": "unused"},
                 "logging": {"log_dir": "unused"}}, str(tmp_path / "configs"))
    os.replace(tmp_path / "configs" / "config.yaml", tmp_path / "configs" / "base.yaml")
    save_config({"model": {"input_dim": 6, "phi_layers": [32, 32], "rho_layers": [32], "output_dim": 1,
                           "pooling": "mean", "layer_norm": False, "activation": "gelu", "residual_block": True},
                 "dataset": {"batch_size": 16}, "trainer": {"learning_rate": 0.001, "optimizer": "adamw"}},
                str(tmp_path / "configs"))
    os.replace(tmp_path / "configs" / "config.yaml", tmp_path / "configs" / "deep_sets.yaml")
    write_s2ppc_cache(str(tmp_path / "data"), n_events=(64, 32, 32), min_points=20, max_points=60, seed=0)
    fused_phi.phi_pool.launches = fused_phi.phi_pool.bwd_launches = 0
    main(["train", "deep_sets", "--config-dir", str(tmp_path / "configs"), "--data-dir", str(tmp_path / "data"),
          "--log-dir", str(tmp_path / "log"), "--epochs", "2"])
    assert fused_phi.phi_pool.bwd_launches == 2 * 4  # a launch of K2 per train step
    assert fused_phi.phi_pool.launches > fused_phi.phi_pool.bwd_launches
    run = tmp_path / "log" / "version_0"
    main(["evaluate", str(run)])
    with open(run / "eval" / "metrics.json") as f:
        metrics = json.load(f)
    assert list(metrics) == ["accuracy_train", "accuracy_val", "accuracy_test"]
    with open(run / "eval" / "classification_report.txt") as f:
        assert f.read().splitlines()[-1].split()[-1] == "32"


# -- the kernels under torch.func.vmap (the sweep's arms) ----------------------------------

VMAP_ARMS = [1, 2, 4]


def _grads_and_values(loss, batched, shared, argnums):
    from torch.func import grad_and_value, vmap

    in_dims = (0,) * len(batched) + (None,) * len(shared)
    grads, values = vmap(grad_and_value(loss, argnums=argnums), in_dims=in_dims)(*batched, *shared)
    torch.cuda.synchronize()
    return [*grads, values]


def _hold_to_plain(loss, batched, shared, argnums, launches, want_launches):
    """The vmapped kernel route (each counter rising by ``want_launches``)
    against the same vmapped step inside ``force_plain()`` (no launch):
    values and gradients within TOL[f32] of the largest plain entry."""
    before = launches()
    got = _grads_and_values(loss, batched, shared, argnums)
    assert tuple(a - b for a, b in zip(launches(), before)) == want_launches
    after = launches()
    with force_plain():
        want = _grads_and_values(loss, batched, shared, argnums)
    assert launches() == after
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        err = (g.double() - w.double()).abs().max().item() / max(1.0, w.double().abs().max().item())
        assert err <= TOL[torch.float32], err


def _stacked(rng, k, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=(k, *shape)) * scale).astype(np.float32)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("k", VMAP_ARMS)
def test_phi_pool_vmap_rule_matches_plain_on_the_card(k):
    """K1 once an arm forward, K2 once an arm backward, over shared points."""
    dev = _cuda()
    pts, seg, params, s = _inputs(dev, torch.float32)
    rng = np.random.default_rng(k)
    weights = [w[None] + _stacked(rng, k, *w.shape, scale=0.02) for layer in params for w in layer]
    cot = torch.from_numpy(rng.normal(size=(s, 256)).astype(np.float32)).to(dev)

    def loss(w0, b0, w1, b1, points):
        return (fused_phi.phi_pool(points, seg, SPEC, ((w0, b0), (w1, b1)), "gelu", s) * cot).sum()

    counts = lambda: (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches)  # noqa: E731
    _hold_to_plain(loss, weights, [pts], (0, 1, 2, 3), counts, (k, k))


@pytest.mark.gpu
@pytest.mark.parametrize("lists", ["shared", "keep-masked-per-arm"])
@pytest.mark.parametrize("k", VMAP_ARMS)
def test_gat_vmap_rules_match_plain_on_the_card(k, lists):
    """K3 and K4 once an arm; the mirror once where the lists are shared,
    once an arm where SAG has masked them per arm."""
    dev = _cuda()
    s_dst, s_src, in_src, in_w, xw = _gat_inputs(dev, torch.float32, **GAT_CASES["config-shape"])
    rng = np.random.default_rng(k)
    feats = [t[None] + _stacked(rng, k, *t.shape, scale=0.1) for t in (s_dst, s_src, xw)]
    cot = torch.from_numpy(rng.normal(size=tuple(xw.shape)).astype(np.float32)).to(dev)

    def loss(a, b, x, w):
        out = gat.gat_attention(a, b, in_src, w, x, gat.SLOPE, gat.gat_backward_mirror(in_src, w))
        return (out * cot).sum()

    def counts():
        return (gat.gat_attention.launches, gat.gat_attention.bwd_launches, gat.gat_out_rows.launches)

    if lists == "shared":
        _hold_to_plain(loss, feats, [in_w], (0, 1, 2), counts, (k, k, 1))
    else:
        masked = torch.stack([_keep_masked(in_src, in_w, seed=arm) for arm in range(k)])
        _hold_to_plain(loss, [*feats, masked], [], (0, 1, 2), counts, (k, k, k))


@pytest.mark.gpu
@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("k", VMAP_ARMS)
def test_inrow_vmap_rule_matches_plain_on_the_card(k, aggr):
    """K6 once an arm forward and once an arm backward."""
    dev = _cuda()
    h, in_src, in_w, out_dst, out_w = _inrow_inputs(dev, torch.float32, **INROW_CASES["config-like"])
    rng = np.random.default_rng(k)
    hs = h[None] + _stacked(rng, k, *h.shape, scale=0.1)
    cot = torch.from_numpy(rng.normal(size=tuple(h.shape)).astype(np.float32)).to(dev)

    def loss(x):
        return (inrow_graph.inrow_aggregate(x, in_src, in_w, out_dst, out_w, aggr) * cot).sum()

    counts = lambda: (inrow_graph.inrow_aggregate.launches, inrow_graph.inrow_aggregate.bwd_launches)  # noqa: E731
    _hold_to_plain(loss, [hs], [], (0,), counts, (k, k))


@pytest.mark.gpu
@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("k", VMAP_ARMS)
def test_knn_vmap_rule_matches_plain_on_the_card(k, aggr):
    """K5's gather once an arm both ways, over one shared plan."""
    dev = _cuda()
    x, pos, seg, graphs, _ = _knn_inputs(dev, torch.float32, "ragged")
    plan = knn.knn_select(pos, seg, 8, graphs)  # the plain version's, exactly (K5's selection)
    rng = np.random.default_rng(k)
    xs = x[None] + _stacked(rng, k, *x.shape, scale=0.1)
    cot = torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(dev)

    def loss(v):
        return (knn.knn_aggregate(v, pos, seg, 8, graphs, aggr, plan) * cot).sum()

    counts = lambda: (knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches)  # noqa: E731
    _hold_to_plain(loss, [xs], [], (0,), counts, (k, k))


@pytest.mark.gpu
def test_the_python_rule_for_chains_agrees_with_k2s_refusal():
    """``fused_phi.kernel_takes_chain`` says which DeepSets chains K1 and K2
    take; over the sweep's chains (φ [d] × n, d 128 to 1024, n 1 to 4, plain
    and residual) K2's C entry refuses exactly the one the rule refuses, φ
    [1024] × 4, and takes every other on its tf32x3 variant in f32."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    for width, n, residual in itertools.product((128, 256, 512, 1024), (1, 2, 3, 4), (False, True)):
        takes = (width, n) != (1024, 4)
        spec = _deep_sets_spec(n, residual)
        dims = [6] + [width] * n
        assert fused_phi.kernel_takes_chain(dims, [kind for kind, _ in spec]) is takes
        params = tuple((torch.from_numpy((rng.normal(size=(i, o)) * i**-0.5).astype(np.float32)).to(dev),
                        torch.zeros(o, device=dev)) for i, o in zip(dims[:-1], dims[1:]))
        pts = torch.from_numpy(rng.normal(size=(70, 6)).astype(np.float32)).to(dev)
        seg = torch.zeros(70, dtype=torch.int32, device=dev)
        g = torch.ones(1, width, device=dev)
        if takes:
            fused_phi._phi_pool_bwd_cuda(pts, seg, g, spec, params, "gelu", 1)
            assert fused_phi.phi_pool.bwd_variant == "tf32x3", (width, n, residual)
        else:
            with pytest.raises(RuntimeError, match="too wide"):
                fused_phi._phi_pool_bwd_cuda(pts, seg, g, spec, params, "gelu", 1)


# f32 chains of S = 1 to 3 square layers whose recompute is held to K1's
# forward: one block a tile (128, 256), a cluster of two (512), of four (1024)
RECOMPUTE_CHAINS = {"phi256x2": (256, 2), "phi128x4": (128, 4), "phi512x4": (512, 4), "phi1024x3": (1024, 3)}


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["gelu", "silu", "relu", "tanh"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("chain", list(RECOMPUTE_CHAINS))
def test_f32_k2_recomputes_k1s_hidden_rows_bit_for_bit(chain, residual, activation):
    """f32 K2's tf32x3 row pass recomputes each square layer's input rows
    h_1 … h_S with K1's first layer, products and epilogue in K1's order:
    against K1's own forward over the chain's first l layers, pooled one
    segment a point (each sum 0 + v), no value of any h_l differs
    (pcc_phi_pool_bwd_departures).  The chain K1 runs for h_l keeps the
    whole chain's length, its layers past l residual with zero weights and
    bias (each adds act(0) = 0), because K1 sums a chunk's products apart
    in chains of three layers or more (csrc/phi_tf32.cuh:chunk_product): a
    chain cut to l layers would take the other sums."""
    dev = _cuda()
    width, n = RECOMPUTE_CHAINS[chain]
    p = 1001
    rng = np.random.default_rng(n * width)
    pts = torch.from_numpy(rng.normal(size=(p, 6)).astype(np.float32)).to(dev)
    seg = torch.from_numpy(np.sort(rng.integers(0, 8, size=p)).astype(np.int32)).to(dev)
    dims = [6] + [width] * n
    params = tuple((torch.from_numpy((rng.normal(size=(i, o)) * i**-0.5).astype(np.float32)).to(dev),
                    torch.from_numpy((rng.normal(size=(o,)) * 0.1).astype(np.float32)).to(dev))
                   for i, o in zip(dims[:-1], dims[1:]))
    spec = _deep_sets_spec(n, residual)
    ids = torch.arange(p, dtype=torch.int32, device=dev)
    zero = (torch.zeros_like(params[-1][0]), torch.zeros_like(params[-1][1]))
    refs = [fused_phi.phi_pool(pts, ids, spec[:l] + (("residual", False),) * (n - l),
                               params[:l] + (zero,) * (n - l), activation, p) for l in range(1, n)]
    assert fused_phi.phi_pool.variant == "tf32x3"
    counts = torch.zeros(2 * (n - 1), dtype=torch.int64, device=dev)
    g = torch.from_numpy(rng.normal(size=(8, width)).astype(np.float32)).to(dev)
    fused_phi._phi_pool_bwd_cuda(pts, seg, g, spec, params, activation, 8, with_points=False,
                                 departures=(refs, counts))
    torch.cuda.synchronize()
    assert fused_phi.phi_pool.bwd_variant == "tf32x3"
    assert counts.tolist()[0::2] == [0] * (n - 1), counts.tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["deep_sets", "gat"])
def test_vmapped_arms_on_the_card_match_sequential_runs(family):
    """Two arms through ``train_configs_vmapped`` on the card (K1 and K2, or
    K3, K4 and the mirror, once an arm a step) against two sequential
    ``ModelWrapper`` runs: final train-mode loss within 1e-4."""
    from point_cloud_classifier_tpu_torch.data import GraphLoader, PointCloudLoader
    from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs
    from point_cloud_classifier_tpu_torch.models import ModelWrapper
    from point_cloud_classifier_tpu_torch.models.wrapper import masked_bce
    from point_cloud_classifier_tpu_torch.parallel import train_configs_vmapped

    _cuda()
    rng = np.random.default_rng(0)
    if family == "deep_sets":
        events = [rng.normal(size=(rng.integers(20, 60), 6)).astype(np.float32) for _ in range(48)]
        labels = np.array([float(e[:, 0].mean() > 0) for e in events])
        cls, cfg = DeepSets, dict(input_dim=6, phi_layers=[32, 32], rho_layers=[32], output_dim=1,
                                  activation="gelu", layer_norm=False, residual_block=True, pooling="mean")
        loaders = lambda: (PointCloudLoader(events[:32], labels[:32], 16, shuffle=True),  # noqa: E731
                           PointCloudLoader(events[32:], labels[32:], 16, shuffle=False))
        counters = lambda: (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches)  # noqa: E731
    else:
        graphs = lineage_graphs(rng, 48, 20, 40)
        cls, cfg = GraphNet, dict(input_dim=4, hidden_dim=32, output_dim=1, activation="tanh", use_gat=True,
                                  gat_heads=4, deepchem_style=True)
        loaders = lambda: (GraphLoader(graphs[:32], 16, shuffle=True, use_weights=False,  # noqa: E731
                                       layout="dense"),
                           GraphLoader(graphs[32:], 16, shuffle=False, use_weights=False, layout="dense"))
        counters = lambda: (gat.gat_attention.launches, gat.gat_attention.bwd_launches)  # noqa: E731
    lrs = [1e-3, 3e-4]
    before = counters()
    train, val = loaders()
    result = train_configs_vmapped(cls(**cfg), lrs, "adam", 2, train, val, seeds=[0, 1])
    assert all(c > b for c, b in zip(counters(), before))
    batch = next(iter(loaders()[1]))
    for arm, lr in enumerate(lrs):
        train, val = loaders()
        wrapper = ModelWrapper(cls(**cfg, generator=torch.Generator().manual_seed(arm)), lr, 2, seed=arm)
        wrapper.fit(train, val)
        losses = []
        for state in (wrapper._host_state_dict(), result["final_state"][arm]):
            wrapper.model.load_state_dict(state)
            wrapper.model.train()
            with torch.no_grad():
                dev_batch = wrapper._put(batch)
                logits = wrapper.model(dev_batch, train=True)
                losses.append(masked_bce(logits, dev_batch["y"], dev_batch["y_mask"]).item())
        assert abs(losses[0] - losses[1]) <= 1e-4 * max(1.0, abs(losses[0])), losses


# -- fused step windows (fuse_steps) as CUDA graphs ------------------------------


def _same_shape(batches, k=4):
    """``k`` batches of the loader's most frequent shape."""
    from point_cloud_classifier_tpu_torch.data.resident import shape_key

    groups = {}
    for b in batches:
        groups.setdefault(shape_key(b), []).append(b)
    best = max(groups.values(), key=len)
    assert len(best) >= k, "the loader gave too few batches of one shape"
    return best[:k]


def _window_route(route):
    """``(model factory, four host batches of one shape)`` for a route at
    the configs' widths, B=16 clouds or 8 graphs."""
    from point_cloud_classifier_tpu_torch.data import GraphLoader, PointCloudLoader, TabularLoader
    from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs
    from point_cloud_classifier_tpu_torch.models import FullyConnectedNet

    rng = np.random.default_rng(7)
    ds = dict(input_dim=6, phi_layers=[256, 256], rho_layers=[256], output_dim=1, activation="gelu",
              layer_norm=False, residual_block=True, pooling="mean")
    if route.startswith("deep_sets"):
        events = [rng.normal(size=(40, 6)).astype(np.float32) for _ in range(64)]
        layout = "dense" if "dense" in route else "flat"
        loader = PointCloudLoader(events, rng.integers(0, 2, size=64), 16, False, layout=layout)
        extra = {"deep_sets-tail": dict(fused_phi="tail"), "deep_sets-plain-ln": dict(layer_norm=True),
                 "deep_sets-bf16-dense": dict(compute_dtype="bfloat16"),
                 # the wide variants, whose K2 allocates its [P, W] scratch in the window
                 "deep_sets-bf16-phi1024": dict(compute_dtype="bfloat16", phi_layers=[1024, 1024])
                 }.get(route, {})
        return (lambda seed: DeepSets(**{**ds, **extra}, generator=torch.Generator().manual_seed(seed))), \
            _same_shape(list(loader))
    if route == "fcn":
        loader = TabularLoader(rng.normal(size=(64, 9)), rng.integers(0, 2, size=64), 16, False)
        return (lambda seed: FullyConnectedNet(9, [64, 128, 64], True, 1)), list(loader)[:4]
    graphs = lineage_graphs(np.random.default_rng(4), 96, 40, 90, position_grid=1 / 64)
    model = {"gat": dict(use_gat=True), "graphconv-fused": dict(fused_inrow=True),
             "graphconv-add": {}, "gat-sag": dict(use_gat=True, sag_pool=True),
             "knn": dict(knn_k=8), "flat-add": {}, "flat-sag": dict(sag_pool=True),
             "max": dict(local_pooling="max")}[route]
    kw = dict(layout="flat") if route in ("knn", "flat-add", "flat-sag") else dict(
        layout="dense", emit_out_rows="fused" in route)
    loader = GraphLoader(graphs, 8, shuffle=False, use_weights=not model.get("use_gat"), **kw)
    cfg = dict(input_dim=4, hidden_dim=128, output_dim=1, activation="tanh", deepchem_style=True, **model)
    return (lambda seed: GraphNet(**cfg, generator=torch.Generator().manual_seed(seed))), \
        _same_shape(list(loader))


def _counts():
    return (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches, gat.gat_attention.launches,
            gat.gat_attention.bwd_launches, gat.gat_out_rows.launches, inrow_graph.inrow_aggregate.launches,
            inrow_graph.inrow_aggregate.bwd_launches, knn.knn_select.launches, knn.knn_aggregate.launches,
            knn.knn_aggregate.bwd_launches)


WINDOW_ROUTES = ["deep_sets-flat", "deep_sets-dense", "deep_sets-bf16-dense", "deep_sets-bf16-phi1024", "deep_sets-tail",
                 "deep_sets-plain-ln", "fcn", "gat", "graphconv-fused", "graphconv-add", "gat-sag", "knn",
                 "flat-add", "flat-sag", "max"]
# the FCN's biases ahead of a BatchNorm have a gradient of 0 in exact
# arithmetic; Adam scales the rounding residue up to lr-sized steps, so two
# runs that sum in other orders drift apart there (docs/parity_torch.md §7)
FREE = {"fcn": ("network.0.bias", "network.3.bias", "network.6.bias")}


@pytest.mark.gpu
@pytest.mark.parametrize("route", WINDOW_ROUTES)
def test_fused_window_matches_eager_steps(route):
    """A window of four train steps (run eagerly at its first call, captured
    at its second, replayed at its third) against the same steps run one by
    one on the card: per-step losses within 1e-5 relative, the parameters
    after, the kernels launched (counted at each replay), and a fused
    ``predict`` against an unfused one.  Every route captures (SAG's ranks
    count the ids on the device since this test found ``bincount`` reading
    the largest id back)."""
    from point_cloud_classifier_tpu_torch.models import ModelWrapper

    _cuda()
    make, batches = _window_route(route)
    fused = ModelWrapper(make(0), 1e-3, 1, optimizer="adamw", fuse_steps=4, device="cuda")
    eager = ModelWrapper(make(1), 1e-3, 1, optimizer="adamw", device="cuda")
    eager.model.load_state_dict(fused.model.state_dict())
    # f32: sums in other orders (K1's run-length atomics, capturable Adam's
    # device-side bias correction); bf16: a reordered f32 sum can round to
    # the neighbouring bf16 value (1.1e-4 of a loss read on an H100)
    tol = 1e-3 if "bf16" in route else 1e-5
    for rep in range(3):
        before = _counts()
        got = fused.train_window(batches)
        mid = _counts()
        want = torch.stack([eager.train_step(b) for b in batches])
        after = _counts()
        assert [m - b for m, b in zip(mid, before)] == [a - m for a, m in zip(after, mid)], rep
        torch.testing.assert_close(got, want, rtol=tol, atol=tol / 10)
    assert len(fused.windows) == 1 and fused.windows.replays == 2 and fused.windows.captures == 1
    for (name, p), q in zip(fused.model.named_parameters(), eager.model.parameters()):
        if name not in FREE.get(route, ()):
            err = ((p - q).abs().max() / q.abs().max().clamp(min=1.0)).item()
            assert err <= 10 * tol, (name, err)
    # eval windows from the same weights (a copy in place: the graphs keep
    # their pointers)
    fused.model.load_state_dict(eager.model.state_dict())
    y1, p1 = eager.predict(batches * 3, return_prob=True)
    fused.windows.replays = 0
    yk, pk = fused.predict(batches * 3, return_prob=True)  # warm-up, capture, replay
    assert fused.windows.replays == 2
    np.testing.assert_array_equal(yk, y1)
    np.testing.assert_allclose(pk, p1, rtol=10 * tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [False, True], ids=["flat", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_tail_pair_matches_plain(dtype, dense):
    """``fused_phi="tail"``: K1 and K2 over the chain of one bare linear
    layer after the plain hidden chain (f32: the tf32x3 variants; bf16: the
    wide ones, one block a tile), the loss and every gradient against
    ``force_plain()``.  f32: the same math in other sum orders; bf16: a
    reordered f32 dot can round a row's value to the neighbouring bf16 value
    (TOL), which the rest of the step carries."""
    from point_cloud_classifier_tpu_torch.models import ModelWrapper

    _cuda()
    make, batches = _window_route("deep_sets-dense" if dense else "deep_sets-flat")
    cfg = dict(input_dim=6, phi_layers=[256, 256], rho_layers=[256], output_dim=1, activation="gelu",
               layer_norm=False, residual_block=True, pooling="mean", fused_phi="tail", compute_dtype=dtype)
    kernel = ModelWrapper(DeepSets(**cfg, generator=torch.Generator().manual_seed(0)), 1e-3, 1, device="cuda")
    plain = ModelWrapper(DeepSets(**cfg, generator=torch.Generator().manual_seed(1)), 1e-3, 1, device="cuda")
    plain.model.load_state_dict(kernel.model.state_dict())
    before = (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches)
    loss = kernel.train_step(batches[0])
    assert (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches) == (before[0] + 1, before[1] + 1)
    variant = "tf32x3" if dtype == "float32" else "wide"
    assert (fused_phi.phi_pool.variant, fused_phi.phi_pool.bwd_variant) == (variant, variant)
    with force_plain():
        ref = plain.train_step(batches[0])
    loss_tol, grad_tol = (1e-5, 1e-4) if dtype == "float32" else (TOL[torch.bfloat16], TOL[torch.bfloat16])
    torch.testing.assert_close(loss, ref, rtol=loss_tol, atol=1e-6)
    for (name, p), q in zip(kernel.model.named_parameters(), plain.model.parameters()):
        scale = max(1e-12, q.grad.abs().max().item())
        assert (p.grad - q.grad).abs().max().item() <= grad_tol * scale, name


def _resume_loaders(route):
    """``(model factory, train batches, val batches)``: two shapes each, in
    runs of four train and two val batches (windows of those lengths)."""
    from point_cloud_classifier_tpu_torch.data import GraphLoader, PointCloudLoader
    from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs

    rng = np.random.default_rng(3)
    if route == "deep_sets":
        sizes = np.concatenate([rng.integers(20, 30, size=48), rng.integers(70, 90, size=48)])
        events = [rng.normal(size=(int(k), 6)).astype(np.float32) for k in sizes]
        labels = rng.integers(0, 2, size=len(events))
        pick = lambda idx: list(PointCloudLoader([events[i] for i in idx], labels[idx], 8, False))  # noqa: E731
        cfg = dict(input_dim=6, phi_layers=[256, 256], rho_layers=[256], output_dim=1, activation="gelu",
                   layer_norm=False, residual_block=True, pooling="mean")
        make = lambda: DeepSets(**cfg, generator=torch.Generator().manual_seed(0))  # noqa: E731
    else:
        graphs = lineage_graphs(np.random.default_rng(4), 48, 20, 30) + \
            lineage_graphs(np.random.default_rng(5), 48, 100, 120)
        pick = lambda idx: list(GraphLoader([graphs[i] for i in idx], 8, shuffle=False,  # noqa: E731
                                            layout="dense", use_weights=True, emit_out_rows=True))
        cfg = dict(input_dim=4, hidden_dim=128, output_dim=1, activation="tanh", deepchem_style=True,
                   fused_inrow=True)
        make = lambda: GraphNet(**cfg, generator=torch.Generator().manual_seed(0))  # noqa: E731
    train = np.r_[0:32, 48:80]
    val = np.r_[32:48, 80:96]
    return make, pick(train), pick(val)


def _resume_runs(route, tmp_path, device):
    """A run of 4 epochs with ``fuse_steps=4`` over resident caches with
    validation each epoch; the same run stopped after epoch 1 and resumed
    for 3 more (its state read back to the CPU by ``torch.load``); an
    unfused run with the optimizer the windows capture (``capturable``: the
    trainer's default Adam rounds apart from it, ``chip_smoke.py`` phase 24
    measures by how much).  The caches replay in their first order (a resumed run's
    cache streams its first epoch in the loader's order, so a shuffled
    replay would part it from the uninterrupted run).  Returns
    ``{name: (wrapper, metrics)}``."""
    from point_cloud_classifier_tpu_torch.data.resident import ResidentCache
    from point_cloud_classifier_tpu_torch.models import ModelWrapper
    from point_cloud_classifier_tpu_torch.models.wrapper import _make_optimizer

    make, train, val = _resume_loaders(route)

    def run(name, fuse, epochs, resume=False):
        wrapper = ModelWrapper(make(), 3e-3, epochs, log_dir=str(tmp_path / name), optimizer="adamw",
                               seed=0, state_every=1, fuse_steps=fuse, device_resident=True, device=device)
        if fuse == 1:
            wrapper.optimizer = _make_optimizer("adamw", wrapper.model.parameters(), 3e-3,
                                                capturable=device != "cpu")
        wrapper.fit(ResidentCache(train, device=device), ResidentCache(val, device=device), resume=resume)
        return wrapper

    runs = {"straight": run("straight", 4, 4), "unfused": run("unfused", 1, 4)}
    run("resumed", 4, 1)
    runs["resumed"] = run("resumed", 4, 4, resume=True)
    out = {}
    for name, wrapper in runs.items():
        rows = {}
        with open(tmp_path / name / "metrics.jsonl") as f:
            for line in f:
                row = json.loads(line)
                rows.setdefault(row["tag"], {})[row["step"]] = row["value"]
        out[name] = (wrapper, rows)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["deep_sets", "graphconv-fused"])
def test_resumed_fused_run_on_the_card_matches_an_uninterrupted_one(route, tmp_path):
    """``fuse_steps=4`` over resident loaders of two shapes with validation
    each epoch, so that train and eval graphs of several shape keys replay
    in turn from the one pool: a run stopped after its first epoch and
    resumed (the capturable Adam state saved, read back to the CPU and
    loaded onto the card) ends where the uninterrupted fused run ends, and
    where an unfused run with the same Adam ends: per-epoch losses within 1e-5 relative,
    parameters and Adam moments within 1e-4 of their scale, the step counts
    equal."""
    _cuda()
    runs = _resume_runs(route, tmp_path, "cuda")
    straight, rows = runs["straight"]
    # two train and two eval shape keys, each captured once and replayed
    assert (len(straight.windows), straight.windows.captures) == (4, 4) and straight.windows.replays >= 8
    resumed = runs["resumed"][0]
    assert (len(resumed.windows), resumed.windows.captures) == (4, 4) and resumed.windows.replays >= 4
    for name in ("resumed", "unfused"):
        wrapper, other = runs[name]
        for tag in ("Loss/train", "Loss/val"):
            for epoch, value in rows[tag].items():
                assert abs(other[tag][epoch] - value) <= 1e-5 * abs(value), (name, tag, epoch, other[tag], value)
        for (key, p), q in zip(wrapper.model.named_parameters(), straight.model.parameters()):
            err = ((p - q).abs().max() / q.abs().max().clamp(min=1.0)).item()
            assert err <= 1e-4, (name, key, err)
        ours, ref = wrapper.optimizer.state_dict()["state"], straight.optimizer.state_dict()["state"]
        for i, state in ref.items():
            assert torch.equal(ours[i]["step"].cpu(), state["step"].cpu()), (name, i)
            for k in ("exp_avg", "exp_avg_sq"):
                scale = state[k].abs().max().clamp(min=1e-30)
                err = ((ours[i][k] - state[k]).abs().max() / scale).item()
                assert err <= 1e-4, (name, i, k, err)


class _HostRead(torch.nn.Module):
    """A model whose forward reads the device on the host."""

    name = "host_read"
    config = {"width": 4}

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(9, 1)

    def forward(self, batch, train=False):
        x = batch["x"]
        if x.abs().sum().item() > 0:
            x = x * 1.0
        return self.lin(x)


@pytest.mark.gpu
def test_uncapturable_route_raises_naming_the_operation():
    """A train step that reads the device on the host raises at its first
    window, naming the route and the operation; nothing trains unfused."""
    from point_cloud_classifier_tpu_torch.data import TabularLoader
    from point_cloud_classifier_tpu_torch.models import ModelWrapper

    _cuda()
    rng = np.random.default_rng(0)
    batches = list(TabularLoader(rng.normal(size=(32, 9)), rng.integers(0, 2, size=32), 8, False))
    wrapper = ModelWrapper(_HostRead(), 1e-3, 1, fuse_steps=2, device="cuda")
    before = [p.detach().clone() for p in wrapper.model.parameters()]
    with pytest.raises(NotImplementedError, match=r"fuse_steps=2: the train step of host_read "
                       r'\{"width": 4\} cannot run as a CUDA graph: .* at tests/test_torch_gpu.py:\d+ '
                       r"\(if x.abs\(\).sum\(\).item\(\) > 0:\)"):
        wrapper.train_window(batches[:2])
    with pytest.raises(NotImplementedError, match="host_read"):
        wrapper.fit(batches)
    assert torch.cuda.get_sync_debug_mode() == 0
    assert all(torch.equal(p, q) for p, q in zip(wrapper.model.parameters(), before))


# -- int8 evaluation and the serving export ---------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows, k, n", [(5, 6, 256), (16, 6, 3), (1001, 6, 256), (1001, 256, 256), (40, 256, 12)])
def test_int8_linear_on_the_card_matches_the_cpu(rows, k, n):
    """``torch._int_mm`` on the card, its codes padded to what it takes
    (more than 16 rows, inner and outer dimensions multiples of 8), against
    the same call on the CPU: codes, scales and s32 sums equal, outputs
    within 1e-6 relative (f32 products in another order, if any)."""
    from point_cloud_classifier_tpu_torch.ops import quant

    dev = _cuda()
    rng = np.random.default_rng(rows + k + n)
    x = torch.from_numpy(rng.normal(size=(rows, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(n, k)) * k**-0.5).astype(np.float32)).t()  # a transposed weight
    b = torch.from_numpy((rng.normal(size=(n,)) * 0.1).astype(np.float32))
    xq, sx = quant.quantize_rows(x)
    wq, sw = quant.quantize_cols(w)
    xq_d, sx_d = quant.quantize_rows(x.to(dev))
    wq_d, sw_d = quant.quantize_cols(w.to(dev))
    assert torch.equal(xq_d.cpu(), xq) and torch.equal(sx_d.cpu(), sx)
    assert torch.equal(wq_d.cpu(), wq) and torch.equal(sw_d.cpu(), sw)
    assert torch.equal(quant.int8_matmul(xq_d, wq_d).cpu(), quant.int8_matmul(xq, wq))
    for dtype in (torch.float32, torch.bfloat16):
        out = quant.int8_linear(x.to(dev, dtype), w.to(dev), b.to(dev), dtype).cpu().float()
        ref = quant.int8_linear(x.to(dtype), w, b, dtype).float()
        tol = 1e-6 if dtype == torch.float32 else 2**-8
        assert (out - ref).abs().max().item() <= tol * ref.abs().max().item(), dtype


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["deep_sets-flat", "deep_sets-dense", "deep_sets-bf16-dense"])
def test_int8_eval_window_captures(route):
    """``predict`` of a ``quant="int8"`` DeepSets in fused eval windows
    (warm-up, capture, replay: no host read of a scale or an abs-max) against
    the eager int8 ``predict``, and against the CPU's int8 ``predict``; no K1
    launch."""
    from point_cloud_classifier_tpu_torch.models import ModelWrapper

    _cuda()
    make, batches = _window_route(route)
    net = make(0)
    net.quant = "int8"
    fused = ModelWrapper(net, 1e-3, 1, fuse_steps=4, device="cuda")
    eager = ModelWrapper(make(0), 1e-3, 1, device="cuda")
    eager.model.quant = "int8"
    eager.model.load_state_dict(fused.model.state_dict())
    on_cpu = ModelWrapper(make(0), 1e-3, 1, device="cpu")
    on_cpu.model.quant = "int8"
    on_cpu.model.load_state_dict({k: v.cpu() for k, v in fused.model.state_dict().items()})
    k1 = fused_phi.phi_pool.launches
    y1, p1 = eager.predict(batches * 3, return_prob=True)
    yk, pk = fused.predict(batches * 3, return_prob=True)
    assert fused_phi.phi_pool.launches == k1
    assert fused.windows.captures == 1 and fused.windows.replays == 2
    np.testing.assert_array_equal(yk, y1)
    np.testing.assert_allclose(pk, p1, rtol=0, atol=1e-6)
    # the card's activations may round an ulp apart from the CPU's, which can
    # move a later layer's code by one at a rounding tie (logits within 1e-4)
    _, pc = on_cpu.predict(batches, return_prob=True)
    tol = 1e-4 if "bf16" not in route else 2e-2
    np.testing.assert_allclose(p1[: len(pc)], pc, rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_export_on_the_card_host_serves_on_the_card_and_the_cpu(tmp_path, quant):
    """A DeepSets run trained on the card, exported there for both devices
    (``export_run`` restores it on the card and traces a CPU copy), served by
    ``ExportedModel`` on the card and on the CPU, each against ``predict`` of
    the same route on its device (the plain route for float); no kernel
    launches while a program runs."""
    from point_cloud_classifier_tpu_torch import factory, serving
    from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache
    from point_cloud_classifier_tpu_torch.train import train_model
    from point_cloud_classifier_tpu_torch.utils.config import load_config

    _cuda()
    data = str(tmp_path / "data")
    write_s2ppc_cache(data, n_events=(64, 16, 40), min_points=3, max_points=60, seed=4)
    cfg = {"meta": {"model_name": "", "dataset_name": ""},
           "dataset": {"data_dir": data, "batch_size": 16},
           "logging": {"log_dir": str(tmp_path / "log")},
           "model": {"input_dim": 6, "phi_layers": [256, 256], "rho_layers": [256], "output_dim": 1,
                     "pooling": "mean", "layer_norm": False, "activation": "gelu", "residual_block": True},
           "trainer": {"epochs": 1, "learning_rate": 0.001, "optimizer": "adamw"}}
    run = train_model("deep_sets", "s2ppc", cfg, return_log_dir=True)
    out = serving.export_run(run, out_dir=str(tmp_path / "exported"), quant=quant, platforms=("cuda", "cpu"))
    config = load_config(f"{run}/config.yaml")
    factory.apply_quant(config, "deep_sets", quant)
    batches = list(factory.get_dataloader("s2ppc", config).get_test_loader())
    for device in ("cuda", "cpu"):
        with force_plain():
            _, ref = factory.get_model("deep_sets", config, run, device=device).predict(iter(batches), True)
        before = _counts()
        _, got = serving.ExportedModel(out, device=device).predict(iter(batches), return_prob=True)
        assert _counts() == before
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=device)

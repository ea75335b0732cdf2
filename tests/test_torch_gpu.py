"""The port's CUDA kernel on a card: K1 against its plain version, and the
DeepSets kernel route against its plain route.

These tests need a CUDA card and skip without one.  They import neither jax
nor the JAX package, so they run on a machine that has only PyTorch; there,
skip the repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_classifier_tpu_torch.models import DeepSets  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi  # noqa: E402

SPEC = (("plain", False), ("residual", False))
# max |kernel − plain| / max(1, max |plain|): f32 sums in another order
# (sequential FMAs and atomics against cuBLAS and index_add); bf16 values
# that round to the neighbouring bf16 value after a reordered dot.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


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
    with pytest.raises(NotImplementedError, match="backward"):
        fused_phi.phi_pool(pts.requires_grad_(), seg, SPEC, params, "gelu", s)


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

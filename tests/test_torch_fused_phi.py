"""PyTorch port of ops/fused_phi: plain φ chain and pool against the JAX package.

The same seeded numpy inputs go through the JAX function
(``phi_pool_xla``, and ``phi_pool_pallas`` in interpret mode as
tests/test_fused_phi.py runs it) and the port's ``phi_pool_plain``.  The CUDA
kernel itself runs only on a card: tests/test_torch_gpu.py and chip_smoke.py
hold it against ``phi_pool_plain`` there.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_classifier_tpu.ops import fused_phi as jax_phi  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi  # noqa: E402

SPECS = {
    "plain": (("plain", False),),
    "plain+res": (("plain", False), ("residual", False)),
    "deep": (("plain", False), ("residual", False), ("residual", False)),
    "empty": (),
}
# f32: both sides accumulate every dot and every segment sum in f32 over
# ≤ 4,096 points, so they differ by rounding only: 1e-5 relative, 1e-4
# absolute on pooled sums.
F32 = dict(rtol=1e-5, atol=1e-4)
# bf16: one bf16 rounding (2^-8 relative) that lands differently on either
# side carries through the chain; 3e-2 of the output scale bounds it.
BF16_REL = 3e-2


def _inputs(spec, final, p=96, f=6, b=5, width=32, seed=0):
    """Seeded numpy points, sorted seg ids (padding rows get id b) and
    params ``(w [in, out], b, ln_scale, ln_bias)`` (+ the final ``(w, b)``)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(p, f)).astype(np.float32)
    seg = np.sort(rng.integers(0, b + 1, size=p)).astype(np.int32)
    seg[seg == 2] = 3  # event 2 is empty
    params, last = [], f
    for _kind, has_ln in spec:
        w = (rng.normal(size=(last, width)) * last**-0.5).astype(np.float32)
        bias = (rng.normal(size=(width,)) * 0.1).astype(np.float32)
        ln = (
            (1.0 + 0.1 * rng.normal(size=(width,))).astype(np.float32),
            (0.1 * rng.normal(size=(width,))).astype(np.float32),
        ) if has_ln else (None, None)
        params.append((w, bias, *ln))
        last = width
    if final:
        params.append(
            (
                (rng.normal(size=(last, last)) * last**-0.5).astype(np.float32),
                (rng.normal(size=(last,)) * 0.1).astype(np.float32),
            )
        )
    return pts, seg, b + 1, tuple(params)


def _as(params, conv):
    return tuple(tuple(None if a is None else conv(a) for a in layer) for layer in params)


def _jax(pts, seg, params, dtype=jnp.float32):
    return jnp.asarray(pts).astype(dtype), jnp.asarray(seg), _as(params, jnp.asarray)


def _torch(pts, seg, params, dtype=torch.float32):
    return torch.from_numpy(pts).to(dtype), torch.from_numpy(seg), _as(params, torch.from_numpy)


@pytest.mark.parametrize("final", [False, True], ids=["hidden-only", "full"])
@pytest.mark.parametrize("activation", ["relu", "silu", "tanh", "gelu"])
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_phi_pool_plain_matches_xla(spec_name, activation, final):
    spec = SPECS[spec_name]
    pts, seg, s, params = _inputs(spec, final)
    jp, js, jparams = _jax(pts, seg, params)
    ref = jax_phi.phi_pool_xla(jp, js, spec, jparams, activation, s)
    tp, ts, tparams = _torch(pts, seg, params)
    out = fused_phi.phi_pool_plain(tp, ts, spec, tparams, activation, s)
    assert out.dtype == torch.float32 and out.shape == (s, ref.shape[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize(
    "spec_name, final",
    [("plain+res", False), ("plain+res", True), ("empty", True)],
    ids=["plain+res-hidden-only", "plain+res-full", "empty-full"],
)
def test_phi_pool_plain_matches_pallas_interpret(spec_name, final, activation):
    spec = SPECS[spec_name]
    pts, seg, s, params = _inputs(spec, final, p=64)
    jp, js, jparams = _jax(pts, seg, params)
    ref = jax_phi.phi_pool_pallas(jp, js, spec, jparams, activation, s, interpret=True)
    tp, ts, tparams = _torch(pts, seg, params)
    out = fused_phi.phi_pool_plain(tp, ts, spec, tparams, activation, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("activation", ["relu", "silu", "tanh", "gelu"])
def test_phi_pool_plain_bf16_matches_xla(activation):
    spec = SPECS["plain+res"]
    pts, seg, s, params = _inputs(spec, final=False)
    jp, js, jparams = _jax(pts, seg, params, jnp.bfloat16)
    ref = np.asarray(jax_phi.phi_pool_xla(jp, js, spec, jparams, activation, s))
    tp, ts, tparams = _torch(pts, seg, params, torch.bfloat16)
    out = fused_phi.phi_pool_plain(tp, ts, spec, tparams, activation, s).numpy()
    assert np.abs(out - ref).max() <= BF16_REL * max(1.0, np.abs(ref).max())


def test_phi_forward_with_layer_norm_matches_xla():
    spec = (("plain", True), ("residual", True))
    pts, _, _, params = _inputs(spec, final=True)
    ref = jax_phi.phi_forward_xla(jnp.asarray(pts), spec, _as(params, jnp.asarray), "gelu")
    out = fused_phi.phi_forward(torch.from_numpy(pts), spec, _as(params, torch.from_numpy), "gelu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_exact_gelu_is_tanh_form(monkeypatch):
    monkeypatch.setenv("PCC_GELU", "exact")
    spec = SPECS["plain+res"]
    pts, seg, s, params = _inputs(spec, final=True)
    jp, js, jparams = _jax(pts, seg, params)
    ref = jax_phi.phi_pool_xla(jp, js, spec, jparams, "gelu", s)
    tp, ts, tparams = _torch(pts, seg, params)
    out = fused_phi.phi_pool_plain(tp, ts, spec, tparams, "gelu", s)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_phi_pool_on_cpu_takes_plain_and_counts_no_launch():
    spec = SPECS["plain+res"]
    pts, seg, s, params = _inputs(spec, final=False)
    args = (torch.from_numpy(pts), torch.from_numpy(seg), spec, _as(params, torch.from_numpy), "gelu", s)
    before = fused_phi.phi_pool.launches
    out = fused_phi.phi_pool(*args)
    assert fused_phi.phi_pool.launches == before
    assert torch.equal(out, fused_phi.phi_pool_plain(*args))


def test_phi_pool_raises_off_cpu_and_cuda():
    spec = SPECS["plain"]
    pts = torch.empty((8, 6), device="meta")
    seg = torch.empty((8,), dtype=torch.int32, device="meta")
    params = ((torch.empty((6, 4), device="meta"), torch.empty((4,), device="meta")),)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_phi.phi_pool(pts, seg, spec, params, "relu", 3)

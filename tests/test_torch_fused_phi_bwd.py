"""The backward of the port's fused φ-pool against the JAX package.

``phi_pool_bwd_plain`` (the closed form that the CUDA kernel K2 computes)
goes against ``phi_pool_bwd_pallas`` in interpret mode, as
tests/test_fused_phi.py runs it, and against ``jax.vjp`` of ``phi_pool_xla``,
on the same seeded numpy inputs.  ``gradcheck`` in float64 holds the
autograd Function that routes to it.  K2 itself runs only on a card:
tests/test_torch_gpu.py and chip_smoke.py hold it against
``phi_pool_bwd_plain`` there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.ops import fused_phi as jax_phi  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi  # noqa: E402

SPEC = (("plain", False), ("residual", False))
ACTIVATIONS = [("relu", "quick"), ("silu", "quick"), ("tanh", "quick"), ("gelu", "quick"), ("gelu", "exact")]
ACT_IDS = ["relu", "silu", "tanh", "quick-gelu", "tanh-gelu"]
# f32: both sides take every dot and sum in f32 over ≤ 128 points, in other
# orders: 1e-5 of the gradient's scale.
F32_REL = 1e-5
# bf16: the two sides round to bf16 at different points (autodiff rounds
# every primitive's cotangent, the closed form rounds once per dz, dz Wᵀ and
# residual add), each 2^-8 relative: 1e-2 relative Frobenius, the bound of
# tests/test_fused_phi.py's bf16 backward test.
BF16_FRO = 1e-2


def _inputs(final, p, b=5, width=16, seed=0):
    """Seeded points, sorted seg ids (padding rows get id b; event 2 is
    empty), params (w [in, out], b) and an f32 cotangent g [b + 1, width]."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(p, 6)).astype(np.float32)
    seg = np.sort(rng.integers(0, b + 1, size=p)).astype(np.int32)
    seg[seg == 2] = 3
    params, last = [], 6
    for _ in range(len(SPEC) + int(final)):
        w = (rng.normal(size=(last, width)) * last**-0.5).astype(np.float32)
        bias = (rng.normal(size=(width,)) * 0.1).astype(np.float32)
        params.append((w, bias))
        last = width
    g = rng.normal(size=(b + 1, width)).astype(np.float32)
    return pts, seg, tuple(params), g, b + 1


def _port(pts, seg, params, g, s, activation, dtype=torch.float32):
    tparams = tuple((torch.from_numpy(w), torch.from_numpy(b)) for w, b in params)
    d_points, grads = fused_phi.phi_pool_bwd_plain(
        torch.from_numpy(pts).to(dtype), torch.from_numpy(seg), torch.from_numpy(g),
        SPEC, tparams, activation, s,
    )
    assert d_points.dtype == dtype and all(t.dtype == torch.float32 for t in grads)
    return [d_points.float().numpy()] + [t.numpy() for t in grads]


def _jax_vjp(pts, seg, params, g, s, activation, dtype=jnp.float32):
    # phi_pool_xla's hidden layers carry (w, b, ln_scale, ln_bias)
    jparams = tuple(
        (jnp.asarray(w), jnp.asarray(b)) + ((None, None) if i < len(SPEC) else ())
        for i, (w, b) in enumerate(params)
    )

    def f(x, prm):
        return jax_phi.phi_pool_xla(x, jnp.asarray(seg), SPEC, prm, activation, s)

    _, vjp = jax.vjp(f, jnp.asarray(pts).astype(dtype), jparams)
    d_points, d_params = vjp(jnp.asarray(g))
    return [np.asarray(d_points, np.float32)] + [
        np.asarray(t, np.float32) for layer in d_params for t in layer if t is not None
    ]


def _assert_close(out, ref, rel):
    for a, r in zip(out, ref, strict=True):
        assert a.shape == r.shape
        assert np.abs(a - r).max() <= rel * max(1.0, np.abs(r).max())


def _assert_fro(out, ref, bound):
    for a, r in zip(out, ref, strict=True):
        a64, r64 = a.astype(np.float64), r.astype(np.float64)
        assert np.linalg.norm(a64 - r64) <= bound * (np.linalg.norm(r64) + 1e-8)


@pytest.mark.parametrize("final", [False, True], ids=["hidden-only", "full"])
@pytest.mark.parametrize("activation, gelu", ACTIVATIONS, ids=ACT_IDS)
def test_plain_backward_matches_jax_kernel_interpret(monkeypatch, activation, gelu, final):
    monkeypatch.setenv("PCC_GELU", gelu)
    pts, seg, params, g, s = _inputs(final, p=128)
    d_points, flat = jax_phi.phi_pool_bwd_pallas(
        jnp.asarray(pts), jnp.asarray(seg), jnp.asarray(g), SPEC,
        tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params), activation, s,
        interpret=True,
    )
    ref = [np.asarray(d_points)] + [np.asarray(t).reshape(np.shape(p)) for t, p in
                                    zip(flat, [a for layer in params for a in layer])]
    _assert_close(_port(pts, seg, params, g, s, activation), ref, F32_REL)


@pytest.mark.parametrize("final", [False, True], ids=["hidden-only", "full"])
@pytest.mark.parametrize("activation, gelu", ACTIVATIONS, ids=ACT_IDS)
def test_plain_backward_matches_jax_vjp_ragged(monkeypatch, activation, gelu, final):
    monkeypatch.setenv("PCC_GELU", gelu)
    pts, seg, params, g, s = _inputs(final, p=101)  # tiles no power of two
    ref = _jax_vjp(pts, seg, params, g, s, activation)
    _assert_close(_port(pts, seg, params, g, s, activation), ref, F32_REL)


@pytest.mark.parametrize("activation", ["relu", "silu", "tanh", "gelu"])
def test_plain_backward_bf16_matches_jax_vjp(activation):
    pts, seg, params, _, s = _inputs(final=False, p=256, width=32, seed=5)
    # the linear loss Σ out[:b] · c, so that both sides get the same
    # cotangent (no padding row)
    g = np.random.default_rng(6).normal(size=(s, 32)).astype(np.float32)
    g[-1] = 0.0
    ref = _jax_vjp(pts, seg, params, g, s, activation, jnp.bfloat16)
    _assert_fro(_port(pts, seg, params, g, s, activation, torch.bfloat16), ref, BF16_FRO)


def test_plain_backward_bf16_matches_jax_kernel_interpret():
    pts, seg, params, _, s = _inputs(final=False, p=256, width=32, seed=5)
    g = np.random.default_rng(6).normal(size=(s, 32)).astype(np.float32)
    g[-1] = 0.0
    jparams = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params)
    d_points, flat = jax_phi.phi_pool_bwd_pallas(
        jnp.asarray(pts, jnp.bfloat16), jnp.asarray(seg), jnp.asarray(g), SPEC, jparams,
        "gelu", s, interpret=True,
    )
    ref = [np.asarray(d_points, np.float32)] + [
        np.asarray(t).reshape(np.shape(p)) for t, p in zip(flat, [a for layer in params for a in layer])
    ]
    _assert_fro(_port(pts, seg, params, g, s, "gelu", torch.bfloat16), ref, BF16_FRO)


@pytest.mark.parametrize("final", [False, True], ids=["hidden-only", "full"])
@pytest.mark.parametrize("activation, gelu", ACTIVATIONS, ids=ACT_IDS)
def test_phi_pool_gradcheck_float64(monkeypatch, activation, gelu, final):
    """d_points and every weight and bias of the autograd Function, against
    finite differences."""
    monkeypatch.setenv("PCC_GELU", gelu)
    pts, seg, params, _, s = _inputs(final, p=24, b=3, width=5)
    x = torch.from_numpy(pts).double().requires_grad_()
    flat = [torch.from_numpy(a).double().requires_grad_() for layer in params for a in layer]

    def f(points, *ws):
        return fused_phi.phi_pool(
            points, torch.from_numpy(seg), SPEC, tuple(zip(ws[0::2], ws[1::2])), activation, s
        )

    assert torch.autograd.gradcheck(f, (x, *flat))


def test_cpu_backward_takes_the_plain_version(monkeypatch):
    """On CPU tensors the Function's backward is phi_pool_bwd_plain, asked
    for d_points only when the points need a gradient, and launches nothing."""
    pts, seg, params, _, s = _inputs(final=False, p=64)
    calls = []
    real = fused_phi.phi_pool_bwd_plain

    def spy(*args, **kwargs):
        calls.append(kwargs["with_points"])
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_phi, "phi_pool_bwd_plain", spy)
    tparams = tuple(
        (torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_())
        for w, b in params
    )
    launches = (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches)
    for points_grad in (False, True):
        x = torch.from_numpy(pts).requires_grad_(points_grad)
        fused_phi.phi_pool(x, torch.from_numpy(seg), SPEC, tparams, "gelu", s).sum().backward()
        assert (x.grad is not None) == points_grad
    assert calls == [False, True]
    assert (fused_phi.phi_pool.launches, fused_phi.phi_pool.bwd_launches) == launches
    ref = torch.autograd.grad(
        fused_phi.phi_pool_plain(torch.from_numpy(pts), torch.from_numpy(seg), SPEC,
                                 tparams, "gelu", s).sum(),
        [t for layer in tparams for t in layer],
    )
    for layer, (w_ref, b_ref) in zip(tparams, zip(ref[0::2], ref[1::2])):
        torch.testing.assert_close(layer[0].grad, 2 * w_ref, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(layer[1].grad, 2 * b_ref, rtol=1e-5, atol=1e-6)

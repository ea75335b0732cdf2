"""The bf16 tail (``fused_phi="tail"`` in bf16) in the port, on the CPU.

- The port's DeepSets with ``compute_dtype="bfloat16"`` and
  ``fused_phi="tail"`` (the hidden φ chain on the plain path, then the final
  [H, H] linear and the pooling through ``phi_pool``'s pair over a
  one-layer chain, plain on the CPU) against the JAX package's
  ``fused_phi="tail"`` in bf16 on the same seeded weights and batch: on the
  flat wire the JAX side runs its Pallas pair in interpret mode, as the JAX
  package's tests run it; on the dense wire it takes XLA.  The train-mode
  logits within ``BF16_LOGITS`` of their own scale, and every parameter's
  gradient within a relative Frobenius bound of its own (``BF16_WEIGHT_FRO``,
  ``BF16_BIAS_FRO``).
- ``phi_pool_bwd_plain`` over the tail's bare layer in bf16 (what K2's bf16
  tail form computes on the card) against its closed form in f64: the
  cotangent rounded to bf16 before the gather (zero for ids outside [0, S)),
  ``d_W = hᵀ dz`` and ``d_b = Σ dz`` summed from those bf16 values, and
  ``d_points = bf16(dz Wᵀ)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu_torch import convert  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi  # noqa: E402
from tests.test_torch_deep_sets import (  # noqa: E402
    _port_grads,
    jax_and_port,
    model_cfg,
    wire_batch,
)

H = 256
# Each leaf against JAX on its own scale: bf16 on both sides, rounded at
# other points (the JAX package's autodiff rounds every primitive's
# cotangent, the port's closed form once per dz and dz Wᵀ) and summed in
# other orders, through the whole model.  Readings at these inputs, the tail
# route (and the port's plain route, fused_phi="off", for scale): the
# logits' max |Δ| / max |JAX| up to 1.2e-2 (2.6e-2); relative Frobenius of
# each weight's gradient up to 1.5e-2 (1.4e-2), of each bias's up to 4.0e-2
# (3.7e-2), rho.0.bias at mean pooling: a bias's gradient sums the
# differently rounded cotangents of every row.  A zero or unrelated
# gradient reads 1 or more.
BF16_LOGITS, BF16_WEIGHT_FRO, BF16_BIAS_FRO = 3e-2, 2e-2, 5e-2
# the plain backward's f32 sums of exact bf16 products against f64 sums
F32_REL = 1e-5


def _rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("wire", ["flat", "dense"])
def test_bf16_tail_matches_jax_loss_and_gradients(wire, pooling):
    cfg = model_cfg(phi_layers=[H, H], rho_layers=[16], pooling=pooling, compute_dtype="bfloat16",
                    fused_phi="tail")
    batch = wire_batch(wire, "float16", b=5)
    assert batch["points"].shape[-2 if wire == "dense" else 0] <= 128
    jax_model, variables, port = jax_and_port(cfg, batch)
    assert port._tail()
    cot = np.random.default_rng(4).normal(size=(5, 1)).astype(np.float32)

    def loss(p):
        logits = jax_model.apply({"params": p}, batch, train=True)
        return jnp.sum(logits * cot), logits

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    want = convert.to_torch_state_dict("deep_sets", {"model": cfg}, jax.tree.map(np.asarray, grads), {})
    calls = []
    original = fused_phi._PhiPoolFn.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_phi._PhiPoolFn, "apply", lambda *a: calls.append(a) or original(*a))
        out, got = _port_grads(port.train(), batch, cot)
    # one bare linear [H, H] over the hidden chain's bf16 rows
    assert len(calls) == 1 and calls[0][2] == () and calls[0][0].dtype == torch.bfloat16
    assert calls[0][0].shape[1] == H
    ref = np.asarray(ref, np.float64)
    assert out.shape == (5, 1)
    assert np.abs(np.asarray(out, np.float64) - ref).max() <= BF16_LOGITS * np.abs(ref).max()
    assert set(got) == set(want)
    for key, g in got.items():
        bound = BF16_WEIGHT_FRO if key.endswith("weight") else BF16_BIAS_FRO
        assert _rel_fro(g, want[key]) <= bound, key


def _tail_inputs(in_dim, out_dim, p=128, s=5, seed=0):
    """bf16 rows h [P, in] whose ids run 0..S-1 in order with padding ids
    (S and S + 3) and a negative id among them, bf16-exact weights, an f32
    cotangent g [S, out] with values off the bf16 grid."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(p, in_dim)).astype(np.float32)).to(torch.bfloat16)
    seg = np.sort(rng.integers(0, s, size=p)).astype(np.int32)
    seg[-7:] = s
    seg[-2] = s + 3
    seg[3] = -1
    w = torch.from_numpy((rng.normal(size=(in_dim, out_dim)) * in_dim**-0.5).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(out_dim,)) * 0.1).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(s, out_dim)).astype(np.float32))
    return h, torch.from_numpy(seg), ((w, b),), g


def _closed_form(h, seg, w, g, s, round_g=True):
    """The tail's backward in f64 from the bf16 operands: dz[p] = g16[seg[p]]
    (zero outside [0, S)), g16 = g rounded to bf16 (or, with round_g false,
    g itself); d_W = hᵀ dz, d_b = Σ dz, d_points = dz W16ᵀ."""
    gg = (g.to(torch.bfloat16) if round_g else g).double()
    ids = seg.long()
    valid = (ids >= 0) & (ids < s)
    dz = torch.where(valid[:, None], gg[ids.clamp(0, s - 1)], torch.zeros((), dtype=torch.float64))
    w16 = w.to(torch.bfloat16).double()
    return dz @ w16.t(), [h.double().t() @ dz, dz.sum(0)]


@pytest.mark.parametrize("dims", [(256, 256), (256, 512), (320, 256), (64, 64)],
                         ids=["256x256", "256x512", "320x256", "64x64"])
def test_bf16_tail_backward_matches_its_f64_closed_form(dims):
    in_dim, out_dim = dims
    s = 5
    h, seg, params, g = _tail_inputs(in_dim, out_dim, s=s, seed=in_dim + out_dim)
    d_points, grads = fused_phi.phi_pool_bwd_plain(h, seg, g, (), params, "gelu", s)
    assert d_points.dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in grads)
    want_points, want = _closed_form(h, seg, params[0][0], g, s)
    # d_W and d_b: f32 sums of exact products of bf16 values, against f64
    for got, ref in zip(grads, want):
        scale = max(1.0, ref.abs().max().item())
        assert (got.double() - ref).abs().max().item() <= F32_REL * scale
    # d_points: the f32 sum rounded once to bf16 on the port's side, the f64
    # sum here: the same bf16 value but where the two sums fall on either
    # side of a rounding boundary (none at these inputs), one bf16 step apart
    rounded = want_points.to(torch.bfloat16).double()
    apart = d_points.double() != rounded
    assert apart.double().mean().item() <= 1e-3
    assert ((d_points.double() - want_points).abs() <= 2.0**-8 * want_points.abs() + 1e-30).all()
    # the rows of padding ids get no gradient
    outside = (seg < 0) | (seg >= s)
    assert outside.any() and (d_points[outside] == 0).all()
    # g is rounded to bf16 before the gather: d_W from the unrounded g
    # misses it by the rounding's 2^-9 or so
    _, unrounded = _closed_form(h, seg, params[0][0], g, s, round_g=False)
    miss = (grads[0].double() - unrounded[0]).abs().max().item() / max(1.0, unrounded[0].abs().max().item())
    assert miss > 100 * F32_REL

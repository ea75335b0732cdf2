"""The port's int8 evaluation (``ops/quant.py``, ``DeepSets(quant="int8")``)
against the JAX package's on the CPU.

The integer codes and scales are the JAX package's bit for bit (the same f32
abs-max, division, round half to even and clip), and the s32 sums are exact
on both sides, so what is left between the two is f32 rounding in the
activations: an activation one ulp apart can move a later layer's code by
one where ``x / scale`` lies at a rounding tie.  The model tests count such
codes (``test_later_layer_codes_differ_only_at_ties``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu.ops.activations import resolve_activation as jax_resolve_activation  # noqa: E402
from point_cloud_classifier_tpu.ops import quant as jax_quant  # noqa: E402
from point_cloud_classifier_tpu_torch import factory  # noqa: E402
from point_cloud_classifier_tpu_torch.models import DeepSets  # noqa: E402
from point_cloud_classifier_tpu_torch.models import deep_sets as port_deep_sets  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import quant  # noqa: E402
from point_cloud_classifier_tpu_torch.ops.activations import resolve_activation  # noqa: E402
from tests.test_torch_deep_sets import (  # noqa: E402
    _port_logits,
    jax_and_port,
    jax_batch,
    model_cfg,
    wire_batch,
)

# int8_linear against the JAX function: the same codes, the same exact s32
# sums, the same rescale in the same order; only the f32 products may round
# apart (1e-6 relative is a few ulps)
LINEAR_REL = 1e-6
# DeepSets int8 logits against the JAX model's: f32 rounding in the
# activations, carried through the pool and ρ (bf16: a value at a bf16
# rounding boundary lands on its neighbour, as test_deep_sets_bf16_matches_jax
# allows)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _scaled_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _tie_matrix(rows=12, cols=16, seed=0):
    """Rows built to hit ``round`` at .5 ties: a row abs-max of 127·s makes
    the scale exactly s (a power of two), so that k.5 · s divides to k.5;
    one row all zero (the padding's epsilon scale)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, cols)).astype(np.float32) * 3
    for r in range(rows - 4):
        s = np.float32(2.0 ** int(rng.integers(-6, 3)))
        x[r, : cols // 2] = (rng.integers(-126, 126, size=cols // 2) + 0.5).astype(np.float32) * s
        x[r, cols // 2] = 127 * s
        x[r, cols // 2 + 1 :] = np.clip(x[r, cols // 2 + 1 :], -126 * s, 126 * s)
    x[-1] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_codes_and_scales_are_bit_equal_to_jax(axis, dtype):
    x = _tie_matrix()
    if axis == "cols":
        x = np.ascontiguousarray(x.T)
    ours_fn, theirs_fn = {"rows": (quant.quantize_rows, jax_quant.quantize_rows),
                          "cols": (quant.quantize_cols, jax_quant.quantize_cols)}[axis]
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = ours_fn(xt)
    q_ref, s_ref = theirs_fn(jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    if axis == "rows" and dtype == "float32":
        # the ties landed (halves to even) and the zero row is all zeros
        ties = np.abs(np.abs(x[:-4, :8] / s.numpy()[:-4]) % 1 - 0.5) == 0
        assert ties.sum() >= 40
        assert not q.numpy()[-1].any() and s.numpy()[-1, 0] == np.float32(1e-8) / np.float32(127)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("rows, outputs", [(5, 3), (16, 12), (40, 32)])
def test_int8_linear_matches_jax(rows, outputs, bias):
    """K = 6 (the configs' first layer) and outputs that are no multiple of
    8, with fewer than 17 rows: every padding ``torch._int_mm`` needs."""
    rng = np.random.default_rng(rows + outputs)
    x = rng.normal(size=(rows, 6)).astype(np.float32)
    w = (rng.normal(size=(6, outputs)) * 0.4).astype(np.float32)
    b = (rng.normal(size=(outputs,)) * 0.1).astype(np.float32) if bias else None
    xq, sx = quant.quantize_rows(torch.from_numpy(x))
    wq, sw = quant.quantize_cols(torch.from_numpy(w))
    xp, wp = quant.int_mm_operands(xq, wq)
    # what torch._int_mm takes on the card; the weight codes column-major
    assert xp.shape[0] == max(rows, 17) and xp.shape[1] == wp.shape[0] == 8 and wp.shape[1] % 8 == 0
    assert xp.is_contiguous() and wp.t().is_contiguous()
    assert not xp[rows:].any() and not xp[:, 6:].any() and not wp[6:].any() and not wp[:, outputs:].any()
    acc = quant.int8_matmul(xq, wq)
    acc_ref = jax.lax.dot_general(jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()), (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32 and acc.shape == (rows, outputs)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_ref))
    np.testing.assert_array_equal(acc.numpy(), xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64))
    out = quant.int8_linear(torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b),
                            torch.float32)
    ref = np.asarray(jax_quant.int8_linear(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                                           jnp.float32))
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= LINEAR_REL * np.abs(ref).max()


def _phi(final, seed=3, width=32, depth=3, p=200):
    """A φ chain of ``depth`` layers (plain, then residual), its params in
    ``ops/fused_phi`` layout on both sides, and points."""
    rng = np.random.default_rng(seed)
    spec, params, last = [], [], 6
    for _ in range(depth):
        spec.append(("residual" if last == width else "plain", False))
        params.append(((rng.normal(size=(last, width)) * 0.3).astype(np.float32),
                       (rng.normal(size=(width,)) * 0.1).astype(np.float32)))
        last = width
    if final:
        params.append(((rng.normal(size=(last, last)) * 0.3).astype(np.float32),
                       (rng.normal(size=(last,)) * 0.1).astype(np.float32)))
    pts = rng.normal(size=(p, 6)).astype(np.float32)
    pts[-3:] = 0.0  # padding rows
    return pts, tuple(spec), params


@pytest.mark.parametrize("final", [False, True], ids=["hidden-only", "with-final"])
def test_phi_forward_int8_matches_jax(final):
    pts, spec, params = _phi(final)
    out = quant.phi_forward_int8(torch.from_numpy(pts), spec,
                                 [tuple(torch.from_numpy(a) for a in layer) for layer in params], "gelu")
    ref = jax_quant.phi_forward_int8(jnp.asarray(pts), spec,
                                     [tuple(jnp.asarray(a) for a in layer) + (None, None) for layer in params],
                                     "gelu")
    assert out.shape == (pts.shape[0], 32)
    assert _scaled_err(out.numpy(), np.asarray(ref)) <= LOGIT_TOL["float32"]


def test_phi_forward_int8_refuses_layer_norm():
    pts, spec, params = _phi(False, depth=1)
    w, b = (torch.from_numpy(a) for a in params[0])
    with pytest.raises(ValueError, match="layer_norm"):
        quant.phi_forward_int8(torch.from_numpy(pts), (("plain", True),), [(w, b, torch.ones(32), torch.zeros(32))],
                               "gelu")


def _batch(wire, dtype="float32", factored=()):
    if wire in ("ids", "counts"):
        assert not factored
        return jax_batch(wire, seed=5)
    return wire_batch(wire, "float16" if dtype == "bfloat16" else "float32", factored)


def _int8_pair(cfg, batch):
    jax_model, variables, port = jax_and_port({**cfg, "quant": "int8"}, batch)
    return np.asarray(jax_model.apply(variables, batch, train=False)), _port_logits(port, batch), port


CASES = {
    # wire, model overrides
    "flat-ids-mean": ("ids", {}),
    "flat-counts-sum": ("counts", dict(pooling="sum")),
    "flat-ids-max": ("ids", dict(pooling="max")),
    "dense-mean": ("dense", {}),
    "dense-max": ("dense", dict(pooling="max")),
    "flat-factored": ("flat", dict(factored_cols=(1, 4))),
    "tail-mean": ("counts", dict(fused_phi="tail")),
    "tail-sum-dense": ("dense", dict(fused_phi="tail", pooling="sum")),
    "bf16-dense-mean": ("dense", dict(compute_dtype="bfloat16")),
    "bf16-flat-max": ("flat", dict(compute_dtype="bfloat16", pooling="max")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_deep_sets_int8_eval_matches_jax(case, monkeypatch):
    """Eval logits of ``DeepSets(quant="int8")`` against the JAX model's on
    the same weights and batch: flat wire (ids, counts), dense wire (its zero
    padding rows quantize to 0 with the epsilon scale), factored columns,
    sum, mean and max, ``fused_phi="tail"`` (which must keep the post-pool
    f32 final linear), bf16 compute.  No K1 route and no tail pair is
    taken."""
    wire, over = CASES[case]
    cfg = model_cfg(**over)
    batch = _batch(wire, cfg.get("compute_dtype", "float32"), tuple(over.get("factored_cols", ())))

    # int8 is not the float forward: the same weights in float give other logits
    float_out = _port_logits(jax_and_port(cfg, batch)[2], batch)

    def tripwire(*a, **k):
        raise AssertionError("an int8 forward reached phi_pool")

    monkeypatch.setattr(port_deep_sets, "phi_pool", tripwire)
    ref, out, _ = _int8_pair(cfg, batch)
    assert out.shape == ref.shape == (6, 1) and out.dtype == np.float32
    assert _scaled_err(out, ref) <= LOGIT_TOL[cfg.get("compute_dtype", "float32")]
    assert not np.array_equal(out, float_out)


@pytest.mark.parametrize("postpool", ["1", "0"], ids=["postpool", "per-point-final"])
def test_int8_final_linear_placement_follows_postpool(postpool, monkeypatch):
    """``PCC_PHI_POSTPOOL=0`` moves the final linear into the int8 chain, per
    point, in both packages."""
    monkeypatch.setenv("PCC_PHI_POSTPOOL", postpool)
    ref, out, port = _int8_pair(model_cfg(pooling="sum"), jax_batch("counts", seed=6))
    assert port._post_pool(True) == (postpool == "1")
    assert _scaled_err(out, ref) <= LOGIT_TOL["float32"]


@pytest.mark.parametrize("wire", ["counts", "dense"])
def test_later_layer_codes_differ_only_at_ties(wire, capsys):
    """Layer by layer, the port's codes against the JAX package's from each
    side's own activations: the first layer's codes are equal, and a later
    layer's code differs by at most one, only where JAX's ``x / scale`` lies
    within a few ulps of a .5 tie.  The count is printed."""
    cfg = model_cfg(phi_layers=[32, 32, 32])
    batch = _batch(wire)
    _, _, port = jax_and_port({**cfg, "quant": "int8"}, batch)
    spec, params = port._phi_spec_params()
    h = torch.from_numpy(batch["points"].reshape(-1, 6)).float()
    hj = jnp.asarray(h.numpy())
    act, act_j = resolve_activation("gelu"), jax_resolve_activation("gelu")
    differ = []
    with torch.no_grad():
        for layer, ((kind, _), (w, b, *_)) in enumerate(zip(spec, params)):
            q, s = quant.quantize_rows(h)
            q_ref, s_ref = jax_quant.quantize_rows(hj)
            diff = q.numpy().astype(np.int32) - np.asarray(q_ref).astype(np.int32)
            if layer == 0:
                assert not diff.any()
            else:
                assert np.abs(diff).max(initial=0) <= 1
                ratio = np.asarray(hj, np.float32) / np.asarray(s_ref)
                near_tie = np.abs(np.abs(ratio) % 1 - 0.5) <= 8 * np.spacing(np.abs(ratio).astype(np.float32))
                assert near_tie[diff != 0].all()
            differ.append(int((diff != 0).sum()))
            wn = jnp.asarray(w.detach().numpy())
            bn = jnp.asarray(b.detach().numpy())
            out = act(quant.int8_linear(h, w, b, h.dtype))
            out_j = act_j(jax_quant.int8_linear(hj, wn, bn, hj.dtype))
            h = h + out if kind == "residual" else out
            hj = hj + out_j if kind == "residual" else out_j
    with capsys.disabled():
        print(f"\nint8 codes differing from the JAX package's by one, per layer ({wire} wire, "
              f"{h.shape[0]} rows x 32): {differ}")


def test_train_forward_stays_float(monkeypatch):
    """A train-mode forward of ``quant="int8"`` is the float forward, bit for
    bit, and never reaches the int8 chain (JAX ``tests/test_quant.py``)."""
    batch = jax_batch("counts", seed=7)
    _, _, qport = jax_and_port({**model_cfg(), "quant": "int8"}, batch)
    _, _, fport = jax_and_port(model_cfg(), batch)

    def tripwire(*a, **k):
        raise AssertionError("a train-mode forward reached the int8 chain")

    monkeypatch.setattr(port_deep_sets, "phi_forward_int8", tripwire)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        torch.testing.assert_close(qport(tb, train=True), fport(tb, train=True), rtol=0, atol=0)
    assert qport._int8(train=False) and not qport._int8(train=True)
    assert not DeepSets(**model_cfg(quant="int8", layer_norm=True))._int8(train=False)


QUANT_CONFIGS = [
    {"model": {"phi_layers": [256, 256]}},
    {"model": {"phi_layers": [512, 1024]}},
    {"model": {"phi_layers": [1024]}},
    {"model": {"phi_layers": [2048, 64]}},
    {"model": {"phi_layers": [1024], "layer_norm": True}},
    {"model": {"phi_layers": [1023]}},
    {"model": {"phi_layers": []}},
    {"model": {}},
]


@pytest.mark.parametrize("requested", ["none", None, "auto", "int8"])
@pytest.mark.parametrize("model_name", ["deep_sets", "graph_net", "fully_connected_net", "logistic_regression"])
def test_resolve_and_apply_quant_match_jax(model_name, requested):
    for cfg in QUANT_CONFIGS:
        assert (factory.resolve_quant(cfg, model_name, requested)
                == jax_factory.resolve_quant(cfg, model_name, requested)), cfg
        ours, theirs = {"model": dict(cfg["model"])}, {"model": dict(cfg["model"])}
        results = []
        for fn, c in ((factory.apply_quant, ours), (jax_factory.apply_quant, theirs)):
            try:
                fn(c, model_name, requested)
                results.append(("ok", c))
            except ValueError as e:
                results.append(("ValueError", str(e)))
        assert results[0] == results[1], cfg

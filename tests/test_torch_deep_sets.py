"""The port's DeepSets against the JAX package's ``DeepSets.apply(train=False)``.

Both models get the same weights (the JAX tree moved through the port's
``convert``) and the same numpy batch from the JAX package's own loader.
The JAX side runs with ``fused_phi`` "off" (XLA) and "on" (the Pallas kernel,
interpreted on the CPU); the port runs the matching route, which on a CPU
tensor is ``phi_pool``'s plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.data.batching import PointCloudLoader as JaxLoader  # noqa: E402
from point_cloud_classifier_tpu.models import DeepSets as JaxDeepSets  # noqa: E402
from point_cloud_classifier_tpu_torch import convert  # noqa: E402
from point_cloud_classifier_tpu_torch.models import DeepSets  # noqa: E402

# f32 logits: the same math in f32 on both sides, differing in summation
# order only.
F32 = dict(rtol=1e-5, atol=1e-5)


def model_cfg(**kw):
    cfg = dict(
        input_dim=6,
        phi_layers=[32, 32],
        rho_layers=[16],
        output_dim=1,
        activation="gelu",
        layer_norm=False,
        residual_block=True,
        pooling="mean",
    )
    cfg.update(kw)
    return cfg


def jax_batch(seg_encoding="ids", seed=0, b=6):
    """One flat-wire batch from the JAX loader: events 0..b-1, event 2 empty,
    the last event slot unused (masked) and padding rows at the end."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 40, size=b - 1)
    sizes[2] = 0
    events = [rng.normal(size=(int(n), 6)).astype(np.float32) for n in sizes]
    labels = rng.integers(0, 2, size=b - 1)
    loader = JaxLoader(events, labels, b, shuffle=False, min_bucket=64, seg_encoding=seg_encoding)
    return next(iter(loader))


def jax_and_port(cfg, batch, seed=0):
    """A JAX DeepSets with its initialised variables, and the port's DeepSets
    carrying the same weights."""
    jax_model = JaxDeepSets(**cfg)
    variables = jax_model.init(jax.random.PRNGKey(seed), batch, train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    port = DeepSets(**cfg)
    sd = convert.to_torch_state_dict("deep_sets", {"model": cfg}, params, {})
    port.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return jax_model, variables, port.eval()


def _port_logits(port, batch):
    with torch.no_grad():
        return port({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("postpool", ["1", "0"], ids=["postpool", "per-point-final"])
@pytest.mark.parametrize("wire", ["ids", "counts"])
@pytest.mark.parametrize("pooling", ["sum", "mean", "max"])
def test_deep_sets_matches_jax(pooling, wire, postpool, fused, monkeypatch):
    monkeypatch.setenv("PCC_PHI_POSTPOOL", postpool)
    cfg = model_cfg(pooling=pooling, fused_phi=fused)
    batch = jax_batch(wire)
    jax_model, variables, port = jax_and_port(cfg, batch)
    ref = np.asarray(jax_model.apply(variables, batch, train=False))
    out = _port_logits(port, batch)
    assert out.dtype == np.float32 and out.shape == ref.shape == (6, 1)
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("residual", [True, False])
def test_deep_sets_layer_norm_matches_jax(residual):
    cfg = model_cfg(layer_norm=True, residual_block=residual, phi_layers=[16, 16, 8], rho_layers=[8, 8])
    batch = jax_batch("counts", seed=1)
    jax_model, variables, port = jax_and_port(cfg, batch, seed=1)
    np.testing.assert_allclose(
        _port_logits(port, batch), np.asarray(jax_model.apply(variables, batch, train=False)), **F32
    )


@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_deep_sets_bf16_matches_jax(pooling):
    cfg = model_cfg(pooling=pooling, compute_dtype="bfloat16")
    batch = jax_batch("ids", seed=2)
    jax_model, variables, port = jax_and_port(cfg, batch, seed=2)
    ref = np.asarray(jax_model.apply(variables, batch, train=False))
    out = _port_logits(port, batch)
    # bf16: roundings that land on neighbouring bf16 values on either side
    # carry through φ, the pool and ρ; 3e-2 of the output scale bounds them
    assert np.abs(out - ref).max() <= 3e-2 * max(1.0, np.abs(ref).max())


def test_kernel_route_follows_config():
    assert DeepSets(**model_cfg())._use_kernel()
    assert not DeepSets(**model_cfg(fused_phi="off"))._use_kernel()
    assert not DeepSets(**model_cfg(layer_norm=True))._use_kernel()
    assert not DeepSets(**model_cfg(pooling="max"))._use_kernel()


def test_unported_wires_and_options_raise():
    """``quant="int8"``, once refused, builds and takes the int8 chain in eval
    only and without layer norm; an unknown ``quant`` raises."""
    model = DeepSets(**model_cfg(quant="int8"))
    assert model.quant == model.config["quant"] == "int8"
    assert model._int8(train=False) and not model._int8(train=True)
    assert not DeepSets(**model_cfg(quant="int8", layer_norm=True))._int8(train=False)
    assert not DeepSets(**model_cfg())._int8(train=False)
    with pytest.raises(ValueError, match="quant"):
        DeepSets(**model_cfg(quant="int4"))


def wire_batch(layout, transfer_dtype="float32", factored=(), seg_encoding="ids", seed=3, b=6):
    """One batch of the JAX loader on the flat or dense wire: event 2 empty,
    the last slot unused, columns 1 and 4 constant within each event."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 40, size=b - 1)
    sizes[2] = 0
    events = [rng.normal(size=(int(n), 6)).astype(np.float32) for n in sizes]
    for e in events:
        e[:, 1], e[:, 4] = rng.normal(), rng.normal()
    loader = JaxLoader(events, rng.integers(0, 2, size=b - 1), b, shuffle=False, min_bucket=64,
                       seg_encoding=seg_encoding, layout=layout, transfer_dtype=transfer_dtype,
                       factor_event_cols=factored)
    batch = next(iter(loader))
    assert batch["points"].ndim == (3 if layout == "dense" else 2)
    return batch


def _port_grads(port, batch, cot):
    out = port({k: torch.from_numpy(v) for k, v in batch.items()}, train=True)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), {k: p.grad.numpy() for k, p in port.named_parameters()}


def _scaled_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("factored", [(), (1,), (1, 4)], ids=["no-fac", "fac1", "fac14"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("pooling", ["sum", "mean", "max"])
@pytest.mark.parametrize("wire", ["dense", "flat"])
def test_wires_match_jax_forward_and_gradients(wire, pooling, dtype, factored, fused):
    """Train-mode logits and one step's gradients of every parameter against
    JAX ``DeepSets``, on the dense and flat wires, with factored columns.  bf16
    takes the fp16 wire, as the flagship does.  The port's kernel route
    (``auto``, sum and mean) flattens the dense wire and pools by id; the JAX
    package's dense wire is XLA's masked row sum."""
    cfg = model_cfg(pooling=pooling, compute_dtype=dtype, fused_phi=fused, factored_cols=factored)
    batch = wire_batch(wire, "float16" if dtype == "bfloat16" else "float32", factored)
    jax_model, variables, port = jax_and_port(cfg, batch)
    cot = np.random.default_rng(4).normal(size=(6, 1)).astype(np.float32)

    def loss(p):
        logits = jax_model.apply({"params": p}, batch, train=True)
        return jnp.sum(logits * cot), logits

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    want = convert.to_torch_state_dict("deep_sets", {"model": cfg}, jax.tree.map(np.asarray, grads), {})
    out, got = _port_grads(port.train(), batch, cot)
    # f32: the same math in other summation orders; bf16: as the bf16 test
    bound = 1e-5 if dtype == "float32" else 3e-2
    assert out.shape == (6, 1) and _scaled_err(out, np.asarray(ref)) <= bound
    assert set(got) == set(want)
    for key, g in got.items():
        assert _scaled_err(g, want[key]) <= bound, key


@pytest.mark.parametrize("postpool", ["1", "0"], ids=["postpool", "per-point-final"])
@pytest.mark.parametrize("seg_encoding", ["ids", "counts"])
def test_flat_wire_factored_columns_match_jax(seg_encoding, postpool, monkeypatch):
    """``spread_by_segment`` under both id encodings, and the final linear
    per point, with the factored columns back in place."""
    monkeypatch.setenv("PCC_PHI_POSTPOOL", postpool)
    cfg = model_cfg(pooling="sum", factored_cols=(4, 1))
    batch = wire_batch("flat", factored=(1, 4), seg_encoding=seg_encoding)
    jax_model, variables, port = jax_and_port(cfg, batch)
    ref = np.asarray(jax_model.apply(variables, batch, train=False))
    np.testing.assert_allclose(_port_logits(port, batch), ref, **F32)


@pytest.mark.parametrize("postpool", ["1", "0"], ids=["postpool", "per-point-final"])
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_dense_wire_matches_the_flat_wire(fused, postpool, monkeypatch):
    """The same events on both wires give the same logits (the JAX
    package's dense wire against its flat one), with the final linear per
    point or per event."""
    monkeypatch.setenv("PCC_PHI_POSTPOOL", postpool)
    cfg = model_cfg(pooling="mean", fused_phi=fused, factored_cols=(1,))
    dense, flat = wire_batch("dense", factored=(1,)), wire_batch("flat", factored=(1,))
    jax_model, variables, port = jax_and_port(cfg, dense)
    ref = np.asarray(jax_model.apply(variables, flat, train=False))
    np.testing.assert_allclose(_port_logits(port, dense), ref, **F32)
    np.testing.assert_allclose(_port_logits(port, flat), ref, **F32)


def test_dense_segment_ids_mark_the_in_row_padding():
    from point_cloud_classifier_tpu_torch.models.deep_sets import dense_segment_ids

    ids = dense_segment_ids(torch.tensor([2, 0, 3], dtype=torch.int32), 4)
    assert ids.dtype == torch.int32
    assert ids.tolist() == [0, 0, 3, 3, 3, 3, 3, 3, 2, 2, 2, 3]

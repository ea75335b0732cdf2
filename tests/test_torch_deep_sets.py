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
    port = DeepSets(**model_cfg())
    batch = {k: torch.from_numpy(v) for k, v in jax_batch().items()}
    with pytest.raises(NotImplementedError):
        port({**batch, "points": torch.zeros(6, 8, 6)})
    with pytest.raises(NotImplementedError):
        port({**batch, "event_feats": torch.zeros(7, 1)})
    with pytest.raises(NotImplementedError):
        DeepSets(**model_cfg(fused_phi="tail"))
    with pytest.raises(NotImplementedError):
        DeepSets(**model_cfg(quant="int8"))

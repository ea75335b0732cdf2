"""The port's serving path — ``factory.get_model`` + ``ModelWrapper.predict`` on
a JAX-format ``best_model.pt`` — against the JAX package's, end to end."""

import os
import pickle

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu.data.batching import PointCloudLoader as JaxLoader  # noqa: E402
from point_cloud_classifier_tpu.models import DeepSets as JaxDeepSets  # noqa: E402
from point_cloud_classifier_tpu_torch import factory  # noqa: E402
from point_cloud_classifier_tpu_torch.data import PointCloudLoader  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi  # noqa: E402

# f32 probabilities through the same math on both sides (summation order
# only differs)
F32 = dict(rtol=1e-5, atol=1e-6)


def _config(pooling="mean"):
    """configs/deep_sets.yaml at narrow widths."""
    return {
        "model": dict(
            input_dim=6, phi_layers=[32, 32], rho_layers=[32], output_dim=1,
            sparse_batching=True, pooling=pooling, layer_norm=False,
            activation="gelu", residual_block=True,
        ),
        "dataset": {"batch_size": 8, "sparse_batching": True},
        "trainer": {"epochs": 1, "learning_rate": 0.001, "optimizer": "adamw"},
        "logging": {"log_dir": None},
    }


def _clouds(seed=0, n=29):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 60, size=n)
    sizes[4] = 0
    events = [rng.normal(size=(int(k), 6)).astype(np.float32) for k in sizes]
    return events, rng.integers(0, 2, size=n).astype(np.float32)


def _write_jax_checkpoint(run_dir, cfg, seed=0):
    """``best_model.pt`` as the JAX trainer writes it: a pickle of numpy trees."""
    batch = next(iter(JaxLoader(*_clouds(), 8, shuffle=False)))
    variables = JaxDeepSets(**cfg["model"]).init(jax.random.PRNGKey(seed), batch, train=False)
    state = {"params": jax.tree.map(np.asarray, variables["params"]), "batch_stats": {}}
    with open(os.path.join(run_dir, "best_model.pt"), "wb") as f:
        pickle.dump(state, f)


@pytest.mark.parametrize("seg_encoding", ["ids", "counts"])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_predict_matches_jax(tmp_path, pooling, seg_encoding):
    cfg = _config(pooling)
    _write_jax_checkpoint(tmp_path, cfg)
    events, labels = _clouds()
    kw = dict(batch_size=8, shuffle=False, seg_encoding=seg_encoding)
    y_ref, p_ref = jax_factory.get_model("deep_sets", cfg, str(tmp_path)).predict(
        JaxLoader(events, labels, **kw), return_prob=True
    )
    model = factory.get_model("deep_sets", cfg, str(tmp_path))
    assert model.device.type == "cpu"
    launches = fused_phi.phi_pool.launches
    y, p = model.predict(PointCloudLoader(events, labels, **kw), return_prob=True)
    assert fused_phi.phi_pool.launches == launches  # a CPU run launches no kernel
    np.testing.assert_array_equal(y, y_ref)
    assert p.shape == p_ref.shape == (len(events), 1) and p.dtype == np.float32
    np.testing.assert_allclose(p, p_ref, **F32)
    _, labels_out = model.predict(PointCloudLoader(events, labels, **kw))
    np.testing.assert_array_equal(labels_out, (p >= 0.5).astype(np.float32))


def test_port_state_dict_checkpoint_loads(tmp_path):
    cfg = _config()
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir(), port_dir.mkdir()
    _write_jax_checkpoint(jax_dir, cfg, seed=5)
    from_jax = factory.get_model("deep_sets", cfg, str(jax_dir))
    torch.save(from_jax.model.state_dict(), port_dir / "best_model.pt")
    from_port = factory.get_model("deep_sets", cfg, str(port_dir))
    events, labels = _clouds()
    _, p1 = from_jax.predict(PointCloudLoader(events, labels, 8, shuffle=False), return_prob=True)
    _, p2 = from_port.predict(PointCloudLoader(events, labels, 8, shuffle=False), return_prob=True)
    np.testing.assert_array_equal(p1, p2)


def test_get_model_errors(tmp_path):
    cfg = _config()
    for name in ("logistic_regression", "fully_connected_net", "graph_net"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            factory.get_model(name, cfg)
    with pytest.raises(ValueError):
        factory.get_model("transformer", cfg)
    with pytest.raises(FileNotFoundError):
        factory.get_model("deep_sets", cfg, str(tmp_path))
    with pytest.raises(ValueError, match="no batches"):
        factory.get_model("deep_sets", cfg).predict([])

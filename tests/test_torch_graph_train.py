"""The port's GraphNet training path against the JAX package's, on the CPU.

``ModelWrapper.fit`` on both sides from the same weights (moved through
``convert``) and byte-identical loaders over a seeded synthetic S2PG cache:
GAT, GraphConv add and mean, and GraphConv with ``fused_inrow`` (whose
aggregation runs through the autograd Function and the out-row wire in the
port; off the TPU the JAX model warns and aggregates over the adjacency, the
same function).  Then ``train_model`` and ``resume_training`` end to end with
their artifacts.
"""

import copy
import json
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import train as jax_train  # noqa: E402
from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu_torch import convert, factory  # noqa: E402
from point_cloud_classifier_tpu_torch import train as port_train  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2pg_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import gat, inrow_graph  # noqa: E402

# f32 training: both sides run the same math in f32 in other summation
# orders (the port's closed-form aggregation backward over the out-rows
# against autodiff of the adjacency product); a few Adam steps keep the drift
# at a few f32 ulps of the weights' scale.
PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-5
MODELS = {
    "gat": dict(use_gat=True),
    "graphconv-add": dict(local_pooling="add"),
    "graphconv-mean": dict(local_pooling="mean"),
    "graphconv-add-fused": dict(local_pooling="add", fused_inrow=True),
    "graphconv-mean-fused": dict(local_pooling="mean", fused_inrow=True),
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("s2pg_train"))
    write_s2pg_cache(path, n_graphs=(24, 8, 8), min_nodes=24, max_nodes=48, seed=5)
    return path


def _config(data_dir, log_dir, name, epochs=2, **trainer):
    """configs/base.yaml + configs/graph_net.yaml at narrow width."""
    model = dict(
        input_dim=4, output_dim=1, hidden_dim=16, activation="tanh", use_gat=False,
        gat_heads=4, sag_pool=False, pool_ratio=0.5, local_pooling="add",
        global_pooling="mean", deepchem_style=True,
    )
    model.update(MODELS[name])
    return {
        "meta": {"model_name": "", "dataset_name": ""},
        "dataset": {"data_dir": data_dir, "batch_size": 8, "use_weights": name != "gat", "n_features": 4},
        "logging": {"log_dir": str(log_dir)},
        "model": model,
        "trainer": {"epochs": epochs, "learning_rate": 0.001, **trainer},
    }


def _metrics(log_dir):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append(row["value"])
    return out


def _best_epochs(printed):
    return [int(m) for m in re.findall(r"Epoch (\d+): New best model saved", printed)]


@pytest.mark.parametrize("name", list(MODELS))
def test_fit_matches_jax_fit(data_dir, tmp_path, capsys, name):
    optimizer = "adamw" if name == "gat" else "adam"
    port_cfg = _config(data_dir, tmp_path / "port", name, optimizer=optimizer, state_every=0)
    jax_cfg = _config(data_dir, tmp_path / "jax", name, optimizer=optimizer, state_every=0)

    port = factory.get_model("graph_net", port_cfg)
    ref = jax_factory.get_model("graph_net", jax_cfg)
    params, stats = convert.convert_torch_state_dict("graph_net", port_cfg, port.model.state_dict())
    ref.params = jax.tree.map(jnp.asarray, params)  # the JAX fit takes assigned params
    ref.batch_stats = jax.tree.map(jnp.asarray, stats)

    data = factory.get_dataloader("s2pg", port_cfg)
    jax_data = jax_factory.get_dataloader("s2pg", jax_cfg)
    fused = "fused" in name
    assert data.loader_kwargs["emit_out_rows"] == fused
    launches = (gat.gat_attention.launches, gat.gat_attention.bwd_launches,
                inrow_graph.inrow_aggregate.launches, inrow_graph.inrow_aggregate.bwd_launches)
    capsys.readouterr()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the port's fused branch is taken, silently
        port.fit(data.get_train_loader(), data.get_val_loader())
    port_printed = capsys.readouterr().out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # off the TPU the JAX model warns and takes the adjacency
        ref.fit(jax_data.get_train_loader(), jax_data.get_val_loader())
    ref_printed = capsys.readouterr().out
    assert launches == (gat.gat_attention.launches, gat.gat_attention.bwd_launches,
                        inrow_graph.inrow_aggregate.launches, inrow_graph.inrow_aggregate.bwd_launches)

    trained = convert.to_torch_state_dict(
        "graph_net", port_cfg, jax.tree.map(np.asarray, ref.params), jax.tree.map(np.asarray, ref.batch_stats))
    state = port.model.state_dict()
    moved = convert.to_torch_state_dict("graph_net", port_cfg, params, stats)
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), trained[key], rtol=0, atol=PARAM_ATOL, err_msg=key)
        assert not np.array_equal(value.numpy(), moved[key]), f"{key} did not train"
    ours, theirs = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    for tag in ("Loss/train", "Loss/val", "Accuracy/val"):
        assert len(ours[tag]) == len(theirs[tag]) == 2
        np.testing.assert_allclose(ours[tag], theirs[tag], rtol=METRIC_RTOL, err_msg=tag)
    assert set(ours) == set(theirs)
    assert _best_epochs(port_printed) == _best_epochs(ref_printed) != []
    # best_model.pt carries the running statistics that predict normalizes with
    saved = torch.load(tmp_path / "port" / "best_model.pt", weights_only=True)
    assert {"bn1.running_mean", "bn2.running_var", "bn3.running_mean"} <= set(saved)
    y, p = port.predict(data.get_test_loader(), return_prob=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        y_ref, p_ref = ref.predict(jax_data.get_test_loader(), return_prob=True)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)


def test_train_model_end_to_end(data_dir, tmp_path):
    cfg = _config(data_dir, tmp_path / "log", "gat")
    log_dir = port_train.train_model("graph_net", "S2PG", copy.deepcopy(cfg), return_log_dir=True)
    jax_cfg = _config(data_dir, tmp_path / "jax", "gat", state_every=0)
    jax_dir = jax_train.train_model("graph_net", "s2pg", jax_cfg, return_log_dir=True)

    assert log_dir == str(tmp_path / "log" / "version_0")
    with open(os.path.join(log_dir, "meta.json")) as f:
        text = f.read()
    with open(os.path.join(jax_dir, "meta.json")) as f:
        ref = json.load(f)
    meta = json.loads(text)
    assert list(meta) == list(ref) == ["dataset", "model", "metrics"]
    assert (meta["dataset"], meta["model"]) == (ref["dataset"], ref["model"]) == ("s2pg", "graph_net")
    assert list(meta["metrics"]) == list(ref["metrics"])
    assert meta["metrics"]["parameters"] == ref["metrics"]["parameters"]
    for key in ("accuracy/train", "accuracy/val"):
        assert 0.0 <= meta["metrics"][key] <= 1.0 and round(meta["metrics"][key], 6) == meta["metrics"][key]
    assert text == json.dumps(meta, indent=4)
    with open(os.path.join(log_dir, "config.yaml")) as f:
        written = f.read()
    assert "model_name: graph_net" in written and "dataset_name: s2pg" in written
    artifacts = {"best_model.pt", "config.yaml", "meta.json", "metrics.jsonl", "model.pt"}
    assert artifacts <= set(os.listdir(log_dir)) and artifacts <= set(os.listdir(jax_dir))
    assert sorted(os.listdir(os.path.join(log_dir, "state"))) == ["state.pt", "trainer_state.json"]

    # model.pt holds the weights and running statistics that gave meta's accuracy/val
    final = factory.get_model("graph_net", cfg)
    final.load(os.path.join(log_dir, "model.pt"))
    y, pred = final.predict(factory.get_dataloader("s2pg", cfg).get_val_loader())
    assert round(port_train.accuracy(y, pred), 6) == meta["metrics"]["accuracy/val"]
    best = factory.get_model("graph_net", cfg, log_dir)  # best_model.pt
    _, p_best = best.predict(factory.get_dataloader("s2pg", cfg).get_val_loader(), return_prob=True)
    assert np.isfinite(p_best).all()


@pytest.mark.parametrize("name", ["gat", "graphconv-add-fused"])
def test_resume_training_continues_a_run(data_dir, tmp_path, name):
    """The resumable state carries the weights and the running statistics of
    the epoch it was written at, and ``resume_training`` trains on from it."""
    cfg = _config(data_dir, tmp_path / "log", name, epochs=1)
    log_dir = port_train.train_model("graph_net", "s2pg", cfg, return_log_dir=True)
    final = torch.load(os.path.join(log_dir, "model.pt"), weights_only=True)
    restored = factory.get_model("graph_net", cfg)  # train_model rewrote log_dir to the run's
    assert not torch.equal(restored.model.state_dict()["bn1.running_mean"], final["bn1.running_mean"])
    assert restored.restore_state() == 1
    for key, value in restored.model.state_dict().items():
        assert torch.equal(value, final[key]), key

    cfg["trainer"]["epochs"] = 3
    resumed = port_train.resume_training(log_dir, cfg)
    assert len(_metrics(log_dir)["Loss/train"]) == 3  # epoch 1, then 2 and 3
    with open(os.path.join(log_dir, "state", "trainer_state.json")) as f:
        assert json.load(f)["epoch"] == 2
    reloaded = factory.get_model("graph_net", cfg)
    reloaded.load(os.path.join(log_dir, "model.pt"))
    for key, value in resumed.model.state_dict().items():
        assert torch.equal(reloaded.model.state_dict()[key], value), key
        if not key.endswith("num_batches_tracked"):
            assert not torch.equal(value, final[key]), f"{key} did not move after the resume"

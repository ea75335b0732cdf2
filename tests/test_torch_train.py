"""The port's training path against the JAX package's, on the CPU.

``ModelWrapper.fit`` on both sides from the same weights (moved through
``convert``) and the same loaders; the run artifacts ``config.yaml`` and
``meta.json`` byte for byte; ``train_model`` end to end; resume, the
non-finite guard, and the options the port refuses.
"""

import copy
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

import train as jax_train  # noqa: E402
from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu.utils import config as jax_config  # noqa: E402
from point_cloud_classifier_tpu.utils.log import TrainingLogger as JaxLogger  # noqa: E402
from point_cloud_classifier_tpu_torch import convert, factory  # noqa: E402
from point_cloud_classifier_tpu_torch import train as port_train  # noqa: E402
from point_cloud_classifier_tpu_torch.data import PointCloudLoader  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.models.wrapper import ModelWrapper  # noqa: E402
from point_cloud_classifier_tpu_torch.utils.config import save_config  # noqa: E402
from point_cloud_classifier_tpu_torch.utils.log import TrainingLogger  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 training: both sides run the same math in f32 in other summation
# orders (and the port's closed-form φ backward against autodiff); a few
# Adam steps keep the drift at a few f32 ulps of the weights' scale.
PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-5


def _config(tmp_path, optimizer="adamw", epochs=2, **trainer):
    """configs/deep_sets.yaml at narrow widths (φ [16, 16] residual, ρ [16])."""
    return {
        "meta": {"model_name": "", "dataset_name": ""},
        "dataset": {"data_dir": str(tmp_path / "data"), "batch_size": 8,
                    "sparse_batching": True, "energy_cutoff": 0.015},
        "logging": {"log_dir": str(tmp_path / "log")},
        "model": {"input_dim": 6, "phi_layers": [16, 16], "rho_layers": [16],
                  "output_dim": 1, "sparse_batching": True, "pooling": "mean",
                  "layer_norm": False, "activation": "gelu", "residual_block": True},
        "trainer": {"epochs": epochs, "learning_rate": 0.001, "optimizer": optimizer, **trainer},
    }


@pytest.fixture
def data_dir(tmp_path):
    write_s2ppc_cache(str(tmp_path / "data"), n_events=(40, 16, 16), min_points=3,
                      max_points=30, seed=1)
    return tmp_path


def _metrics(log_dir):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append(row["value"])
    return out


def _best_epochs(printed):
    return [int(m) for m in re.findall(r"Epoch (\d+): New best model saved", printed)]


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_fit_matches_jax_fit(data_dir, capsys, optimizer):
    tmp = data_dir
    cfg = _config(tmp, optimizer, state_every=0)
    port_cfg, jax_cfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    port_cfg["logging"]["log_dir"] = str(tmp / "port")
    jax_cfg["logging"]["log_dir"] = str(tmp / "jax")

    port = factory.get_model("deep_sets", port_cfg, device="cpu")
    ref = jax_factory.get_model("deep_sets", jax_cfg)
    params, _ = convert.convert_torch_state_dict("deep_sets", cfg, port.model.state_dict())
    ref.params = jax.tree.map(jnp.asarray, params)  # the JAX fit takes assigned params
    ref.batch_stats = {}

    data = factory.get_dataloader("s2ppc", port_cfg)
    jax_data = jax_factory.get_dataloader("s2ppc", jax_cfg)
    capsys.readouterr()
    port.fit(data.get_train_loader(), data.get_val_loader())
    port_printed = capsys.readouterr().out
    ref.fit(jax_data.get_train_loader(), jax_data.get_val_loader())
    ref_printed = capsys.readouterr().out

    trained = convert.to_torch_state_dict("deep_sets", cfg, jax.tree.map(np.asarray, ref.params), {})
    for key, value in port.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), trained[key], rtol=0, atol=PARAM_ATOL, err_msg=key)
    ours, theirs = _metrics(tmp / "port"), _metrics(tmp / "jax")
    for tag in ("Loss/train", "Loss/val", "Accuracy/val"):
        assert len(ours[tag]) == len(theirs[tag]) == 2
        np.testing.assert_allclose(ours[tag], theirs[tag], rtol=METRIC_RTOL, err_msg=tag)
    assert set(ours) == set(theirs)
    assert _best_epochs(port_printed) == _best_epochs(ref_printed) != []
    assert os.path.exists(tmp / "port" / "best_model.pt")
    y, p = port.predict(data.get_test_loader(), return_prob=True)
    y_ref, p_ref = ref.predict(jax_data.get_test_loader(), return_prob=True)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["base", "deep_sets", "fully_connected_net", "graph_net", "logistic_regression"])
def test_save_config_byte_identical(tmp_path, name):
    base = os.path.join(REPO, "configs", "base.yaml")
    specific = None if name == "base" else os.path.join(REPO, "configs", f"{name}.yaml")
    config = jax_config.load_config(base, specific)
    # the fields train_model sets
    config["logging"]["log_dir"] = os.path.join(config["logging"]["log_dir"], "version_0")
    config["meta"]["model_name"] = name
    config["meta"]["dataset_name"] = "s2ppc"
    ours = save_config(copy.deepcopy(config), str(tmp_path / "port"))
    ref = jax_config.save_config(copy.deepcopy(config), str(tmp_path / "jax"))
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_save_config_quotes_what_yaml_would_misread(tmp_path):
    config = {"meta": {"model_name": "", "dataset_name": "true"},
              "logging": {"log_dir": "a: b", "x": "0x10", "y": "'q'", "z": 1e-5},
              "model": {"layers": [[1, 2], {"a": None}], "empty": [], "d": {}}}
    ours = save_config(copy.deepcopy(config), str(tmp_path / "port"))
    ref = jax_config.save_config(copy.deepcopy(config), str(tmp_path / "jax"))
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_training_logger_meta_json_byte_identical(tmp_path):
    for cls, sub in ((TrainingLogger, "port"), (JaxLogger, "jax")):
        log_dir = str(tmp_path / sub)
        os.makedirs(os.path.join(log_dir, "version_0"))
        logger = cls("deep_sets", "s2ppc", log_dir)
        assert logger.get_version() == "1"
        logger.log_metric("accuracy/train", round(0.123456789, 6))
        logger.log_metric("parameters", 199425)
    with open(tmp_path / "port" / "version_1" / "meta.json", "rb") as a:
        with open(tmp_path / "jax" / "version_1" / "meta.json", "rb") as b:
            assert a.read() == b.read()


def test_train_model_end_to_end(data_dir):
    tmp = data_dir
    cfg = _config(tmp)
    log_dir = port_train.train_model("deep_sets", "S2PPC", copy.deepcopy(cfg), return_log_dir=True, device="cpu")
    jax_cfg = _config(tmp, state_every=0)
    jax_cfg["logging"]["log_dir"] = str(tmp / "jax")
    jax_dir = jax_train.train_model("deep_sets", "s2ppc", jax_cfg, return_log_dir=True)

    assert log_dir == str(tmp / "log" / "version_0")
    with open(os.path.join(log_dir, "meta.json")) as f:
        text = f.read()
    with open(os.path.join(jax_dir, "meta.json")) as f:
        ref_text = f.read()
    meta, ref = json.loads(text), json.loads(ref_text)
    assert list(meta) == list(ref) == ["dataset", "model", "metrics"]
    assert list(meta["metrics"]) == list(ref["metrics"])
    assert meta["metrics"]["parameters"] == ref["metrics"]["parameters"]
    for key in ("accuracy/train", "accuracy/val"):
        assert 0.0 <= meta["metrics"][key] <= 1.0
        assert round(meta["metrics"][key], 6) == meta["metrics"][key]
    assert text == json.dumps(meta, indent=4)
    with open(os.path.join(log_dir, "config.yaml")) as f:
        written = f.read()
    assert "model_name: deep_sets" in written and "dataset_name: s2ppc" in written

    trained = factory.get_model("deep_sets", cfg, log_dir, device="cpu")  # best_model.pt
    final = factory.get_model("deep_sets", cfg, device="cpu")
    final.load(os.path.join(log_dir, "model.pt"))
    loader = factory.get_dataloader("s2ppc", cfg).get_val_loader()
    _, p_best = trained.predict(loader, return_prob=True)
    _, p_final = final.predict(loader, return_prob=True)
    assert np.isfinite(p_best).all() and np.isfinite(p_final).all()
    assert sorted(os.listdir(os.path.join(log_dir, "state"))) == ["state.pt", "trainer_state.json"]


@pytest.mark.parametrize("from_yaml", [False, True], ids=["config-dict", "config-yaml"])
def test_resume_training_continues_a_run(data_dir, from_yaml):
    cfg = _config(data_dir, epochs=1)
    log_dir = port_train.train_model("deep_sets", "s2ppc", cfg, return_log_dir=True, device="cpu")
    if from_yaml:  # the run's config.yaml, read back with PyYAML
        with open(os.path.join(log_dir, "config.yaml")) as f:
            text = f.read()
        with open(os.path.join(log_dir, "config.yaml"), "w") as f:
            f.write(text.replace("epochs: 1", "epochs: 3"))
        model = port_train.resume_training(log_dir, device="cpu")
    else:
        cfg["trainer"]["epochs"] = 3  # train_model rewrote log_dir to the run's
        model = port_train.resume_training(log_dir, cfg, device="cpu")
    assert len(_metrics(log_dir)["Loss/train"]) == 3  # epoch 1, then 2 and 3
    with open(os.path.join(log_dir, "state", "trainer_state.json")) as f:
        assert json.load(f)["epoch"] == 2
    reloaded = factory.get_model("deep_sets", cfg, device="cpu")
    reloaded.load(os.path.join(log_dir, "model.pt"))
    for key, value in model.model.state_dict().items():
        assert torch.equal(reloaded.model.state_dict()[key], value)


def _flat_loaders(seed=0, n=40, batch=8):
    rng = np.random.default_rng(seed)
    events = [rng.normal(size=(int(k), 6)).astype(np.float32) for k in rng.integers(1, 30, size=n)]
    labels = rng.integers(0, 2, size=n)
    return (PointCloudLoader(events, labels, batch, shuffle=False),
            PointCloudLoader(events[:16], labels[:16], batch, shuffle=False))


def test_resume_restores_weights_optimizer_and_counters(tmp_path):
    train, val = _flat_loaders()
    straight = factory.get_model("deep_sets", _config(tmp_path / "a", epochs=3), device="cpu")
    straight.fit(train, val)

    first = factory.get_model("deep_sets", _config(tmp_path / "b", epochs=2), device="cpu")
    first.log_dir = str(tmp_path / "run")
    first.fit(train, val)
    resumed = factory.get_model("deep_sets", _config(tmp_path / "b", epochs=3, seed=7), device="cpu")
    resumed.log_dir = str(tmp_path / "run")
    assert resumed.restore_state() == 2
    for key, value in first.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], value)
    ours, ref = resumed.optimizer.state_dict(), first.optimizer.state_dict()
    assert ours["param_groups"] == ref["param_groups"]
    for i, state in ref["state"].items():
        for k, v in state.items():
            assert torch.equal(ours["state"][i][k], v)
    assert (resumed.best_val_loss, resumed.early_stop_counter) == (
        first.best_val_loss, first.early_stop_counter)

    resumed = factory.get_model("deep_sets", _config(tmp_path / "b", epochs=3, seed=7), device="cpu")
    resumed.log_dir = str(tmp_path / "run")
    resumed.fit(train, val, resume=True)
    for key, value in straight.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[key], value, rtol=0, atol=0)
    with open(tmp_path / "run" / "state" / "trainer_state.json") as f:
        text = f.read()
    assert json.loads(text)["epoch"] == 2 and text == json.dumps(json.loads(text), indent=4)


def test_non_finite_loss_raises(tmp_path):
    rng = np.random.default_rng(0)
    events = [rng.normal(size=(5, 6)).astype(np.float32) for _ in range(8)]
    events[3][0, 0] = np.nan
    loader = PointCloudLoader(events, np.zeros(8), 4, shuffle=False)
    model = factory.get_model("deep_sets", _config(tmp_path), device="cpu")
    with pytest.raises(FloatingPointError, match="Non-finite training loss .* at epoch 1; last good"):
        model.fit(loader, loader)
    assert _metrics(tmp_path / "log")["Loss/train"][0] != _metrics(tmp_path / "log")["Loss/train"][0]


@pytest.mark.parametrize(
    "kwargs, env",
    [
        ({"data_parallel": True}, {}),
        ({}, {"PCC_DATA_PARALLEL": "1"}),
        ({"n_model": 2}, {}),
        ({}, {"PCC_N_MODEL": "2"}),
        ({"mesh": object()}, {}),
    ],
    ids=["data_parallel", "PCC_DATA_PARALLEL", "n_model", "PCC_N_MODEL", "mesh"],
)
def test_unported_trainer_options_raise(monkeypatch, tmp_path, kwargs, env):
    """The JAX trainer's mesh options, ported: each builds a mesh over every
    rank, here a world of one gloo rank, whose wrapper predicts what the
    meshless one does; a model axis of 2 over one rank raises the JAX
    ``make_mesh``'s error.  (Multi-rank runs: tests/test_torch_mesh.py.)"""
    import torch.distributed as dist

    from point_cloud_classifier_tpu_torch.parallel import make_mesh

    model = factory.get_model("deep_sets", _config(tmp_path), device="cpu").model
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(0)
    events = [rng.normal(size=(int(k), 6)).astype(np.float32) for k in rng.integers(1, 20, size=10)]
    loader = PointCloudLoader(events, np.arange(10) % 2, 4, shuffle=False)
    try:
        if kwargs.get("mesh") is not None:
            kwargs = {"mesh": make_mesh(device="cpu")}
        if kwargs.get("n_model") == 2 or env.get("PCC_N_MODEL") == "2":
            with pytest.raises(ValueError, match="mesh 0x2 needs 2 devices, have 1"):
                ModelWrapper(model, learning_rate=1e-3, epochs=1, **kwargs, device="cpu")
            return
        wrapper = ModelWrapper(model, learning_rate=1e-3, epochs=1, **kwargs, device="cpu")
        assert wrapper.mesh.shape == {"data": 1, "model": 1} and wrapper.writer
        want = ModelWrapper(model, learning_rate=1e-3, epochs=1, device="cpu").predict(loader, return_prob=True)
        np.testing.assert_allclose(wrapper.predict(loader, return_prob=True)[1], want[1], rtol=1e-6, atol=1e-7)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_unported_train_model_options_raise(data_dir, monkeypatch):
    """The plots are ported (tests/test_torch_plots.py): without matplotlib
    ``plots=True`` raises naming it before the run directory exists.  An
    unknown optimizer is refused."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib is not installed"):
        port_train.train_model("deep_sets", "s2ppc", _config(data_dir), plots=True, device="cpu")
    assert not os.path.exists(data_dir / "log")
    monkeypatch.delitem(sys.modules, "matplotlib")
    with pytest.raises(ValueError, match="optimizer"):
        factory.get_model("deep_sets", _config(data_dir, optimizer="sgd"), device="cpu")

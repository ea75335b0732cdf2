"""Raw-file inference in the port (``data/inference.py``, ``train.infer_raw``
and ``server.Scorer``) against the JAX package's, on the CPU, over the JAX
generator's raw files and caches the JAX package built from them:
``inference_loader``'s batches byte for byte and its event ids for S2PT (a
``TabularLoader``, and the columns a ``LogRegression`` reads), S2PPC and S2PG
(on the flat wire the config pins, and on the wire the port's factory gives a
GraphNet config, against the JAX loader given that wire); a file's bytes
equal to its path; and ``infer_raw``'s CSV and the ``Scorer``'s JSON within
1e-5 of the JAX package's on JAX-format run directories (the JAX checkpoint
pickle, written by ``convert``) for DeepSets, GAT, the FCN and the logistic
regression."""

import contextlib
import copy
import io
import os
import shutil

import numpy as np
import pytest
import torch

import train as jax_train
from point_cloud_classifier_tpu.data import inference as jax_inference
from point_cloud_classifier_tpu.data.synthetic import write_shower_file, write_synthetic_dataset
from point_cloud_classifier_tpu.server import Scorer as JaxScorer
from point_cloud_classifier_tpu.utils import config as jax_config
from point_cloud_classifier_tpu_torch import convert, factory
from point_cloud_classifier_tpu_torch import train as port_train
from point_cloud_classifier_tpu_torch.data import inference as port_inference
from point_cloud_classifier_tpu_torch.factory import _graph_dataset_config
from point_cloud_classifier_tpu_torch.models import LogRegression
from point_cloud_classifier_tpu_torch.server import Scorer
from point_cloud_classifier_tpu_torch.utils.config import load_config, save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = {"deep_sets": "s2ppc", "graph_net": "s2pg", "fully_connected_net": "s2pt", "logistic_regression": "s2pt"}
NARROW = {"deep_sets": dict(phi_layers=[16, 16], rho_layers=[16]), "graph_net": dict(hidden_dim=16, use_gat=True),
          "fully_connected_net": dict(hidden_layers=[8, 8]), "logistic_regression": {}}


def _config(model, data_dir):
    cfg = load_config(os.path.join(REPO, "configs", "base.yaml"), os.path.join(REPO, "configs", f"{model}.yaml"))
    cfg["dataset"]["data_dir"] = data_dir
    cfg.setdefault("model", {}).update(NARROW[model])
    cfg["meta"].update(model_name=model, dataset_name=DATASETS[model])
    return cfg


def write_jax_run(root, model, data_dir):
    """A run directory in the JAX package's format: ``config.yaml`` and the
    JAX checkpoint pickle of seeded weights (``model.pkl`` of a fit for the
    logistic regression)."""
    cfg = _config(model, data_dir)
    run = os.path.join(root, model)
    cfg["logging"]["log_dir"] = run
    save_config(cfg, run)
    if model == "logistic_regression":
        LogRegression(device="cpu").fit(factory.get_dataloader("s2pt", cfg).get_train_loader()).save(run)
        return run
    cfg.setdefault("trainer", {})["seed"] = 5
    wrapper = factory.get_model(model, cfg, device="cpu")
    torch.save(wrapper.model.state_dict(), os.path.join(run, "state.pt"))
    convert.convert_checkpoint(model, cfg, os.path.join(run, "state.pt"), os.path.join(run, "best_model.pt"))
    os.remove(os.path.join(run, "state.pt"))
    return run


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX generator's raw files, the JAX package's three caches built
    from them, a run directory for each model and a raw file to score."""
    root = tmp_path_factory.mktemp("raw_inference")
    data = write_synthetic_dataset(str(root / "data"), n_events_per_file=30, n_files_per_particle=2, seed=4)
    with contextlib.redirect_stdout(io.StringIO()):
        for ds, model in (("s2pt", "fully_connected_net"), ("s2ppc", "deep_sets"), ("s2pg", "graph_net")):
            cfg = jax_config.load_config(os.path.join(REPO, "configs", "base.yaml"),
                                         os.path.join(REPO, "configs", f"{model}.yaml"))
            cfg["dataset"].update(data_dir=data, create_dataset=True)
            jax_train.get_dataloader(ds, cfg)
        runs = {model: write_jax_run(str(root / "runs"), model, data) for model in DATASETS}
    raw = str(root / "serve.h5")
    write_shower_file(raw, "piM", 13, 99)
    return {"data": data, "runs": runs, "raw": raw, "root": root}


def _batches(loader):
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _assert_same_batches(ours, theirs):
    a, b = _batches(ours), _batches(theirs)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for key in x:
            assert x[key].dtype == y[key].dtype, key
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


@pytest.mark.parametrize("case", ["s2pt-tensor", "s2pt-columns", "s2ppc", "s2pg-flat", "s2pg-factory-wire"])
def test_inference_loader_matches_jax(setup, case):
    model = {"s2pt-tensor": "fully_connected_net", "s2pt-columns": "logistic_regression",
             "s2ppc": "deep_sets"}.get(case, "graph_net")
    cfg = load_config(os.path.join(setup["runs"][model], "config.yaml"))
    ours_cfg, theirs_cfg = cfg, copy.deepcopy(cfg)
    if case == "s2pg-flat":
        ours_cfg["dataset"]["graph_layout"] = theirs_cfg["dataset"]["graph_layout"] = "flat"
    if case == "s2pg-factory-wire":
        # the JAX loader given the wire the port's factory (and the JAX
        # factory) gives the run's cached splits
        theirs_cfg["dataset"] = _graph_dataset_config(cfg)
    ds = DATASETS[model]
    with contextlib.redirect_stdout(io.StringIO()):
        ours, ids = port_inference.inference_loader(ds, ours_cfg, setup["raw"])
        theirs, ids_ref = jax_inference.inference_loader(ds, theirs_cfg, setup["raw"])
        with open(setup["raw"], "rb") as f:
            from_bytes, ids_bytes = port_inference.inference_loader(ds, ours_cfg, f.read())
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_array_equal(ids_bytes, ids_ref)
    assert sorted(ids.tolist()) == list(range(13))
    if case == "s2pt-columns":
        assert list(ours) == list(theirs.columns) and list(from_bytes) == list(ours)
        for name in ours:
            np.testing.assert_array_equal(ours[name], theirs[name].to_numpy(), err_msg=name)
            np.testing.assert_array_equal(from_bytes[name], ours[name])
        return
    _assert_same_batches(ours, theirs)
    _assert_same_batches(from_bytes, theirs)
    if case == "s2pg-factory-wire":
        assert all("in_src" in b for b in _batches(ours))  # the in-row wire, K3's


def _csv(path):
    with open(path) as f:
        header = f.readline()
        rows = np.array([line.strip().split(",") for line in f], dtype=np.float64)
    return header, rows


@pytest.mark.parametrize("model", list(DATASETS))
def test_infer_raw_and_scorer_match_jax(setup, tmp_path, model):
    run = setup["runs"][model]
    with contextlib.redirect_stdout(io.StringIO()):
        ours = port_train.infer_raw(run, setup["raw"], output=str(tmp_path / "port.csv"), device="cpu")
        theirs = jax_train.infer_raw(run, setup["raw"], output=str(tmp_path / "jax.csv"))
    (h, a), (h_ref, b) = _csv(ours), _csv(theirs)
    assert h == h_ref == "event_id,probability,prediction\n"
    assert a.shape == b.shape == (13, 3)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1], b[:, 1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(a[:, 2], (a[:, 1] >= 0.5).astype(float))

    with open(setup["raw"], "rb") as f:
        data = f.read()
    with contextlib.redirect_stdout(io.StringIO()):
        got = Scorer(run, device="cpu").score_bytes(data)
        want = JaxScorer(run).score_bytes(data)
    assert [p["event_id"] for p in got] == [p["event_id"] for p in want]
    np.testing.assert_allclose([p["probability"] for p in got], [p["probability"] for p in want], rtol=0, atol=1e-5)
    assert all(p["prediction"] == int(p["probability"] >= 0.5) for p in got)


def test_missing_scaler_raises_file_not_found(setup, tmp_path):
    """The run's data directory without its scaler: the error the server
    maps to 500, naming the path and dataset creation."""
    data = shutil.copytree(setup["data"], str(tmp_path / "data"))
    os.remove(os.path.join(data, "S2PPC", "S2PPC_scaler.pkl"))
    cfg = load_config(os.path.join(setup["runs"]["deep_sets"], "config.yaml"))
    cfg["dataset"]["data_dir"] = data
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(FileNotFoundError, match="run dataset creation"):
        port_inference.inference_loader("s2ppc", cfg, setup["raw"])
    with pytest.raises(ValueError, match="Unknown dataset"):
        port_inference.inference_loader("s2px", cfg, setup["raw"])

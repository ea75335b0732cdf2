"""The port's hyperparameter sweep on the CPU against the repository's JAX
``sweep.py``: the samplers dict for dict under the same seeds, the
leaderboard and ``status_log.txt`` byte for byte, the command line
(``python -m point_cloud_classifier_tpu_torch.sweep``) sampling the JAX
sweep's configurations, the vmapped search's artifacts (a winner that the
port's ``evaluate`` scores, no ``best_model.pt`` for an arm gone NaN), and
what it refuses."""

import json
import os
from copy import deepcopy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sweep as jax_sweep  # noqa: E402
from point_cloud_classifier_tpu.utils.config import load_config as jax_load_config  # noqa: E402
from point_cloud_classifier_tpu_torch import cli, factory  # noqa: E402
from point_cloud_classifier_tpu_torch import sweep  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import (  # noqa: E402
    write_s2pg_cache,
    write_s2ppc_cache,
    write_s2pt_cache,
)
from point_cloud_classifier_tpu_torch.parallel import vmap_sweep  # noqa: E402
from point_cloud_classifier_tpu_torch.utils.config import load_config  # noqa: E402


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("sweep_data"))
    write_s2pt_cache(data, n_events=(100, 30, 30), seed=1)
    write_s2ppc_cache(data, n_events=(48, 16, 16), min_points=3, max_points=20, seed=2)
    write_s2pg_cache(data, n_graphs=(32, 16, 16), min_nodes=10, max_nodes=24, seed=3)
    return data


def _configs(model):
    paths = ("configs/base.yaml", f"configs/{model}.yaml")
    return load_config(*paths), jax_load_config(*paths)


@pytest.mark.parametrize("model", sorted(sweep._SAMPLERS))
def test_samplers_draw_the_jax_sweeps_configurations(model):
    ours, theirs = _configs(model)
    assert ours == theirs
    for seed in range(10):
        np.random.seed(seed)
        drawn = [sweep._SAMPLERS[model](ours) for _ in range(3)]
        np.random.seed(seed)
        assert drawn == [jax_sweep._SAMPLERS[model](theirs) for _ in range(3)], seed


def _fake_run(val_accs):
    """A ``train_model`` stand-in that makes a run directory with the given
    val accuracies, one a call, as the trainer's logger would."""
    calls = iter(val_accs)

    def run(model_name, dataset_name, config, return_log_dir=True, **kwargs):
        from point_cloud_classifier_tpu_torch.utils.log import TrainingLogger

        logger = TrainingLogger(model_name, dataset_name, **config["logging"])
        logger.log_metric("accuracy/val", next(calls))
        logger.log_metric("parameters", 1234)
        return logger.version_dir

    return run


def test_leaderboard_is_the_jax_sweeps_byte_for_byte(tmp_path, monkeypatch):
    accs = [0.5, 0.75, 0.625, 0.75]
    monkeypatch.setattr(sweep, "train_model", _fake_run(accs))
    monkeypatch.setattr(jax_sweep, "train_model", _fake_run(accs))
    for mod, name in ((sweep, "port"), (jax_sweep, "jax")):
        np.random.seed(0)
        kwargs = {"device": "cpu"} if mod is sweep else {}
        top = mod.run_search("fully_connected_net", "s2pt", search_dir=str(tmp_path / name), max_runs=4,
                             epochs=1, force=True, **kwargs)
        assert [r["version"] for r in top] == ["1", "3", "2", "0"]
    with open(tmp_path / "port" / "search_results.json", "rb") as a, open(tmp_path / "jax" / "search_results.json", "rb") as b:
        assert a.read() == b.read()


def test_failure_goes_to_the_status_log_as_in_the_jax_sweep(tmp_path, monkeypatch):
    def boom(**kwargs):
        raise RuntimeError("injected failure")

    monkeypatch.setattr(sweep, "train_model", boom)
    monkeypatch.setattr(jax_sweep, "train_model", boom)
    for mod, name in ((sweep, "port"), (jax_sweep, "jax")):
        np.random.seed(0)
        kwargs = {"device": "cpu"} if mod is sweep else {}
        top = mod.run_search("deep_sets", "s2ppc", search_dir=str(tmp_path / name), max_runs=2, epochs=1,
                             force=True, **kwargs)
        assert top == []
        with open(tmp_path / name / "search_results.json") as f:
            assert json.load(f) == []
    log = (tmp_path / "port" / "status_log.txt").read_text()
    assert "Run 0 FAILED" in log and "Run 1 FAILED" in log and "injected failure" in log
    # the sampled dicts hold the search directory's absolute path: the logs
    # agree once it is named alike
    assert log.replace(str(tmp_path / "port"), "S") == (
        (tmp_path / "jax" / "status_log.txt").read_text().replace(str(tmp_path / "jax"), "S"))


def test_sequential_sweep_from_the_command_line_samples_the_jax_sweeps_configs(caches, tmp_path):
    search = str(tmp_path / "search")
    sweep.main(["deep_sets", "--seed", "0", "--max-runs", "3", "--epochs", "1", "--force",
                "--data-dir", caches, "--search-dir", search], device="cpu")
    with open(os.path.join(search, "search_results.json")) as f:
        top = json.load(f)
    assert sorted(r["version"] for r in top) == ["0", "1", "2"]
    assert [r["val_acc"] for r in top] == sorted((r["val_acc"] for r in top), reverse=True)
    config = jax_load_config("configs/base.yaml", "configs/deep_sets.yaml")
    config["logging"]["log_dir"] = os.path.abspath(search)
    config["trainer"]["epochs"] = 1
    config["trainer"]["state_every"] = 0
    config["dataset"]["data_dir"] = caches
    np.random.seed(0)
    for version in range(3):
        want = jax_sweep.deep_sets_config(config)
        run = os.path.join(search, f"version_{version}")
        got = load_config(os.path.join(run, "config.yaml"))
        for section in ("model", "dataset", "trainer"):
            assert got[section] == want[section], (version, section)
        assert {"model.pt", "best_model.pt", "config.yaml", "meta.json"} <= set(os.listdir(run))
        assert not os.path.exists(os.path.join(run, "state"))  # state_every: 0


def test_vmapped_sweep_artifacts_and_the_winner_evaluates(caches, tmp_path):
    search = str(tmp_path / "search")
    np.random.seed(0)
    top = sweep.run_search_vmapped("fully_connected_net", "s2pt", search_dir=search, max_runs=3, epochs=1,
                                   force=True, data_dir=caches, device="cpu")
    assert len(top) == 3
    assert [r["val_acc"] for r in top] == sorted((r["val_acc"] for r in top), reverse=True)
    with open(os.path.join(search, "search_results.json")) as f:
        assert json.load(f) == top
    for i in range(3):
        run = os.path.join(search, f"version_{i}")
        with open(os.path.join(run, "meta.json")) as f:
            assert {"accuracy/train", "accuracy/val", "parameters"} <= set(json.load(f)["metrics"])
        for name in ("config.yaml", "model.pt", "best_model.pt"):
            assert os.path.exists(os.path.join(run, name)), (run, name)
        assert set(torch.load(os.path.join(run, "model.pt"), weights_only=True)) == set(
            torch.load(os.path.join(run, "best_model.pt"), weights_only=True))
    win = os.path.join(search, f"version_{top[0]['version']}")
    cfg = load_config(os.path.join(win, "config.yaml"))
    model = factory.get_model("fully_connected_net", cfg, model_dir=win, device="cpu")
    y, pred = model.predict(factory.get_dataloader("s2pt", cfg).get_val_loader())
    assert float((pred.reshape(-1) == y.reshape(-1)).mean()) == pytest.approx(top[0]["val_acc"], abs=0.2)
    cli.main(["evaluate", win], device="cpu")
    with open(os.path.join(win, "eval", "metrics.json")) as f:
        assert set(json.load(f)) == {"accuracy_train", "accuracy_val", "accuracy_test"}


@pytest.mark.parametrize("model", ["deep_sets", "graph_net"])
def test_vmapped_sweep_from_the_command_line(caches, tmp_path, model):
    """Every group trains (a graph group's loader takes the layout its model
    can read), and the groups are the JAX sweep's."""
    search = str(tmp_path / "search")
    sweep.main([model, "--vmap", "--seed", "3", "--max-runs", "3", "--epochs", "1", "--force",
                "--data-dir", caches, "--search-dir", search], device="cpu")
    status = os.path.join(search, "status_log.txt")
    with open(os.path.join(search, "search_results.json")) as f:
        top = json.load(f)
    assert len(top) == 3, open(status).read() if os.path.exists(status) else top


def _one_group_sampler(lrs):
    """A sampler that draws one architecture with the given learning rates
    in turn: one vmapped group."""
    rates = iter(lrs)

    def sample(config):
        hp = deepcopy(config)
        hp["model"]["hidden_layers"] = [8]
        hp["model"]["batch_normalization"] = False
        hp["trainer"]["learning_rate"] = next(rates)
        return hp

    return sample


def test_vmapped_sweep_writes_no_best_model_for_an_arm_gone_nan(caches, tmp_path, monkeypatch):
    monkeypatch.setitem(sweep._SAMPLERS, "fully_connected_net", _one_group_sampler([float("nan"), 1e-2]))
    search = str(tmp_path / "search")
    top = sweep.run_search_vmapped("fully_connected_net", "s2pt", search_dir=search, max_runs=2, epochs=2,
                                   force=True, data_dir=caches, device="cpu")
    assert len(top) == 2
    nan_run, good_run = (os.path.join(search, f"version_{i}") for i in range(2))
    assert os.path.exists(os.path.join(nan_run, "model.pt"))
    assert not os.path.exists(os.path.join(nan_run, "best_model.pt"))
    assert os.path.exists(os.path.join(good_run, "best_model.pt"))


def test_vmapped_sweep_logs_a_failed_group_and_searches_on(caches, tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("injected group failure")

    monkeypatch.setattr(vmap_sweep, "train_configs_vmapped", boom)
    search = str(tmp_path / "search")
    np.random.seed(0)
    top = sweep.run_search_vmapped("fully_connected_net", "s2pt", search_dir=search, max_runs=2, epochs=1,
                                   force=True, data_dir=caches, device="cpu")
    assert top == []
    log = open(os.path.join(search, "status_log.txt")).read()
    assert "Group 0 (1 configs) FAILED" in log and "Group 1 (1 configs) FAILED" in log
    assert "injected group failure" in log


def test_mesh_and_a_missing_card_are_refused(tmp_path, monkeypatch):
    """``--mesh`` is ported (tests/test_torch_mesh_sweep.py runs it on 2
    ranks); asked for on a machine with no card and no ``device``, it
    raises as every other run does.  A missing card is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main(["deep_sets", "--vmap", "--mesh", "--search-dir", str(tmp_path / "s")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_search_vmapped("deep_sets", "s2ppc", str(tmp_path / "s"), use_mesh=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (sweep.run_search, sweep.run_search_vmapped):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn("deep_sets", "s2ppc", str(tmp_path / "s"), max_runs=1, force=True)

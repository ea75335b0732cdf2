"""The port's command line and its run functions against the JAX package's,
on the CPU: ``classification_report`` byte for byte against sklearn's;
``evaluate_model`` and ``infer`` on one run directory through both packages
(``metrics.json`` and ``classification_report.txt`` byte for byte, the
predictions CSVs column by column); the parser's subcommands, options,
choices and defaults against the JAX parser's; ``train --plots``'s plots;
``infer-raw``, ``serve``, ``create-datasets`` and ``train --create-dataset``
on raw shower files; ``export`` and ``--quant int8``; ``main(["train", …])`` for the four model families; and ``main``
without a device on a host without a card."""

import argparse
import contextlib
import copy
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
import warnings

import numpy as np
import pytest
from sklearn.metrics import classification_report as sk_classification_report

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

import train as jax_train  # noqa: E402
from point_cloud_classifier_tpu.utils import config as jax_config  # noqa: E402
from point_cloud_classifier_tpu_torch import cli  # noqa: E402
from point_cloud_classifier_tpu_torch import train as port_train  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import (  # noqa: E402
    write_s2pg_cache,
    write_s2ppc_cache,
    write_s2pt_cache,
    write_synthetic_dataset,
)
from point_cloud_classifier_tpu_torch.utils.config import load_config, save_config  # noqa: E402
from point_cloud_classifier_tpu_torch.utils.metrics import classification_report  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("logistic_regression", "fully_connected_net", "deep_sets", "graph_net")
DATASETS = {"logistic_regression": "s2pt", "fully_connected_net": "s2pt", "deep_sets": "s2ppc", "graph_net": "s2pg"}


def _report_case(name):
    rng = np.random.default_rng(len(name))
    t, p = rng.integers(0, 2, 101), rng.integers(0, 2, 101)
    return {
        "float32": (t.astype(np.float32), p.astype(np.float32)),
        "float64-and-float32": (t.astype(np.float64), p.astype(np.float32)),
        "int": (t, p),
        "never-predicted": (t.astype(np.float32), np.zeros(101, np.float32)),
        "class-absent": (np.ones(40), rng.integers(0, 2, 40).astype(np.float64)),
        "one-class": (np.zeros(7), np.zeros(7)),
        "ties": (np.array([0, 0, 1, 1, 0, 1, 0, 1.0]), np.array([0, 1, 0, 1, 1, 0, 0, 1.0])),
        "eighths": (np.repeat([0.0, 1.0], 8), np.r_[np.zeros(7), np.ones(2), np.zeros(7)]),
        "all-wrong": (np.r_[np.zeros(5), np.ones(3)], np.r_[np.ones(5), np.zeros(3)]),
    }[name]


@pytest.mark.parametrize("case", ["float32", "float64-and-float32", "int", "never-predicted", "class-absent",
                                  "one-class", "ties", "eighths", "all-wrong"])
def test_classification_report_matches_sklearn(case):
    y_true, y_pred = _report_case(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn warns where a ratio is 0/0
        want = sk_classification_report(y_true, y_pred)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the port does not
        got = classification_report(y_true, y_pred)
    assert got == want


def _narrow(config_dir, name):
    """configs/{name}.yaml with narrow widths and small batches."""
    cfg = load_config(os.path.join(REPO, "configs", "base.yaml"), os.path.join(REPO, "configs", f"{name}.yaml"))
    model, dataset = cfg.get("model", {}), cfg.get("dataset", {})
    if name == "deep_sets":
        model.update(phi_layers=[16, 16], rho_layers=[16])
        dataset["batch_size"] = 8
    elif name == "graph_net":
        model["hidden_dim"] = 16
        dataset["batch_size"] = 8
    elif name == "fully_connected_net":
        model["hidden_layers"] = [8, 8]
        dataset["batch_size"] = 16
    with open(os.path.join(REPO, "configs", f"{name}.yaml")) as f:
        text = f.read()
    if text.strip():
        path = os.path.join(config_dir, f"{name}.yaml")
        save_config({k: v for k, v in cfg.items() if k not in ("meta", "logging")}, config_dir)
        os.replace(os.path.join(config_dir, "config.yaml"), path)
    else:
        shutil.copy(os.path.join(REPO, "configs", f"{name}.yaml"), config_dir)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A config directory at narrow widths and seeded caches of every dataset,
    none a multiple of its batch size."""
    root = tmp_path_factory.mktemp("cli")
    config_dir = root / "configs"
    os.makedirs(config_dir)
    shutil.copy(os.path.join(REPO, "configs", "base.yaml"), config_dir)
    for name in MODELS:
        _narrow(str(config_dir), name)
    data = str(root / "data")
    write_s2pt_cache(data, n_events=(90, 37, 29), seed=1)
    write_s2ppc_cache(data, n_events=(36, 13, 11), min_points=3, max_points=30, seed=1)
    write_s2pg_cache(data, n_graphs=(16, 8, 8), min_nodes=10, max_nodes=20, seed=1)
    return root


def _args(tiny, model, log_dir, *extra):
    return ["train", model, "--config-dir", str(tiny / "configs"), "--data-dir", str(tiny / "data"),
            "--log-dir", str(log_dir), *extra]


@pytest.fixture(scope="module")
def jax_runs(tiny):
    """Run directories trained by the JAX package (its checkpoints, which
    both packages read), one per model family that ``evaluate`` compares."""
    runs = {}
    for model in ("logistic_regression", "fully_connected_net", "deep_sets"):
        cfg = jax_config.load_config(str(tiny / "configs" / "base.yaml"), str(tiny / "configs" / f"{model}.yaml"))
        cfg["dataset"]["data_dir"] = str(tiny / "data")
        cfg["logging"]["log_dir"] = str(tiny / "jax" / model)
        cfg.setdefault("trainer", {})["epochs"] = 2
        runs[model] = jax_train.train_model(model, DATASETS[model], cfg, return_log_dir=True)
    return runs


@pytest.mark.parametrize("model", ["logistic_regression", "fully_connected_net", "deep_sets"])
def test_evaluate_writes_the_jax_bytes(jax_runs, tmp_path, model):
    run = jax_runs[model]
    ours = port_train.evaluate_model(run, save_dir=str(tmp_path / "port"), device="cpu")
    theirs = jax_train.evaluate_model(run, save_dir=str(tmp_path / "jax"))
    assert ours == theirs
    for name in ("metrics.json", "classification_report.txt"):
        with open(tmp_path / "port" / name, "rb") as a, open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    # and the test split's three plots (tests/test_torch_plots.py holds their pixels)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "classification_report.txt", "confusion_matrix_test.png", "metrics.json", "precision_recall_test.png",
        "roc_curve_test.png"]


def _csv(path):
    with open(path) as f:
        header = f.readline()
        rows = np.array([line.strip().split(",") for line in f], dtype=np.float64)
    return header, rows


@pytest.mark.parametrize("split", ["test", "train"])
@pytest.mark.parametrize("model", ["logistic_regression", "fully_connected_net", "deep_sets"])
def test_infer_matches_jax(jax_runs, tmp_path, model, split):
    run = jax_runs[model]
    ours = port_train.infer(run, split=split, output=str(tmp_path / "port.csv"), device="cpu")
    theirs = jax_train.infer(run, split=split, output=str(tmp_path / "jax.csv"))
    (h, a), (h_ref, b) = _csv(ours), _csv(theirs)
    assert h == h_ref == "index,y_true,probability,prediction\n"
    assert a.shape == b.shape and len(a) > 0
    np.testing.assert_array_equal(a[:, [0, 1, 3]], b[:, [0, 1, 3]])
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a[:, 3], (a[:, 2] >= 0.5).astype(float))


def test_infer_on_a_length_sorted_train_split_keeps_the_jax_order(jax_runs, tmp_path):
    """The train loader is read unshuffled, and a length-sorted one still
    sorts by size, in both packages: the CSV's ``index`` counts that order."""
    run = str(tmp_path / "run")
    shutil.copytree(jax_runs["deep_sets"], run)
    cfg = load_config(os.path.join(run, "config.yaml"))
    cfg["dataset"]["length_sorted"] = True
    save_config(cfg, run)
    ours = port_train.infer(run, split="train", output=str(tmp_path / "port.csv"), device="cpu")
    theirs = jax_train.infer(run, split="train", output=str(tmp_path / "jax.csv"))
    (_, a), (_, b) = _csv(ours), _csv(theirs)
    unsorted = _csv(port_train.infer(jax_runs["deep_sets"], split="train", output=str(tmp_path / "u.csv"),
                                     device="cpu"))[1]
    np.testing.assert_array_equal(a[:, [0, 1, 3]], b[:, [0, 1, 3]])
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=0, atol=1e-6)
    assert not np.array_equal(a[:, 1], unsorted[:, 1]) or not np.allclose(a[:, 2], unsorted[:, 2])


def _parser_tree(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {
        name: sorted(
            (a.dest, tuple(a.option_strings), a.nargs, repr(a.default), tuple(a.choices or ()), a.required,
             a.type, type(a).__name__)
            for a in p._actions
        )
        for name, p in sub.choices.items()
    }


def test_parser_matches_the_jax_parser():
    ours, theirs = _parser_tree(cli.build_parser()), _parser_tree(jax_train._build_parser())
    assert list(ours) == list(theirs) and len(ours) == 9
    for name in theirs:
        assert ours[name] == theirs[name], name


@pytest.fixture(scope="module")
def raw_run(tiny):
    """Raw shower files (2 files of 30 events a particle), the S2PPC cache
    ``create-datasets`` builds from them with the narrow configs, and a
    DeepSets run ``train`` makes over it (1 epoch)."""
    root = tiny / "raw_run"
    data = write_synthetic_dataset(str(root / "data"), n_events_per_file=30, n_files_per_particle=2, seed=6)
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["create-datasets", "--data-dir", data, "--config-dir", str(tiny / "configs"),
                  "--datasets", "s2ppc"], device="cpu")
        cli.main(["train", "deep_sets", "--config-dir", str(tiny / "configs"), "--data-dir", data,
                  "--log-dir", str(root / "log"), "--epochs", "1"], device="cpu")
    return {"data": data, "run": str(root / "log" / "version_0"), "raw": os.path.join(data, "piM_file1.h5")}


def _serve_once(argv, capsys, monkeypatch):
    """``serve`` in a thread until it answers ``/health``; its printed
    address and the answer."""
    from point_cloud_classifier_tpu_torch import server as server_mod

    made = []
    real = server_mod.make_server
    monkeypatch.setattr(server_mod, "make_server", lambda *a, **k: made.append(real(*a, **k)) or made[-1])
    thread = threading.Thread(target=cli.main, args=(argv,), kwargs={"device": "cpu"}, daemon=True)
    thread.start()
    for _ in range(600):
        if made:
            break
        time.sleep(0.05)
    try:
        port = made[0].server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        made[0].shutdown()
    thread.join(timeout=60)
    return port, health, capsys.readouterr().out


@pytest.mark.parametrize("argv, item", [
    (["infer-raw", "run", "--input", "x.h5"], "Wrote 30 predictions to"),
    (["serve", "run", "--quant", "int8"], "Serving"),
    (["export", "run"], "Exported serving artifacts to"),
    (["create-datasets", "--data-dir", "d"], "Scaling the following columns:"),
    (["train", "deep_sets", "--create-dataset"], "Creating Step2PointPointCloud (S2PPC) dataset"),
    (["train", "deep_sets", "--plots"], "confusion_matrix_test.png"),
], ids=["infer-raw", "serve", "export", "create-datasets", "train-create-dataset", "train-plots"])
def test_unported_commands_fail_naming_their_item(tiny, jax_runs, raw_run, tmp_path, capsys, monkeypatch, argv,
                                                  item):
    """Every command once refused runs on the CPU now: ``train --plots``
    draws the val split's three plots into the run directory, and the others
    print the JAX package's lines: ``export`` (its manifest), ``infer-raw`` (a row a raw event),
    ``serve`` (its address, ``/health`` with the int8 path that runs),
    ``create-datasets`` (the S2PT and S2PG caches over two workers, their
    scalers) and ``train --create-dataset`` (the cache, then the run, whose
    ``config.yaml`` says ``create_dataset: false``)."""
    command = argv[0] if argv[0] != "train" else argv[-1]
    if command == "export":
        out_dir = str(tmp_path / "log")
        cli.main([argv[0], jax_runs["deep_sets"], "--out-dir", out_dir], device="cpu")
        assert f"{item} {out_dir}" in capsys.readouterr().out
        assert os.path.exists(os.path.join(out_dir, "manifest.json"))
        return
    if command == "infer-raw":
        out = str(tmp_path / "p.csv")
        cli.main(["infer-raw", raw_run["run"], "--input", raw_run["raw"], "--output", out], device="cpu")
        assert f"{item} {out}" in capsys.readouterr().out
        header, rows = _csv(out)
        assert header == "event_id,probability,prediction\n" and rows.shape == (30, 3)
        np.testing.assert_array_equal(np.sort(rows[:, 0]), np.arange(30))
        return
    if command == "serve":
        port, health, out = _serve_once(["serve", raw_run["run"], "--port", "0", "--quant", "int8"], capsys,
                                        monkeypatch)
        assert f"{item} {raw_run['run']} on http://127.0.0.1:{port}" in out
        assert health == {"status": "ok", "model": "deep_sets", "dataset": "s2ppc", "quant": "int8"}
        return
    if "--plots" in argv:
        cli.main(["train", "deep_sets", "--config-dir", str(tiny / "configs"), "--data-dir", raw_run["data"],
                  "--log-dir", str(tmp_path / "log"), "--epochs", "1", "--plots"], device="cpu")
        files = set(os.listdir(tmp_path / "log" / "version_0"))
        assert {item, "roc_curve_test.png", "precision_recall_test.png", "meta.json"} <= files
        return
    data = shutil.copytree(raw_run["data"], str(tmp_path / "data"), ignore=shutil.ignore_patterns("S2P*"))
    if command == "create-datasets":
        cli.main(["create-datasets", "--data-dir", data, "--config-dir", str(tiny / "configs"),
                  "--datasets", "s2pt", "s2pg", "--workers", "2"], device="cpu")
        assert item in capsys.readouterr().out
        for name in ("S2PT", "S2PG"):
            assert os.path.exists(os.path.join(data, name, f"{name}_scaler.pkl"))
        assert sorted(os.listdir(os.path.join(data, "S2PT", "test"))) == ["S2PT_test.npz"]
        assert len(os.listdir(os.path.join(data, "S2PG", "train"))) == 72  # 60% of 120 events
        assert not os.path.exists(os.path.join(data, "S2PPC"))
        return
    argv = ["train", "deep_sets", "--config-dir", str(tiny / "configs"), "--data-dir", data, "--log-dir",
            str(tmp_path / "log"), *argv[2:]]
    cli.main([*argv, "--epochs", "1"], device="cpu")
    assert item in capsys.readouterr().out
    run = tmp_path / "log" / "version_0"
    assert load_config(str(run / "config.yaml"))["dataset"]["create_dataset"] is False
    assert {"config.yaml", "meta.json", "best_model.pt"} <= set(os.listdir(run))
    assert len(glob.glob(os.path.join(data, "S2PPC", "*", "S2PPC_*_*.npz"))) == 6


def test_quant_int8_fails_naming_its_item(jax_runs, tmp_path):
    """``--quant int8`` is ported: ``evaluate`` of a DeepSets run scores it
    through the int8 chain (``metrics.json`` with ``"quant": "int8"``, the
    accuracies the JAX package's int8 evaluation gives), ``infer`` takes it
    too, the logistic regression keeps the JAX package's error, and ``auto``
    stays float at these widths."""
    run = jax_runs["deep_sets"]
    cli.main(["evaluate", run, "--quant", "int8", "--save-dir", str(tmp_path / "port")], device="cpu")
    jax_train.evaluate_model(run, save_dir=str(tmp_path / "jax"), quant="int8")
    for name in ("metrics.json", "classification_report.txt"):
        with open(tmp_path / "port" / name, "rb") as a, open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    with open(tmp_path / "port" / "metrics.json") as f:
        assert json.load(f)["quant"] == "int8"
    cli.main(["infer", run, "--quant", "int8", "--output", str(tmp_path / "q.csv")], device="cpu")
    assert len(_csv(str(tmp_path / "q.csv"))[1]) > 0
    with pytest.raises(ValueError, match="only supported for deep_sets"):
        cli.main(["infer", jax_runs["logistic_regression"], "--quant", "int8"], device="cpu")
    cli.main(["evaluate", run, "--quant", "auto"], device="cpu")  # float at these widths
    with open(os.path.join(run, "eval", "metrics.json")) as f:
        assert list(json.load(f)) == ["accuracy_train", "accuracy_val", "accuracy_test"]


def test_module_entry_lists_every_command_and_refuses_the_unported(tmp_path):
    """``python -m point_cloud_classifier_tpu_torch``: ``--help`` lists every
    command, ``serve --help`` its options, and ``create-datasets`` builds a
    cache on a host without a card (dataset creation never touches one)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    run = [sys.executable, "-m", "point_cloud_classifier_tpu_torch"]
    helped = subprocess.run(run + ["--help"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert helped.returncode == 0, helped.stderr
    for name in ("train", "evaluate", "resume", "infer", "infer-raw", "serve", "export", "create-datasets",
                 "convert"):
        assert name in helped.stdout
    served = subprocess.run(run + ["serve", "--help"], cwd=REPO, env=env, capture_output=True, text=True,
                            timeout=120)
    assert served.returncode == 0, served.stderr
    assert all(opt in served.stdout for opt in ("model_dir", "--host", "--port", "--quant"))
    data = write_synthetic_dataset(str(tmp_path / "data"), n_events_per_file=10, seed=2)
    created = subprocess.run(run + ["create-datasets", "--data-dir", data, "--datasets", "s2pt"], cwd=REPO,
                             env=env, capture_output=True, text=True, timeout=120)
    assert created.returncode == 0, created.stderr
    assert sorted(os.listdir(os.path.join(data, "S2PT"))) == ["S2PT_scaler.pkl", "test", "train", "val"]


def _expected_config(tiny, model, log_dir, epochs, seed):
    """What the JAX command line's ``train`` writes as ``config.yaml``."""
    cfg = jax_config.load_config(str(tiny / "configs" / "base.yaml"), str(tiny / "configs" / f"{model}.yaml"))
    cfg["dataset"]["data_dir"] = str(tiny / "data")
    cfg["logging"]["log_dir"] = os.path.join(str(log_dir), "version_0")
    cfg.setdefault("trainer", {})["epochs"] = epochs
    cfg["trainer"]["seed"] = seed
    cfg["meta"].update(model_name=model, dataset_name=DATASETS[model])
    return cfg


@pytest.mark.parametrize("model", MODELS)
def test_main_trains_every_model(tiny, tmp_path, model):
    log_dir = tmp_path / "log"
    cli.main(_args(tiny, model, log_dir, "--epochs", "2", "--seed", "3"), device="cpu")
    run = log_dir / "version_0"
    files = {"config.yaml", "meta.json"} | ({"model.pkl"} if model == "logistic_regression" else
                                            {"metrics.jsonl", "best_model.pt", "model.pt", "state"})
    assert set(os.listdir(run)) == files
    want = jax_config.save_config(_expected_config(tiny, model, log_dir, 2, 3), str(tmp_path / "jax"))
    with open(run / "config.yaml", "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    with open(run / "meta.json") as f:
        text = f.read()
    meta = json.loads(text)
    assert text == json.dumps(meta, indent=4)
    assert list(meta) == ["dataset", "model", "metrics"]
    assert (meta["dataset"], meta["model"]) == (DATASETS[model], model)
    assert list(meta["metrics"]) == ["accuracy/train", "accuracy/val", "parameters"]
    for key in ("accuracy/train", "accuracy/val"):
        assert 0.0 <= meta["metrics"][key] <= 1.0 and round(meta["metrics"][key], 6) == meta["metrics"][key]
    if model == "logistic_regression":
        assert meta["metrics"]["parameters"] == 10
    else:
        cli.main(["resume", str(run)], device="cpu")  # no more epochs to run: the state is read back
        with open(run / "state" / "trainer_state.json") as f:
            assert json.load(f)["epoch"] == 1


def test_main_trains_with_fuse_steps_from_the_config(tiny, tmp_path, monkeypatch):
    """A config directory whose deep_sets.yaml sets ``trainer.fuse_steps``:
    ``train`` runs windows of up to 4 steps (on the CPU one after another),
    writes the JAX command line's ``config.yaml``, and trains the weights the
    unfused command trains, bit for bit."""
    from point_cloud_classifier_tpu_torch.models.wrapper import ModelWrapper

    fused_dir = tmp_path / "configs"
    shutil.copytree(tiny / "configs", fused_dir)
    cfg = load_config(str(fused_dir / "base.yaml"), str(fused_dir / "deep_sets.yaml"))
    cfg["trainer"]["fuse_steps"] = 4
    save_config({k: v for k, v in cfg.items() if k not in ("meta", "logging")}, str(fused_dir))
    os.replace(fused_dir / "config.yaml", fused_dir / "deep_sets.yaml")
    lengths = []
    original = ModelWrapper.train_window
    monkeypatch.setattr(ModelWrapper, "train_window",
                        lambda self, window: lengths.append(len(window)) or original(self, window))
    fused_args = _args(tiny, "deep_sets", tmp_path / "fused", "--epochs", "2", "--seed", "3")
    fused_args[fused_args.index("--config-dir") + 1] = str(fused_dir)
    cli.main(fused_args, device="cpu")
    assert max(lengths) == 4 and sum(lengths) == 2 * 5  # 36 events in batches of 8, 2 epochs
    lengths.clear()
    cli.main(_args(tiny, "deep_sets", tmp_path / "plain", "--epochs", "2", "--seed", "3"), device="cpu")
    assert set(lengths) == {1}

    run = tmp_path / "fused" / "version_0"
    want = jax_config.load_config(str(fused_dir / "base.yaml"), str(fused_dir / "deep_sets.yaml"))
    want["dataset"]["data_dir"] = str(tiny / "data")
    want["logging"]["log_dir"] = str(run)
    want["trainer"].update(epochs=2, seed=3)
    want["meta"].update(model_name="deep_sets", dataset_name="s2ppc")
    expected = jax_config.save_config(want, str(tmp_path / "jax"))
    with open(run / "config.yaml", "rb") as a, open(expected, "rb") as b:
        assert a.read() == b.read()
    assert "fuse_steps: 4" in (run / "config.yaml").read_text()
    fused = torch.load(run / "model.pt", weights_only=True)
    plain = torch.load(tmp_path / "plain" / "version_0" / "model.pt", weights_only=True)
    assert fused.keys() == plain.keys() and all(torch.equal(fused[k], plain[k]) for k in plain)


def test_convert_round_trip_through_main(tiny, tmp_path):
    cli.main(_args(tiny, "deep_sets", tmp_path / "log", "--epochs", "1"), device="cpu")
    run = tmp_path / "log" / "version_0"
    cfg = str(run / "config.yaml")
    cli.main(["convert", "deep_sets", str(run / "best_model.pt"), str(tmp_path / "ref.pt"), "--to-torch",
              "--config", cfg])
    cli.main(["convert", "deep_sets", str(tmp_path / "ref.pt"), str(tmp_path / "jax.pt"), "--config", cfg])
    cli.main(["convert", "deep_sets", str(tmp_path / "jax.pt"), str(tmp_path / "back.pt"), "--to-torch",
              "--config", cfg])
    best = torch.load(run / "best_model.pt", weights_only=True)
    for name in ("ref.pt", "back.pt"):
        again = torch.load(tmp_path / name, weights_only=True)
        assert list(again) == list(best)
        for key, value in best.items():
            assert torch.equal(again[key], value), (name, key)
    # the JAX package reads the converted pickle as its own checkpoint
    jax_cfg = copy.deepcopy(load_config(cfg))
    model = jax_train.get_model("deep_sets", jax_cfg)
    model.load(str(tmp_path / "jax.pt"))
    assert model.get_trainable_parameters() == sum(v.numel() for k, v in best.items() if "running" not in k)


@pytest.mark.parametrize("command", ["train-logistic_regression", "train-fully_connected_net", "evaluate",
                                     "infer", "resume"])
def test_main_without_a_device_raises_here(tiny, jax_runs, tmp_path, monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if command.startswith("train-"):
        argv = _args(tiny, command[len("train-"):], tmp_path / "log", "--epochs", "1")
    else:
        argv = [command, jax_runs["fully_connected_net"]]
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        cli.main(argv)

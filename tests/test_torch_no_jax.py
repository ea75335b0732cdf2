"""The port imports without jax, the JAX package, pandas, sklearn, PyYAML,
matplotlib, h5py or joblib, and runs without them (the kNN path, the
flagship wire, the command line, the C++ host packers and edge builder, the
sequential and vmapped sweeps, int8 evaluation and the serving export, dataset creation from raw HDF5
showers, raw-file inference and the HTTP scorer, the mesh and its rank spawner, and the mesh tests'
rank side, ``tests/torch_mesh_jobs.py``); chip_smoke.py refuses to run without a CUDA card or without
the repository beside it."""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "h5py", "pandas", "sklearn", "yaml", "matplotlib", "joblib",
           "point_cloud_classifier_tpu")


def _run(code_or_args, cwd=REPO, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_every_port_module_and_chip_smoke_import_without_jax():
    code = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        blocked = {BLOCKED!r}
        for name in list(sys.modules):
            if name.split(".")[0] in blocked:
                del sys.modules[name]
        for name in blocked:
            sys.modules[name] = None  # any import of it now raises ImportError
        import point_cloud_classifier_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        sys.path.insert(0, "tests")
        import torch_mesh_jobs
        print(len(names), "modules:", " ".join(names))
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 30
    walked = set(proc.stdout.split(":", 1)[1].split())
    graph_slice = {"data.graph", "models.graph_net", "ops.dispatch", "ops.gat", "ops.inrow_graph", "ops.knn",
                   "ops.segment", "data.batching", "data.synthetic", "convert", "factory"}
    pipelines = {"data.background", "data.prefetch", "data.resident"}
    command_line = {"cli", "__main__", "data.tabular", "models.fully_connected_net",
                    "models.logistic_regression", "utils.metrics"}
    host = {"native", "native.host"}
    sweep = {"sweep", "parallel", "parallel.vmap_sweep", "parallel.mesh", "parallel.ranks"}
    fused = {"utils.profiling", "models.windows"}
    serving = {"ops.quant", "serving"}
    raw_showers = {"data.h5lite", "data.hdf5", "data.module", "data.npz_io", "data.inference", "server"}
    assert {f"point_cloud_classifier_tpu_torch.{m}"
            for m in graph_slice | pipelines | command_line | host | sweep | fused | serving | raw_showers} <= walked


def test_chip_smoke_fails_without_cuda():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], cwd=tmp_path, env_extra={"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert "ModuleNotFoundError" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_fused_fit_trace_and_histograms_run_without_jax(tmp_path):
    """``fit`` with ``fuse_steps``, ``PCC_TRACE=1`` and histogram mode, and
    ``utils/profiling``'s ``StepTimer``, in a process where jax and the JAX
    package cannot be imported."""
    code = textwrap.dedent(
        f"""
        import os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        os.environ.update(PCC_TRACE="1", PCC_TENSORBOARD="1", PCC_TB_HISTOGRAMS="1")
        import numpy as np, torch
        from point_cloud_classifier_tpu_torch.data import PointCloudLoader
        from point_cloud_classifier_tpu_torch.models import DeepSets, ModelWrapper
        from point_cloud_classifier_tpu_torch.utils.profiling import StepTimer, maybe_trace
        rng = np.random.default_rng(0)
        events = [rng.normal(size=(int(n), 6)).astype(np.float32) for n in rng.integers(1, 20, size=24)]
        loader = PointCloudLoader(events, rng.integers(0, 2, size=24), 8, shuffle=False)
        net = DeepSets(6, [8, 8], [8], 1, "gelu", layer_norm=False, fused_phi="tail", pooling="mean",
                       generator=torch.Generator().manual_seed(0))
        ModelWrapper(net, 1e-3, 1, log_dir={str(tmp_path)!r}, fuse_steps=2, device="cpu").fit(loader)
        timer = StepTimer(8)
        with timer.step():
            pass
        print(sorted(os.listdir({str(tmp_path)!r})), timer.summary()["steps"])
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "'trace'" in proc.stdout and proc.stdout.split()[-1] == "1"
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path))


def test_knn_path_runs_without_jax():
    """The kNN GraphNet path end to end on the CPU in a process where jax and
    the JAX package cannot be imported: flat loader, model, one train step."""
    code = textwrap.dedent(
        f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import numpy as np, torch
        from point_cloud_classifier_tpu_torch.data import GraphLoader
        from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs
        from point_cloud_classifier_tpu_torch.models import GraphNet, ModelWrapper
        graphs = lineage_graphs(np.random.default_rng(0), 4, 12, 20)
        batch = next(iter(GraphLoader(graphs, 4, shuffle=False, layout="flat", seg_encoding="counts")))
        net = GraphNet(input_dim=4, hidden_dim=8, output_dim=1, activation="tanh", knn_k=3,
                       deepchem_style=True, generator=torch.Generator().manual_seed(0))
        loss = ModelWrapper(net, 1e-3, 1, device="cpu").train_step(batch)
        print(sorted(batch), float(loss))
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "node_seg_counts" in proc.stdout and np.isfinite(float(proc.stdout.split()[-1]))


def test_graph_slice_2_runs_without_jax():
    """GraphNet slice 2 on the CPU in a process where jax and the JAX package
    cannot be imported: a ``layout="auto"`` loader over graphs with a
    duplicate edge, an exact-zero weight and a node of 40 incoming edges
    (demoted, warned, or shipping triples), one train step of each new arm
    (flat GraphConv max and GAT, in-row SAG with GAT and with max, the
    edge-slot triples, the kNN edge-list arm) and a SAG checkpoint through
    ``convert`` both ways."""
    code = textwrap.dedent(
        f"""
        import sys, warnings
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import numpy as np, torch
        from point_cloud_classifier_tpu_torch import convert
        from point_cloud_classifier_tpu_torch.data import GraphLoader
        from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs
        from point_cloud_classifier_tpu_torch.models import GraphNet, ModelWrapper
        graphs = lineage_graphs(np.random.default_rng(0), 6, 42, 50, outliers=True)
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            flat = next(iter(GraphLoader(graphs, 3, False, layout="auto", dense_w_is_existence=True)))
            mixed = list(GraphLoader(graphs, 3, False, layout="auto", require_inrow=True))
        slots = next(iter(GraphLoader(graphs, 3, False, layout="auto")))
        inrow = next(iter(GraphLoader(graphs[1:4], 3, False, layout="auto")))
        arms = [(flat, dict(local_pooling="max")), (flat, dict(use_gat=True)),
                (inrow, dict(use_gat=True, sag_pool=True)), (mixed[1], dict(local_pooling="max", sag_pool=True)),
                (mixed[0], dict(local_pooling="max", sag_pool=True)), (slots, dict(local_pooling="mean")),
                (flat, dict(knn_k=3, use_gat=True))]
        losses = []
        for batch, arm in arms:
            cfg = dict(input_dim=4, hidden_dim=8, output_dim=1, activation="tanh", deepchem_style=True, **arm)
            net = GraphNet(**cfg, generator=torch.Generator().manual_seed(0))
            losses.append(float(ModelWrapper(net, 1e-3, 1, device="cpu").train_step(batch)))
            if arm.get("sag_pool"):
                params, stats = convert.convert_torch_state_dict("graph_net", {{"model": cfg}}, net.state_dict())
                back = convert.to_torch_state_dict("graph_net", {{"model": cfg}}, params, stats)
                assert all(np.array_equal(back[k], v.numpy()) for k, v in net.state_dict().items())
        wires = ["src" in flat, "src" in mixed[0], "in_src" in mixed[1], "edge_slot" in slots]
        print(len(warned), wires, all(np.isfinite(losses)))
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["2", "[True,", "True,", "True,", "True]", "True"]


def test_host_packers_and_edge_builder_run_without_jax():
    """The C++ packers build and fill every wire, and the C++ edge builder
    builds an event's edges equal to the numpy builder's, in a process where
    jax, the JAX package and sklearn cannot be imported."""
    code = textwrap.dedent(
        f"""
        import sys, warnings
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import numpy as np
        from point_cloud_classifier_tpu_torch.data import GraphLoader, PointCloudLoader
        from point_cloud_classifier_tpu_torch.data.graph import build_event_edges
        from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs
        from point_cloud_classifier_tpu_torch.native.host import build_event_edges_native, host_library
        rng = np.random.default_rng(0)
        events = [rng.normal(size=(int(n), 6)).astype(np.float32) for n in rng.integers(1, 30, 40)]
        labels = rng.integers(0, 2, size=40)
        keys = set()
        for layout in ("flat", "dense"):
            keys |= set(next(iter(PointCloudLoader(events, labels, 8, False, layout=layout, factor_event_cols=(1,)))))
        graphs = lineage_graphs(rng, 6, 12, 20)
        for kw in (dict(layout="flat"), dict(layout="dense", emit_out_rows=True), dict(layout="dense", adj_wire="host")):
            keys |= set(next(iter(GraphLoader(graphs, 3, False, **kw))))
        pids = np.array([1, 1, 2, 0]); times = np.array([0.5, 0.7, 1.0, 0.0]); steps = np.arange(4)
        parents = {{0: [], 1: [0], 2: [1]}}
        same = np.array_equal(build_event_edges_native(pids, times, steps, parents),
                              build_event_edges(pids, times, steps, parents))
        print(host_library().path.name.startswith("libpcc_host_"), same, " ".join(sorted(keys)))
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    words = proc.stdout.split()
    assert words[:2] == ["True", "True"]
    assert {"event_feats", "seg", "seg_counts", "src", "edge_mask", "out_pos", "in_w", "adj"} <= set(words[2:])


def test_flagship_wire_and_pipelines_run_without_jax():
    """bench.py's DeepSets wire (dense and flat batches, fp16, energy_total
    factored, length-sorted) through a resident cache, a background packer
    and the prefetch, two epochs of ``fit`` on the CPU in a process where jax
    and the JAX package cannot be imported."""
    code = textwrap.dedent(
        f"""
        import os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        os.environ["PCC_BG_LOADER"] = os.environ["PCC_PREFETCH"] = "1"
        import numpy as np, torch
        from point_cloud_classifier_tpu_torch.data import PointCloudLoader
        from point_cloud_classifier_tpu_torch.models import DeepSets, ModelWrapper
        rng = np.random.default_rng(0)
        events = [rng.normal(size=(int(n), 6)).astype(np.float32) for n in rng.integers(20, 25, 300)]
        events += [rng.normal(size=(int(n), 6)).astype(np.float32) for n in rng.integers(1, 60, 100)]
        labels = rng.integers(0, 2, size=len(events))
        loader = PointCloudLoader(events, labels, 128, True, layout="auto", transfer_dtype="float16",
                                  factor_event_cols=(1,), length_sorted=True)
        wires = sorted({{b["points"].ndim for b in loader}})
        net = DeepSets(6, [16, 16], [16], 1, "gelu", layer_norm=False, residual_block=True,
                       pooling="mean", factored_cols=(1,), generator=torch.Generator().manual_seed(0))
        wrapper = ModelWrapper(net, 1e-3, 2, device_resident=True, device="cpu")
        wrapper.fit(loader, loader)
        loss, acc = wrapper._evaluate(loader)
        print(wires, loss)
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "[2, 3]" in proc.stdout and np.isfinite(float(proc.stdout.split()[-1]))


def test_command_line_runs_without_jax_pandas_sklearn_or_yaml(tmp_path):
    """``train``, ``evaluate``, ``infer`` and ``convert`` through ``cli.main`` on
    the CPU for the tabular models and DeepSets, from the repository's
    configs, in a process where none of the blocked packages can be
    imported."""
    code = textwrap.dedent(
        f"""
        import json, os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        from point_cloud_classifier_tpu_torch.cli import main
        from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache, write_s2pt_cache
        work = {str(tmp_path)!r}
        write_s2pt_cache(os.path.join(work, "data"), n_events=(70, 30, 30), seed=2)
        write_s2ppc_cache(os.path.join(work, "data"), n_events=(20, 8, 8), min_points=3, max_points=12, seed=2)
        for model in ("logistic_regression", "fully_connected_net", "deep_sets"):
            log = os.path.join(work, model)
            main(["train", model, "--data-dir", os.path.join(work, "data"), "--log-dir", log,
                  "--epochs", "1"], device="cpu")
            run = os.path.join(log, "version_0")
            main(["evaluate", run], device="cpu")
            main(["infer", run], device="cpu")
            if model != "logistic_regression":
                main(["convert", model, os.path.join(run, "best_model.pt"), os.path.join(run, "x.pt"),
                      "--to-torch", "--config", os.path.join(run, "config.yaml")])
            with open(os.path.join(run, "eval", "metrics.json")) as f:
                print(model, json.load(f)["accuracy_test"])
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    printed = dict(line.split() for line in proc.stdout.splitlines() if line.split()[:1] in
                   (["logistic_regression"], ["fully_connected_net"], ["deep_sets"]))
    assert set(printed) == {"logistic_regression", "fully_connected_net", "deep_sets"}
    assert all(0.0 <= float(v) <= 1.0 for v in printed.values())


def test_sweeps_run_without_jax_pandas_sklearn_or_yaml(tmp_path):
    """``python -m point_cloud_classifier_tpu_torch.sweep``'s ``main``, one run
    at a time and vmapped, on the CPU from the repository's configs, in a
    process where none of the blocked packages can be imported."""
    code = textwrap.dedent(
        f"""
        import json, os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        from point_cloud_classifier_tpu_torch.sweep import main
        from point_cloud_classifier_tpu_torch.data.synthetic import write_s2pt_cache
        work = {str(tmp_path)!r}
        write_s2pt_cache(os.path.join(work, "data"), n_events=(70, 30, 30), seed=2)
        for flags in ([], ["--vmap"]):
            search = os.path.join(work, "search" + "".join(flags))
            main(["fully_connected_net", "--seed", "0", "--max-runs", "2", "--epochs", "1", "--force",
                  "--data-dir", os.path.join(work, "data"), "--search-dir", search, *flags], device="cpu")
            with open(os.path.join(search, "search_results.json")) as f:
                print("runs", len(json.load(f)))
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert [line for line in proc.stdout.splitlines() if line.startswith("runs")] == ["runs 2", "runs 2"]


def test_mesh_ranks_train_without_jax(tmp_path):
    """Two gloo ranks spawned (``parallel/ranks.run_ranks``) from a process
    where none of the blocked packages can be imported train a data-parallel
    FCN with BatchNorm (``tests/torch_mesh_jobs.py``) and import none of
    them themselves."""
    code = textwrap.dedent(
        f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, "tests")
        import numpy as np
        import torch
        import torch_mesh_jobs
        from point_cloud_classifier_tpu_torch.models import FullyConnectedNet
        from point_cloud_classifier_tpu_torch.parallel.ranks import run_ranks

        if __name__ == "__main__":
            rng = np.random.default_rng(0)
            batches = [{{"x": rng.normal(size=(8, 9)).astype(np.float32),
                        "y": rng.integers(0, 2, size=(8, 1)).astype(np.float32),
                        "y_mask": np.ones(8, np.float32)}} for _ in range(2)]
            kwargs = dict(input_dim=9, hidden_layers=[8], batch_normalization=True, output_dim=1)
            state = {{k: v.numpy() for k, v in FullyConnectedNet(**kwargs).state_dict().items()}}
            case = dict(family="fully_connected_net", kwargs=kwargs, state=state, train=batches,
                        predict=batches, epochs=1, log_root={str(tmp_path)!r})
            print("loaded", run_ranks(torch_mesh_jobs.loaded_after_fit, 2, {{"fcn": case}}, {BLOCKED!r}))
        """
    )
    script = tmp_path / "mesh_ranks.py"
    script.write_text(code)
    proc = _run([str(script)], env_extra={"PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert "loaded [[], []]" in proc.stdout


def test_int8_evaluation_and_export_run_without_jax(tmp_path):
    """``evaluate --quant int8``, ``export`` (float and int8) and
    ``ExportedModel`` on the CPU, in a process where none of the blocked
    packages can be imported: ``ops/quant.py`` and ``serving.py`` need only
    torch and numpy."""
    code = textwrap.dedent(
        f"""
        import json, os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import numpy as np
        from point_cloud_classifier_tpu_torch import factory
        from point_cloud_classifier_tpu_torch.cli import main
        from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache
        from point_cloud_classifier_tpu_torch.serving import ExportedModel
        from point_cloud_classifier_tpu_torch.utils.config import load_config
        work = {str(tmp_path)!r}
        data = os.path.join(work, "data")
        write_s2ppc_cache(data, n_events=(20, 8, 8), min_points=3, max_points=12, seed=2)
        main(["train", "deep_sets", "--data-dir", data, "--log-dir", os.path.join(work, "log"), "--epochs", "1"],
             device="cpu")
        run = os.path.join(work, "log", "version_0")
        main(["evaluate", run, "--quant", "int8"], device="cpu")
        with open(os.path.join(run, "eval_int8", "metrics.json")) as f:
            print("quant", json.load(f)["quant"])
        for quant in ("none", "int8"):
            out = os.path.join(work, "exported_" + quant)
            main(["export", run, "--out-dir", out, "--quant", quant], device="cpu")
            config = load_config(os.path.join(run, "config.yaml"))
            factory.apply_quant(config, "deep_sets", quant)
            batches = list(factory.get_dataloader("s2ppc", config).get_test_loader())
            _, ref = factory.get_model("deep_sets", config, run, device="cpu").predict(iter(batches), True)
            _, got = ExportedModel(out, device="cpu").predict(iter(batches), True)
            print("served", quant, float(np.abs(got - ref).max()))
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    lines = [line.split() for line in proc.stdout.splitlines() if line.split()[:1] in (["quant"], ["served"])]
    assert lines[0] == ["quant", "int8"]
    assert [line[:2] for line in lines[1:]] == [["served", "none"], ["served", "int8"]]
    assert float(lines[1][2]) <= 1e-5 and float(lines[2][2]) <= 1e-6


def test_dataset_creation_raw_inference_and_serving_run_without_jax(tmp_path):
    """``create-datasets`` (two workers), ``train --create-dataset``,
    ``infer-raw`` and a request served over HTTP, on the CPU, in a process
    where none of the blocked packages (h5py, pandas, sklearn and joblib
    among them) can be imported: the HDF5 reader and writer, the split, the
    scaler and its pickle are the port's own."""
    code = textwrap.dedent(
        f"""
        import json, os, sys, threading, urllib.request
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        from point_cloud_classifier_tpu_torch.cli import main
        from point_cloud_classifier_tpu_torch.data.synthetic import write_synthetic_dataset
        from point_cloud_classifier_tpu_torch.server import make_server
        work = {str(tmp_path)!r}
        data = write_synthetic_dataset(os.path.join(work, "data"), n_events_per_file=20, seed=2)
        main(["create-datasets", "--data-dir", data, "--datasets", "s2pt", "s2pg", "--workers", "2"], device="cpu")
        main(["train", "deep_sets", "--data-dir", data, "--log-dir", os.path.join(work, "log"), "--epochs", "1",
              "--create-dataset"], device="cpu")
        run = os.path.join(work, "log", "version_0")
        raw = os.path.join(data, "piM_file0.h5")
        main(["infer-raw", run, "--input", raw, "--output", os.path.join(work, "p.csv")], device="cpu")
        server = make_server(run, port=0, device="cpu")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        with open(raw, "rb") as f:
            req = urllib.request.Request(f"http://127.0.0.1:{{server.server_address[1]}}/predict", data=f.read())
        with urllib.request.urlopen(req, timeout=120) as r:
            served = json.loads(r.read())["predictions"]
        server.shutdown()
        with open(os.path.join(work, "p.csv")) as f:
            rows = f.read().split()[1:]
        print("rows", len(rows), "served", len(served), sorted(os.listdir(data)))
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    line = next(line for line in proc.stdout.splitlines() if line.startswith("rows"))
    assert line.startswith("rows 20 served 20 ['S2PG', 'S2PPC', 'S2PT', 'piM_file0.h5', 'proton_file0.h5']"), line

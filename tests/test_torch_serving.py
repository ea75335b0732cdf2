"""The port's serving export (``serving.py``, ``cli export``) on the CPU:
``torch.export`` programs, one a bucketed batch shape, served by
``ExportedModel`` against ``ModelWrapper.predict`` for DeepSets (float and
int8), the FCN and GraphNet (in-row GAT, GraphConv, kNN); the manifest; the
shape key against the JAX package's; and a run trained by the JAX package
exported by both packages.
"""

import json
import os
import operator

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

import train as jax_train  # noqa: E402
from point_cloud_classifier_tpu import serving as jax_serving  # noqa: E402
from point_cloud_classifier_tpu.utils import config as jax_config  # noqa: E402
from point_cloud_classifier_tpu_torch import cli, factory, serving  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import (  # noqa: E402
    write_s2pg_cache,
    write_s2ppc_cache,
    write_s2pt_cache,
)
from point_cloud_classifier_tpu_torch.ops import fused_phi  # noqa: E402
from point_cloud_classifier_tpu_torch.train import train_model  # noqa: E402
from point_cloud_classifier_tpu_torch.utils.config import load_config  # noqa: E402

# ExportedModel against wrapper.predict on the same route: the same ATen
# operations in the same order (the float DeepSets export runs fused_phi
# "off", the wrapper's CPU route phi_pool's plain version: f32 sums in
# another grouping)
FLOAT_TOL = 1e-5
# the int8 export against the int8 predict: the same codes and exact s32 sums
INT8_TOL = 1e-6
# the int8 export against the float predict: JAX tests/test_quant.py's band
INT8_FLOAT_BAND = 0.05

RUNS = {
    "deep_sets": ("s2ppc", {"input_dim": 6, "phi_layers": [16, 16], "rho_layers": [16], "output_dim": 1,
                            "pooling": "mean", "layer_norm": False, "activation": "gelu",
                            "residual_block": True}, {"batch_size": 8}),
    "fully_connected_net": ("s2pt", {"input_dim": 9, "hidden_layers": [8, 8], "output_dim": 1,
                                     "batch_normalization": True}, {"batch_size": 16, "convert_to_tensor": True}),
    "gat": ("s2pg", {"input_dim": 4, "hidden_dim": 16, "output_dim": 1, "activation": "tanh", "use_gat": True,
                     "gat_heads": 4, "deepchem_style": True}, {"batch_size": 8, "use_weights": False,
                                                               "n_features": 4}),
    "graphconv": ("s2pg", {"input_dim": 4, "hidden_dim": 16, "output_dim": 1, "activation": "tanh",
                           "deepchem_style": True}, {"batch_size": 8, "use_weights": False, "n_features": 4}),
    "knn": ("s2pg", {"input_dim": 4, "hidden_dim": 16, "output_dim": 1, "activation": "tanh", "knn_k": 4,
                     "deepchem_style": True}, {"batch_size": 8, "use_weights": False, "n_features": 4}),
}
MODEL_NAMES = {"deep_sets": "deep_sets", "fully_connected_net": "fully_connected_net", "gat": "graph_net",
               "graphconv": "graph_net", "knn": "graph_net"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    d = str(root / "data")
    write_s2pt_cache(d, n_events=(64, 32, 40), seed=3)
    write_s2ppc_cache(d, n_events=(32, 16, 21), min_points=3, max_points=90, seed=3)
    write_s2pg_cache(d, n_graphs=(16, 8, 12), min_nodes=10, max_nodes=24, seed=3)
    return root


def _config(data, name):
    dataset, model, ds = RUNS[name]
    return dataset, {"meta": {"model_name": "", "dataset_name": ""},
                     "dataset": {"data_dir": str(data / "data"), **ds},
                     "logging": {"log_dir": str(data / "log" / name)},
                     "model": dict(model),
                     "trainer": {"epochs": 1, "learning_rate": 0.001}}


@pytest.fixture(scope="module")
def runs(data):
    """A port run directory per entry of ``RUNS``, one epoch each."""
    out = {}
    for name in RUNS:
        dataset, cfg = _config(data, name)
        out[name] = train_model(MODEL_NAMES[name], dataset, cfg, return_log_dir=True, device="cpu")
    return out


def _wrapper_and_batches(run, quant="none"):
    config = load_config(os.path.join(run, "config.yaml"))
    model_name = config["meta"]["model_name"]
    factory.apply_quant(config, model_name, quant)
    wrapper = factory.get_model(model_name, config, model_dir=run, device="cpu")
    loader = factory.get_dataloader(config["meta"]["dataset_name"], config).get_test_loader()
    return wrapper, list(loader)


@pytest.fixture(scope="module")
def exports(runs, tmp_path_factory):
    """Each run exported for the CPU by ``export_run``."""
    root = tmp_path_factory.mktemp("exports")
    return {name: serving.export_run(run, out_dir=str(root / name), device="cpu") for name, run in runs.items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_exported_model_matches_wrapper_predict(runs, exports, name):
    run, out = runs[name], exports[name]
    wrapper, batches = _wrapper_and_batches(run)
    y_ref, p_ref = wrapper.predict(iter(batches), return_prob=True)
    served = serving.ExportedModel(out, device="cpu")
    before = fused_phi.phi_pool.launches
    y_srv, p_srv = served.predict(iter(batches), return_prob=True)
    assert fused_phi.phi_pool.launches == before
    np.testing.assert_array_equal(y_srv, y_ref)
    assert p_srv.shape == p_ref.shape and p_srv.dtype == np.float32
    np.testing.assert_allclose(p_srv, p_ref, rtol=0, atol=FLOAT_TOL)
    _, d_srv = served.predict(iter(batches))
    np.testing.assert_array_equal(d_srv, (p_ref >= 0.5).astype(np.float32))
    # one artifact per distinct shape of the test loader, each loaded once
    assert len(served.manifest["artifacts"]) == len({serving._shape_key(b) for b in batches})
    assert set(served._loaded) == set(served.manifest["artifacts"])


def test_int8_export_matches_the_int8_predict(runs, tmp_path):
    run = runs["deep_sets"]
    out = serving.export_run(run, out_dir=str(tmp_path / "q"), quant="int8", device="cpu")
    qwrapper, batches = _wrapper_and_batches(run, "int8")
    fwrapper, _ = _wrapper_and_batches(run)
    assert qwrapper.model.quant == "int8"
    assert len({serving._shape_key(b) for b in batches}) >= 2  # one program each
    _, p_q = qwrapper.predict(iter(batches), return_prob=True)
    _, p_f = fwrapper.predict(iter(batches), return_prob=True)
    _, p_srv = serving.ExportedModel(out, device="cpu").predict(iter(batches), return_prob=True)
    np.testing.assert_allclose(p_srv, p_q, rtol=0, atol=INT8_TOL)
    np.testing.assert_allclose(p_srv, p_f, rtol=0, atol=INT8_FLOAT_BAND)
    assert not np.array_equal(p_q, p_f)
    manifest = json.load(open(os.path.join(out, serving.MANIFEST)))
    assert manifest["quant"] == "int8"
    # the s8 product is in the program
    program = torch.export.load(os.path.join(out, next(iter(manifest["artifacts"].values()))))
    assert any(n.target is torch.ops.aten._int_mm.default for n in program.graph.nodes)


def test_manifest_fields(runs, tmp_path):
    run = runs["gat"]
    out = serving.export_run(run, out_dir=str(tmp_path / "m"), platforms=("cpu", "cuda"), device="cpu")
    manifest = json.load(open(os.path.join(out, serving.MANIFEST)))
    assert list(manifest) == ["model", "dataset", "quant", "torch_version", "platforms", "artifacts"]
    assert manifest["model"] == "graph_net" and manifest["dataset"] == "s2pg" and manifest["quant"] == "none"
    assert manifest["torch_version"] == torch.__version__ and manifest["platforms"] == ["cpu", "cuda"]
    assert sorted(manifest["artifacts"].values()) == [f"shape_{i}.pt2" for i in range(len(manifest["artifacts"]))]
    assert sorted(os.listdir(out)) == sorted([serving.MANIFEST, *manifest["artifacts"].values()])
    # the default: the run's device; quant "auto" resolves to float at these widths
    out = serving.export_run(run, out_dir=str(tmp_path / "d"), quant="auto", device="cpu")
    manifest = json.load(open(os.path.join(out, serving.MANIFEST)))
    assert manifest["platforms"] == ["cpu"] and manifest["quant"] == "none"
    with pytest.raises(ValueError, match="platforms"):
        serving.export_run(run, out_dir=str(tmp_path / "t"), platforms=("tpu",), device="cpu")


@pytest.mark.parametrize("name", list(RUNS))
def test_exported_graph_holds_aten_operations_only(exports, name):
    """No binding of the port's CUDA library and no CUDA device inside the
    programs: every call is an ATen operation (or a tuple index)."""
    out = exports[name]
    manifest = json.load(open(os.path.join(out, serving.MANIFEST)))
    for fname in manifest["artifacts"].values():
        program = torch.export.load(os.path.join(out, fname))
        calls = [n for n in program.graph.nodes if n.op == "call_function"]
        assert calls
        for node in calls:
            target = node.target
            assert target is operator.getitem or (
                isinstance(target, torch._ops.OpOverload) and target.namespace == "aten"
            ), target
            assert "cuda" not in str(node.kwargs.get("device", "")), node
        for t in [*program.state_dict.values(), *program.constants.values()]:
            assert not isinstance(t, torch.Tensor) or t.device.type == "cpu"


def test_knn_program_takes_the_arrays_the_model_reads(runs, exports):
    """A kNN GraphNet drops the loader's edge arrays: its programs take the
    rest, and the shape key is still taken over the whole batch."""
    served = serving.ExportedModel(exports["knn"], device="cpu")
    _, batches = _wrapper_and_batches(runs["knn"])
    served(batches[0])
    (key, program), = served._loaded.items()
    assert key == serving._shape_key(batches[0]) and "src" in key
    assert sorted(program.keys) == sorted(set(batches[0]) - {"src", "dst", "edge_w", "edge_mask"})


def test_unknown_shape_raises_key_error(runs, exports):
    served = serving.ExportedModel(exports["deep_sets"], device="cpu")
    _, batches = _wrapper_and_batches(runs["deep_sets"])
    bad = {k: np.asarray(v)[:1] if np.ndim(v) else v for k, v in batches[0].items()}
    with pytest.raises(KeyError, match="no exported artifact for batch shape"):
        served(bad)


def test_device_rules(runs, exports, tmp_path):
    """The card unless the caller asks for the CPU, and only a device the
    manifest lists."""
    out = exports["deep_sets"]
    with pytest.raises(ValueError, match="exported for"):
        serving.ExportedModel(out, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.ExportedModel(out)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.export_run(runs["deep_sets"], out_dir=str(tmp_path / "s"))


def test_logistic_regression_is_refused(data, tmp_path):
    _, cfg = _config(data, "fully_connected_net")
    cfg.update(model={}, dataset={"data_dir": cfg["dataset"]["data_dir"]})
    cfg["logging"]["log_dir"] = str(tmp_path / "log")
    run = train_model("logistic_regression", "s2pt", cfg, return_log_dir=True, device="cpu")
    with pytest.raises(ValueError, match="closed-form scorer"):
        serving.export_run(run, device="cpu")


def test_quant_on_another_model_is_refused(runs):
    wrapper, _ = _wrapper_and_batches(runs["gat"])
    with pytest.raises(ValueError, match="only supported for DeepSets"):
        serving._eval_fn(wrapper, quant="int8")
    with pytest.raises(ValueError, match="only supported for DeepSets"):
        serving.export_run(runs["gat"], quant="int8", device="cpu")


def test_cli_export(runs, tmp_path, capsys):
    out_dir = str(tmp_path / "cli")
    cli.main(["export", runs["deep_sets"], "--out-dir", out_dir, "--quant", "int8", "--platforms", "cpu", "cuda"],
             device="cpu")
    assert f"Exported serving artifacts to {out_dir}" in capsys.readouterr().out
    manifest = json.load(open(os.path.join(out_dir, serving.MANIFEST)))
    assert manifest["quant"] == "int8" and manifest["platforms"] == ["cpu", "cuda"]
    cli.main(["export", runs["fully_connected_net"]], device="cpu")
    assert os.path.exists(os.path.join(runs["fully_connected_net"], "exported", serving.MANIFEST))


def test_shape_key_matches_jax(runs):
    """The same string as the JAX package's for the same numpy batches, on
    every wire these runs' loaders emit, in any key order."""
    for name in RUNS:
        _, batches = _wrapper_and_batches(runs[name])
        for batch in batches:
            assert serving._shape_key(batch) == jax_serving._shape_key(batch)
            assert serving._shape_key(dict(reversed(list(batch.items())))) == serving._shape_key(batch)
    mixed = {"x": np.zeros((2, 3), np.float16), "y": [1, 2], "n": np.int16(3)}
    assert serving._shape_key(mixed) == jax_serving._shape_key(mixed)


@pytest.fixture(scope="module")
def jax_run(data):
    """A DeepSets run trained by the JAX package, on the same cache."""
    cfg = jax_config.load_config("configs/base.yaml", "configs/deep_sets.yaml")
    cfg["model"].update(phi_layers=[16, 16], rho_layers=[16])
    cfg["dataset"].update(data_dir=str(data / "data"), batch_size=8)
    cfg["logging"]["log_dir"] = str(data / "jax_log")
    cfg["trainer"]["epochs"] = 1
    return jax_train.train_model("deep_sets", "s2ppc", cfg, return_log_dir=True)


@pytest.mark.parametrize("quant", ["int8"])
def test_both_packages_export_one_run_alike(jax_run, tmp_path, quant):
    """The JAX package's export and the port's of the same JAX-trained run:
    the same manifest keys and artifact shapes, and probabilities within
    1e-5 (int8: the same codes and s32 sums, f32 rounding apart)."""
    ours = serving.export_run(jax_run, out_dir=str(tmp_path / "port"), quant=quant, device="cpu")
    theirs = jax_serving.export_run(jax_run, out_dir=str(tmp_path / "jax"), quant=quant)
    m_ours = json.load(open(os.path.join(ours, serving.MANIFEST)))
    m_theirs = json.load(open(os.path.join(theirs, serving.MANIFEST)))
    assert set(m_ours) - {"torch_version"} == set(m_theirs) - {"jax_version"}
    assert set(m_ours["artifacts"]) == set(m_theirs["artifacts"])
    assert m_ours["quant"] == m_theirs["quant"] == quant
    config = load_config(os.path.join(jax_run, "config.yaml"))
    batches = list(factory.get_dataloader("s2ppc", config).get_test_loader())
    y1, p1 = serving.ExportedModel(ours, device="cpu").predict(iter(batches), return_prob=True)
    y2, p2 = jax_serving.ExportedModel(theirs).predict(iter(batches), return_prob=True)
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_allclose(p1, p2, rtol=0, atol=FLOAT_TOL)

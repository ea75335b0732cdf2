"""The port's HTTP scoring endpoint (``server.py``) on the CPU, as
``tests/test_server.py`` holds the JAX server: the real ``ThreadingHTTPServer``
on a free port, driven with urllib over a DeepSets run whose cache the port
built from raw files: ``/health``, ``/predict`` against ``infer_raw``, 404 for
other paths, 400 for garbage, a truncated file, a file without the schema and
a bad ``Content-Length``, 500 for a fault of the server and for a run whose
scaler is missing, and ``quant_active`` reporting the int8 fallback of a
layer-norm DeepSets."""

import contextlib
import io
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from point_cloud_classifier_tpu_torch import convert, factory
from point_cloud_classifier_tpu_torch import server as server_mod
from point_cloud_classifier_tpu_torch import train as port_train
from point_cloud_classifier_tpu_torch.data.h5lite import write_h5
from point_cloud_classifier_tpu_torch.data.pointcloud import Step2PointPointCloud
from point_cloud_classifier_tpu_torch.data.synthetic import write_shower_file, write_synthetic_dataset
from point_cloud_classifier_tpu_torch.server import Scorer, make_server
from point_cloud_classifier_tpu_torch.utils.config import load_config, save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_dir(root, data_dir):
    """A DeepSets run directory (narrow widths, seeded weights, the JAX
    checkpoint format) over ``data_dir``."""
    cfg = load_config(os.path.join(REPO, "configs", "base.yaml"), os.path.join(REPO, "configs", "deep_sets.yaml"))
    cfg["dataset"]["data_dir"] = data_dir
    cfg["model"].update(phi_layers=[16, 16], rho_layers=[16])
    cfg["meta"].update(model_name="deep_sets", dataset_name="s2ppc")
    cfg["logging"]["log_dir"] = root
    save_config(cfg, root)
    wrapper = factory.get_model("deep_sets", cfg, device="cpu")
    torch.save(wrapper.model.state_dict(), os.path.join(root, "state.pt"))
    convert.convert_checkpoint("deep_sets", cfg, os.path.join(root, "state.pt"), os.path.join(root, "best_model.pt"))
    return root


def _start(run_dir):
    server = make_server(run_dir, port=0, device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("server")
    data = write_synthetic_dataset(str(root / "data"), n_events_per_file=30, seed=31)
    with contextlib.redirect_stdout(io.StringIO()):
        Step2PointPointCloud(data_dir=data, create_dataset=True, energy_cutoff=0.015)
    raw = str(root / "serve.h5")
    write_shower_file(raw, "piM", n_events=10, seed=99)
    run_dir = _run_dir(str(root / "run"), data)
    server, url = _start(run_dir)
    yield url, run_dir, raw
    server.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, data, headers=None):
    req = urllib.request.Request(url, data=data, method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _status(fn, *args, **kwargs):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*args, **kwargs)
    body = json.loads(e.value.read())
    assert "error" in body
    return e.value.code, body["error"]


def test_health(served):
    url, _, _ = served
    status, body = _get(url + "/health")
    assert status == 200
    assert body == {"status": "ok", "model": "deep_sets", "dataset": "s2ppc", "quant": "none"}


def test_predict_matches_infer_raw(served, tmp_path):
    url, run_dir, raw = served
    with open(raw, "rb") as f:
        status, body = _post(url + "/predict", f.read())
    assert status == 200
    preds = body["predictions"]
    assert len(preds) == 10
    with contextlib.redirect_stdout(io.StringIO()):
        csv = port_train.infer_raw(run_dir, raw, output=str(tmp_path / "p.csv"), device="cpu")
    with open(csv) as f:
        rows = f.read().strip().split("\n")[1:]
    ref = {int(r.split(",")[0]): float(r.split(",")[1]) for r in rows}
    assert sorted(ref) == sorted(p["event_id"] for p in preds) == list(range(10))
    for p in preds:
        assert p["prediction"] == int(p["probability"] >= 0.5)
        np.testing.assert_allclose(p["probability"], ref[p["event_id"]], atol=1e-6)


def test_unknown_route_404(served):
    url, _, _ = served
    assert _status(_get, url + "/nope")[0] == 404
    assert _status(_post, url + "/score", b"x")[0] == 404


def test_garbage_body_400(served, tmp_path):
    """Garbage, a truncated file and a file without the shower schema are
    the client's fault, and so is a bad ``Content-Length``."""
    url, _, raw = served
    code, error = _status(_post, url + "/predict", b"this is not an hdf5 file")
    assert code == 400 and "not an HDF5 file" in error
    with open(raw, "rb") as f:
        blob = f.read()
    code, error = _status(_post, url + "/predict", blob[: len(blob) // 2])
    assert code == 400 and "truncated file" in error
    write_h5(str(tmp_path / "other.h5"), {"steps/energy": np.zeros(3)})
    with open(tmp_path / "other.h5", "rb") as f:
        code, error = _status(_post, url + "/predict", f.read())
    assert code == 400 and error.startswith("KeyError")
    assert _status(_post, url + "/predict", b"x", headers={"Content-Length": "0"})[0] == 400


def test_server_fault_500(served, monkeypatch):
    """A failure that is not the input's (a backend fault) is a 500."""
    url, _, _ = served

    def boom(self, data):
        raise RuntimeError("backend exploded")

    monkeypatch.setattr(server_mod.Scorer, "score_bytes", boom)
    code, error = _status(_post, url + "/predict", b"whatever")
    assert code == 500 and "RuntimeError" in error


def test_missing_scaler_500(served, tmp_path):
    """A run whose data directory lost its scaler: ``FileNotFoundError``, an
    ``OSError`` that the server still counts as its own fault."""
    _, run_dir, raw = served
    cfg = load_config(os.path.join(run_dir, "config.yaml"))
    data = shutil.copytree(cfg["dataset"]["data_dir"], str(tmp_path / "data"))
    os.remove(os.path.join(data, "S2PPC", "S2PPC_scaler.pkl"))
    run = shutil.copytree(run_dir, str(tmp_path / "run"))
    cfg["dataset"]["data_dir"] = data
    save_config(cfg, run)
    server, url = _start(run)
    try:
        with open(raw, "rb") as f:
            code, error = _status(_post, url + "/predict", f.read())
        assert code == 500 and error.startswith("FileNotFoundError")
    finally:
        server.shutdown()


def test_quant_active_reports_fallback(served):
    """/health reports the quantization that runs: a layer-norm DeepSets
    asked for int8 stays float."""
    _, run_dir, _ = served
    scorer = Scorer(run_dir, quant="int8", device="cpu")
    assert scorer.quant_active() == "int8"
    scorer.model.model.layer_norm = True
    assert scorer.quant_active() == "none"
    assert Scorer(run_dir, quant="auto", device="cpu").quant_active() == "none"  # narrow φ stays float

"""``scripts/measure_parity_torch.py``, the port's arm of the accuracy-parity
measurement, end to end at a small size on the CPU: caches built by the JAX
pipeline, the JAX package and the port trained on them with one seed for one
epoch, val accuracies and Δ reported for the logistic regression and
DeepSets."""

import json
import os
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import measure_parity_torch  # noqa: E402


def test_parity_arm_reports_both_sides(tmp_path, capsys):
    results = measure_parity_torch.measure(
        ["logistic_regression", "deep_sets"], events=40, repeats=1, epochs=1, work=str(tmp_path))
    printed = capsys.readouterr().out
    assert set(results) == {"logistic_regression", "deep_sets"}
    for model, r in results.items():
        assert r["events_per_file"] == 40 and r["seeds"] == 1
        assert len(r["jax_runs"]) == len(r["port_runs"]) == 1
        for acc in (r["jax_val_acc"], r["port_val_acc"]):
            assert 0.0 <= acc <= 1.0
        assert r["delta"] == pytest.approx(r["port_val_acc"] - r["jax_val_acc"])
        assert f"{model}: JAX {r['jax_val_acc']:.4f}" in printed and "(CPU)" in printed
    # the logistic regression is a convex solve: the port's L-BFGS lands on
    # the JAX fit's coefficients (docs/parity_torch.md §7), so the same val
    # predictions
    assert results["logistic_regression"]["delta"] == 0.0
    # both sides wrote their runs under the work directory
    runs = os.listdir(tmp_path / "runs")
    assert any(r.startswith("port_deep_sets_0") for r in runs)
    assert any(r.startswith("ours_deep_sets_0") for r in runs)


def test_parity_arm_command_line_writes_json(tmp_path, monkeypatch):
    monkeypatch.setattr(measure_parity_torch, "measure", lambda *a: {"deep_sets": {"args": list(a)}})
    out = tmp_path / "r.json"
    measure_parity_torch.main(["--models", "deep_sets", "--events", "40", "--repeats", "1",
                               "--epochs", "1", "--json", str(out)])
    assert json.loads(out.read_text()) == {"deep_sets": {"args": [["deep_sets"], 40, 1, 1]}}
    assert measure_parity_torch.SETUPS == {"logistic_regression": (200, 3), "fully_connected_net": (200, 3),
                                           "deep_sets": (200, 3), "graph_net": (400, 5)}

"""The port's EDA (``point_cloud_classifier_tpu_torch/eda.py``) against the
JAX package's ``eda.py``, on the CPU, over the seeded synthetic showers that
``tests/test_eda.py`` uses: both JSON files with the same keys in the same
order and the same numbers (1e-12 relative), every figure pixel for pixel,
the pairplot skipped without an S2PT cache; the numpy group-bys against
pandas on larger draws; and the JSON files alone without matplotlib."""

import json
import os
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

pytest.importorskip("torch")

import eda as jax_eda  # noqa: E402
from point_cloud_classifier_tpu.data import Step2PointTabular  # noqa: E402
from point_cloud_classifier_tpu.data.synthetic import write_synthetic_dataset  # noqa: E402
from point_cloud_classifier_tpu_torch import eda  # noqa: E402

RTOL = 1e-12
FIGURES = ("energy_distribution.png", "shower_3d.png", "correlation_matrix.png")


def _same_tree(ours, theirs, path="") -> None:
    """Equal keys in equal order, equal ints, floats within RTOL."""
    if isinstance(theirs, dict):
        assert list(ours) == list(theirs), path
        for key in theirs:
            _same_tree(ours[key], theirs[key], f"{path}/{key}")
    else:
        assert type(ours) is type(theirs), path
        if isinstance(theirs, float):
            np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=0, err_msg=path)
        else:
            assert ours == theirs, path


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's EDA over the showers without a cache, then both scripts'
    with one (the JSON files and the first three figures do not depend on
    the cache: ``tests/test_eda.py`` runs the JAX script without one)."""
    root = tmp_path_factory.mktemp("eda")
    data = str(root / "data")
    write_synthetic_dataset(data, n_events_per_file=20, seed=5)
    out = {"bare": {"port": str(root / "bare" / "port")}, "cached": {}}
    eda.run_eda(data, out["bare"]["port"], sample=30)
    Step2PointTabular(data, create_dataset=True)
    for side, script in (("port", eda), ("jax", jax_eda)):
        out["cached"][side] = str(root / "cached" / side)
        script.run_eda(data, out["cached"][side], sample=30)
    return out


@pytest.mark.parametrize("name", ["summary_stats.json", "missing_values.json"])
@pytest.mark.parametrize("label", ["bare", "cached"])
def test_json_files_equal_the_jax_files(runs, label, name):
    ours = _json(os.path.join(runs[label]["port"], name))
    theirs = _json(os.path.join(runs["cached"]["jax"], name))
    _same_tree(ours, theirs)
    if name == "missing_values.json":
        assert all(v == 0 for counts in ours.values() for v in counts.values())
    else:
        assert ours["n_events"] == {"proton": 20, "piM": 20}


@pytest.mark.parametrize("name", [*FIGURES, "plot.png", "pairplot.png"])
def test_figures_equal_the_jax_figures(runs, name):
    ours, theirs = (mpimg.imread(os.path.join(runs["cached"][side], name)) for side in ("port", "jax"))
    np.testing.assert_array_equal(ours, theirs)


def test_without_a_cache_the_cache_figures_are_skipped(runs):
    want = sorted(["summary_stats.json", "missing_values.json", *FIGURES])
    assert sorted(os.listdir(runs["bare"]["port"])) == want
    assert sorted(os.listdir(runs["cached"]["port"])) == sorted(os.listdir(runs["cached"]["jax"])) == sorted(
        want + ["plot.png", "pairplot.png"])
    for name in FIGURES:
        np.testing.assert_array_equal(mpimg.imread(os.path.join(runs["bare"]["port"], name)),
                                      mpimg.imread(os.path.join(runs["cached"]["port"], name)))


@pytest.mark.parametrize("seed", [0, 1])
def test_event_table_and_correlation_equal_pandas(seed):
    """The per-event columns and the correlation against pandas' group-bys
    and ``DataFrame.corr()`` exactly, over unsorted event ids with steps of
    widely spread energies."""
    rng = np.random.default_rng(seed)
    n = 20_000
    raw = {"event_id": rng.integers(0, 400, n), "energy": (rng.random(n) ** 6 * 500).astype(np.float32),
           "time": (rng.random(n) * 80).astype(np.float32), "mcparticle_id": rng.integers(0, 30, n)}
    ours = eda.event_level(raw, "proton")
    theirs = jax_eda._event_level(raw, "proton")
    for col in ["event_id", *eda.EVENT_COLS]:
        assert ours[col].dtype == theirs[col].dtype, col
        np.testing.assert_array_equal(ours[col], theirs[col].to_numpy(), err_msg=col)
    np.testing.assert_array_equal(eda.correlation(np.stack([ours[c] for c in eda.EVENT_COLS], axis=1)),
                                  theirs[eda.EVENT_COLS].corr().to_numpy())


def test_summary_counts_ties_and_order_follow_pandas(tmp_path):
    """``n_events`` largest first (ties in order of appearance),
    ``by_particle`` sorted, on an uneven table."""
    rng = np.random.default_rng(2)
    particle = np.array(["proton"] * 7 + ["piM"] * 9 + ["kaon"] * 7)
    events = {"particle": particle, "total_energy": rng.random(23).astype(np.float32),
              "n_steps": rng.integers(1, 50, 23), "n_particles": rng.integers(1, 9, 23),
              "elapsed_time": rng.random(23)}
    eda.summary_stats(events, str(tmp_path))
    ours = _json(tmp_path / "summary_stats.json")
    theirs = jax_eda.summary_stats(pd.DataFrame(events), str(tmp_path))
    _same_tree(ours, json.loads(json.dumps(theirs, default=float)))
    assert list(ours["n_events"]) == ["piM", "proton", "kaon"]


def test_without_matplotlib_only_the_json_files(runs, tmp_path, monkeypatch, capsys):
    data = os.path.join(os.path.dirname(os.path.dirname(runs["cached"]["port"])), "data")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    eda.main(["--data-dir", data, "--out-dir", str(tmp_path / "out")])
    assert sorted(os.listdir(tmp_path / "out")) == ["missing_values.json", "summary_stats.json"]
    assert "matplotlib is not installed" in capsys.readouterr().out
    _same_tree(_json(tmp_path / "out" / "summary_stats.json"),
               _json(os.path.join(runs["cached"]["jax"], "summary_stats.json")))

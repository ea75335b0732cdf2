"""The port's evaluation plots against the JAX package's, on the CPU.

``utils/metrics.py``'s five curve functions against ``sklearn.metrics``
exactly (ties, all-equal scores, float32 probabilities, float and ±1
labels, one class present, labels in both orders); each of the four plot
functions' PNG pixel for pixel against the JAX ``utils/plots.py`` on the
same arrays (Agg); ``plot_data``'s ``sample_size`` against pandas'
``groupby().sample``; ``train_model(plots=True)`` and ``evaluate_model`` on a
tiny DeepSets cache writing the JAX file set, drawn once on a one-rank gloo
mesh; and both without matplotlib."""

import os
import sys
import warnings

import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
from sklearn import metrics as sk  # noqa: E402
from sklearn.exceptions import UndefinedMetricWarning as SkUndefinedMetricWarning  # noqa: E402

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.utils import plots as jax_plots  # noqa: E402
from point_cloud_classifier_tpu_torch import train as port_train  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.utils import metrics, plots  # noqa: E402

PLOT_FILES = ("confusion_matrix_test.png", "roc_curve_test.png", "precision_recall_test.png")


def _case(name):
    """``(y_true, y_score)`` of one seeded case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 97
    y = rng.integers(0, 2, n)
    s = rng.random(n)
    if name == "ties":
        s = np.round(s * 5) / 5
    elif name == "all_equal":
        s = np.full(n, 0.25)
    elif name == "float32":
        s = s.astype(np.float32)
    elif name == "float_labels":
        y = y.astype(np.float32)
        s = (np.round(s * 20) / 20).astype(np.float32)
    elif name == "pm1_labels":
        y = 2 * y - 1
    elif name == "sorted_up":
        y = np.sort(y)
    elif name == "sorted_down":
        y = np.sort(y)[::-1].copy()
    elif name == "column":
        y, s = y[:, None].astype(np.float32), s[:, None].astype(np.float32)
    return y, s


CASES = ["random", "ties", "all_equal", "float32", "float_labels", "pm1_labels", "sorted_up", "sorted_down",
         "column"]


def _same(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert np.array_equal(ours, theirs, equal_nan=True)


@pytest.mark.parametrize("name", CASES)
def test_curves_equal_sklearn(name):
    y, s = _case(name)
    for ours, theirs in zip(metrics.roc_curve(y, s), sk.roc_curve(y.ravel(), s.ravel())):
        _same(ours, theirs)
    for ours, theirs in zip(metrics.precision_recall_curve(y, s), sk.precision_recall_curve(y.ravel(), s.ravel())):
        _same(ours, theirs)
    assert metrics.roc_auc_score(y, s) == sk.roc_auc_score(y.ravel(), s.ravel())
    precision, recall, _ = sk.precision_recall_curve(y.ravel(), s.ravel())
    assert metrics.auc(recall, precision) == sk.auc(recall, precision)
    fpr, tpr, _ = sk.roc_curve(y.ravel(), s.ravel())
    assert metrics.auc(fpr, tpr) == sk.auc(fpr, tpr)
    pred = (s >= 0.5).astype(np.int64)
    _same(metrics.confusion_matrix(y, pred, normalize="true"),
          sk.confusion_matrix(y.ravel(), pred.ravel(), normalize="true"))
    _same(metrics.confusion_matrix(y, pred), sk.confusion_matrix(y.ravel(), pred.ravel()))


def test_auc_direction_and_refusals():
    x, y = np.array([0.0, 0.5, 1.0]), np.array([1.0, 0.5, 1.0])
    assert metrics.auc(x[::-1], y[::-1]) == sk.auc(x[::-1], y[::-1]) == metrics.auc(x, y)
    with pytest.raises(ValueError, match="neither increasing nor decreasing"):
        metrics.auc(np.array([0.0, 1.0, 0.5]), y)
    with pytest.raises(ValueError, match="At least 2 points"):
        metrics.auc(np.array([1.0]), np.array([1.0]))
    with pytest.raises(ValueError, match="multiclass"):
        metrics.roc_curve(np.array([0, 1, 2]), np.array([0.1, 0.2, 0.3]))


@pytest.mark.parametrize("present", [0, 1])
def test_one_class_present_warns_as_sklearn(present):
    """``roc_auc_score`` of one class: NaN and sklearn's warning, no error;
    the curves' own warnings and NaNs; a 1×1 confusion matrix warns."""
    y, s = np.full(12, present), np.linspace(0.0, 1.0, 12)
    with pytest.warns(metrics.UndefinedMetricWarning, match="Only one class is present in y_true"):
        ours = metrics.roc_auc_score(y, s)
    with pytest.warns(SkUndefinedMetricWarning, match="Only one class is present in y_true"):
        theirs = sk.roc_auc_score(y, s)
    assert np.isnan(ours) and np.isnan(theirs)
    with warnings.catch_warnings(record=True) as ours_w:
        warnings.simplefilter("always")
        ours = metrics.roc_curve(y, s) + metrics.precision_recall_curve(y, s)
        metrics.confusion_matrix(y, y)
    with warnings.catch_warnings(record=True) as theirs_w:
        warnings.simplefilter("always")
        theirs = sk.roc_curve(y, s) + sk.precision_recall_curve(y, s)
        sk.confusion_matrix(y, y)
    for a, b in zip(ours, theirs):
        _same(a, b)
    assert [str(w.message) for w in ours_w] == [str(w.message) for w in theirs_w]


def _pixels(path):
    return mpimg.imread(path)


@pytest.mark.parametrize("plot", ["plot_confusion_matrix", "plot_roc_curve", "plot_precision_recall_curve"])
@pytest.mark.parametrize("name", ["random", "ties", "float32", "float_labels"])
def test_plot_pixels_equal_the_jax_plots(tmp_path, plot, name):
    y, s = _case(name)
    arg = (s >= 0.5).astype(np.int64) if plot == "plot_confusion_matrix" else s
    for side, module in (("port", plots), ("jax", jax_plots)):
        os.makedirs(tmp_path / side)
        getattr(module, plot)(y, arg, str(tmp_path / side), split_name="val")
    (file,) = os.listdir(tmp_path / "jax")
    assert os.listdir(tmp_path / "port") == [file] and file.endswith("_val.png")
    np.testing.assert_array_equal(_pixels(tmp_path / "port" / file), _pixels(tmp_path / "jax" / file))


def _columns(n=120, seed=3, float_labels=False):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 2, n)
    return {"energy_total": rng.gamma(2.0, 50.0, n).astype(np.float32),
            "hits_total": rng.integers(1, 400, n),
            "label": label.astype(np.float64) if float_labels else label}


@pytest.mark.parametrize("sample_size", [None, 25])
@pytest.mark.parametrize("float_labels", [False, True])
def test_plot_data_pixels_equal_the_jax_plot(tmp_path, sample_size, float_labels):
    cols = _columns(float_labels=float_labels)
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    plots.plot_data(cols, sample_size=sample_size, save_dir=str(tmp_path / "port"))
    jax_plots.plot_data(pd.DataFrame(cols), sample_size=sample_size, save_dir=str(tmp_path / "jax"))
    assert os.listdir(tmp_path / "port") == ["plot.png"]
    np.testing.assert_array_equal(_pixels(tmp_path / "port" / "plot.png"), _pixels(tmp_path / "jax" / "plot.png"))


@pytest.mark.parametrize("n, random_state", [(10, 42), (30, 7), (1, 0)])
def test_sample_by_label_draws_the_pandas_rows(n, random_state):
    cols = _columns(n=90, seed=11)
    cols["label"] = np.where(cols["label"] == 0, 5, 2)  # labels out of row order
    frame = pd.DataFrame(cols)
    want = frame.groupby("label", group_keys=False).sample(n=n, random_state=random_state).index.to_numpy()
    np.testing.assert_array_equal(plots.sample_by_label(cols["label"], n, random_state), want)
    with pytest.raises(ValueError, match="larger sample than population"):
        plots.sample_by_label(cols["label"], 1000)


def _config(root, epochs=1, **trainer):
    """configs/deep_sets.yaml at widths of at most 16."""
    return {
        "meta": {"model_name": "", "dataset_name": ""},
        "dataset": {"data_dir": str(root / "data"), "batch_size": 8, "sparse_batching": True},
        "logging": {"log_dir": str(root / "log")},
        "model": {"input_dim": 6, "phi_layers": [16, 16], "rho_layers": [16], "output_dim": 1,
                  "sparse_batching": True, "pooling": "mean", "layer_norm": False, "activation": "gelu",
                  "residual_block": True},
        "trainer": {"epochs": epochs, "learning_rate": 0.001, "optimizer": "adamw", **trainer},
    }


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("plots")
    write_s2ppc_cache(str(root / "data"), n_events=(40, 24, 24), min_points=3, max_points=20, seed=4)
    return root


def _drawn_by_jax(tmp_path, y, pred, prob):
    os.makedirs(tmp_path, exist_ok=True)
    jax_plots.plot_confusion_matrix(y, pred, str(tmp_path))
    jax_plots.plot_precision_recall_curve(y, prob, str(tmp_path))
    jax_plots.plot_roc_curve(y, prob, str(tmp_path))
    return tmp_path


def test_train_and_evaluate_draw_the_jax_plots(cache, tmp_path):
    """``train_model(plots=True)`` draws the val split into the run
    directory under ``*_test.png`` names, as the JAX package does;
    ``evaluate_model`` draws the test split into its directory; each PNG
    equals the JAX functions' drawing of the same predictions."""
    cfg = _config(cache)
    cfg["logging"]["log_dir"] = str(tmp_path / "log")
    log_dir = port_train.train_model("deep_sets", "s2ppc", cfg, plots=True, return_log_dir=True, device="cpu")
    for png in PLOT_FILES:
        assert os.path.exists(os.path.join(log_dir, png)), png

    from point_cloud_classifier_tpu_torch import factory

    model = factory.get_model("deep_sets", cfg, model_dir=log_dir, device="cpu")
    module = factory.get_dataloader("s2ppc", cfg)
    val = module.get_val_loader()
    # best_model.pt: after one epoch, the weights train_model drew with
    y, pred = model.predict(val)
    _, prob = model.predict(val, return_prob=True)
    want = _drawn_by_jax(tmp_path / "jax_val", y, pred, prob)
    for png in PLOT_FILES:
        np.testing.assert_array_equal(_pixels(os.path.join(log_dir, png)), _pixels(want / png), err_msg=png)

    save_dir = str(tmp_path / "eval")
    metrics_out = port_train.evaluate_model(log_dir, save_dir=save_dir, device="cpu")
    assert set(metrics_out) == {"accuracy_train", "accuracy_val", "accuracy_test"}
    assert sorted(os.listdir(save_dir)) == sorted(["metrics.json", "classification_report.txt", *PLOT_FILES])
    test = module.get_test_loader()
    y, pred = model.predict(test)
    _, prob = model.predict(test, return_prob=True)
    want = _drawn_by_jax(tmp_path / "jax_test", y, pred, prob)
    for png in PLOT_FILES:
        np.testing.assert_array_equal(_pixels(os.path.join(save_dir, png)), _pixels(want / png), err_msg=png)


def test_plots_are_drawn_once_on_a_one_rank_mesh(cache, tmp_path, monkeypatch):
    """Under a mesh every rank predicts and the writer rank alone draws: on
    a world of one gloo rank, each plot once in ``train_model`` and once in
    ``evaluate_model``."""
    import torch.distributed as dist

    drawn = []
    for name in ("plot_confusion_matrix", "plot_precision_recall_curve", "plot_roc_curve"):
        real = getattr(port_train, name)
        monkeypatch.setattr(port_train, name, lambda *a, _real=real, _name=name: drawn.append(_name) or _real(*a))
    cfg = _config(cache, data_parallel=True)
    cfg["logging"]["log_dir"] = str(tmp_path / "log")
    try:
        log_dir = port_train.train_model("deep_sets", "s2ppc", cfg, plots=True, return_log_dir=True, device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert sorted(drawn) == ["plot_confusion_matrix", "plot_precision_recall_curve", "plot_roc_curve"]
        port_train.evaluate_model(log_dir, save_dir=str(tmp_path / "eval"), device="cpu")
        assert len(drawn) == 6
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for png in PLOT_FILES:
        assert os.path.exists(os.path.join(log_dir, png)) and os.path.exists(tmp_path / "eval" / png)


def test_without_matplotlib_train_raises_first_and_evaluate_writes_its_files(cache, tmp_path, monkeypatch,
                                                                             capsys):
    cfg = _config(cache)
    cfg["logging"]["log_dir"] = str(tmp_path / "log")
    run = port_train.train_model("deep_sets", "s2ppc", dict(cfg, logging={"log_dir": str(tmp_path / "run")}),
                                 return_log_dir=True, device="cpu")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match=r"train_model\(plots=True\): matplotlib is not installed"):
        port_train.train_model("deep_sets", "s2ppc", cfg, plots=True, device="cpu")
    assert not os.path.exists(tmp_path / "log")
    with pytest.raises(ImportError, match="plot_roc_curve: matplotlib is not installed"):
        plots.plot_roc_curve(np.array([0, 1]), np.array([0.2, 0.7]), str(tmp_path))
    capsys.readouterr()
    port_train.evaluate_model(run, save_dir=str(tmp_path / "eval"), device="cpu")
    assert sorted(os.listdir(tmp_path / "eval")) == ["classification_report.txt", "metrics.json"]
    lines = [line for line in capsys.readouterr().out.splitlines() if "is not installed" in line]
    assert lines == ["evaluate_model's plots: matplotlib is not installed; no plots written"]

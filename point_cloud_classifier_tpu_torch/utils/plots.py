"""The evaluation plots, as PNG files.

Counterpart of ``point_cloud_classifier_tpu/utils/plots.py``, with its names,
signatures, file names and figure calls: the row-normalized confusion
matrix, the ROC curve with its AUC, the precision-recall curve with its AUC,
and the energy-vs-hits scatter of the tabular dataset.  The curves come from
``utils/metrics.py`` (numpy, as scikit-learn computes them), and
``plot_data`` takes numpy columns instead of a DataFrame.

matplotlib is imported by each function, never by this module: the port
runs where matplotlib is missing, and there a plot raises ``ImportError``
naming matplotlib and the plot.  The backend is chosen as the JAX module
chooses it: on a headless Linux host (no ``MPLBACKEND``, ``DISPLAY`` or
``WAYLAND_DISPLAY``) Agg, elsewhere matplotlib's own choice.
``save_dir=None`` shows the figure instead of writing it.
"""

from __future__ import annotations

import os
import sys
from typing import Mapping

import numpy as np

from point_cloud_classifier_tpu_torch.utils.metrics import (
    auc,
    confusion_matrix,
    precision_recall_curve,
    roc_auc_score,
    roc_curve,
)


def pyplot(what: str):
    """``matplotlib.pyplot``, the backend chosen on first import; raises
    ``ImportError`` naming matplotlib and ``what`` where it is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{what}: matplotlib is not installed") from e
    if (
        "matplotlib.pyplot" not in sys.modules
        and not os.environ.get("MPLBACKEND")
        and not os.environ.get("DISPLAY")
        and not os.environ.get("WAYLAND_DISPLAY")
        and sys.platform.startswith("linux")
    ):
        # headless default only: an interactive host keeps its backend
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, save_dir, filename):
    import matplotlib.pyplot as plt  # imported by the plot that drew ``fig``

    if save_dir:
        fig.savefig(os.path.join(save_dir, filename))
        plt.close(fig)
    else:  # pragma: no cover - interactive use
        plt.show()
        if not plt.isinteractive():
            # a non-interactive show() returns without a window: close the figure
            plt.close(fig)


def sample_by_label(labels: np.ndarray, n: int, random_state: int = 42) -> np.ndarray:
    """The rows ``groupby("label").sample(n, random_state=…)`` draws: one
    ``RandomState`` over the labels in sorted order, ``n`` rows without
    replacement from each, concatenated label by label."""
    rng = np.random.RandomState(random_state)
    rows = []
    for label in np.unique(labels):
        group = np.flatnonzero(labels == label)
        rows.append(group[rng.choice(len(group), size=n, replace=False).astype(np.intp, copy=False)])
    return np.concatenate(rows)


def plot_data(dataset: Mapping[str, np.ndarray], sample_size=None, random_state=42, save_dir=None):
    """Scatter of total energy vs hit count per event, colored by label
    (``dataset``: the columns ``energy_total``, ``hits_total`` and
    ``label``), written as ``plot.png``."""
    plt = pyplot("plot_data")
    columns = {k: np.asarray(dataset[k]) for k in ("energy_total", "hits_total", "label")}
    if sample_size is not None:
        rows = sample_by_label(columns["label"], sample_size, random_state)
        columns = {k: v[rows] for k, v in columns.items()}

    fig, ax = plt.subplots(figsize=(10, 6))
    for label in np.unique(columns["label"]):
        group = columns["label"] == label
        ax.scatter(columns["energy_total"][group], columns["hits_total"][group], alpha=0.7, label=str(label), s=12)
    ax.set_xlabel("Shower Energy (MeV)")
    ax.set_ylabel("Number of Hits")
    ax.legend(title="Particle")
    ax.grid(True)
    _finish(fig, save_dir, "plot.png")


def plot_confusion_matrix(y_true, y_pred, save_dir=None, split_name="test"):
    """Row-normalized confusion matrix heatmap."""
    plt = pyplot("plot_confusion_matrix")
    cm = confusion_matrix(y_true, y_pred, normalize="true")
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.imshow(cm, cmap="Blues", vmin=0.0, vmax=1.0)
    for (i, j), v in np.ndenumerate(cm):
        ax.text(j, i, f"{v:.2f}", ha="center", va="center", color="white" if v > 0.5 else "black")
    ax.set_xticks(range(cm.shape[1]))
    ax.set_yticks(range(cm.shape[0]))
    ax.set_title(f"Confusion Matrix ({split_name})")
    ax.set_xlabel("Predicted label")
    ax.set_ylabel("True label")
    fig.tight_layout()
    _finish(fig, save_dir, f"confusion_matrix_{split_name}.png")


def plot_roc_curve(y_true, y_prob, save_dir=None, split_name="test"):
    """ROC curve with its AUC."""
    plt = pyplot("plot_roc_curve")
    fpr, tpr, _ = roc_curve(y_true, y_prob)
    auc_value = roc_auc_score(y_true, y_prob)

    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(fpr, tpr, label=f"AUC = {auc_value:.3f}")
    ax.plot([0, 1], [0, 1], "k--", label="Random")
    ax.set_title(f"ROC Curve ({split_name})")
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.legend(loc="lower right")
    fig.tight_layout()
    _finish(fig, save_dir, f"roc_curve_{split_name}.png")


def plot_precision_recall_curve(y_true, y_prob, save_dir=None, split_name="test"):
    """Precision-recall curve with its AUC."""
    plt = pyplot("plot_precision_recall_curve")
    precision, recall, _ = precision_recall_curve(y_true, y_prob)
    pr_auc = auc(recall, precision)

    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(recall, precision, label=f"AUC = {pr_auc:.3f}")
    ax.set_title(f"Precision-Recall Curve ({split_name})")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.legend(loc="lower left")
    fig.tight_layout()
    _finish(fig, save_dir, f"precision_recall_{split_name}.png")

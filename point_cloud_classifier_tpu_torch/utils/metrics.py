"""Accuracy, the per-class report and the evaluation plots' curves, in numpy.

Counterpart of what the JAX package's ``train.py`` and ``utils/plots.py``
take from ``sklearn.metrics`` (sklearn is not on every machine that runs the
port):
:func:`accuracy` is ``accuracy_score``, and :func:`classification_report`
writes ``classification_report(y_true, y_pred)``'s text at its defaults
byte for byte: labels are the sorted union of both arrays, named as
``"%s" % label`` (``0.0`` for float labels); a ratio whose denominator is 0
(a class never predicted, or absent from ``y_true``) reads 0.00, without a
warning; F1 is ``2·tp / (true + predicted)``; the macro and weighted rows
average the per-class values as numpy does, and the ``accuracy`` row is the
micro F1; where no row is predicted right, the supports print as floats.

:func:`confusion_matrix`, :func:`roc_curve`, :func:`roc_auc_score`,
:func:`precision_recall_curve` and :func:`auc` are the five calls of the
plots, at the arguments the plots use, as scikit-learn 1.9 computes them:
scores sorted descending (stably), ties merged into one threshold, the
true- and false-positive counts summed in float64, the positive class the
label 1 (``roc_auc_score``: the larger label).
"""

from __future__ import annotations

import warnings

import numpy as np


class UndefinedMetricWarning(UserWarning):
    """A metric that the labels leave undefined (sklearn's warning of that
    name)."""


def accuracy(y_true, y_pred) -> float:
    """The share of rows whose prediction equals the label."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float(np.mean(y_true == y_pred))


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``num / den`` in float64, 0 where ``den`` is 0."""
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def classification_report(y_true, y_pred, digits: int = 2) -> str:
    """Precision, recall, F1 and support per class, then the accuracy,
    macro-average and weighted-average rows."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    names = ["%s" % label for label in labels]
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels])
    true = np.array([np.sum(y_true == c) for c in labels])
    pred = np.array([np.sum(y_pred == c) for c in labels])
    if not tp.any():
        # sklearn counts in floats when no row is right, so the supports
        # print as 5.0
        true = true.astype(np.float64)
    precision, recall, f1 = _divide(tp, pred), _divide(tp, true), _divide(2 * tp, true + pred)

    width = max(max(len(name) for name in names), len("weighted avg"), digits)
    headers = ["precision", "recall", "f1-score", "support"]
    report = ("{:>{width}s} " + " {:>9}" * len(headers)).format("", *headers, width=width)
    report += "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(names, precision, recall, f1, true):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    micro_f1 = _divide(2 * tp.sum(), true.sum() + pred.sum())
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n").format(
        "accuracy", "", "", float(micro_f1), np.sum(true), width=width, digits=digits
    )
    for heading, weights in (("macro avg", None), ("weighted avg", true)):
        if weights is None:
            avg = [float(np.nanmean(v)) for v in (precision, recall, f1)]
        else:
            avg = [float(np.average(v, weights=weights)) for v in (precision, recall, f1)]
        report += row_fmt.format(heading, *avg, np.sum(true), width=width, digits=digits)
    return report


def confusion_matrix(y_true, y_pred, normalize=None) -> np.ndarray:
    """Counts of (true, predicted) label pairs, rows and columns over the
    sorted union of the labels; ``normalize="true"`` divides each row by its
    sum (an empty row reads 0)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    n = len(labels)
    cm = np.bincount(np.searchsorted(labels, y_true) * n + np.searchsorted(labels, y_pred),
                     minlength=n * n).astype(np.int64).reshape(n, n)
    if normalize == "true":
        with np.errstate(all="ignore"):
            cm = np.nan_to_num(cm / cm.sum(axis=1, keepdims=True))
    elif normalize is not None:
        raise ValueError(f"normalize must be None or 'true', got {normalize!r}")
    if cm.shape == (1, 1):
        warnings.warn("A single label was found in 'y_true' and 'y_pred'. For the confusion matrix to have the "
                      "correct shape, use the 'labels' parameter to pass all known labels.", UserWarning)
    return cm


def _binary_counts(y_true, y_score):
    """``(fps, tps, thresholds)``: the false and true positives (float64) at
    each distinct score, taken as a threshold from the highest down, the
    positive class being label 1."""
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    if len(y_true) != len(y_score):
        raise ValueError(f"y_true has {len(y_true)} rows and y_score {len(y_score)}")
    if not np.isfinite(y_score).all():
        raise ValueError("y_score holds NaN or infinity")
    classes = np.unique(y_true)
    if len(classes) > 2:
        raise ValueError("multiclass format is not supported")
    if not set(classes.tolist()) <= {0, 1} and not set(classes.tolist()) <= {-1, 1}:
        raise ValueError(f"y_true takes values in {classes.tolist()}: the positive class must be 1, "
                         "the labels {0, 1} or {-1, 1}")
    # a stable descending sort: ties keep their order of rows
    order = len(y_score) - 1 - np.argsort(y_score[::-1], kind="stable")[::-1]
    y_score = y_score[order]
    positive = (y_true[order] == 1).astype(np.float64)
    ends = np.concatenate([np.nonzero(np.diff(y_score))[0], [len(y_score) - 1]])
    tps = np.cumsum(positive, dtype=np.float64)[ends]
    fps = 1 + ends.astype(np.float64) - tps
    return fps, tps, y_score[ends]


def roc_curve(y_true, y_score):
    """``(fpr, tpr, thresholds)`` with ``drop_intermediate=True``: a point
    is kept where either count bends; the curve starts at (0, 0) under an
    infinite threshold."""
    fps, tps, thresholds = _binary_counts(y_true, y_score)
    if len(fps) > 2:
        keep = np.nonzero(np.concatenate([[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    if fps[-1] <= 0:
        warnings.warn("No negative samples in y_true, false positive value should be meaningless",
                      UndefinedMetricWarning)
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn("No positive samples in y_true, true positive value should be meaningless",
                      UndefinedMetricWarning)
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """The trapezoid area under ``y`` over a monotone ``x`` (negated where
    ``x`` decreases)."""
    x = np.asarray(x).reshape(-1)
    y = np.asarray(y).reshape(-1)
    if x.shape[0] < 2:
        raise ValueError(f"At least 2 points are needed to compute area under curve, but x.shape = {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * (dx * (y[1:] + y[:-1]) / 2.0).sum())


def roc_auc_score(y_true, y_score) -> float:
    """The area under the ROC curve of binary labels, the larger label
    positive; NaN, with an :class:`UndefinedMetricWarning`, where ``y_true``
    holds one class."""
    y_true = np.asarray(y_true).reshape(-1)
    classes = np.unique(y_true)
    if len(classes) > 2:
        raise ValueError("multi_class must be in ('ovo', 'ovr')")
    if len(classes) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not defined in that case.",
                      UndefinedMetricWarning)
        return np.nan
    fpr, tpr, _ = roc_curve((y_true == classes[1]).astype(np.int64), y_score)
    return auc(fpr, tpr)


def precision_recall_curve(y_true, y_score):
    """``(precision, recall, thresholds)`` with ``drop_intermediate=False``:
    recall decreasing, and a last point of precision 1 and recall 0 without
    a threshold."""
    fps, tps, thresholds = _binary_counts(y_true, y_score)
    precision = tps / (tps + fps)  # tps + fps counts the rows at or above each threshold: never 0
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to one for all thresholds.")
        recall = np.ones(tps.shape)
    else:
        recall = tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]), np.concatenate([recall[::-1], [0.0]]),
            thresholds[::-1])

"""Accuracy and the per-class report of an evaluation, in numpy.

Counterpart of what the JAX package's ``train.py`` takes from
``sklearn.metrics`` (sklearn is not on every machine that runs the port):
:func:`accuracy` is ``accuracy_score``, and :func:`classification_report`
writes ``classification_report(y_true, y_pred)``'s text at its defaults
byte for byte: labels are the sorted union of both arrays, named as
``"%s" % label`` (``0.0`` for float labels); a ratio whose denominator is 0
(a class never predicted, or absent from ``y_true``) reads 0.00, without a
warning; F1 is ``2·tp / (true + predicted)``; the macro and weighted rows
average the per-class values as numpy does, and the ``accuracy`` row is the
micro F1; where no row is predicted right, the supports print as floats.
"""

from __future__ import annotations

import numpy as np


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

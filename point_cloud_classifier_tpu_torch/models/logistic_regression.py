"""L2-regularized logistic regression, solved by L-BFGS on the device.

Counterpart of ``point_cloud_classifier_tpu/models/logistic_regression.py``,
with the same interface: ``fit(train, val)`` and ``predict(data,
return_prob)`` read a split's columns (``data/tabular.Step2PointTabular``
with ``convert_to_tensor=False``: the features in order, then ``label``)
where the JAX package reads a DataFrame; ``save(dir)`` pickles ``{"coef_",
"intercept_", "C"}`` to ``model.pkl``; ``get_trainable_parameters`` counts
the coefficients and the intercept.

The same math as the JAX fit (sklearn's defaults): minimize ``Σ log(1 +
e^{-ŷ}) + ‖w‖² / (2C)`` with the intercept unpenalized, C = 1, in f32, from
zero, iterating while ``max|grad| ≥ tol`` (1e-4) at the iterate before the
step and fewer than ``max_iter`` (100) steps were taken.  The solver is
L-BFGS with a history of 10 pairs, as optax's, but the line search differs:
optax zooms to a strong Wolfe point; here each step tries a ladder of step
sizes ``1, 1/2, …, 2^-19`` in one batched evaluation and takes the largest
that passes Armijo's sufficient decrease or, where f32 cannot resolve the
decrease any more, Hager and Zhang's approximate Wolfe test (as optax's
search also allows).  So the coefficients agree with the JAX fit's to the
solve's tolerance, not bit for bit.  The whole solve stays on the device:
no value comes back to the host inside an iteration, and the stop rule is
read once every ``_CHECK_EVERY`` iterations (a finished solve's further
iterations change nothing).  ``torch.optim.LBFGS`` reads the loss back on
every evaluation (``float(closure())``), so it is not used.

``load`` reads the JAX package's dict pickle and the original reference's
``model.pkl``, a pickled sklearn ``LogisticRegression``, without sklearn:
the unpickler turns the ``sklearn`` classes into a plain holder of their
state and takes ``coef_``, ``intercept_`` and ``C`` from it.  ``predict``
is numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from point_cloud_classifier_tpu_torch.data.tabular import Columns, feature_matrix
from point_cloud_classifier_tpu_torch.models.wrapper import resolve_device

_MEMORY = 10  # L-BFGS history pairs, optax's default
_LADDER = 20  # step sizes 2^0 … 2^-19 tried per iteration
_CHECK_EVERY = 10  # iterations between reads of the stop rule
_ARMIJO = 1e-4  # sufficient decrease, as optax's slope_rtol
_APPROX_DEC = 1e-6  # approximate Wolfe's allowed rise, relative to |value| (optax's approx_dec_rtol)


class _SklearnState:
    """What a pickled sklearn estimator holds, without sklearn: the state
    dict it was pickled with, as attributes."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _ReferenceUnpickler(pickle.Unpickler):
    """Unpickles an sklearn estimator as :class:`_SklearnState`; every other
    class resolves as ``pickle`` resolves it (numpy's arrays and dtypes)."""

    def find_class(self, module, name):
        if module == "sklearn" or module.startswith("sklearn."):
            return _SklearnState
        return super().find_class(module, name)


def _objective(A, y, theta, reg):
    """Value and gradient of ``Σ softplus(z) − y·z + ½ Σ reg·θ²`` at ``θ``
    (``z = A θ``), all on ``A``'s device."""
    z = A @ theta
    value = (F.softplus(z) - y * z).sum() + 0.5 * (reg * theta * theta).sum()
    grad = A.T @ (torch.sigmoid(z) - y) + reg * theta
    return value, grad


def _two_loop(g, S, Y, rho, gamma, newest: int, count: int):
    """L-BFGS's two-loop recursion: ``H g`` from the ``count`` newest pairs
    of the ring (``newest`` the latest slot; an empty slot has ``rho = 0``)."""
    q = g.clone()
    slots = [(newest - i) % _MEMORY for i in range(count)]
    alphas = []
    for j in slots:
        a = rho[j] * (S[j] @ q)
        q = q - a * Y[j]
        alphas.append(a)
    r = gamma * q
    for j, a in zip(reversed(slots), reversed(alphas)):
        r = r + S[j] * (a - rho[j] * (Y[j] @ r))
    return r


def _step_size(A, y, theta, reg, d, value, slope):
    """The largest step of the ladder that passes (0 if none does), over
    one ``[N, ladder]`` evaluation: Armijo's test on the value's change
    (summed per row, to keep it exact where the value itself rounds), or
    the approximate Wolfe test (the change within ``_APPROX_DEC·|value|``
    and the slope at the step at most ``(1 − 2·_ARMIJO)·|slope|``)."""
    t = torch.pow(2.0, -torch.arange(_LADDER, device=A.device, dtype=A.dtype))
    z = (A @ theta)[:, None]
    u = (A @ d)[:, None]
    zt = z + u * t[None, :]
    rows = (F.softplus(zt) - y[:, None] * zt) - (F.softplus(z) - y[:, None] * z)
    change = rows.sum(0) + t * (reg * theta * d).sum() + 0.5 * t * t * (reg * d * d).sum()
    slope_t = (u * (torch.sigmoid(zt) - y[:, None])).sum(0) + (reg * theta * d).sum() + t * (reg * d * d).sum()
    ok = (change <= _ARMIJO * t * slope) | (
        (change <= _APPROX_DEC * value.abs()) & (slope_t <= (1 - 2 * _ARMIJO) * slope.abs())
    )
    first = torch.argmax(ok.to(torch.int32))
    return torch.where(ok.any(), t[first], torch.zeros_like(value))


def fit_lbfgs(X: torch.Tensor, y: torch.Tensor, C: float, tol: float, max_iter: int):
    """``(w [F], b, iterations)`` minimizing the logistic loss with ``‖w‖²/(2C)``
    on ``X``'s device and dtype; ``iterations`` counts the steps taken, as
    the JAX fit's loop counts them."""
    n, f = X.shape
    A = torch.cat([X, torch.ones(n, 1, device=X.device, dtype=X.dtype)], dim=1)
    reg = torch.full((f + 1,), 1.0 / C, device=X.device, dtype=X.dtype)
    reg[-1] = 0.0  # the intercept is not penalized
    theta = torch.zeros(f + 1, device=X.device, dtype=X.dtype)
    S = torch.zeros(_MEMORY, f + 1, device=X.device, dtype=X.dtype)
    Y = torch.zeros_like(S)
    rho = torch.zeros(_MEMORY, device=X.device, dtype=X.dtype)
    gamma = torch.ones((), device=X.device, dtype=X.dtype)
    value, g = _objective(A, y, theta, reg)
    # the JAX loop's state: it steps while the gradient at the iterate
    # before the previous step was at least tol (inf before the first)
    prev_gnorm = torch.full((), float("inf"), device=X.device, dtype=X.dtype)
    iterations = torch.zeros((), device=X.device, dtype=torch.int32)
    for k in range(max_iter):
        if k and k % _CHECK_EVERY == 0 and not bool(prev_gnorm >= tol):
            break
        active = prev_gnorm >= tol
        if k == 0:
            d = -g * torch.clamp(1.0 / g.abs().sum(), max=1.0)
        else:
            d = -_two_loop(g, S, Y, rho, gamma, (k - 1) % _MEMORY, min(k, _MEMORY))
        t = torch.where(active, _step_size(A, y, theta, reg, d, value, g @ d), torch.zeros_like(value))
        s = t * d
        theta = theta + s
        new_value, new_g = _objective(A, y, theta, reg)
        yk = new_g - g
        sy = s @ yk
        valid = sy > 1e-10
        S[k % _MEMORY] = s
        Y[k % _MEMORY] = yk
        rho[k % _MEMORY] = torch.where(valid, 1.0 / torch.where(valid, sy, 1.0), 0.0)
        gamma = torch.where(valid, sy / torch.clamp(yk @ yk, min=1e-30), gamma)
        prev_gnorm = torch.where(active, g.abs().max(), prev_gnorm)
        iterations = iterations + active.to(torch.int32)
        value, g = new_value, new_g
    return theta[:f], theta[f], iterations


class LogRegression:
    def __init__(self, C: float = 1.0, max_iter: int = 100, tol: float = 1e-4, device: Optional[str] = None):
        """``device`` is where ``fit`` solves: the card unless the caller
        names another (``"cpu"``); ``None`` raises where there is no card."""
        self.C = C
        self.max_iter = max_iter
        self.tol = tol
        self.device = resolve_device(device)
        self.coef_: np.ndarray = None
        self.intercept_: np.ndarray = None
        self.n_iter_: int = None

    @staticmethod
    def _split_xy(columns: Columns):
        return feature_matrix(columns).astype(np.float64), np.asarray(columns["label"], dtype=np.float64)

    def fit(self, train_loader: Columns, val_loader: Columns = None) -> "LogRegression":
        X, y = self._split_xy(train_loader)
        w, b, iterations = fit_lbfgs(
            torch.as_tensor(X, dtype=torch.float32, device=self.device),
            torch.as_tensor(y, dtype=torch.float32, device=self.device),
            self.C,
            self.tol,
            self.max_iter,
        )
        host = torch.cat([w, b[None], iterations[None].to(w.dtype)]).cpu().numpy()
        self.coef_ = host[:-2].reshape(1, -1)
        self.intercept_ = host[-2:-1].copy()
        self.n_iter_ = int(host[-1])
        return self

    def _decision(self, X: np.ndarray) -> np.ndarray:
        return X @ self.coef_[0] + self.intercept_[0]

    def predict(self, data_loader: Columns, return_prob: bool = False):
        X, y_true = self._split_xy(data_loader)
        scores = self._decision(X)
        if return_prob:
            return y_true, 1.0 / (1.0 + np.exp(-scores))
        return y_true, (scores >= 0.0).astype(np.float64)

    def save(self, save_dir: str) -> None:
        path = os.path.join(save_dir, "model.pkl")
        with open(path, "wb") as f:
            pickle.dump({"coef_": self.coef_, "intercept_": self.intercept_, "C": self.C}, f)
        print(f"Model saved to {path}")

    def load(self, model_path: str) -> "LogRegression":
        """The JAX package's ``model.pkl`` (a dict) or the original
        reference's (a pickled sklearn estimator).  Unpickles as the JAX
        package's ``load`` does: read only files this project or the
        reference wrote."""
        with open(model_path, "rb") as f:
            state = _ReferenceUnpickler(f).load()
        if isinstance(state, dict):
            self.coef_ = state["coef_"]
            self.intercept_ = state["intercept_"]
            self.C = state.get("C", 1.0)
        else:
            self.coef_ = np.asarray(state.coef_, dtype=np.float64)
            self.intercept_ = np.asarray(state.intercept_, dtype=np.float64)
            self.C = float(getattr(state, "C", 1.0))
        return self

    def get_trainable_parameters(self) -> int:
        if self.coef_ is None:
            raise ValueError(
                "Model has not been fitted yet. Fit the model before counting parameters."
            )
        return self.coef_.size + self.intercept_.size

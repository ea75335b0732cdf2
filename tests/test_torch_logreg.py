"""The port's LogRegression against the JAX package's and sklearn's, on the
CPU, from the same seeded S2PT caches: the coefficients and intercept of the
fit, the iteration count, the predictions, ``model.pkl`` both ways between
the packages, and the original reference's pickled sklearn estimator read in
a process where sklearn cannot be imported."""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
from sklearn.linear_model import LogisticRegression as SkLogisticRegression

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.models import LogRegression as JaxLogRegression  # noqa: E402
from point_cloud_classifier_tpu.models import logistic_regression as jax_lr  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2pt_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.data.tabular import Step2PointTabular, feature_matrix  # noqa: E402
from point_cloud_classifier_tpu_torch.models import LogRegression  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ROADMAP item 11's bound (BASELINE.md's sklearn parity): both fits stop at
# max|grad| < 1e-4 of the summed loss, in f32, with other line searches
COEF_ATOL = 2e-4
# predictions may differ only where the decision is this close to 0
BOUNDARY = 1e-3
CACHES = {"small": ((64, 16, 16), 1), "mid": ((300, 50, 50), 2), "config": ((1024, 256, 256), 0)}


@pytest.fixture(params=list(CACHES))
def columns(request, tmp_path):
    sizes, seed = CACHES[request.param]
    write_s2pt_cache(str(tmp_path), n_events=sizes, seed=seed)
    data = Step2PointTabular(str(tmp_path))
    return data.get_train_loader(), data.get_test_loader()


def _frame(cols):
    return pd.DataFrame(cols)


def _jax_iterations(X, y, C=1.0, tol=1e-4, max_iter=100):
    """The JAX fit's loop (``logistic_regression._fit_lbfgs``) with its step
    counter returned: its params must equal the JAX fit's bit for bit."""
    def loss_fn(params):
        logits = X @ params["w"] + params["b"]
        return jnp.sum(optax.sigmoid_binary_cross_entropy(logits, y)) + 0.5 / C * jnp.sum(params["w"] ** 2)

    value_and_grad = optax.value_and_grad_from_state(loss_fn)

    def body(carry):
        params, opt_state, _, i = carry
        value, grad = value_and_grad(params, state=opt_state)
        updates, opt_state = jax_lr._SOLVER.update(
            grad, opt_state, params, value=value, grad=grad, value_fn=loss_fn
        )
        params = optax.apply_updates(params, updates)
        gnorm = jnp.maximum(jnp.max(jnp.abs(grad["w"])), jnp.abs(grad["b"]))
        return params, opt_state, gnorm, i + 1

    def cond(carry):
        return (carry[3] < max_iter) & (carry[2] >= tol)

    params = {"w": jnp.zeros(X.shape[1]), "b": jnp.array(0.0)}
    params, _, _, i = jax.jit(lambda p: jax.lax.while_loop(
        cond, body, (p, jax_lr._SOLVER.init(p), jnp.inf, jnp.int32(0))))(params)
    return np.asarray(params["w"]), int(i)


def test_fit_matches_jax_and_sklearn(columns, capsys):
    train, _ = columns
    port = LogRegression(device="cpu").fit(train)
    ref = JaxLogRegression().fit(_frame(train))
    X, y = feature_matrix(train), train["label"]
    exact = SkLogisticRegression(tol=1e-10, max_iter=10_000).fit(X, y)  # the minimizer itself
    default = SkLogisticRegression().fit(X, y)  # stops on the 1/n-scaled gradient

    assert port.coef_.shape == (1, 9) and port.intercept_.shape == (1,)
    assert port.coef_.dtype == ref.coef_.dtype == np.float32
    for other in (ref, exact):
        np.testing.assert_allclose(port.coef_, other.coef_, rtol=0, atol=COEF_ATOL)
        np.testing.assert_allclose(port.intercept_, other.intercept_, rtol=0, atol=COEF_ATOL)
    # as close to sklearn's default estimate as the JAX fit is
    far = np.abs(np.concatenate([port.coef_[0], port.intercept_]) - np.r_[default.coef_[0], default.intercept_])
    ref_far = np.abs(np.concatenate([ref.coef_[0], ref.intercept_]) - np.r_[default.coef_[0], default.intercept_])
    np.testing.assert_allclose(far, ref_far, rtol=0, atol=1e-5)

    w, jax_steps = _jax_iterations(jnp.asarray(X), jnp.asarray(y.astype(np.float64)))
    np.testing.assert_array_equal(w, ref.coef_[0])
    assert 0 < port.n_iter_ < port.max_iter and 0 < jax_steps < 100
    with capsys.disabled():
        print(f"\nLogRegression iterations on {len(y)} rows: port {port.n_iter_}, JAX {jax_steps}; "
              f"max |Δcoef| port−JAX {np.abs(port.coef_ - ref.coef_).max():.3e}, "
              f"port−sklearn(tol 1e-10) {np.abs(port.coef_ - exact.coef_).max():.3e}, "
              f"JAX−sklearn(default) {np.abs(ref.coef_ - default.coef_).max():.3e}")


def test_predictions_match_jax_except_at_the_boundary(columns):
    train, test = columns
    port = LogRegression(device="cpu").fit(train)
    ref = JaxLogRegression().fit(_frame(train))
    y, pred = port.predict(test)
    y_ref, pred_ref = ref.predict(_frame(test))
    np.testing.assert_array_equal(y, y_ref)
    assert pred.dtype == pred_ref.dtype == np.float64
    near = np.abs(ref._decision(feature_matrix(test).astype(np.float64))) < BOUNDARY
    np.testing.assert_array_equal(pred[~near], pred_ref[~near])
    _, prob = port.predict(test, return_prob=True)
    _, prob_ref = ref.predict(_frame(test), return_prob=True)
    np.testing.assert_allclose(prob, prob_ref, rtol=0, atol=COEF_ATOL * 10)


def test_model_pkl_reads_both_ways(tmp_path):
    write_s2pt_cache(str(tmp_path), n_events=(80, 20, 20), seed=4)
    train = Step2PointTabular(str(tmp_path)).get_train_loader()
    port = LogRegression(device="cpu").fit(train)
    ref = JaxLogRegression().fit(_frame(train))
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "jax"))

    theirs = JaxLogRegression().load(str(tmp_path / "port" / "model.pkl"))
    ours = LogRegression(device="cpu").load(str(tmp_path / "jax" / "model.pkl"))
    for a, b in ((theirs, port), (ours, ref)):
        np.testing.assert_array_equal(a.coef_, b.coef_)
        np.testing.assert_array_equal(a.intercept_, b.intercept_)
        assert a.C == b.C == 1.0
    np.testing.assert_array_equal(ours.predict(train)[1], ref.predict(_frame(train))[1])
    assert ours.get_trainable_parameters() == ref.get_trainable_parameters() == 10
    with pytest.raises(ValueError, match="not been fitted"):
        LogRegression(device="cpu").get_trainable_parameters()


def test_reads_a_reference_sklearn_pickle_without_sklearn(tmp_path):
    """The original reference's ``model.pkl`` is the pickled estimator; the
    port reads it in a process where ``import sklearn`` fails."""
    write_s2pt_cache(str(tmp_path), n_events=(80, 20, 20), seed=5)
    train = Step2PointTabular(str(tmp_path)).get_train_loader()
    X, y = feature_matrix(train), train["label"]
    sk = SkLogisticRegression().fit(X, y)
    with open(tmp_path / "model.pkl", "wb") as f:
        pickle.dump(sk, f)
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("sklearn", "jax", "pandas", "point_cloud_classifier_tpu"):
            sys.modules[name] = None  # any import of it now raises ImportError
        import numpy as np
        from point_cloud_classifier_tpu_torch.models import LogRegression
        from point_cloud_classifier_tpu_torch.data.tabular import Step2PointTabular
        model = LogRegression(device="cpu").load({str(tmp_path / "model.pkl")!r})
        _, prob = model.predict(Step2PointTabular({str(tmp_path)!r}).get_train_loader(), return_prob=True)
        assert not any(m.startswith("sklearn") for m, v in sys.modules.items() if v is not None)
        np.save({str(tmp_path / "out.npy")!r}, np.concatenate([model.coef_[0], model.intercept_, [model.C], prob]))
        """
    )
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = np.load(tmp_path / "out.npy")
    np.testing.assert_array_equal(out[:9], sk.coef_[0])
    np.testing.assert_array_equal(out[9:10], sk.intercept_)
    assert out[10] == sk.C
    np.testing.assert_allclose(out[11:], sk.predict_proba(X)[:, 1], rtol=1e-12, atol=1e-12)


def test_fit_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        LogRegression()
    assert LogRegression(device="cpu").device.type == "cpu"

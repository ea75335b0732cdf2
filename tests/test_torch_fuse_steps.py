"""The port's step fusion (``fuse_steps``) against the JAX package's, on the
CPU.

On the CPU a window runs its K steps one after another (a CUDA graph holds
them on the card, ``tests/test_torch_gpu.py``).  Held here: the port's fused
``fit`` against the JAX wrapper's fused ``fit`` (its ``lax.scan`` windows)
for DeepSets, the FCN and in-row GraphConv over mixed-shape loaders with a
short final window; the port at K=4 against K=1, bit for bit; fused
evaluation and ``predict`` against unfused; ``PCC_FUSE_STEPS``; a resumed
fused run; the resident cache's window-stable shuffle.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu_torch import convert, factory  # noqa: E402
from point_cloud_classifier_tpu_torch.data import PointCloudLoader  # noqa: E402
from point_cloud_classifier_tpu_torch.data.resident import ResidentCache, shape_key  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import (  # noqa: E402
    write_s2pg_cache,
    write_s2ppc_cache,
    write_s2pt_cache,
)
from point_cloud_classifier_tpu_torch.models import FullyConnectedNet  # noqa: E402
from point_cloud_classifier_tpu_torch.models import wrapper as port_wrapper  # noqa: E402
from point_cloud_classifier_tpu_torch.models.wrapper import ModelWrapper  # noqa: E402

# f32 training on both sides in other summation orders, as the unfused fit
# parity tests hold it
PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-5
K = 4

MODELS = {
    "deep_sets": ("s2ppc", {"input_dim": 6, "phi_layers": [16, 16], "rho_layers": [16], "output_dim": 1,
                            "sparse_batching": True, "pooling": "mean", "layer_norm": False,
                            "activation": "gelu", "residual_block": True}),
    "fully_connected_net": ("s2pt", {"input_dim": 9, "hidden_layers": [8, 16, 8],
                                     "batch_normalization": False, "output_dim": 1}),
    "graph_net": ("s2pg", {"input_dim": 4, "output_dim": 1, "hidden_dim": 16, "activation": "tanh",
                           "use_gat": False, "gat_heads": 4, "sag_pool": False, "pool_ratio": 0.5,
                           "local_pooling": "add", "global_pooling": "mean", "deepchem_style": True}),
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fuse_data"))
    # sizes that bucket into several shapes, splits no multiple of the batch
    write_s2ppc_cache(path, n_events=(44, 19, 16), min_points=3, max_points=90, seed=1)
    write_s2pt_cache(path, n_events=(50, 21, 19), seed=2)
    write_s2pg_cache(path, n_graphs=(44, 13, 12), min_nodes=8, max_nodes=40, seed=5)
    return path


def _config(data_dir, log_dir, model, epochs=2, **trainer):
    _, model_cfg = MODELS[model]
    dataset = {"data_dir": data_dir, "batch_size": 8}
    if model == "graph_net":
        dataset.update(use_weights=True, n_features=4)
    if model == "fully_connected_net":
        dataset.update(convert_to_tensor=True)
    return {
        "meta": {"model_name": "", "dataset_name": ""},
        "dataset": dataset,
        "logging": {"log_dir": str(log_dir)},
        "model": copy.deepcopy(model_cfg),
        "trainer": {"epochs": epochs, "learning_rate": 0.003, "optimizer": "adamw",
                    "state_every": 0, **trainer},
    }


def _metrics(log_dir):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append(row["value"])
    return out


def _spy_windows(monkeypatch):
    """The length of every training window the port runs."""
    lengths = []
    original = ModelWrapper.train_window

    def spy(self, window):
        lengths.append(len(window))
        return original(self, window)

    monkeypatch.setattr(ModelWrapper, "train_window", spy)
    return lengths


@pytest.mark.parametrize("model", list(MODELS))
def test_fused_fit_matches_jax_fused_fit(data_dir, tmp_path, monkeypatch, model):
    dataset = MODELS[model][0]
    port_cfg = _config(data_dir, tmp_path / "port", model, fuse_steps=K)
    jax_cfg = _config(data_dir, tmp_path / "jax", model, fuse_steps=K)
    port = factory.get_model(model, port_cfg, device="cpu")
    ref = jax_factory.get_model(model, jax_cfg)
    assert port.fuse_steps == ref.fuse_steps == K
    params, stats = convert.convert_torch_state_dict(model, port_cfg, port.model.state_dict())
    ref.params = jax.tree.map(jnp.asarray, params)  # the JAX fit takes assigned params
    ref.batch_stats = jax.tree.map(jnp.asarray, stats)

    data = factory.get_dataloader(dataset, port_cfg)
    jax_data = jax_factory.get_dataloader(dataset, jax_cfg)
    lengths = _spy_windows(monkeypatch)
    port.fit(data.get_train_loader(), data.get_val_loader())
    ref.fit(jax_data.get_train_loader(), jax_data.get_val_loader())
    # full windows, and shorter ones flushed by a change of shape or the end
    assert max(lengths) == K and min(lengths) < K

    trained = convert.to_torch_state_dict(
        model, port_cfg, jax.tree.map(np.asarray, ref.params), jax.tree.map(np.asarray, ref.batch_stats))
    for key, value in port.model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), trained[key], rtol=0, atol=PARAM_ATOL, err_msg=key)
    ours, theirs = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert set(ours) == set(theirs)
    for tag in ("Loss/train", "Loss/val", "Accuracy/val"):
        assert len(ours[tag]) == len(theirs[tag]) == 2
        np.testing.assert_allclose(ours[tag], theirs[tag], rtol=METRIC_RTOL, err_msg=tag)
    y, p = port.predict(data.get_test_loader(), return_prob=True)
    y_ref, p_ref = ref.predict(jax_data.get_test_loader(), return_prob=True)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)


def _fit(data_dir, log_dir, model, fuse, epochs=2, resume=False, **trainer):
    cfg = _config(data_dir, log_dir, model, epochs=epochs, fuse_steps=fuse, **trainer)
    torch.manual_seed(0)
    wrapper = factory.get_model(model, cfg, device="cpu")
    data = factory.get_dataloader(MODELS[model][0], cfg)
    wrapper.fit(data.get_train_loader(), data.get_val_loader(), resume=resume)
    return wrapper, data


@pytest.mark.parametrize("model", list(MODELS))
def test_fused_fit_equals_unfused_bit_for_bit(data_dir, tmp_path, model):
    """On a streaming loader the CPU window is its steps in sequence: K=4
    and K=1 give the same bits, weights, losses and outputs."""
    fused, data = _fit(data_dir, tmp_path / "k4", model, K)
    plain, _ = _fit(data_dir, tmp_path / "k1", model, 1)
    for key, value in plain.model.state_dict().items():
        assert torch.equal(fused.model.state_dict()[key], value), key
    ours, theirs = _metrics(tmp_path / "k4"), _metrics(tmp_path / "k1")
    for tag in ("Loss/train", "Loss/val", "Accuracy/val"):
        assert ours[tag] == theirs[tag], tag
    assert ours["compile/distinct_batch_shapes"] == theirs["compile/distinct_batch_shapes"]
    y4, p4 = fused.predict(data.get_test_loader(), return_prob=True)
    y1, p1 = plain.predict(data.get_test_loader(), return_prob=True)
    np.testing.assert_array_equal(y4, y1)
    np.testing.assert_array_equal(p4, p1)


@pytest.mark.parametrize("model", ["deep_sets", "graph_net"])
def test_fused_eval_equals_unfused(data_dir, tmp_path, model):
    """Evaluation and ``predict`` over windows of same-shape runs (a shape
    change flushes, a short window ends) give the unfused outputs."""
    wrapper, data = _fit(data_dir, tmp_path / "run", model, 1, epochs=1)
    cfg = _config(data_dir, tmp_path / "run", model)
    cfg["dataset"]["batch_size"] = 4
    small = list(factory.get_dataloader(MODELS[model][0], cfg).get_val_loader())[:2]
    train = list(data.get_train_loader())
    batches = train[:5] + small + train[5:]
    keys = [shape_key(b) for b in batches]
    assert len(set(keys)) > 1 and len(keys) % 3
    y1, p1 = wrapper.predict(batches, return_prob=True)
    loss1, acc1 = wrapper._evaluate(batches)
    wrapper.fuse_steps = 3
    yk, pk = wrapper.predict(batches, return_prob=True)
    lossk, acck = wrapper._evaluate(batches)
    np.testing.assert_array_equal(yk, y1)
    np.testing.assert_array_equal(pk, p1)
    assert (lossk, acck) == (loss1, acc1)


@pytest.mark.parametrize("env, want", [("3", 3), ("0", 1), ("1", 1), (None, 5)])
def test_pcc_fuse_steps_overrides(data_dir, tmp_path, monkeypatch, env, want):
    if env is not None:
        monkeypatch.setenv("PCC_FUSE_STEPS", env)
    cfg = _config(data_dir, tmp_path, "deep_sets", fuse_steps=5)
    assert factory.get_model("deep_sets", cfg, device="cpu").fuse_steps == want
    assert port_wrapper.fuse_steps_from_env(5) == want


def test_pcc_fuse_steps_must_be_an_integer(data_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("PCC_FUSE_STEPS", "four")
    with pytest.raises(ValueError, match="PCC_FUSE_STEPS must be an integer, got 'four'"):
        factory.get_model("deep_sets", _config(data_dir, tmp_path, "deep_sets"), device="cpu")


def _point_loaders(seed=0, n=44, batch=8):
    """Unshuffled DeepSets loaders (a resumed run sees the same order) over
    clouds of 1–90 points: several shapes."""
    rng = np.random.default_rng(seed)
    events = [rng.normal(size=(int(k), 6)).astype(np.float32) for k in rng.integers(1, 90, size=n)]
    labels = rng.integers(0, 2, size=n)
    return (PointCloudLoader(events, labels, batch, shuffle=False),
            PointCloudLoader(events[:16], labels[:16], batch, shuffle=False))


def test_resumed_fused_run_continues_as_an_unfused_one(data_dir, tmp_path):
    """A fused run stopped after 2 epochs and resumed for a third ends where
    an uninterrupted fused run and an uninterrupted unfused run end."""
    train, val = _point_loaders()

    def run(log_dir, fuse, epochs, resume=False):
        cfg = _config(data_dir, log_dir, "deep_sets", epochs=epochs, fuse_steps=fuse, state_every=1)
        wrapper = factory.get_model("deep_sets", cfg, device="cpu")
        wrapper.fit(train, val, resume=resume)
        return wrapper

    straight, unfused = run(tmp_path / "straight", K, 3), run(tmp_path / "unfused", 1, 3)
    run(tmp_path / "run", K, 2)
    resumed = run(tmp_path / "run", K, 3, resume=True)
    for key, value in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], value), key
        assert torch.equal(unfused.model.state_dict()[key], value), key
    ours, ref = resumed.optimizer.state_dict()["state"], straight.optimizer.state_dict()["state"]
    for i, state in ref.items():
        for k, v in state.items():
            assert torch.equal(ours[i][k], v), (i, k)
    assert _metrics(tmp_path / "run")["Loss/train"] == _metrics(tmp_path / "straight")["Loss/train"]


def _same_shape_batches(n=20, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{
        "x": rng.normal(size=(b, 9)).astype(np.float32),
        "y": rng.integers(0, 2, size=(b, 1)).astype(np.float32),
        "y_mask": np.ones((b,), np.float32),
    } for _ in range(n)]


@pytest.mark.parametrize("k", [2, 4])
def test_resident_cache_shuffles_whole_windows(tmp_path, monkeypatch, k):
    """With ``device_resident`` the cache permutes blocks of ``fuse_steps``
    batches (the JAX trainer's ``shuffle_block=fuse_steps``), so every
    replayed window holds the batches of one first-epoch window, in order."""
    caches, windows = [], []

    class Spy(ResidentCache):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            caches.append(self)

    original = ModelWrapper.train_window

    def spy(self, window):
        windows.append([id(b) for b in window])
        return original(self, window)

    monkeypatch.setattr(port_wrapper, "ResidentCache", Spy)
    monkeypatch.setattr(ModelWrapper, "train_window", spy)
    wrapper = ModelWrapper(FullyConnectedNet(**MODELS["fully_connected_net"][1]), 1e-3, 3,
                           fuse_steps=k, device_resident=True, device="cpu")
    batches = _same_shape_batches(n=9 * k + 1)
    wrapper.fit(batches)
    cache = caches[0]
    assert cache.shuffle_block == k and cache.replay_is_window_stable(k)
    first = {id(b): i for i, b in enumerate(cache._cached)}
    orders = [[first[i] for w in windows[e * 10: (e + 1) * 10] for i in w] for e in range(3)]
    assert orders[0] == list(range(9 * k + 1))
    for order in orders[1:]:
        assert order != orders[0] and sorted(order) == orders[0]
        assert order[-1] == 9 * k  # the partial block stays last
        for w in range(9):
            block = order[w * k: (w + 1) * k]
            assert block[0] % k == 0 and block == list(range(block[0], block[0] + k))

"""The port's input pipelines against the JAX package's, on the CPU.

``ResidentCache`` replays the JAX cache's batch order; ``BackgroundIterator``
and ``prefetch_to_device`` keep order and pass errors on; the trainer takes
each pipeline (``device_resident``, ``PCC_RESIDENT``, ``PCC_BG_LOADER``,
``PCC_PREFETCH``) with the same losses as streaming; and ``train_model`` on
the flagship wire with ``device_resident`` matches the JAX ``train_model``
epoch by epoch.
"""

import copy
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

import train as jax_train  # noqa: E402
from point_cloud_classifier_tpu.data.batching import PointCloudLoader as JaxLoader  # noqa: E402
from point_cloud_classifier_tpu.data.resident import ResidentCache as JaxResidentCache  # noqa: E402
from point_cloud_classifier_tpu_torch import convert, factory  # noqa: E402
from point_cloud_classifier_tpu_torch import train as port_train  # noqa: E402
from point_cloud_classifier_tpu_torch.data import PointCloudLoader  # noqa: E402
from point_cloud_classifier_tpu_torch.data.background import BackgroundIterator  # noqa: E402
from point_cloud_classifier_tpu_torch.data.prefetch import prefetch_to_device  # noqa: E402
from point_cloud_classifier_tpu_torch.data.resident import ResidentCache  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.models.wrapper import ModelWrapper  # noqa: E402

# f32 training on both sides, sums in other orders (see test_torch_train.py)
METRIC_RTOL = 1e-5


def _events(n=90, seed=0):
    rng = np.random.default_rng(seed)
    events = [rng.normal(size=(int(k), 6)).astype(np.float32) for k in rng.integers(1, 30, size=n)]
    return events, rng.integers(0, 2, size=n)


def _loaders(n=90, batch=4, shuffle=True):
    events, labels = _events(n)
    kw = dict(shuffle=shuffle, seed=2, min_bucket=64, seg_encoding="counts")
    return PointCloudLoader(events, labels, batch, **kw), JaxLoader(events, labels, batch, **kw)


def _same(ours, theirs):
    """Two batch sequences hold the same arrays, batch for batch."""
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("epoch_offset", [0, 3])
@pytest.mark.parametrize(
    "shuffle_seed, shuffle_block, n",
    [(None, 1, 90), (7, 1, 90), (7, 2, 90), (7, 4, 90), (7, 3, 40)],
    ids=["no-shuffle", "batches", "blocks-of-2", "blocks-of-4-below-8", "blocks-of-3-below-8"],
)
def test_resident_cache_replays_the_jax_order(shuffle_seed, shuffle_block, n, epoch_offset):
    """Four epochs: the first streams the loader's shuffled order, the
    replays permute batches, or blocks where 8 full blocks exist (23 batches
    give 11 blocks of 2 and 5 of 4; 10 give 3 of 3) — as the JAX cache."""
    ours, theirs = _loaders(n)
    kw = dict(shuffle_seed=shuffle_seed, epoch_offset=epoch_offset, shuffle_block=shuffle_block)
    cache, ref = ResidentCache(ours, device="cpu", **kw), JaxResidentCache(theirs, **kw)
    for _ in range(4):
        _same(cache, ref)
        assert cache.cached and ref.cached
        assert cache._replay_block() == ref._replay_block()
        for k in (1, 2, 3, 4):
            assert cache.replay_is_window_stable(k) == ref.replay_is_window_stable(k)


@pytest.mark.parametrize("budget_batches", [0.5, 5.5], ids=["first-batch", "mid-epoch"])
def test_resident_cache_over_budget_streams_host_batches(budget_batches):
    ours, theirs = _loaders()
    budget = int(budget_batches * sum(v.nbytes for v in next(iter(_loaders()[0])).values()))
    cache = ResidentCache(ours, device="cpu", budget_bytes=budget, shuffle_seed=1)
    ref = JaxResidentCache(theirs, budget_bytes=budget, shuffle_seed=1)
    for epoch in range(4):
        got = list(cache)
        # the first epoch's batches before the trip went to the device
        host = got[int(budget_batches):] if epoch == 0 else got
        assert all(isinstance(v, np.ndarray) for b in host for v in b.values())
        _same(got, ref)
    assert not cache.cached and cache._abandoned
    assert not cache.replay_is_window_stable(1)


def test_resident_cache_budget_from_the_environment(monkeypatch):
    monkeypatch.setenv("PCC_RESIDENT_BUDGET_MB", "3")
    assert ResidentCache([], device="cpu").budget_bytes == 3 << 20
    monkeypatch.delenv("PCC_RESIDENT_BUDGET_MB")
    assert ResidentCache([], device="cpu").budget_bytes == 2 << 30


@pytest.mark.parametrize("upload_chunk", [1, 3, 64])
def test_resident_cache_chunked_upload_gives_the_same_batches(upload_chunk):
    ours, theirs = _loaders(shuffle=False)
    cache = ResidentCache(ours, device="cpu", upload_chunk=upload_chunk, shuffle_seed=4)
    ref = JaxResidentCache(theirs, shuffle_seed=4)
    for _ in range(3):
        got = list(cache)
        assert all(isinstance(v, torch.Tensor) for b in got for v in b.values())
        _same(got, ref)


def test_background_iterator_keeps_order_and_passes_errors_on():
    ours, _ = _loaders(shuffle=False)
    _same(BackgroundIterator(ours, prefetch=2), ours)

    def failing():
        yield {"x": np.zeros(2)}
        raise KeyError("packing failed")

    got = []
    with pytest.raises(KeyError, match="packing failed"):
        for batch in BackgroundIterator(failing()):
            got.append(batch)
    assert len(got) == 1


def test_background_iterator_retires_its_producer_when_the_consumer_leaves():
    before = threading.active_count()
    it = iter(BackgroundIterator(({"i": np.array(i)} for i in range(1000)), prefetch=2))
    next(it)
    it.close()  # the consumer walks away mid-epoch
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_keeps_order_on_the_cpu(size):
    ours, _ = _loaders(shuffle=False)
    got = list(prefetch_to_device(ours, size=size, device="cpu"))
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for b in got for v in b.values())
    _same(got, ours)


def _model_cfg(**model):
    return {"input_dim": 6, "phi_layers": [16, 16], "rho_layers": [16], "output_dim": 1,
            "pooling": "mean", "layer_norm": False, "activation": "gelu",
            "residual_block": True, **model}


def _net():
    return factory.get_model("deep_sets", {"model": _model_cfg(), "trainer": {
        "learning_rate": 1e-3, "epochs": 1}}, device="cpu").model


def _fit_losses(log_dir, train, val, **wrapper):
    cfg = {"model": _model_cfg(), "trainer": {"epochs": 3, "learning_rate": 1e-3,
                                              "optimizer": "adamw", "state_every": 0, **wrapper},
           "logging": {"log_dir": str(log_dir)}}
    factory.get_model("deep_sets", cfg, device="cpu").fit(train, val)
    return _metrics(log_dir)


def _metrics(log_dir):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append(row["value"])
    return out


@pytest.mark.parametrize(
    "env", [{"PCC_BG_LOADER": "1"}, {"PCC_PREFETCH": "1"}, {"PCC_BG_LOADER": "1", "PCC_PREFETCH": "1"}],
    ids=["background", "prefetch", "both"])
def test_fit_through_background_and_prefetch_equals_streaming(tmp_path, monkeypatch, env):
    train, val = _loaders(shuffle=True)[0], _loaders(n=20, shuffle=False)[0]
    want = _fit_losses(tmp_path / "stream", train, val)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    train, val = _loaders(shuffle=True)[0], _loaders(n=20, shuffle=False)[0]
    got = _fit_losses(tmp_path / "piped", train, val)
    for tag in ("Loss/train", "Loss/val", "Accuracy/val"):
        assert got[tag] == want[tag], tag


@pytest.mark.parametrize("how", ["argument", "PCC_RESIDENT"])
def test_device_resident_wraps_both_loaders(tmp_path, monkeypatch, how):
    if how == "PCC_RESIDENT":
        monkeypatch.setenv("PCC_RESIDENT", "1")
        kwargs = {}
    else:
        kwargs = {"device_resident": True}
    wrapper = ModelWrapper(_net(), 1e-3, 2, seed=5, **kwargs, device="cpu")
    assert wrapper.device_resident
    seen = []
    original = ModelWrapper._batches

    def spy(self, loader):
        seen.append(loader)
        return original(self, loader)

    monkeypatch.setattr(ModelWrapper, "_batches", spy)
    train, val = _loaders()[0], _loaders(n=20, shuffle=False)[0]
    wrapper.fit(train, val)
    caches = [x for x in seen if isinstance(x, ResidentCache)]
    assert len(caches) == len(seen) == 4  # train and val, two epochs
    assert caches[0].shuffle_seed == 5 and caches[1].shuffle_seed is None
    assert caches[0].cached and caches[1].cached


def test_put_passes_device_tensors_through():
    wrapper = ModelWrapper(_net(), 1e-3, 1, device="cpu")
    t = torch.zeros(3)
    batch = wrapper._put({"t": t, "a": np.ones(2, dtype=np.float16)})
    assert batch["t"] is t and batch["a"].dtype == torch.float16


FLAGSHIP_DATASET = {"layout": "auto", "transfer_dtype": "float16", "factor_event_cols": [1],
                    "length_sorted": True}


@pytest.mark.parametrize("seg_encoding", ["ids", "counts"])
def test_train_model_flagship_wire_resident_matches_jax(tmp_path, monkeypatch, seg_encoding):
    """``train_model`` with bench.py's wire and ``device_resident`` against
    the JAX ``train_model`` from the same initial weights: three epochs of
    per-epoch losses and val accuracy, and the batch shapes it counted."""
    write_s2ppc_cache(str(tmp_path / "data"), n_events=(700, 200, 200), min_points=3,
                      max_points=12, seed=2)
    cfg = {
        "meta": {"model_name": "", "dataset_name": ""},
        "dataset": {"data_dir": str(tmp_path / "data"), "batch_size": 128,
                    "seg_encoding": seg_encoding, **FLAGSHIP_DATASET},
        "logging": {"log_dir": str(tmp_path / "port")},
        "model": _model_cfg(factored_cols=[1]),
        "trainer": {"epochs": 3, "learning_rate": 1e-3, "optimizer": "adamw",
                    "device_resident": True, "state_every": 0},
    }
    batches = list(factory.get_dataloader("s2ppc", cfg).get_train_loader())
    assert {b["points"].ndim for b in batches} == {2, 3}  # both wires train
    jax_cfg = copy.deepcopy(cfg)
    jax_cfg["logging"]["log_dir"] = str(tmp_path / "jax")
    init = factory.get_model("deep_sets", copy.deepcopy(cfg), device="cpu").model.state_dict()
    real_get_model = jax_train.get_model

    def get_model_from_port_weights(**kwargs):
        wrapper = real_get_model(**kwargs)
        params, _ = convert.convert_torch_state_dict("deep_sets", cfg, init)
        wrapper.params = jax.tree.map(jnp.asarray, params)
        wrapper.batch_stats = {}
        return wrapper

    monkeypatch.setattr(jax_train, "get_model", get_model_from_port_weights)
    port_dir = port_train.train_model("deep_sets", "s2ppc", copy.deepcopy(cfg), return_log_dir=True,
                                      device="cpu")
    jax_dir = jax_train.train_model("deep_sets", "s2ppc", jax_cfg, return_log_dir=True)
    ours, theirs = _metrics(port_dir), _metrics(jax_dir)
    for tag in ("Loss/train", "Loss/val", "Accuracy/val"):
        assert len(ours[tag]) == len(theirs[tag]) == 3
        np.testing.assert_allclose(ours[tag], theirs[tag], rtol=METRIC_RTOL, err_msg=tag)
    assert ours["compile/distinct_batch_shapes"] == theirs["compile/distinct_batch_shapes"]
    with open(os.path.join(port_dir, "meta.json")) as a, open(os.path.join(jax_dir, "meta.json")) as b:
        meta, ref = json.load(a)["metrics"], json.load(b)["metrics"]
    assert meta["parameters"] == ref["parameters"]
    for key in ("accuracy/train", "accuracy/val"):
        assert abs(meta[key] - ref[key]) <= 1 / 200, key

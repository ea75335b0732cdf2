"""The port's ``utils/profiling.py`` and the trainer's trace and histogram
modes against the JAX package's, on the CPU.

- ``StepTimer.summary()`` and ``dump()`` equal the JAX ``StepTimer``'s on
  the same step times;
- ``PCC_TRACE=1`` writes a ``torch.profiler`` Chrome trace under
  ``{log_dir}/trace/`` from ``fit``, and warns when there is no
  ``log_dir``;
- ``PCC_TB_HISTOGRAMS=1`` with ``PCC_TENSORBOARD=1``: the port's fit logs
  the JAX fit's histograms, every tag mapped through ``convert``'s key map,
  with equal values, read back with tensorboard's ``EventAccumulator``.
"""

import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu.utils import profiling as jax_profiling  # noqa: E402
from point_cloud_classifier_tpu_torch import convert, factory  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.utils import profiling  # noqa: E402

TIMES = [
    [],
    [0.25],
    [0.003, 0.001, 0.002],
    [0.010, 0.002, 0.031, 0.004, 0.0005, 0.007, 0.012, 0.003, 0.020, 0.001, 0.0009],
]


@pytest.mark.parametrize("times", TIMES, ids=["empty", "one", "three", "eleven"])
@pytest.mark.parametrize("examples", [None, 256])
def test_step_timer_summary_equals_jax(times, examples, tmp_path):
    ours, theirs = profiling.StepTimer(examples), jax_profiling.StepTimer(examples)
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary() == theirs.summary()
    assert set(ours.summary()) == {"steps", "total_seconds", "mean_ms", "p50_ms", "p90_ms", "p99_ms"} | (
        {"examples_per_sec"} if examples and times else set())
    ours.dump(str(tmp_path / "a" / "ours.json"))
    theirs.dump(str(tmp_path / "a" / "theirs.json"))
    assert (tmp_path / "a" / "ours.json").read_text() == (tmp_path / "a" / "theirs.json").read_text()


def test_step_timer_times_its_steps():
    timer = profiling.StepTimer(4)
    for _ in range(3):
        with timer.step():
            pass
    timer.stop()  # no step open: nothing recorded
    assert timer.summary()["steps"] == 3 and timer.summary()["examples_per_sec"] > 0


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("profiling_data"))
    write_s2ppc_cache(path, n_events=(24, 8, 8), min_points=3, max_points=30, seed=3)
    return path


def _config(data_dir, log_dir):
    return {
        "meta": {"model_name": "", "dataset_name": ""},
        "dataset": {"data_dir": data_dir, "batch_size": 8},
        "logging": {"log_dir": str(log_dir)},
        "model": {"input_dim": 6, "phi_layers": [16, 16], "rho_layers": [16], "output_dim": 1,
                  "sparse_batching": True, "pooling": "mean", "layer_norm": False,
                  "activation": "gelu", "residual_block": True},
        "trainer": {"epochs": 2, "learning_rate": 0.003, "optimizer": "adamw", "state_every": 0},
    }


def test_pcc_trace_writes_a_trace_under_log_dir(data_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("PCC_TRACE", "1")
    cfg = _config(data_dir, tmp_path / "log")
    model = factory.get_model("deep_sets", cfg, device="cpu")
    data = factory.get_dataloader("s2ppc", cfg)
    model.fit(data.get_train_loader(), data.get_val_loader())
    traces = sorted(glob.glob(str(tmp_path / "log" / "trace" / "*.json")))
    assert len(traces) == 2  # one an epoch
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_no_trace_without_pcc_trace(data_dir, tmp_path, monkeypatch):
    monkeypatch.delenv("PCC_TRACE", raising=False)
    cfg = _config(data_dir, tmp_path / "log")
    model = factory.get_model("deep_sets", cfg, device="cpu")
    data = factory.get_dataloader("s2ppc", cfg)
    model.fit(data.get_train_loader())
    assert not os.path.exists(tmp_path / "log" / "trace")
    with profiling.maybe_trace(str(tmp_path / "x")):
        pass
    assert not os.path.exists(tmp_path / "x")


def test_maybe_trace_warns_without_log_dir(monkeypatch, tmp_path):
    with pytest.warns(UserWarning, match="log_dir is None"):
        with profiling.maybe_trace(None, force=True):
            pass
    with pytest.warns(UserWarning, match="log_dir is None"):
        with jax_profiling.maybe_trace(None, force=True):
            pass
    with profiling.maybe_trace(str(tmp_path), force=True):
        torch.ones(3).sum()
    assert len(glob.glob(str(tmp_path / "trace" / "*.json"))) == 1


def _histograms(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir), size_guidance={"histograms": 0})
    acc.Reload()
    return {tag: acc.Histograms(tag) for tag in acc.Tags()["histograms"]}


def test_histogram_mode_logs_the_jax_tags_with_equal_values(data_dir, tmp_path, monkeypatch):
    pytest.importorskip("tensorboard")
    monkeypatch.setenv("PCC_TENSORBOARD", "1")
    monkeypatch.setenv("PCC_TB_HISTOGRAMS", "1")
    cfg = _config(data_dir, "")
    cfg["trainer"]["fuse_steps"] = 4  # histogram mode forces windows of one step
    port_cfg, jax_cfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    port_cfg["logging"]["log_dir"] = str(tmp_path / "port")
    jax_cfg["logging"]["log_dir"] = str(tmp_path / "jax")
    port = factory.get_model("deep_sets", port_cfg, device="cpu")
    ref = jax_factory.get_model("deep_sets", jax_cfg)
    params, _ = convert.convert_torch_state_dict("deep_sets", cfg, port.model.state_dict())
    ref.params = jax.tree.map(jnp.asarray, params)
    ref.batch_stats = {}
    data = factory.get_dataloader("s2ppc", port_cfg)
    jax_data = jax_factory.get_dataloader("s2ppc", jax_cfg)
    port.fit(data.get_train_loader(), data.get_val_loader())
    ref.fit(jax_data.get_train_loader(), jax_data.get_val_loader())

    ours, theirs = _histograms(tmp_path / "port"), _histograms(tmp_path / "jax")
    tag_map = {"logits": "logits"}
    for key, tree, path, _ in convert._mapping("deep_sets", cfg):
        if tree == "params":
            for suffix in ("_weight", "_grad"):
                tag_map["/".join(path) + suffix] = key + suffix
    assert set(theirs) == set(tag_map) and set(ours) == set(tag_map.values())
    assert len(ours) == 2 * len(list(port.model.parameters())) + 1
    for jax_tag, port_tag in tag_map.items():
        a, b = ours[port_tag], theirs[jax_tag]
        assert [e.step for e in a] == [e.step for e in b] == [0, 1], jax_tag
        for ea, eb in zip(a, b):
            ha, hb = ea.histogram_value, eb.histogram_value
            assert ha.num == hb.num, jax_tag
            for field in ("min", "max", "sum", "sum_squares"):
                x, y = getattr(ha, field), getattr(hb, field)
                assert abs(x - y) <= 1e-5 * max(1.0, abs(y)), (jax_tag, field, x, y)

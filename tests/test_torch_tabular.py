"""The port's tabular slice against the JAX package's, on the CPU, from the
same seeded numpy inputs: ``TabularLoader`` batches byte for byte,
``Step2PointTabular``'s columns against the JAX DataFrame, the
FullyConnectedNet's logits (train and eval mode), BatchNorm statistics and
gradients against the Flax model's with weights moved by ``convert``, a
3-epoch ``fit`` against the JAX ``fit``, and the FCN checkpoint mapping both
ways and through its files."""

import copy
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu.data.batching import TabularLoader as JaxTabularLoader  # noqa: E402
from point_cloud_classifier_tpu.data.tabular import Step2PointTabular as JaxTabular  # noqa: E402
from point_cloud_classifier_tpu.models import FullyConnectedNet as JaxFCN  # noqa: E402
from point_cloud_classifier_tpu_torch import convert, factory  # noqa: E402
from point_cloud_classifier_tpu_torch.data import Step2PointTabular, TabularLoader  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2pt_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.data.tabular import COLUMN_ORDER, FEATURE_ORDER  # noqa: E402
from point_cloud_classifier_tpu_torch.models import FullyConnectedNet  # noqa: E402
from point_cloud_classifier_tpu_torch.models.wrapper import masked_bce  # noqa: E402

# the same f32 math in other summation orders (matrix products, the masked
# batch moments)
LOGITS = dict(rtol=1e-5, atol=1e-6)
# a few Adam steps keep the weights within a few f32 ulps of their scale
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5
SPLITS = (50, 21, 19)  # none a multiple of the batch sizes below


@pytest.fixture
def data_dir(tmp_path):
    write_s2pt_cache(str(tmp_path), n_events=SPLITS, seed=3)
    return str(tmp_path)


def _same_batches(ours, theirs, epochs=2):
    for _ in range(epochs):
        ours_b, theirs_b = list(ours), list(theirs)
        assert len(ours_b) == len(theirs_b) == len(ours) == len(theirs)
        for a, b in zip(ours_b, theirs_b):
            assert list(a) == list(b)
            for key in a:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
                assert a[key].tobytes() == b[key].tobytes(), key


@pytest.mark.parametrize("batch_size", [7, 50, None], ids=["partial", "exact", "whole"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_tabular_loader_byte_identical(shuffle, batch_size):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 9))  # float64 in, f32 out
    y = rng.integers(0, 2, size=50)
    _same_batches(TabularLoader(X, y, batch_size, shuffle, seed=4),
                  JaxTabularLoader(X, y, batch_size, shuffle, seed=4))


def test_columns_match_the_jax_dataframe(data_dir):
    ours, theirs = Step2PointTabular(data_dir), JaxTabular(data_dir)
    for split, get in (("train", "get_train_loader"), ("val", "get_val_loader"), ("test", "get_test_loader")):
        assert list(ours.datasets[split]) == COLUMN_ORDER == list(theirs.datasets[split].columns)
        columns, frame = getattr(ours, get)(), getattr(theirs, get)()
        assert list(columns) == FEATURE_ORDER + ["label"] == list(frame.columns)
        values = frame.to_numpy()
        for i, name in enumerate(columns):
            assert columns[name].dtype == frame[name].to_numpy().dtype, name
            np.testing.assert_array_equal(columns[name].astype(values.dtype), values[:, i], err_msg=name)
        assert "event_id" not in ours.datasets[split]


@pytest.mark.parametrize("batch_size", [8, 16])
def test_loaders_byte_identical_to_jax(data_dir, batch_size):
    ours = Step2PointTabular(data_dir, convert_to_tensor=True, batch_size=batch_size)
    theirs = JaxTabular(data_dir, convert_to_tensor=True, batch_size=batch_size)
    for get in ("get_train_loader", "get_val_loader", "get_test_loader"):
        _same_batches(getattr(ours, get)(), getattr(theirs, get)())


def _fcn_cfg(bn=True, hidden=(8, 16, 8)):
    return {"input_dim": 9, "hidden_layers": list(hidden), "batch_normalization": bn, "output_dim": 1}


def _batch(seed=0, b=16, k=11):
    """A batch of ``b`` rows, the last ``b − k`` of them padding (zeros)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(k, 9))
    y = rng.integers(0, 2, size=k)
    return next(iter(TabularLoader(X, y, b, shuffle=False)))


def _port_and_jax_vars(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    net = FullyConnectedNet(**cfg, generator=gen)
    with torch.no_grad():  # running statistics away from their 0/1 start
        for module in net.modules():
            if hasattr(module, "running_mean"):
                module.running_mean.uniform_(-0.5, 0.5, generator=gen)
                module.running_var.uniform_(0.5, 2.0, generator=gen)
    params, stats = convert.convert_torch_state_dict("fully_connected_net", {"model": cfg}, net.state_dict())
    return net, {"params": jax.tree.map(jnp.asarray, params), "batch_stats": jax.tree.map(jnp.asarray, stats)}


def _jax_loss(variables, batch, cfg, train):
    def loss(params):
        out = JaxFCN(**cfg).apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=train, mutable=["batch_stats"] if train else False,
        )
        logits, new = out if train else (out, {"batch_stats": variables["batch_stats"]})
        per = optax.sigmoid_binary_cross_entropy(logits, batch["y"]) * batch["y_mask"][:, None]
        return jnp.sum(per) / jnp.maximum(jnp.sum(batch["y_mask"]), 1.0), (logits, new)
    return jax.value_and_grad(loss, has_aux=True)(variables["params"])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no-bn"])
@pytest.mark.parametrize("rows", [16, 11, 1], ids=["full", "partial", "one-row"])
def test_fcn_matches_flax_logits_stats_and_gradients(bn, train, rows):
    cfg = _fcn_cfg(bn)
    net, variables = _port_and_jax_vars(cfg)
    batch = _batch(k=rows)
    (loss_ref, (logits_ref, new_vars)), grads_ref = _jax_loss(variables, jax.tree.map(jnp.asarray, batch), cfg, train)

    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    net.train(train)
    logits = net(tensors, train=train)
    loss = masked_bce(logits, tensors["y"], tensors["y_mask"])
    loss.backward()
    assert logits.dtype == torch.float32 and logits.shape == (16, 1)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_ref), **LOGITS)
    np.testing.assert_allclose(loss.item(), float(loss_ref), **LOGITS)
    grads = convert.to_torch_state_dict(
        "fully_connected_net", {"model": cfg}, jax.tree.map(np.asarray, grads_ref), new_vars["batch_stats"]
    )
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=1e-5, atol=1e-6, err_msg=name)
    for name, buf in net.named_buffers():  # train mode moved them from the real rows only
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(buf.numpy(), np.asarray(grads[name]), **LOGITS, err_msg=name)


def test_fcn_padding_rows_change_nothing():
    """The same real rows with and without padding rows beside them: the same
    logits, batch statistics and gradients (the mask is what keeps them out)."""
    cfg = _fcn_cfg()
    outs = []
    for b in (11, 16):
        net, _ = _port_and_jax_vars(cfg)
        batch = {k: torch.from_numpy(v) for k, v in _batch(b=b).items()}
        logits = net(batch, train=True)
        masked_bce(logits, batch["y"], batch["y_mask"]).backward()
        outs.append((logits[:11].detach(), [p.grad.clone() for p in net.parameters()],
                     [buf.clone() for buf in net.buffers()]))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-7)


def _fit_config(data_dir, log_dir, bn=True, batch_size=16):
    """configs/fully_connected_net.yaml at narrow widths, 3 epochs."""
    return {
        "meta": {"model_name": "", "dataset_name": ""},
        "dataset": {"data_dir": data_dir, "convert_to_tensor": True, "batch_size": batch_size},
        "logging": {"log_dir": log_dir},
        "model": _fcn_cfg(bn),
        "trainer": {"epochs": 3, "learning_rate": 0.01, "state_every": 0},
    }


def _metrics(log_dir):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append(row["value"])
    return out


# A Linear's bias ahead of a BatchNorm has a gradient of 0 in exact
# arithmetic (the batch mean is subtracted); each side's rounding leaves a
# residue of ~1e-9 that Adam scales up to steps near lr, so those biases, and
# the running means that take them in, drift apart (0.014 after one epoch
# here).  Train-mode outputs do not see them; eval-mode outputs do.
_FREE = ("network.0.bias", "network.3.bias", "network.6.bias",
         "network.1.running_mean", "network.4.running_mean", "network.7.running_mean")


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no-bn"])
def test_fit_matches_jax_fit(data_dir, tmp_path, bn):
    cfg = _fit_config(data_dir, "", bn)
    port_cfg, jax_cfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    port_cfg["logging"]["log_dir"] = str(tmp_path / "port")
    jax_cfg["logging"]["log_dir"] = str(tmp_path / "jax")
    port = factory.get_model("fully_connected_net", port_cfg, device="cpu")
    ref = jax_factory.get_model("fully_connected_net", jax_cfg)
    params, stats = convert.convert_torch_state_dict("fully_connected_net", cfg, port.model.state_dict())
    ref.params = jax.tree.map(jnp.asarray, params)  # the JAX fit takes assigned weights
    ref.batch_stats = jax.tree.map(jnp.asarray, stats)

    data = factory.get_dataloader("s2pt", port_cfg)
    jax_data = jax_factory.get_dataloader("s2pt", jax_cfg)
    port.fit(data.get_train_loader(), data.get_val_loader())
    ref.fit(jax_data.get_train_loader(), jax_data.get_val_loader())

    ours, theirs = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    for tag in ("Loss/train",) + (() if bn else ("Loss/val", "Accuracy/val")):
        assert len(ours[tag]) == len(theirs[tag]) == 3
        np.testing.assert_allclose(ours[tag], theirs[tag], rtol=LOSS_RTOL, err_msg=tag)
    trained = convert.to_torch_state_dict(
        "fully_connected_net", cfg, jax.tree.map(np.asarray, ref.params), jax.tree.map(np.asarray, ref.batch_stats)
    )
    state = port.model.state_dict()
    for key, value in state.items():
        if not (bn and key in _FREE):
            np.testing.assert_allclose(value.numpy(), trained[key], rtol=0, atol=PARAM_ATOL, err_msg=key)
    if bn:  # with the JAX run's free biases and running means the eval outputs agree too
        port.model.load_state_dict({**state, **{k: torch.tensor(trained[k]) for k in _FREE}})
    y, p = port.predict(data.get_test_loader(), return_prob=True)
    y_ref, p_ref = ref.predict(jax_data.get_test_loader(), return_prob=True)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no-bn"])
def test_fcn_convert_round_trip_exact(bn, tmp_path):
    cfg = {"model": _fcn_cfg(bn, hidden=(32, 32, 64))}
    net, variables = _port_and_jax_vars(cfg["model"], seed=5)
    state = net.state_dict()
    params, stats = convert.convert_torch_state_dict("fully_connected_net", cfg, state)
    back = convert.to_torch_state_dict("fully_connected_net", cfg, params, stats)
    assert list(back) == list(state)  # torch's own key order, num_batches_tracked included
    for key, value in state.items():
        np.testing.assert_array_equal(back[key], value.numpy(), err_msg=key)
    # the Flax model's own tree names, and a strict load of what comes back
    flax_vars = JaxFCN(**cfg["model"]).init(jax.random.PRNGKey(0), _batch(), train=False)
    assert jax.tree.structure(flax_vars["params"]) == jax.tree.structure(variables["params"])
    assert jax.tree.structure(flax_vars.get("batch_stats", {})) == jax.tree.structure(variables["batch_stats"])
    FullyConnectedNet(**cfg["model"]).load_state_dict({k: torch.as_tensor(v) for k, v in back.items()}, strict=True)

    # the files: the port's state_dict → the JAX pickle → a state_dict again
    torch.save(state, tmp_path / "port.pt")
    convert.convert_checkpoint("fully_connected_net", cfg, str(tmp_path / "port.pt"), str(tmp_path / "jax.pt"))
    with open(tmp_path / "jax.pt", "rb") as f:
        tree = pickle.load(f)
    for leaf, want in zip(jax.tree.leaves(tree["params"]), jax.tree.leaves(params)):
        np.testing.assert_array_equal(leaf, want)
    convert.export_torch_checkpoint("fully_connected_net", cfg, str(tmp_path / "jax.pt"), str(tmp_path / "ref.pt"))
    again = torch.load(tmp_path / "ref.pt", weights_only=True)
    assert list(again) == list(state)
    for key, value in state.items():
        assert torch.equal(again[key], value), key

"""GraphNet slice 2 through the entry points a user calls, against the JAX
package on the CPU: ``factory.get_model("graph_net")`` + ``ModelWrapper``
``fit`` and ``predict`` on both sides from the same weights (moved through
``convert``) over the loaders of ``factory.get_dataloader("s2pg")`` on one
seeded synthetic cache.  The configs: SAG pooling (GraphConv and GAT), max
aggregation (flat, in-row, in-row with SAG), ``knn_k: 8`` with GAT, SAG or
max (the kNN edge-list arm), and the flat GraphConv and GAT with ``knn_k:
0``.  Positions lie on a grid of 1/64, so every kNN distance is exact in f32
on both sides (docs/parity_torch.md §3)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu_torch import convert, factory  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2pg_cache  # noqa: E402

# f32 training, a few Adam steps: the same math in other summation orders
PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-5
CONFIGS = {
    "sag": (dict(sag_pool=True), {}, "in_src"),
    "gat-sag": (dict(use_gat=True, sag_pool=True), {}, "in_src"),
    "max-flat": (dict(local_pooling="max"), {"graph_layout": "flat"}, "src"),
    "max-inrow": (dict(local_pooling="max"), {}, "in_src"),
    "max-sag-inrow": (dict(local_pooling="max", sag_pool=True), {}, "in_src"),
    "knn-gat": (dict(knn_k=8, use_gat=True), {}, "src"),
    "knn-sag": (dict(knn_k=8, sag_pool=True, local_pooling="mean"), {}, "src"),
    "knn-max": (dict(knn_k=8, local_pooling="max"), {}, "src"),
    "flat-add": ({}, {"graph_layout": "flat"}, "src"),
    "flat-gat": (dict(use_gat=True), {"graph_layout": "flat"}, "src"),
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("s2pg_slice2"))
    write_s2pg_cache(path, n_graphs=(16, 8, 8), min_nodes=12, max_nodes=30, seed=11, position_grid=1 / 64)
    return path


def _config(data_dir, log_dir, name):
    """configs/base.yaml + configs/graph_net.yaml at narrow width."""
    model, dataset, _ = CONFIGS[name]
    return {
        "meta": {"model_name": "", "dataset_name": ""},
        "dataset": {"data_dir": data_dir, "batch_size": 8, "use_weights": True, "n_features": 4, **dataset},
        "logging": {"log_dir": str(log_dir)},
        "model": {**dict(input_dim=4, output_dim=1, hidden_dim=8, activation="tanh", use_gat=False,
                         gat_heads=4, sag_pool=False, pool_ratio=0.5, local_pooling="add",
                         global_pooling="mean", deepchem_style=True), **model},
        "trainer": {"epochs": 2, "learning_rate": 0.01, "optimizer": "adam", "state_every": 0},
    }


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fit_and_predict_match_jax(data_dir, tmp_path, name):
    port_cfg = _config(data_dir, tmp_path / "port", name)
    jax_cfg = _config(data_dir, tmp_path / "jax", name)
    port = factory.get_model("graph_net", port_cfg, device="cpu")
    ref = jax_factory.get_model("graph_net", jax_cfg)
    params, stats = convert.convert_torch_state_dict("graph_net", port_cfg, port.model.state_dict())
    ref.params = jax.tree.map(jnp.asarray, params)  # the JAX fit takes assigned params
    ref.batch_stats = jax.tree.map(jnp.asarray, stats)

    data, jax_data = factory.get_dataloader("s2pg", port_cfg), jax_factory.get_dataloader("s2pg", jax_cfg)
    wire = CONFIGS[name][2]
    for a, b in zip(data.get_train_loader(), jax_data.get_train_loader(), strict=True):
        assert wire in a and sorted(a) == sorted(b) and all(a[k].tobytes() == b[k].tobytes() for k in a)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.fit(data.get_train_loader(), data.get_val_loader())
    ref.fit(jax_data.get_train_loader(), jax_data.get_val_loader())

    trained = convert.to_torch_state_dict(
        "graph_net", port_cfg, jax.tree.map(np.asarray, ref.params), jax.tree.map(np.asarray, ref.batch_stats))
    moved = convert.to_torch_state_dict("graph_net", port_cfg, params, stats)
    for key, value in port.model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), trained[key], rtol=0, atol=PARAM_ATOL, err_msg=key)
        assert not np.array_equal(value.numpy(), moved[key]), f"{key} did not train"
    y, p = port.predict(data.get_test_loader(), return_prob=True)
    y_ref, p_ref = ref.predict(jax_data.get_test_loader(), return_prob=True)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(p, p_ref, rtol=METRIC_RTOL, atol=1e-6)


@pytest.fixture(scope="module")
def outlier_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("s2pg_outliers"))
    write_s2pg_cache(path, n_graphs=(16, 8, 8), min_nodes=42, max_nodes=60, seed=12, outliers=True)
    return path


@pytest.mark.parametrize(
    "model, wires, warned",
    [
        (dict(use_gat=True), {"src"}, "exact-zero edge weight"),
        (dict(sag_pool=True), {"src"}, "duplicate directed edges"),
        (dict(local_pooling="max"), {"src", "in_src"}, "in/out-degree overflows"),
        ({}, {"edge_slot", "in_src"}, None),
    ],
    ids=["gat-zero-weight", "sag-multigraph", "max-in-degree", "graphconv-edge-slots"],
)
def test_demoted_loader_trains_as_jax(outlier_dir, tmp_path, model, wires, warned):
    """``layout: auto`` over a cache whose first graph of each split holds a
    duplicate edge, an exact-zero weight and a node of 40 incoming edges: the
    port's loader warns and ships the wires the JAX loader ships (a whole
    loader demoted to the flat wire, a batch on the flat wire, a batch of
    edge-slot triples), and ``fit`` and ``predict`` match the JAX package's."""
    cfg = _config(outlier_dir, tmp_path / "port", "sag")
    cfg["model"].update({"sag_pool": False, **model})
    jax_cfg = {**cfg, "logging": {"log_dir": str(tmp_path / "jax")}}
    port = factory.get_model("graph_net", cfg, device="cpu")
    ref = jax_factory.get_model("graph_net", jax_cfg)
    params, stats = convert.convert_torch_state_dict("graph_net", cfg, port.model.state_dict())
    ref.params, ref.batch_stats = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
    data, jax_data = factory.get_dataloader("s2pg", cfg), jax_factory.get_dataloader("s2pg", jax_cfg)
    found = []
    for get in (data.get_train_loader, jax_data.get_train_loader):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            found.append((list(get()), [str(w.message) for w in caught]))
    (ours, ours_warned), (theirs, theirs_warned) = found
    assert ours_warned == theirs_warned and len(ours_warned) == (warned is not None)
    assert warned is None or warned in ours_warned[0]
    assert {w for b in ours for w in wires if w in b} == wires
    for a, b in zip(ours, theirs, strict=True):
        assert sorted(a) == sorted(b) and all(a[k].tobytes() == b[k].tobytes() for k in a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the demotions warn, as above
        port.fit(data.get_train_loader(), data.get_val_loader())
        ref.fit(jax_data.get_train_loader(), jax_data.get_val_loader())
        y, p = port.predict(data.get_test_loader(), return_prob=True)
        y_ref, p_ref = ref.predict(jax_data.get_test_loader(), return_prob=True)
    trained = convert.to_torch_state_dict(
        "graph_net", cfg, jax.tree.map(np.asarray, ref.params), jax.tree.map(np.asarray, ref.batch_stats))
    for key, value in port.model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(value.numpy(), trained[key], rtol=0, atol=PARAM_ATOL, err_msg=key)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(p, p_ref, rtol=METRIC_RTOL, atol=1e-6)

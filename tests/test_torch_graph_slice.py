"""The GraphNet serving slice end to end: ``factory.get_model("graph_net")`` on
a JAX-format ``best_model.pt``, then ``predict`` over
``factory.get_dataloader("s2pg")``'s test loader on a seeded synthetic S2PG
cache, against the JAX package's own ``get_model`` + ``predict`` on the same
cache and checkpoint."""

import os
import pickle

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu.models import GraphNet as JaxGraphNet  # noqa: E402
from point_cloud_classifier_tpu_torch import factory  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2pg_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import gat  # noqa: E402

# f32 probabilities through the same math on both sides (sum orders differ)
F32 = dict(rtol=1e-5, atol=1e-6)
N_GRAPHS = (6, 6, 21)  # train, val, test: the test split is 3 batches of 8


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("s2pg"))
    write_s2pg_cache(path, n_graphs=N_GRAPHS, min_nodes=40, max_nodes=72, seed=3)
    return path


def _config(data_dir, **model):
    """configs/base.yaml + configs/graph_net.yaml at narrow width."""
    cfg = {
        "model": dict(
            input_dim=4, output_dim=1, hidden_dim=16, activation="tanh", use_gat=False,
            gat_heads=4, sag_pool=False, pool_ratio=0.5, local_pooling="add",
            global_pooling="mean", deepchem_style=True,
        ),
        "dataset": {"data_dir": data_dir, "batch_size": 8, "use_weights": False, "n_features": 4},
        "trainer": {"epochs": 1, "learning_rate": 0.001},
        "logging": {"log_dir": None},
    }
    cfg["model"].update(model)
    return cfg


def _write_jax_checkpoint(run_dir, cfg, batch, seed=0):
    """``best_model.pt`` as the JAX trainer writes it, with running statistics
    moved off their initial values."""
    variables = JaxGraphNet(**cfg["model"]).init(jax.random.PRNGKey(seed), batch, train=False)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a)).astype(np.float32),
        variables["batch_stats"],
    )
    with open(os.path.join(run_dir, "best_model.pt"), "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, variables["params"]), "batch_stats": stats}, f)


def test_cache_is_lineage_like(data_dir):
    """Node counts, features, in-degree bound, strictly positive weights,
    both labels, contiguous event ids."""
    loader = factory.get_dataloader("s2pg", _config(data_dir, use_gat=True)).get_test_loader()
    assert loader.n_examples == N_GRAPHS[2] and len(loader) == 3
    assert loader.feat_dim == 4 and loader.node_counts.min() >= 40 and loader.node_counts.max() <= 72
    assert 0 < loader.graph_max_indeg.max() <= 8 and (loader.weights > 0).all()
    assert (loader.edge_mult == 1).all()  # simple graphs
    assert set(np.unique(loader.labels)) == {0.0, 1.0}
    with np.load(os.path.join(data_dir, "S2PG", "test", "graph_00000.npz")) as g:
        assert sorted(g.files) == ["edges", "event_id", "features", "label", "weights"]
        assert int(g["event_id"]) == N_GRAPHS[0] + N_GRAPHS[1]


@pytest.mark.parametrize(
    "model", [dict(use_gat=True), dict(local_pooling="add"), dict(local_pooling="mean")],
    ids=["gat", "graphconv-add", "graphconv-mean"],
)
def test_predict_matches_jax(data_dir, tmp_path, model):
    cfg = _config(data_dir, **model)
    jax_data = jax_factory.get_dataloader("s2pg", cfg)
    port_data = factory.get_dataloader("s2pg", cfg)
    jax_batches, port_batches = list(jax_data.get_test_loader()), list(port_data.get_test_loader())
    for a, b in zip(port_batches, jax_batches, strict=True):
        assert sorted(a) == sorted(b) and all(a[k].tobytes() == b[k].tobytes() for k in a)
    _write_jax_checkpoint(tmp_path, cfg, jax_batches[0])

    y_ref, p_ref = jax_factory.get_model("graph_net", cfg, str(tmp_path)).predict(
        jax_data.get_test_loader(), return_prob=True
    )
    served = factory.get_model("graph_net", cfg, str(tmp_path))
    assert served.device.type == "cpu"
    launches = gat.gat_attention.launches
    y, p = served.predict(port_data.get_test_loader(), return_prob=True)
    assert gat.gat_attention.launches == launches  # a CPU run launches no kernel
    np.testing.assert_array_equal(y, y_ref)
    assert p.shape == p_ref.shape == (N_GRAPHS[2], 1) and p.dtype == np.float32
    np.testing.assert_allclose(p, p_ref, **F32)


@pytest.mark.parametrize(
    "model", [dict(use_gat=True), dict(fused_inrow=True), {}], ids=["gat", "fused-inrow", "graphconv-add"]
)
def test_fit_and_train_step_train_graph_net(data_dir, model):
    """``fit`` and ``train_step`` run on GraphNet (parity with the JAX ``fit``
    is in test_torch_graph_train.py): the loss is finite, every parameter
    gets a gradient, and the running statistics move."""
    cfg = _config(data_dir, **model)
    wrapper = factory.get_model("graph_net", cfg)
    loader = factory.get_dataloader("s2pg", cfg).get_train_loader()
    before = {k: v.clone() for k, v in wrapper.model.state_dict().items()}
    loss = wrapper.train_step(next(iter(loader)))
    assert torch.isfinite(loss)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in wrapper.model.parameters())
    wrapper.fit(loader)
    after = wrapper.model.state_dict()
    for key in ("conv1.lin_rel.weight" if not model.get("use_gat") else "conv1.lin.weight",
                "bn1.running_mean", "bn3.running_var", "fc2.weight"):
        assert not torch.equal(after[key], before[key]), key
    assert not wrapper.model.training  # fit leaves the model in eval mode


def test_fused_inrow_config_ships_the_out_rows_the_jax_loader_ships(data_dir):
    """``model.fused_inrow`` sets ``emit_out_rows`` in both factories, and the
    port's loader now serves it: batches byte-identical, out-rows included."""
    cfg = _config(data_dir, fused_inrow=True)
    jax_data, data = jax_factory.get_dataloader("s2pg", cfg), factory.get_dataloader("s2pg", cfg)
    assert data.loader_kwargs["emit_out_rows"] and jax_data.emit_out_rows
    for a, b in zip(data.get_test_loader(), jax_data.get_test_loader(), strict=True):
        assert sorted(a) == sorted(b) and {"out_dst", "out_w", "out_pos"} <= set(a)
        assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize(
    "model, dataset, match",
    [
        (dict(local_pooling="max"), {}, "require_inrow"),
        (dict(knn_k=8), {}, "flat"),
        ({}, {"graph_layout": "flat"}, "flat"),
    ],
    ids=["max", "knn", "flat"],
)
def test_dataloader_gates_for_unported_configs_raise(data_dir, model, dataset, match):
    """The JAX factory's gates, set as it sets them, lead to wires the port
    does not serve yet; its loaders refuse them."""
    cfg = _config(data_dir, **model)
    cfg["dataset"].update(dataset)
    jax_data = jax_factory.get_dataloader("s2pg", cfg)
    data = factory.get_dataloader("s2pg", cfg)
    for key, value in data.loader_kwargs.items():
        assert value == getattr(jax_data, {"layout": "graph_layout"}.get(key, key)), key
    with pytest.raises(NotImplementedError, match=match):
        data.get_test_loader()


def test_weighted_gat_config_sets_the_jax_gates(data_dir):
    cfg = _config(data_dir, use_gat=True)
    cfg["dataset"]["use_weights"] = True
    kw = factory.get_dataloader("s2pg", cfg).loader_kwargs
    assert kw["dense_w_is_existence"] and kw["flat_if_multigraph"] and kw["layout"] == "auto"
    jax_data = jax_factory.get_dataloader("s2pg", cfg)
    assert (jax_data.dense_w_is_existence, jax_data.flat_if_multigraph, jax_data.graph_layout) == (
        True, True, "auto")


def test_create_dataset_raises(data_dir):
    cfg = _config(data_dir)
    cfg["dataset"]["create_dataset"] = True
    with pytest.raises(NotImplementedError, match="h5py"):
        factory.get_dataloader("s2pg", cfg)

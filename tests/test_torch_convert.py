"""The port's checkpoint mapping against the JAX package's convert.py, both
directions, exact; and its keys against the port's DeepSets and GraphNet
modules."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu import convert as jax_convert  # noqa: E402
from point_cloud_classifier_tpu.data.batching import GraphLoader as JaxGraphLoader  # noqa: E402
from point_cloud_classifier_tpu.models import DeepSets as JaxDeepSets  # noqa: E402
from point_cloud_classifier_tpu.models import GraphNet as JaxGraphNet  # noqa: E402
from point_cloud_classifier_tpu_torch import convert  # noqa: E402
from point_cloud_classifier_tpu_torch.models import DeepSets, GraphNet  # noqa: E402

CONFIGS = {
    "flagship-narrow": dict(phi_layers=[16, 16], rho_layers=[16], layer_norm=False, residual_block=True),
    "plain-ln": dict(phi_layers=[16, 8], rho_layers=[8, 8], layer_norm=True, residual_block=False),
    "residual-ln": dict(phi_layers=[8, 8, 8], rho_layers=[8], layer_norm=True, residual_block=True),
    "no-rho": dict(phi_layers=[8], rho_layers=[], layer_norm=False, residual_block=False),
}


def _model_cfg(name):
    return dict(input_dim=6, output_dim=1, activation="gelu", pooling="mean", **CONFIGS[name])


def _jax_params(model_cfg, seed=0):
    batch = {
        "points": np.zeros((16, 6), np.float32),
        "seg": np.zeros((16,), np.int32),
        "y": np.zeros((2, 1), np.float32),
        "y_mask": np.ones((2,), np.float32),
    }
    variables = JaxDeepSets(**model_cfg).init(jax.random.PRNGKey(seed), batch, train=False)
    return jax.tree.map(np.asarray, variables["params"])


def _assert_trees_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tree_to_state_dict_matches_jax(name):
    cfg = {"model": _model_cfg(name)}
    params = _jax_params(cfg["model"])
    ours = convert.to_torch_state_dict("deep_sets", cfg, params, {})
    theirs = jax_convert.to_torch_state_dict("deep_sets", cfg, params, {})
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_dict_to_tree_matches_jax_and_round_trips(name):
    cfg = {"model": _model_cfg(name)}
    model = DeepSets(**cfg["model"], generator=torch.Generator().manual_seed(1))
    state = model.state_dict()
    ours, ours_stats = convert.convert_torch_state_dict("deep_sets", cfg, state)
    theirs, theirs_stats = jax_convert.convert_torch_state_dict("deep_sets", cfg, state)
    _assert_trees_equal(ours, theirs)
    assert ours_stats == theirs_stats == {}
    # the JAX tree structure: the port's tree initialises the JAX model
    _assert_trees_equal(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), ours),
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), _jax_params(cfg["model"])),
    )
    back = convert.to_torch_state_dict("deep_sets", cfg, ours, {})
    assert list(back) == list(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v.numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_tree_loads_strictly_into_port_model(name):
    cfg = {"model": _model_cfg(name)}
    params = _jax_params(cfg["model"], seed=2)
    model = DeepSets(**cfg["model"])
    sd = convert.to_torch_state_dict("deep_sets", cfg, params, {})
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    np.testing.assert_array_equal(model.phi[-1].weight.detach().numpy(), params["phi_final_kernel"].T)


def test_unknown_and_leftover_keys_raise():
    cfg = {"model": _model_cfg("flagship-narrow")}
    state = DeepSets(**cfg["model"]).state_dict()
    with pytest.raises(ValueError, match="unconverted"):
        convert.convert_torch_state_dict("deep_sets", cfg, {**state, "extra.weight": torch.zeros(1)})
    with pytest.raises(KeyError):
        convert.convert_torch_state_dict("deep_sets", cfg, {k: v for k, v in state.items() if k != "rho.0.bias"})
    with pytest.raises(NotImplementedError, match="no converter"):
        convert.to_torch_state_dict("logistic_regression", cfg, {}, {})
    # a SAG config over a tree without SAG's score network names what is missing
    sag = {"model": _graph_cfg("gat-sag")}
    params, stats = _jax_graph_variables(_graph_cfg("gat"))
    with pytest.raises(KeyError, match="SAGPool_0/GraphConv_0/TorchLinear_0"):
        convert.to_torch_state_dict("graph_net", sag, params, stats)
    with pytest.raises(KeyError, match="GATConv_0"):
        convert.to_torch_state_dict("graph_net", {"model": _graph_cfg("gat")}, {}, {})


def test_converted_tree_is_a_copy_of_the_live_weights():
    """An optimizer step on the model after conversion leaves the tree as it
    was: no entry is a view of a parameter (biases are not transposed)."""
    cfg = _model_cfg("flagship-narrow")
    model = DeepSets(**cfg)
    params, _ = convert.convert_torch_state_dict("deep_sets", {"model": cfg}, model.state_dict())
    before = jax.tree.map(np.copy, params)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    _assert_trees_equal(params, before)


GRAPH_CONFIGS = {
    "graphconv": dict(use_gat=False),
    "gat": dict(use_gat=True),
    "graphconv-sag": dict(use_gat=False, sag_pool=True),
    "gat-sag": dict(use_gat=True, sag_pool=True),
}


def _graph_cfg(name):
    """configs/graph_net.yaml at narrow width."""
    return dict(input_dim=4, hidden_dim=16, output_dim=1, activation="tanh", gat_heads=4,
                deepchem_style=True, **GRAPH_CONFIGS[name])


def _jax_graph_variables(model_cfg, seed=0):
    rng = np.random.default_rng(seed)
    graph = {"features": rng.normal(size=(5, 4)).astype(np.float32),
             "edges": np.array([[0, 1, 2], [1, 2, 3]]), "weights": np.ones(3, np.float32), "label": 1}
    batch = next(iter(JaxGraphLoader([graph] * 2, 2, shuffle=False, layout="dense")))
    variables = JaxGraphNet(**model_cfg).init(jax.random.PRNGKey(seed), batch, train=False)
    # move the running statistics off their 0/1 initial values
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a)).astype(np.float32),
                         variables["batch_stats"])
    return jax.tree.map(np.asarray, variables["params"]), stats


@pytest.mark.parametrize("name", list(GRAPH_CONFIGS))
def test_graph_net_tree_round_trips_exactly(name):
    """A JAX init tree → the port's state_dict (every key of the port's
    GraphNet, in its order) → the same tree, exactly, every key consumed."""
    cfg = {"model": _graph_cfg(name)}
    params, stats = _jax_graph_variables(cfg["model"], seed=3)
    sd = convert.to_torch_state_dict("graph_net", cfg, params, stats)
    model = GraphNet(**cfg["model"])
    assert list(sd) == list(model.state_dict())
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    back, back_stats = convert.convert_torch_state_dict("graph_net", cfg, model.state_dict())
    _assert_trees_equal(back, params)
    _assert_trees_equal(back_stats, stats)
    with pytest.raises(ValueError, match="unconverted"):
        convert.convert_torch_state_dict("graph_net", cfg, {**sd, "conv1.lin_src.weight": sd["fc1.weight"]})


def test_graph_conv_mapping_matches_jax():
    """GraphConv checkpoints map as the JAX package's converter maps them
    (it refuses GAT, whose layout the port fixes for its own checkpoints)."""
    cfg = {"model": _graph_cfg("graphconv")}
    params, stats = _jax_graph_variables(cfg["model"])
    ours = convert.to_torch_state_dict("graph_net", cfg, params, stats)
    theirs = jax_convert.to_torch_state_dict("graph_net", cfg, params, stats)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    state = GraphNet(**cfg["model"], generator=torch.Generator().manual_seed(2)).state_dict()
    ours, ours_stats = convert.convert_torch_state_dict("graph_net", cfg, state)
    theirs, theirs_stats = jax_convert.convert_torch_state_dict("graph_net", cfg, state)
    _assert_trees_equal(ours, theirs)
    _assert_trees_equal(ours_stats, theirs_stats)


@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_knn_graph_net_tree_uses_the_dense_graph_conv_names(local_pooling):
    """Under ``knn_k > 0`` with add or mean Flax names the convolutions
    ``DenseGraphConv_k``; the port's state_dict keys stay the reference's, and
    the tree round-trips exactly.  The JAX package's own converter knows only
    ``GraphConv_k`` and fails on such a tree."""
    model_cfg = dict(_graph_cfg("graphconv"), knn_k=3, local_pooling=local_pooling)
    cfg = {"model": model_cfg}
    rng = np.random.default_rng(4)
    graph = {"features": rng.normal(size=(6, 4)).astype(np.float32),
             "edges": np.array([[0, 1, 2], [1, 2, 3]]), "weights": np.ones(3, np.float32), "label": 1}
    batch = next(iter(JaxGraphLoader([graph] * 2, 2, shuffle=False, layout="flat")))
    variables = JaxGraphNet(**model_cfg).init(jax.random.PRNGKey(4), batch, train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    assert {"DenseGraphConv_0", "DenseGraphConv_1"} <= set(params) and "GraphConv_0" not in params

    sd = convert.to_torch_state_dict("graph_net", cfg, params, stats)
    model = GraphNet(**model_cfg)
    assert list(sd) == list(model.state_dict())
    assert list(sd)[:3] == ["conv1.lin_rel.weight", "conv1.lin_rel.bias", "conv1.lin_root.weight"]
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    back, back_stats = convert.convert_torch_state_dict("graph_net", cfg, model.state_dict())
    _assert_trees_equal(back, params)
    _assert_trees_equal(back_stats, stats)
    with pytest.raises(KeyError):
        jax_convert.to_torch_state_dict("graph_net", cfg, params, stats)
    # without knn_k the same state_dict maps to GraphConv_k, as before
    plain, _ = convert.convert_torch_state_dict("graph_net", {"model": _graph_cfg("graphconv")}, model.state_dict())
    assert "GraphConv_0" in plain and "DenseGraphConv_0" not in plain

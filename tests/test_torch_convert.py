"""The port's checkpoint mapping against the JAX package's convert.py, both
directions, exact; and its keys against the port's DeepSets modules."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_classifier_tpu import convert as jax_convert  # noqa: E402
from point_cloud_classifier_tpu.models import DeepSets as JaxDeepSets  # noqa: E402
from point_cloud_classifier_tpu_torch import convert  # noqa: E402
from point_cloud_classifier_tpu_torch.models import DeepSets  # noqa: E402

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
    with pytest.raises(NotImplementedError):
        convert.to_torch_state_dict("graph_net", cfg, {}, {})

"""Dataset- and model-name dispatch, and checkpoint restore.

Counterpart of ``get_dataloader`` and ``get_model`` in
``point_cloud_classifier_tpu/factory.py``.  Ported: the S2PPC point clouds
with DeepSets, and the S2PG graphs with GraphNet on the dense in-row wire;
the other datasets and families raise and name the ROADMAP item that brings
them.
"""

from __future__ import annotations

import os

import torch

from point_cloud_classifier_tpu_torch.data import Step2PointGraph, Step2PointPointCloud
from point_cloud_classifier_tpu_torch.models import DeepSets, GraphNet, ModelWrapper

_NOT_PORTED = {
    "logistic_regression": "ROADMAP Queue 1, the tabular slice",
    "fully_connected_net": "ROADMAP Queue 1, the tabular slice",
}
_DATASETS_NOT_PORTED = {
    "s2pt": "ROADMAP Queue 1, the tabular slice",
}
_MODELS = {"deep_sets": DeepSets, "graph_net": GraphNet}


def _graph_dataset_config(config: dict) -> dict:
    """``config["dataset"]`` with the JAX factory's S2PG gates
    (``point_cloud_classifier_tpu/factory.py``).  Weighted GAT checks for
    exact-zero wire weights, GAT and SAG demote a multigraph, max pooling
    needs the full in-row wire, ``fused_inrow`` the out-row wire, and the
    layout defaults to ``auto`` (``flat`` for ``knn_k``).  The loaders raise
    on the wires the port does not serve yet: ``require_inrow`` and
    ``flat``."""
    ds_cfg = dict(config["dataset"])
    mdl = config.get("model", {})
    use_gat = mdl.get("use_gat", False)
    pooling = mdl.get("local_pooling", "add")
    not_flat = ds_cfg.get("graph_layout") != "flat"
    if use_gat and ds_cfg.get("use_weights", True) and not_flat:
        ds_cfg.setdefault("dense_w_is_existence", True)
    if (use_gat or mdl.get("sag_pool", False)) and not_flat:
        ds_cfg.setdefault("flat_if_multigraph", True)
    if not use_gat and pooling == "max" and ds_cfg.get("graph_layout") in ("dense", "auto"):
        ds_cfg.setdefault("require_inrow", True)
    if mdl.get("fused_inrow", False) and not_flat:
        ds_cfg.setdefault("emit_out_rows", True)
    if "graph_layout" not in ds_cfg:
        if not use_gat and pooling == "max":
            ds_cfg.setdefault("require_inrow", True)
        eligible = use_gat or pooling in ("add", "mean", "max")
        ds_cfg["graph_layout"] = "auto" if eligible and not mdl.get("knn_k", 0) else "flat"
    return ds_cfg


def get_dataloader(dataset_name: str, config: dict):
    """The data module for ``dataset_name`` over ``config["dataset"]``.  As
    in the JAX package, S2PPC defaults to ``layout="auto"``, which the port
    serves on the flat wire below a batch size of 128 and refuses above;
    S2PG defaults to ``graph_layout="auto"``, which the port serves on the
    dense in-row wire and refuses where the JAX loader would ship a batch
    another way."""
    if dataset_name in _DATASETS_NOT_PORTED:
        raise NotImplementedError(
            f"{dataset_name} is not ported to PyTorch yet "
            f"({_DATASETS_NOT_PORTED[dataset_name]})"
        )
    if dataset_name == "s2pg":
        return Step2PointGraph(**_graph_dataset_config(config))
    if dataset_name != "s2ppc":
        raise ValueError(f"Unknown dataset: {dataset_name}")
    ds_cfg = dict(config["dataset"])
    ds_cfg.setdefault("layout", "auto")
    return Step2PointPointCloud(**ds_cfg)


def get_model(model_name: str, config: dict, model_dir: str = None):
    """A ``ModelWrapper`` around ``config["model"]``, restored from
    ``{model_dir}/best_model.pt`` when ``model_dir`` is given.  Fresh
    weights are drawn from ``trainer.seed`` (default 0)."""
    if model_name in _NOT_PORTED:
        raise NotImplementedError(
            f"{model_name} is not ported to PyTorch yet ({_NOT_PORTED[model_name]})"
        )
    if model_name not in _MODELS:
        raise ValueError(f"Unknown model: {model_name}")

    trainer = config["trainer"]
    generator = torch.Generator().manual_seed(int(trainer.get("seed", 0)))
    net = _MODELS[model_name](**config["model"], generator=generator)
    model = ModelWrapper(net, **trainer, **config.get("logging", {}))
    if model_dir is not None:
        model_path = os.path.join(model_dir, "best_model.pt")
        if not os.path.exists(model_path):
            raise FileNotFoundError(f"{model_name} model not found at {model_path}")
        model.load(model_path)
        print(f"Loaded {model_name} model from {model_path}")
    return model

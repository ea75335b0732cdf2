"""Dataset- and model-name dispatch, checkpoint restore and the ``--quant``
resolution.

Counterpart of ``point_cloud_classifier_tpu/factory.py``: every dataset
(S2PT tabular rows, S2PPC point clouds, S2PG graphs) and every model family
of ``MODEL_DATASETS``.  ``logistic_regression`` restores from ``model.pkl``,
the networks from ``best_model.pt``.  ``apply_quant`` routes a DeepSets
evaluation to the int8 chain (``ops/quant.py``) where ``--quant`` resolves
to ``int8``.
"""

from __future__ import annotations

import os

import torch

from point_cloud_classifier_tpu_torch.data import (
    Step2PointGraph,
    Step2PointPointCloud,
    Step2PointTabular,
)
from point_cloud_classifier_tpu_torch.models import (
    DeepSets,
    FullyConnectedNet,
    GraphNet,
    LogRegression,
    ModelWrapper,
)

MODEL_DATASETS = {
    "logistic_regression": "s2pt",
    "fully_connected_net": "s2pt",
    "deep_sets": "s2ppc",
    "graph_net": "s2pg",
}
_MODELS = {"fully_connected_net": FullyConnectedNet, "deep_sets": DeepSets, "graph_net": GraphNet}


def _graph_dataset_config(config: dict) -> dict:
    """``config["dataset"]`` with the JAX factory's S2PG gates
    (``point_cloud_classifier_tpu/factory.py``): weighted GAT checks for
    exact-zero wire weights and GAT and SAG for a multigraph (the loader
    demotes itself to the flat wire where it finds one), max pooling needs
    the full in-row wire (``require_inrow``: a batch past it ships flat),
    ``fused_inrow`` the out-row wire, and the layout defaults to ``auto``
    (``flat`` for ``knn_k``)."""
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
    """The data module for ``dataset_name`` over ``config["dataset"]``; with
    ``create_dataset: true`` it first builds the cache from the raw shower
    files under ``data_dir`` (over ``workers`` forked processes).  As
    in the JAX package, S2PT reads the cached rows (a ``TabularLoader`` with
    ``convert_to_tensor``, else the rows' columns); S2PPC defaults to
    ``layout="auto"`` (the dense per-cloud-row wire per batch from a batch
    size of 128, else flat) and takes the loader's wire options
    (``transfer_dtype``, ``factor_event_cols``, ``bucket_factor``,
    ``length_sorted``); S2PG defaults to ``graph_layout="auto"`` (the dense
    in-row wire, and every other wire where the JAX loader ships one), and
    to ``"flat"`` for a ``knn_k`` model."""
    if dataset_name == "s2pt":
        return Step2PointTabular(**config["dataset"])
    if dataset_name == "s2pg":
        return Step2PointGraph(**_graph_dataset_config(config))
    if dataset_name != "s2ppc":
        raise ValueError(f"Unknown dataset: {dataset_name}")
    ds_cfg = dict(config["dataset"])
    ds_cfg.setdefault("layout", "auto")
    return Step2PointPointCloud(**ds_cfg)


def get_model(model_name: str, config: dict, model_dir: str = None, device: str = None):
    """The model for ``model_name``, restored from ``model_dir`` when given
    (``model.pkl`` for ``logistic_regression``, else ``best_model.pt``).  A
    network comes in a ``ModelWrapper`` around ``config["model"]``: fresh
    weights are drawn from ``trainer.seed`` (default 0), and every other
    ``trainer`` key (``device_resident`` among them) goes to the wrapper.
    The model runs (``LogRegression`` solves) on the card, and the call
    raises where there is none, unless ``device`` says otherwise
    (``"cpu"``); the device is no part of the config, so a run's
    ``config.yaml`` does not depend on it."""
    if model_name == "logistic_regression":
        model = LogRegression(device=device)
        if model_dir is not None:
            model_path = os.path.join(model_dir, "model.pkl")
            if not os.path.exists(model_path):
                raise FileNotFoundError(f"LogisticRegression model not found at {model_path}")
            model.load(model_path)
            print(f"Loaded LogisticRegression model from {model_path}")
        return model
    if model_name not in _MODELS:
        raise ValueError(f"Unknown model: {model_name}")

    trainer = config["trainer"]
    generator = torch.Generator().manual_seed(int(trainer.get("seed", 0)))
    net = _MODELS[model_name](**config["model"], generator=generator)
    model = ModelWrapper(net, **trainer, **config.get("logging", {}), device=device)
    if model_dir is not None:
        model_path = os.path.join(model_dir, "best_model.pt")
        if not os.path.exists(model_path):
            raise FileNotFoundError(f"{model_name} model not found at {model_path}")
        model.load(model_path)
        print(f"Loaded {model_name} model from {model_path}")
    return model


# The JAX package's int8 crossover: "auto" takes int8 from a widest φ layer
# of 1024 (a TPU measurement, kept as the JAX package states it).  On an
# NVIDIA H100 80GB HBM3 at 700 W the DeepSets eval step at B=256 (φ [w, w],
# f32, resident batches; chip_smoke.py phase 25, PERF.md §5) takes ×1.83,
# ×1.34 and ×1.01 the best float route's time in int8 at w = 256, 512 and
# 1024, and ×0.69 at 2048: the card's crossover lies between 1024 and 2048.
# A new default waits for a benchmark cell that reads int8 evaluation.
_INT8_AUTO_MIN_WIDTH = 1024


def resolve_quant(config: dict, model_name: str, quant: str) -> str:
    """The path a ``--quant`` request takes, as the JAX package resolves it:
    ``"auto"`` → ``"int8"`` for a DeepSets without layer norm whose widest φ
    layer is at least ``_INT8_AUTO_MIN_WIDTH``, else ``"none"``; explicit
    values pass through."""
    if quant in (None, "none"):
        return "none"
    if quant == "auto":
        if model_name != "deep_sets":
            return "none"
        model_cfg = config.get("model", {})
        if model_cfg.get("layer_norm"):
            return "none"
        widths = model_cfg.get("phi_layers") or []
        if not widths or max(widths) < _INT8_AUTO_MIN_WIDTH:
            return "none"
        return "int8"
    return quant


def apply_quant(config: dict, model_name: str, quant: str) -> None:
    """Route evaluation and serving to the int8 chain: sets
    ``config["model"]["quant"]`` where ``quant`` resolves to ``int8``
    (f32 checkpoints load unchanged; the weights are quantized at each
    forward), nothing where it resolves to float, and raises the JAX
    package's error for a model other than DeepSets.  A layer-norm DeepSets
    keeps its float chain inside the model."""
    quant = resolve_quant(config, model_name, quant)
    if quant == "none":
        return
    if model_name != "deep_sets":
        raise ValueError(f"--quant {quant} is only supported for deep_sets (got {model_name})")
    config["model"]["quant"] = quant

"""Model-name dispatch + checkpoint restore, as the serving entry points use it.

Counterpart of ``get_model`` in ``point_cloud_classifier_tpu/factory.py``.
Only DeepSets is ported; the other families raise and name the ROADMAP
item that brings them.
"""

from __future__ import annotations

import os

import torch

from point_cloud_classifier_tpu_torch.models import DeepSets, ModelWrapper

_NOT_PORTED = {
    "logistic_regression": "ROADMAP Queue 1, the tabular slice",
    "fully_connected_net": "ROADMAP Queue 1, the tabular slice",
    "graph_net": "ROADMAP Queue 1, the GraphNet slices",
}


def get_model(model_name: str, config: dict, model_dir: str = None):
    """A ``ModelWrapper`` around ``config["model"]``, restored from
    ``{model_dir}/best_model.pt`` when ``model_dir`` is given.  Fresh
    weights are drawn from ``trainer.seed`` (default 0)."""
    if model_name in _NOT_PORTED:
        raise NotImplementedError(
            f"{model_name} is not ported to PyTorch yet ({_NOT_PORTED[model_name]})"
        )
    if model_name != "deep_sets":
        raise ValueError(f"Unknown model: {model_name}")

    trainer = config["trainer"]
    generator = torch.Generator().manual_seed(int(trainer.get("seed", 0)))
    net = DeepSets(**config["model"], generator=generator)
    model = ModelWrapper(net, **trainer, **config.get("logging", {}))
    if model_dir is not None:
        model_path = os.path.join(model_dir, "best_model.pt")
        if not os.path.exists(model_path):
            raise FileNotFoundError(f"{model_name} model not found at {model_path}")
        model.load(model_path)
        print(f"Loaded {model_name} model from {model_path}")
    return model

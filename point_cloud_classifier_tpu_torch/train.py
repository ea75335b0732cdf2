"""Training runs: ``train_model`` and ``resume_training``.

Counterpart of ``train_model`` and ``resume_training`` in the repository's
``train.py``, with the same run lifecycle: a versioned run directory
(``logging.log_dir`` rewritten to it, ``meta.model_name`` and
``meta.dataset_name`` filled in), the loaders and the model from the
factories, the resolved ``config.yaml``, ``fit``, the final ``model.pt``,
then ``accuracy/train``, ``accuracy/val`` and ``parameters`` in
``meta.json``.  Accuracy is computed with numpy, as sklearn's
``accuracy_score`` computes it.  The config's ``trainer`` section reaches
the wrapper whole, so ``trainer.device_resident: true`` trains from the
resident cache, as in the JAX trainer.

Not ported yet: the evaluation plots (``plots=True``, ROADMAP Queue 1 item
16), and the command line (Queue 1 item 10): callers pass the config dict,
or read one with ``utils.config.load_config``.
"""

from __future__ import annotations

import os

import numpy as np

from point_cloud_classifier_tpu_torch.factory import get_dataloader, get_model
from point_cloud_classifier_tpu_torch.utils.config import load_config, save_config
from point_cloud_classifier_tpu_torch.utils.log import TrainingLogger


def accuracy(y_true, y_pred) -> float:
    """The share of rows whose 0/1 prediction equals the label."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float(np.mean(y_true == y_pred))


def train_model(
    model_name: str,
    dataset_name: str,
    config: dict,
    plots: bool = False,
    return_log_dir: bool = False,
    device: str = None,
):
    """A whole training run (the JAX package's ``train_model``); mutates
    ``config`` as it does.  Runs on the card and raises where there is none,
    unless ``device="cpu"``; ``config.yaml`` and ``meta.json`` are the same
    bytes either way."""
    if plots:
        raise NotImplementedError(
            "evaluation plots are not ported yet (ROADMAP Queue 1 item 16)"
        )
    dataset_name = dataset_name.lower()
    model_name = model_name.lower()

    logger = TrainingLogger(model_name, dataset_name, **config["logging"])
    version = logger.get_version()
    log_dir = os.path.join(config["logging"]["log_dir"], f"version_{version}")
    config["logging"]["log_dir"] = log_dir
    config["meta"]["model_name"] = model_name
    config["meta"]["dataset_name"] = dataset_name

    dataloader = get_dataloader(dataset_name=dataset_name, config=config)
    model = get_model(model_name=model_name, config=config, device=device)

    train_loader = dataloader.get_train_loader()
    val_loader = dataloader.get_val_loader()

    save_config(config=config, log_dir=log_dir)
    model.fit(train_loader, val_loader)
    model.save(save_dir=log_dir)

    y_true_train, y_pred_train = model.predict(train_loader)
    y_true_val, y_pred_val = model.predict(val_loader)

    logger.log_metric("accuracy/train", round(accuracy(y_true_train, y_pred_train), 6))
    logger.log_metric("accuracy/val", round(accuracy(y_true_val, y_pred_val), 6))
    logger.log_metric("parameters", model.get_trainable_parameters())

    if return_log_dir:
        return log_dir
    return None


def resume_training(model_dir: str, config: dict = None, device: str = None):
    """Continue an interrupted run in ``model_dir`` from its full state.

    Rebuilds the loaders and the model from the run's resolved config
    (``config``, or else ``{model_dir}/config.yaml``, read without PyYAML),
    restores the weights, optimizer state, epoch and early-stop counters, and
    continues ``fit`` to the configured epoch count, on the card unless
    ``device="cpu"``."""
    if config is None:
        config = load_config(os.path.join(model_dir, "config.yaml"))
    model_name = config["meta"]["model_name"]
    dataset_name = config["meta"]["dataset_name"]
    dataloader = get_dataloader(dataset_name=dataset_name, config=config)
    model = get_model(model_name=model_name, config=config, device=device)
    model.log_dir = model_dir
    model.checkpoint_path = os.path.join(model_dir, "best_model.pt")

    train_loader = dataloader.get_train_loader()
    val_loader = dataloader.get_val_loader()
    model.fit(train_loader, val_loader, resume=True)
    model.save(save_dir=model_dir)
    return model

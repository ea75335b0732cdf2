"""Runs of the command line: ``train_model``, ``resume_training``,
``evaluate_model``, ``infer`` and ``infer_raw``.

Counterpart of the functions of the same names in the repository's
``train.py``, with the same run lifecycle and files:

- ``train_model``: a versioned run directory (``logging.log_dir`` rewritten
  to it, ``meta.model_name`` and ``meta.dataset_name`` filled in), the
  loaders and the model from the factories, the resolved ``config.yaml``,
  ``fit``, the final ``model.pt`` (``model.pkl`` for ``logistic_regression``),
  then ``accuracy/train``, ``accuracy/val`` and ``parameters`` in
  ``meta.json``.  The config's ``trainer`` section reaches the wrapper whole,
  so ``trainer.device_resident: true`` trains from the resident cache, as in
  the JAX trainer.  ``plots=True`` then draws the val split's confusion
  matrix, ROC and precision-recall curves into the run directory, under the
  JAX package's file names, which say ``test`` (``utils/plots.py``).
- ``resume_training``: the run continued from its full state.
- ``evaluate_model``: ``metrics.json`` (the three splits' accuracies, and
  ``quant`` where it is not ``none``) and ``classification_report.txt`` of
  the test split, under ``{model_dir}/eval`` by default, or
  ``{model_dir}/eval_int8`` when ``quant`` resolves to ``int8`` (DeepSets'
  int8 chain, ``ops/quant.py``), then the test split's three plots where
  matplotlib is installed (without it, one line says so).
- ``infer``: a CSV of one split's probabilities, the train split unshuffled,
  also through the int8 chain where ``quant`` asks for it.
- ``infer_raw``: a CSV of the probabilities of every event of a raw shower
  file, keyed by the file's event ids (``data/inference.inference_loader``:
  the run's preprocessing and the scaler of dataset creation).

Under a mesh (``trainer.data_parallel`` / ``trainer.n_model``, or
``PCC_DATA_PARALLEL`` / ``PCC_N_MODEL``) every rank runs ``train_model`` and
``resume_training``: the process group starts before the run directory is
chosen, rank 0 chooses it and hands its version to the others, and rank 0
alone writes ``config.yaml`` and ``meta.json`` (the wrapper writes the rest
on rank 0 too), which are those of a meshless run.  Every rank predicts
(a prediction gathers over the ranks); the writer rank alone draws.

Accuracy and the report are computed with numpy (``utils/metrics.py``), as
sklearn computes them.  Each runs on the card and raises where there is
none, unless the caller passes ``device="cpu"``; what they write is the
same either way.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch.distributed as dist

from point_cloud_classifier_tpu_torch.factory import (
    apply_quant,
    get_dataloader,
    get_model,
    resolve_quant,
)
from point_cloud_classifier_tpu_torch.parallel.mesh import init_process_group, mesh_options, rank_device
from point_cloud_classifier_tpu_torch.utils.config import load_config, save_config
from point_cloud_classifier_tpu_torch.utils.log import TrainingLogger
from point_cloud_classifier_tpu_torch.utils.metrics import accuracy, classification_report
from point_cloud_classifier_tpu_torch.utils.plots import (
    plot_confusion_matrix,
    plot_precision_recall_curve,
    plot_roc_curve,
    pyplot,
)


def train_model(
    model_name: str,
    dataset_name: str,
    config: dict,
    plots: bool = False,
    return_log_dir: bool = False,
    device: str = None,
):
    """A whole training run (the JAX package's ``train_model``); mutates
    ``config`` as it does."""
    if plots:
        pyplot("train_model(plots=True)")  # no matplotlib: raise before the run directory exists
    dataset_name = dataset_name.lower()
    model_name = model_name.lower()

    logger, version = _run_version(model_name, dataset_name, config, device)
    log_dir = os.path.join(config["logging"]["log_dir"], f"version_{version}")
    config["logging"]["log_dir"] = log_dir
    config["meta"]["model_name"] = model_name
    config["meta"]["dataset_name"] = dataset_name

    dataloader = get_dataloader(dataset_name=dataset_name, config=config)
    model = get_model(model_name=model_name, config=config, device=device)

    train_loader = dataloader.get_train_loader()
    val_loader = dataloader.get_val_loader()

    if logger is not None:
        save_config(config=config, log_dir=log_dir)
    model.fit(train_loader, val_loader)
    model.save(save_dir=log_dir)

    y_true_train, y_pred_train = model.predict(train_loader)
    y_true_val, y_pred_val = model.predict(val_loader)

    if logger is not None:
        logger.log_metric("accuracy/train", round(accuracy(y_true_train, y_pred_train), 6))
        logger.log_metric("accuracy/val", round(accuracy(y_true_val, y_pred_val), 6))
        logger.log_metric("parameters", model.get_trainable_parameters())

    if plots:
        # the JAX package draws the val split under its default split name
        y_true_val, y_prob_val = model.predict(val_loader, return_prob=True)
        if logger is not None:
            _draw(y_true_val, y_pred_val, y_prob_val, log_dir)

    if return_log_dir:
        return log_dir
    return None


def _draw(y_true, y_pred, y_prob, save_dir: str) -> None:
    """The confusion matrix, precision-recall and ROC plots of one split."""
    plot_confusion_matrix(y_true, y_pred, save_dir)
    plot_precision_recall_curve(y_true, y_prob, save_dir)
    plot_roc_curve(y_true, y_prob, save_dir)


def _run_version(model_name: str, dataset_name: str, config: dict, device):
    """``(logger, version)`` of a new run: the logger that made the run
    directory, or None on a mesh rank other than 0, which takes rank 0's
    version."""
    trainer = config.get("trainer", {})
    data_parallel, n_model = mesh_options(trainer.get("data_parallel", False), trainer.get("n_model", 1))
    if not (data_parallel or n_model > 1):
        logger = TrainingLogger(model_name, dataset_name, **config["logging"])
        return logger, logger.get_version()
    init_process_group(rank_device(device))
    logger = None
    if dist.get_rank() == 0:
        logger = TrainingLogger(model_name, dataset_name, **config["logging"])
    version = [logger.get_version() if logger is not None else None]
    dist.broadcast_object_list(version, src=0)
    return logger, version[0]


def resume_training(model_dir: str, config: dict = None, device: str = None):
    """Continue an interrupted run in ``model_dir`` from its full state.

    Rebuilds the loaders and the model from the run's resolved config
    (``config``, or else ``{model_dir}/config.yaml``, read without PyYAML),
    restores the weights, optimizer state, epoch and early-stop counters, and
    continues ``fit`` to the configured epoch count."""
    if config is None:
        config = load_config(os.path.join(model_dir, "config.yaml"))
    model_name = config["meta"]["model_name"]
    dataset_name = config["meta"]["dataset_name"]
    if model_name == "logistic_regression":
        raise ValueError("logistic_regression trains in one shot; nothing to resume")
    dataloader = get_dataloader(dataset_name=dataset_name, config=config)
    model = get_model(model_name=model_name, config=config, device=device)
    model.log_dir = model_dir
    model.checkpoint_path = os.path.join(model_dir, "best_model.pt")

    train_loader = dataloader.get_train_loader()
    val_loader = dataloader.get_val_loader()
    model.fit(train_loader, val_loader, resume=True)
    model.save(save_dir=model_dir)
    return model


def _restore(model_dir: str, config: dict, quant: str, device: str):
    """(the data module, the restored model) of a finished run with its
    resolved ``config``."""
    model_name = config["meta"]["model_name"]
    apply_quant(config, model_name, quant)
    dataloader = get_dataloader(dataset_name=config["meta"]["dataset_name"], config=config)
    model = get_model(model_name=model_name, config=config, model_dir=model_dir, device=device)
    return dataloader, model


def infer(model_dir: str, split: str = "test", output: str = None, quant: str = "none", device: str = None):
    """One split's predictions from a finished run → ``index, y_true,
    probability, prediction`` rows in a CSV (default
    ``{model_dir}/predictions_{split}.csv``).  The train loader is read
    unshuffled, so that ``index`` counts the loader's order; a
    length-sorted train loader still sorts by size (as in the JAX
    package)."""
    config = load_config(os.path.join(model_dir, "config.yaml"))
    dataloader, model = _restore(model_dir, config, quant, device)
    loader = {
        "train": dataloader.get_train_loader,
        "val": dataloader.get_val_loader,
        "test": dataloader.get_test_loader,
    }[split]()
    if hasattr(loader, "shuffle"):
        loader.shuffle = False

    y_true, y_prob = model.predict(loader, return_prob=True)
    y_true = np.asarray(y_true).reshape(-1)
    y_prob = np.asarray(y_prob).reshape(-1)
    output = output or os.path.join(model_dir, f"predictions_{split}.csv")
    with open(output, "w") as f:
        f.write("index,y_true,probability,prediction\n")
        for i, (t, p) in enumerate(zip(y_true, y_prob)):
            f.write(f"{i},{int(t)},{p:.6f},{int(p >= 0.5)}\n")
    print(f"Wrote {len(y_true)} predictions to {output}")
    return output


def infer_raw(model_dir: str, input_path: str, output: str = None, quant: str = "none", device: str = None):
    """Predictions for a raw shower file (no labels, no cache) → ``event_id,
    probability, prediction`` rows in a CSV (default
    ``{input stem}_predictions.csv``), the run's preprocessing and persisted
    scalers applied to the file."""
    from point_cloud_classifier_tpu_torch.data.inference import inference_loader

    config = load_config(os.path.join(model_dir, "config.yaml"))
    model_name = config["meta"]["model_name"]
    apply_quant(config, model_name, quant)
    loader, event_ids = inference_loader(config["meta"]["dataset_name"], config, input_path)
    model = get_model(model_name=model_name, config=config, model_dir=model_dir, device=device)
    _, y_prob = model.predict(loader, return_prob=True)
    y_prob = np.asarray(y_prob).reshape(-1)

    output = output or os.path.splitext(input_path)[0] + "_predictions.csv"
    with open(output, "w") as f:
        f.write("event_id,probability,prediction\n")
        for ev, p in zip(event_ids, y_prob):
            f.write(f"{int(ev)},{p:.6f},{int(p >= 0.5)}\n")
    print(f"Wrote {len(y_prob)} predictions to {output}")
    return output


def evaluate_model(model_dir: str, save_dir: str = None, quant: str = "none", device: str = None):
    """Reload a finished run, score its three splits and write
    ``metrics.json`` and the test split's ``classification_report.txt`` into
    ``save_dir`` (default ``{model_dir}/eval``, or ``eval_{quant}`` for a
    quantized path, decided after ``"auto"`` resolves)."""
    config = load_config(os.path.join(model_dir, "config.yaml"))
    quant = resolve_quant(config, config["meta"]["model_name"], quant)
    dataloader, model = _restore(model_dir, config, quant, device)
    if save_dir is None:
        save_dir = os.path.join(model_dir, "eval" if quant == "none" else f"eval_{quant}")
    os.makedirs(save_dir, exist_ok=True)

    test_loader = dataloader.get_test_loader()
    y_true_test, y_pred_test = model.predict(test_loader)
    acc_test = accuracy(y_true_test, y_pred_test)
    print("accuracy/test", round(acc_test, 6))
    y_true_train, y_pred_train = model.predict(dataloader.get_train_loader())
    acc_train = accuracy(y_true_train, y_pred_train)
    print("accuracy/train", round(acc_train, 6))
    y_true_val, y_pred_val = model.predict(dataloader.get_val_loader())
    acc_val = accuracy(y_true_val, y_pred_val)
    print("accuracy/val", round(acc_val, 6))

    metrics = {
        "accuracy_train": float(acc_train),
        "accuracy_val": float(acc_val),
        "accuracy_test": float(acc_test),
    }
    if quant != "none":
        metrics["quant"] = quant
    with open(os.path.join(save_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=4)
    with open(os.path.join(save_dir, "classification_report.txt"), "w") as f:
        f.write(classification_report(y_true_test, y_pred_test))
    try:
        pyplot("evaluate_model's plots")
    except ImportError as e:
        print(f"{e}; no plots written")
        return metrics
    y_true_test, y_prob_test = model.predict(test_loader, return_prob=True)
    if getattr(model, "writer", True):
        _draw(y_true_test, y_pred_test, y_prob_test, save_dir)
    return metrics

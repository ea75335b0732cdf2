"""Deployment export: a trained run as ``torch.export`` programs.

Counterpart of ``point_cloud_classifier_tpu/serving.py``.  The eval
computation itself is exported, with the weights inside, so that a serving
host runs it with nothing but PyTorch: no model classes, no config, no
checkpoint format.

- **One program a bucketed batch shape.**  The loaders emit static shapes;
  each distinct one is traced once by ``torch.export.export`` and saved as
  ``shape_{n}.pt2``.  ``manifest.json`` maps the shape key (the JAX
  package's :func:`_shape_key`, with numpy dtype names) to the file, and
  :class:`ExportedModel` picks the program by the incoming batch's key.
- **The programs hold only ATen operations.**  The trace runs under
  ``ops/dispatch.force_plain()`` (the counterpart of ``force_xla``) on a
  CPU copy of the model in eval mode, so no binding to the port's CUDA
  library and no CUDA-device constant is inside.  One trace serves the CPU
  and the card: :class:`ExportedModel` moves it to its device at load
  (``torch.export.passes.move_to_device_pass``), where the JAX package
  lowers once per platform.  The int8 chain (``quant="int8"``,
  ``ops/quant.py``) survives export: its quantize passes and
  ``aten._int_mm`` are ATen operations.
- **Probabilities out**, the sigmoid of the logits, as
  ``ModelWrapper.predict`` gives them.

A program takes the arrays the model reads, as ``ModelWrapper.predict``
hands them (a kNN GraphNet drops the batch's edge arrays); the shape key is
taken over the whole loader batch, as in the JAX package.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Iterable, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_unflatten

MANIFEST = "manifest.json"
PLATFORMS = ("cpu", "cuda")


def _shape_key(batch: Dict) -> str:
    """Canonical key for one bucketed batch shape (order-independent)."""
    items = sorted(
        (k, tuple(np.shape(v)), str(np.asarray(v).dtype) if not hasattr(v, "dtype") else str(v.dtype))
        for k, v in batch.items()
    )
    return ";".join(f"{k}:{'x'.join(map(str, s))}:{d}" for k, s, d in items)


class _Probabilities(nn.Module):
    """A batch dict → per-event probabilities: the sigmoid of
    ``model(batch, train=False)``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.sigmoid(self.model(batch, train=False))


def _eval_fn(wrapper, quant: str = "none") -> nn.Module:
    """The serving computation of ``wrapper``'s model, on a CPU copy in eval
    mode.  A DeepSets copy takes ``fused_phi="off"`` (a user's ``"on"``
    would otherwise name the kernel route) and ``quant``; another model with
    a ``quant`` other than ``"none"`` raises."""
    from point_cloud_classifier_tpu_torch.models.deep_sets import DeepSets

    model = copy.deepcopy(wrapper.model).cpu().eval()
    if isinstance(model, DeepSets):
        model.fused_phi = "off"
        if quant != "none":
            model.quant = quant
    elif quant != "none":
        raise ValueError(f"quant={quant!r} is only supported for DeepSets")
    return _Probabilities(model).eval()


def export_run(
    model_dir: str,
    out_dir: str = None,
    quant: str = "none",
    loaders: Sequence[Iterable] = None,
    platforms: Sequence[str] = None,
    device: str = None,
) -> str:
    """Export a finished run dir to ``<model_dir>/exported/`` (or
    ``out_dir``): one ``shape_{n}.pt2`` program per distinct bucketed batch
    shape in ``loaders`` (default: the run's test loader), and
    ``manifest.json``.  Returns the export directory.

    The run's model is restored on ``device`` (the card unless ``"cpu"`` is
    passed), as every entry point of the port does; the trace is made on a
    CPU copy.  ``platforms`` lists the devices the artifacts are for
    (``"cpu"``, ``"cuda"``; default: the run's device)."""
    from point_cloud_classifier_tpu_torch.factory import get_dataloader, get_model, resolve_quant
    from point_cloud_classifier_tpu_torch.models.wrapper import kept_arrays
    from point_cloud_classifier_tpu_torch.ops.dispatch import force_plain
    from point_cloud_classifier_tpu_torch.utils.config import load_config

    config = load_config(os.path.join(model_dir, "config.yaml"))
    model_name = config["meta"]["model_name"]
    if model_name == "logistic_regression":
        raise ValueError(
            "logistic_regression serves via its closed-form scorer; "
            "export covers the jit'd network models"
        )
    dataset_name = config["meta"]["dataset_name"]
    quant = resolve_quant(config, model_name, quant)
    wrapper = get_model(model_name=model_name, config=config, model_dir=model_dir, device=device)
    platforms = list(platforms) if platforms else [wrapper.device.type]
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"platforms must be among {PLATFORMS}, got {unknown}")
    if loaders is None:
        loaders = [get_dataloader(dataset_name, config).get_test_loader()]

    fn = _eval_fn(wrapper, quant=quant)
    out_dir = out_dir or os.path.join(model_dir, "exported")
    os.makedirs(out_dir, exist_ok=True)

    manifest = {
        "model": model_name,
        "dataset": dataset_name,
        "quant": quant,
        "torch_version": torch.__version__,
        "platforms": platforms,
        "artifacts": {},
    }
    n = 0
    for loader in loaders:
        for batch in loader:
            key = _shape_key(batch)
            if key in manifest["artifacts"]:
                continue
            example = {k: torch.as_tensor(v).cpu() for k, v in kept_arrays(batch, fn.model).items()}
            # every kernel op takes its plain version: the program holds
            # ATen operations only and serves on the CPU and the card
            with force_plain(), torch.no_grad():
                exported = torch.export.export(fn, (example,))
            fname = f"shape_{n}.pt2"
            torch.export.save(exported, os.path.join(out_dir, fname))
            manifest["artifacts"][key] = fname
            n += 1
    if not manifest["artifacts"]:
        raise ValueError("no batches produced by the export loaders")
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=4)
    return out_dir


class _Program:
    """One loaded artifact on its device: the module and the batch keys it
    takes (the names of its dict input, in its order)."""

    def __init__(self, path: str, device: torch.device):
        exported = torch.export.load(path)
        if device.type != "cpu":
            from torch.export.passes import move_to_device_pass

            exported = move_to_device_pass(exported, device)
        in_spec = exported.call_spec.in_spec
        (batch,), _ = tree_unflatten(list(range(in_spec.num_leaves)), in_spec)
        self.keys = list(batch)
        self.module = exported.module()


class ExportedModel:
    """Serve from an export directory: no model classes or checkpoints.

    Loads each shape's program lazily, on ``device`` (the card unless
    ``"cpu"`` is passed; one the manifest's ``platforms`` lists), and
    dispatches by the incoming batch's shape key."""

    def __init__(self, export_dir: str, device: str = None):
        from point_cloud_classifier_tpu_torch.models.wrapper import resolve_device

        with open(os.path.join(export_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        self.export_dir = export_dir
        self.device = resolve_device(device)
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(
                f"the artifacts in {export_dir} were exported for {self.manifest['platforms']}, "
                f"not {self.device.type}"
            )
        self._loaded: Dict[str, _Program] = {}

    def _artifact(self, key: str) -> _Program:
        if key not in self._loaded:
            fname = self.manifest["artifacts"].get(key)
            if fname is None:
                known = "\n  ".join(self.manifest["artifacts"])
                raise KeyError(
                    f"no exported artifact for batch shape {key}; "
                    f"exported shapes:\n  {known}"
                )
            self._loaded[key] = _Program(os.path.join(self.export_dir, fname), self.device)
        return self._loaded[key]

    def __call__(self, batch: Dict) -> np.ndarray:
        """Per-event probabilities for one bucketed batch dict (numpy in,
        numpy out)."""
        program = self._artifact(_shape_key(batch))
        inputs = {k: torch.as_tensor(batch[k]).to(self.device) for k in program.keys}
        with torch.inference_mode():
            probs = program.module(inputs)
        return probs.cpu().numpy()

    def predict(self, loader: Iterable, return_prob: bool = False):
        """Mirror ``ModelWrapper.predict`` over an iterable of batches."""
        y_true, y_out = [], []
        for batch in loader:
            probs = self(batch)
            mask = np.asarray(batch["y_mask"]).astype(bool)
            p = probs[mask]
            y_true.append(np.asarray(batch["y"])[mask])
            y_out.append(p if return_prob else (p >= 0.5).astype(np.float32))
        return np.concatenate(y_true), np.concatenate(y_out)

"""The serving half of the trainer: load a checkpoint, predict.

Counterpart of ``point_cloud_classifier_tpu/models/wrapper.py``:

- the eval math behind ``predict``: the model applied with ``train=False``,
  then sigmoid (the masked loss comes with the training half);
- ``load(path)`` reads the JAX package's ``best_model.pt`` (a pickle of
  ``{"params", "batch_stats"}`` numpy trees, moved through ``convert``) or a
  ``torch.save``-d port ``state_dict``;
- ``predict(loader, return_prob)`` returns the same ``(y_true, probs)`` as the
  JAX method: labels and outputs of the unmasked rows, batch after batch.

The model lives on an explicit device, ``cuda`` when there is one.  Batches
go to it one at a time; the outputs come back in one copy at the end.  The
JAX package's scan-fused eval windows and device-resident memo have no
counterpart here; training waits for a later slice.
"""

from __future__ import annotations

import pickle
import zipfile
from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

from point_cloud_classifier_tpu_torch import convert


class ModelWrapper:
    """Owns a model on a device; reference-shaped load/predict."""

    def __init__(
        self,
        model: nn.Module,
        learning_rate: float,
        epochs: int,
        log_dir: Optional[str] = None,
        optimizer: str = "adam",
        seed: int = 0,
        device: Optional[str] = None,
    ):
        # learning_rate, epochs, log_dir, optimizer and seed are the config's
        # trainer and logging settings (factory.get_model passes them all);
        # the serving half reads none of them
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    def _put(self, batch):
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def predict(self, data_loader: Iterable, return_prob: bool = False):
        """``(y_true, probs)`` over the unmasked rows, batch after batch;
        0/1 predictions at sigmoid ≥ 0.5 instead of probs unless
        ``return_prob``."""
        probs, y_all, mask_all = [], [], []
        with torch.inference_mode():
            for batch in data_loader:
                logits = self.model(self._put(batch), train=False)
                probs.append(torch.sigmoid(logits))
                y_all.append(np.asarray(batch["y"]))
                mask_all.append(np.asarray(batch["y_mask"]).astype(bool))
            if not probs:
                raise ValueError("eval loader produced no batches")
            # one device→host copy for every batch's outputs
            sizes = np.cumsum([p.shape[0] for p in probs])[:-1]
            probs_all = np.split(torch.cat(probs).cpu().numpy(), sizes)
        y_true, y_out = [], []
        for p, y, mask in zip(probs_all, y_all, mask_all):
            p = p[mask]
            y_true.append(y[mask])
            y_out.append(p if return_prob else (p >= 0.5).astype(np.float32))
        return np.concatenate(y_true), np.concatenate(y_out)

    def load(self, model_path: str) -> None:
        """Load a JAX-format pickle or a port ``state_dict`` (strict keys).

        The pickle is unpickled as the JAX package's ``load`` does: read only
        checkpoints this project wrote."""
        if zipfile.is_zipfile(model_path):
            state = torch.load(model_path, map_location="cpu", weights_only=True)
        else:
            with open(model_path, "rb") as f:
                state = pickle.load(f)
        if "params" in state:
            state = convert.to_torch_state_dict(
                self.model.name,
                {"model": self.model.config},
                state["params"],
                state.get("batch_stats") or {},
            )
        self.model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()}, strict=True
        )

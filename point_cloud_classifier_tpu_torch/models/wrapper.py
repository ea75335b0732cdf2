"""The trainer: fit with early stopping and checkpoints, evaluate, predict.

Counterpart of ``point_cloud_classifier_tpu/models/wrapper.py``:

- loss: sigmoid binary cross-entropy on logits, masked by ``y_mask`` and
  divided by the number of real rows (:func:`masked_bce`); the epoch train
  loss and the val loss are means of batch means;
- optimizer adam or adamw at torch defaults (betas 0.9/0.999, eps 1e-8;
  adamw's decoupled weight decay 0.01 on every parameter — optax's
  ``adamw`` is the same update);
- per-epoch validation, accuracy at sigmoid ≥ 0.5 over real rows;
  best-val-loss checkpoint ``best_model.pt``, early stopping with patience
  10, the final ``model.pt`` from :meth:`ModelWrapper.save`;
- scalar metrics in ``{log_dir}/metrics.jsonl`` (and TensorBoard when
  ``PCC_TENSORBOARD=1``), under the JAX package's tags;
- a resumable full state in ``{log_dir}/state/`` every ``state_every``
  epochs.

Checkpoints are torch ``state_dict``s under the keys that ``convert.py``
maps; :meth:`ModelWrapper.load` also reads the JAX package's pickles.  The
model lives on an explicit device, ``cuda`` when there is one; batches go to
it one at a time, and losses and outputs come back in one copy per epoch or
per evaluation.

A model's BatchNorm running statistics are buffers of the module: the train
step moves them (``MaskedBatchNorm``), ``best_model.pt``, ``model.pt`` and
the resumable state carry them in the ``state_dict``, and validation and
``predict`` normalize with them — the JAX trainer's ``batch_stats``.

Not ported: fused step windows (``fuse_steps > 1``, ``PCC_FUSE_STEPS``), the
device-resident batch cache (``device_resident``, ``PCC_RESIDENT``), meshes
(``mesh``, ``data_parallel``, ``n_model > 1`` and their environment
variables) and TensorBoard histograms (``PCC_TB_HISTOGRAMS``): each raises.
"""

from __future__ import annotations

import json
import os
import pickle
import time
import zipfile
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from point_cloud_classifier_tpu_torch import convert

STATE_FILE = "state.pt"


def masked_bce(logits: torch.Tensor, y: torch.Tensor, y_mask: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy over the rows with ``y_mask`` set."""
    per = F.binary_cross_entropy_with_logits(logits, y, reduction="none")
    w = y_mask[:, None]
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def _make_optimizer(name: str, params, learning_rate: float) -> torch.optim.Optimizer:
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
        )
    raise ValueError(f"Unknown optimizer: {name}")


def _refuse_unported(fuse_steps, device_resident, mesh, data_parallel, n_model) -> None:
    """Raise for each option of the JAX trainer that this port lacks, set by
    argument or by its environment variable (read as the JAX package reads
    it), rather than ignore it."""
    env = os.environ.get
    if env("PCC_FUSE_STEPS") is not None:
        try:
            fuse_steps = int(env("PCC_FUSE_STEPS"))
        except ValueError as e:
            raise ValueError(f"PCC_FUSE_STEPS must be an integer, got {env('PCC_FUSE_STEPS')!r}") from e
    if env("PCC_N_MODEL") is not None:
        try:
            n_model = int(env("PCC_N_MODEL"))
        except ValueError as e:
            raise ValueError(f"PCC_N_MODEL must be an integer, got {env('PCC_N_MODEL')!r}") from e
    refused = {
        "fuse_steps > 1 (PCC_FUSE_STEPS; CUDA-graph step capture is a later, "
        "measured option)": int(fuse_steps) > 1,
        "device_resident (PCC_RESIDENT; ROADMAP Queue 1 item 9)": (
            env("PCC_RESIDENT") == "1"
            if env("PCC_RESIDENT") is not None
            else bool(device_resident)
        ),
        "mesh, data_parallel and n_model > 1 (PCC_DATA_PARALLEL, PCC_N_MODEL; "
        "ROADMAP Queue 1 item 13)": (
            mesh is not None
            or n_model > 1
            or (
                env("PCC_DATA_PARALLEL") == "1"
                if env("PCC_DATA_PARALLEL") is not None
                else bool(data_parallel)
            )
        ),
        "TensorBoard histograms (PCC_TB_HISTOGRAMS)": env("PCC_TB_HISTOGRAMS") == "1",
    }
    for what, requested in refused.items():
        if requested:
            raise NotImplementedError(f"not ported to PyTorch yet: {what}")


def _shape_key(batch):
    """One bucketed batch shape, as the JAX trainer counts them."""
    return tuple(sorted((k, np.shape(v), str(v.dtype)) for k, v in batch.items()))


def _p50_ms(seconds) -> float:
    """The JAX package's ``StepTimer`` median: the sorted sample at index
    ``round(0.5 · (n − 1))``, in ms."""
    xs = sorted(seconds)
    return xs[min(int(round(0.5 * (len(xs) - 1))), len(xs) - 1)] * 1e3 if xs else 0.0


class _ScalarLog:
    """``metrics.jsonl`` writer with optional TensorBoard mirroring."""

    def __init__(self, log_dir: Optional[str]):
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl") if log_dir else None
        self._tb = None
        if log_dir and os.environ.get("PCC_TENSORBOARD") == "1":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")
        if self._tb:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        if self._tb:
            self._tb.close()


class ModelWrapper:
    """Owns a model and its optimizer on a device; reference-shaped
    fit/predict/save/load."""

    def __init__(
        self,
        model: nn.Module,
        learning_rate: float,
        epochs: int,
        log_dir: Optional[str] = None,
        optimizer: str = "adam",
        seed: int = 0,
        mesh=None,
        data_parallel: bool = False,
        n_model: int = 1,
        state_every: int = 1,
        fuse_steps: int = 1,
        device_resident: bool = False,
        device: Optional[str] = None,
    ):
        # seed is the config's trainer.seed: factory.get_model draws the
        # initial weights from it before the model reaches this wrapper
        _refuse_unported(fuse_steps, device_resident, mesh, data_parallel, n_model)
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.log_dir = log_dir
        # full-state (resume) checkpoint cadence in epochs; 0 disables
        self.state_every = state_every
        self.patience = 10
        self.best_val_loss = float("inf")
        self.early_stop_counter = 0
        self.checkpoint_path = os.path.join(log_dir, "best_model.pt") if log_dir else None
        self.optimizer_name = optimizer
        self.optimizer = _make_optimizer(optimizer, self.model.parameters(), learning_rate)
        self._shapes_seen = set()

    def _put(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}

    # -- training ------------------------------------------------------------

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on a host batch; returns the batch's loss on
        the device (no host sync)."""
        batch = self._put(batch)
        logits = self.model(batch, train=True)
        loss = masked_bce(logits, batch["y"], batch["y_mask"])
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def fit(self, train_loader: Iterable, val_loader: Iterable = None, resume: bool = False) -> None:
        log = _ScalarLog(self.log_dir)
        t0 = time.time()
        start_epoch = self.restore_state() if resume else 0
        self.model.train()
        try:
            for epoch in range(start_epoch, self.epochs):
                if self._fit_epoch(epoch, train_loader, val_loader, log):
                    print("Early stopping triggered.")
                    self.save_state(epoch, force=self.state_every > 0)
                    break
                self.save_state(epoch)
        finally:
            self.model.eval()
        log.scalar("train_wall_seconds", time.time() - t0, 0)
        # each distinct batch shape is a separate bucket the loader emits
        log.scalar("compile/distinct_batch_shapes", len(self._shapes_seen), 0)
        log.close()

    def _fit_epoch(self, epoch, train_loader, val_loader, log) -> bool:
        """One epoch of training and validation; True when early stopping
        triggers."""
        losses, step_seconds = [], []
        epoch_t0 = time.perf_counter()
        for batch in train_loader:
            self._shapes_seen.add(_shape_key(batch))
            step_t0 = time.perf_counter()
            losses.append(self.train_step(batch))
            # the host's side of the step: on a card, kernels run on after it
            step_seconds.append(time.perf_counter() - step_t0)
        if not losses:
            raise ValueError(
                "train loader produced no batches — empty dataset/split "
                "or an over-aggressive filter"
            )
        # one device→host copy per epoch; the wall time is taken after it,
        # so it covers every step's device work
        epoch_loss = float(torch.stack(losses).mean())
        epoch_wall = time.perf_counter() - epoch_t0
        log.scalar("Loss/train", epoch_loss, epoch)
        if not np.isfinite(epoch_loss):
            log.close()
            state = self._state_dir()
            raise FloatingPointError(
                f"Non-finite training loss ({epoch_loss}) at epoch {epoch + 1}"
                + (f"; last good checkpoint in {state}" if state else "")
            )
        n_steps = len(losses)
        log.scalar("Throughput/steps_per_sec", n_steps / max(epoch_wall, 1e-9), epoch)
        log.scalar("StepTime/p50_ms", _p50_ms(step_seconds), epoch)
        log.scalar("StepTime/wall_ms_per_step", 1e3 * epoch_wall / n_steps, epoch)

        if val_loader is None:
            return False
        val_loss, val_acc = self._evaluate(val_loader)
        log.scalar("Loss/val", val_loss, epoch)
        log.scalar("Accuracy/val", val_acc, epoch)
        if val_loss < self.best_val_loss:
            self.best_val_loss = val_loss
            self.early_stop_counter = 0
            if self.checkpoint_path:
                self._write_checkpoint(self.checkpoint_path)
            print(f"Epoch {epoch+1}: New best model saved (val_loss={val_loss:.4f})")
        else:
            self.early_stop_counter += 1
            print(f"Epoch {epoch+1}: No improvement ({self.early_stop_counter}/{self.patience})")
        return self.early_stop_counter >= self.patience

    # -- evaluation and inference ---------------------------------------------

    def _eval_dispatch(self, loader: Iterable):
        """Per-batch masked losses ``[N]`` (host), probabilities, labels and
        masks, with one device→host copy for every batch's outputs."""
        losses, probs, y_all, mask_all = [], [], [], []
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                for batch in loader:
                    dev = self._put(batch)
                    logits = self.model(dev, train=False)
                    losses.append(masked_bce(logits, dev["y"], dev["y_mask"]))
                    probs.append(torch.sigmoid(logits))
                    y_all.append(np.asarray(batch["y"]))
                    mask_all.append(np.asarray(batch["y_mask"]).astype(bool))
                if not probs:
                    raise ValueError("eval loader produced no batches")
                flat = torch.cat([torch.stack(losses), *(p.reshape(-1) for p in probs)])
                flat = flat.cpu().numpy()
        finally:
            self.model.train(was_training)
        n = len(losses)
        outputs = np.split(flat[n:], np.cumsum([p.numel() for p in probs])[:-1])
        probs_all = [o.reshape(p.shape) for o, p in zip(outputs, probs)]
        return flat[:n], probs_all, y_all, mask_all

    def _evaluate(self, loader: Iterable):
        """(mean of the per-batch losses, accuracy at sigmoid ≥ 0.5 over the
        masked rows)."""
        losses, probs_all, y_all, mask_all = self._eval_dispatch(loader)
        correct, total = 0.0, 0.0
        for probs, y, mask in zip(probs_all, y_all, mask_all):
            preds = probs >= 0.5
            correct += float((preds[mask, 0] == (y[mask, 0] >= 0.5)).sum())
            total += float(mask.sum())
        return float(np.mean(losses.astype(np.float64))), correct / max(total, 1.0)

    def predict(self, data_loader: Iterable, return_prob: bool = False):
        """``(y_true, probs)`` over the unmasked rows, batch after batch;
        0/1 predictions at sigmoid ≥ 0.5 instead of probs unless
        ``return_prob``."""
        _, probs_all, y_all, mask_all = self._eval_dispatch(data_loader)
        y_true, y_out = [], []
        for p, y, mask in zip(probs_all, y_all, mask_all):
            p = p[mask]
            y_true.append(y[mask])
            y_out.append(p if return_prob else (p >= 0.5).astype(np.float32))
        return np.concatenate(y_true), np.concatenate(y_out)

    # -- persistence -------------------------------------------------------------

    def _host_state_dict(self):
        return {k: v.detach().cpu() for k, v in self.model.state_dict().items()}

    def _write_checkpoint(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(self._host_state_dict(), path)

    def save(self, save_dir: str) -> None:
        self._write_checkpoint(os.path.join(save_dir, "model.pt"))

    def load(self, model_path: str) -> None:
        """Load a JAX-format pickle or a port ``state_dict`` (strict keys),
        with a fresh optimizer state as the JAX ``load`` has.

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
        self.optimizer = _make_optimizer(
            self.optimizer_name, self.model.parameters(), self.learning_rate
        )

    def _state_dir(self) -> Optional[str]:
        return os.path.abspath(os.path.join(self.log_dir, "state")) if self.log_dir else None

    def save_state(self, epoch: int, force: bool = False) -> None:
        """The model and optimizer state plus the trainer's counters, in
        ``{log_dir}/state/``, every ``state_every`` epochs (or when forced)."""
        path = self._state_dir()
        if path is None:
            return
        if not force and (self.state_every <= 0 or (epoch + 1) % self.state_every != 0):
            return
        os.makedirs(path, exist_ok=True)
        torch.save(
            {"model": self._host_state_dict(), "optimizer": self.optimizer.state_dict()},
            os.path.join(path, STATE_FILE),
        )
        with open(os.path.join(path, "trainer_state.json"), "w") as f:
            json.dump(
                {
                    "epoch": epoch,
                    "best_val_loss": self.best_val_loss,
                    "early_stop_counter": self.early_stop_counter,
                },
                f,
                indent=4,
            )

    def restore_state(self) -> int:
        """Restore a mid-training state; returns the next epoch index (0
        when there is none)."""
        path = self._state_dir()
        meta_path = os.path.join(path, "trainer_state.json") if path else None
        if not (meta_path and os.path.exists(meta_path)):
            return 0
        raw = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
        self.model.load_state_dict(raw["model"], strict=True)
        self.optimizer = _make_optimizer(
            self.optimizer_name, self.model.parameters(), self.learning_rate
        )
        self.optimizer.load_state_dict(raw["optimizer"])
        with open(meta_path) as f:
            meta = json.load(f)
        self.best_val_loss = meta["best_val_loss"]
        self.early_stop_counter = meta["early_stop_counter"]
        return meta["epoch"] + 1

    def get_trainable_parameters(self) -> int:
        return int(sum(p.numel() for p in self.model.parameters()))

"""The trainer: fit with early stopping and checkpoints, evaluate, predict.

Counterpart of ``point_cloud_classifier_tpu/models/wrapper.py``:

- loss: sigmoid binary cross-entropy on logits, masked by ``y_mask`` and
  divided by the number of real rows (:func:`masked_bce`; under a mesh, the
  real rows of the global batch); the epoch train loss and the val loss are
  means of batch means;
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
model lives on the card (``device=None`` means ``"cuda"`` and raises where
there is none; the CPU is taken only when the caller passes
``device="cpu"``); losses and outputs come back in one copy per epoch or per
evaluation.

Input pipelines, as in the JAX trainer: by default each host batch goes to
the device as the step takes it; ``device_resident`` (or
``PCC_RESIDENT=1``) wraps the train loader (shuffled from ``seed``) and the
val loader in ``data/resident.ResidentCache``; ``PCC_BG_LOADER=1`` packs
batches on a background thread (``data/background.py``) and
``PCC_PREFETCH=1`` copies them ahead on a side stream
(``data/prefetch.py``).  A batch already on the device is used as it is.

A model's BatchNorm running statistics are buffers of the module: the train
step moves them (``MaskedBatchNorm``), ``best_model.pt``, ``model.pt`` and
the resumable state carry them in the ``state_dict``, and validation and
``predict`` normalize with them — the JAX trainer's ``batch_stats``.

Step fusion, as in the JAX trainer: ``fuse_steps=K`` (``trainer.fuse_steps``;
``PCC_FUSE_STEPS`` overrides it) runs up to K consecutive batches of one
shape as one window, flushed early by a change of shape or the end of the
epoch, with the result of its K steps run in sequence.  ``Loss/train``
averages the per-step losses, the throughput rows count micro-steps and
``StepTime/p50_ms`` is the median of the timed windows.  On the card a
window is one replay of a CUDA graph of its K steps (``models/windows.py``;
Adam and AdamW then take ``capturable=True``, the step count and the bias
corrections on the device, which a graph needs); on the CPU its steps run
one after another.  Unfused runs on the card keep torch's default Adam: its
step alone measured 0.17–0.50 ms shorter than the capturable one's on an
H100, 5–9% of an unfused step (PERF.md §6); the two forms round apart by
up to ~1e-5 relative over tens of steps, and a state saved by either
resumes in the other.  Evaluation and ``predict`` fuse same-shape runs the same
way.  The resident cache permutes whole windows (``shuffle_block``).

``PCC_TRACE=1`` wraps each epoch's steps in ``torch.profiler``
(``utils/profiling.maybe_trace``, a Chrome trace in ``{log_dir}/trace/``).
``PCC_TB_HISTOGRAMS=1`` with ``PCC_TENSORBOARD=1`` logs, every epoch, a
histogram of each parameter (``{key}_weight``, the ``state_dict`` key), of
its gradient at the epoch's last batch (``{key}_grad``) and of that batch's
``logits``; it forces windows of one step.

Meshes, as in the JAX trainer: ``mesh`` (``parallel/mesh.make_mesh``), or
``data_parallel`` / ``n_model > 1`` (``trainer.data_parallel``,
``trainer.n_model``; ``PCC_DATA_PARALLEL`` and ``PCC_N_MODEL`` override
them), which build a mesh over every rank (``torchrun``'s, or a world of one
rank).  Each rank runs on its own card (``cuda:LOCAL_RANK``) or the device
given; it starts from rank 0's weights, takes its share of every global
batch (``parallel/mesh.RankShares``), divides its summed loss by the global
count of real rows and sums the gradients over the data ranks, so that a
run on n ranks takes the single-device run's steps.  Validation sums over
the ranks and ``predict`` gathers every rank's rows in the global batch
order; rank 0 alone writes files and prints.  A fused window is one CUDA
graph over NCCL, its all-reduces inside; over gloo, which copies through
the host, its steps run in sequence.  On the model axis the wide weights
live in row blocks (``parallel/mesh.param_is_sharded``) and each forward
gathers them (``functional_call``); the optimizer steps each rank's block.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from point_cloud_classifier_tpu_torch import convert
from point_cloud_classifier_tpu_torch.data.background import BackgroundIterator
from point_cloud_classifier_tpu_torch.data.prefetch import prefetch_to_device
from point_cloud_classifier_tpu_torch.data.resident import ResidentCache, shape_key
from point_cloud_classifier_tpu_torch.models.common import MaskedBatchNorm
from point_cloud_classifier_tpu_torch.models.windows import WindowGraphs
from point_cloud_classifier_tpu_torch.parallel import mesh as pmesh
from point_cloud_classifier_tpu_torch.utils.profiling import StepTimer, maybe_trace

STATE_FILE = "state.pt"


def masked_bce(logits: torch.Tensor, y: torch.Tensor, y_mask: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy over the rows with ``y_mask`` set."""
    per = F.binary_cross_entropy_with_logits(logits, y, reduction="none")
    w = y_mask[:, None]
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def _make_optimizer(
    name: str, params, learning_rate: float, capturable: bool = False
) -> torch.optim.Optimizer:
    """Adam or AdamW at torch defaults; ``capturable`` keeps the step count
    on the device so that a CUDA graph can hold the update (the fused
    windows on the card)."""
    if name == "adam":
        return torch.optim.Adam(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, capturable=capturable
        )
    if name == "adamw":
        return torch.optim.AdamW(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
            capturable=capturable,
        )
    raise ValueError(f"Unknown optimizer: {name}")


def fuse_steps_from_env(fuse_steps) -> int:
    """The window length: ``PCC_FUSE_STEPS`` when set (an integer, else
    ``ValueError``), else ``fuse_steps``; at least 1."""
    env = os.environ.get("PCC_FUSE_STEPS")
    if env is not None:
        try:
            fuse_steps = int(env)
        except ValueError as e:
            raise ValueError(f"PCC_FUSE_STEPS must be an integer, got {env!r}") from e
    return max(1, int(fuse_steps))


def resolve_device(device=None) -> torch.device:
    """The device a wrapper runs on: the card unless the caller names
    another.  ``None`` means ``"cuda"`` and raises where there is no usable
    card; it never picks the CPU by itself, so a run cannot end up on the CPU
    through the kernels' plain versions without anyone having asked.

    Taking the card turns off PyTorch's
    ``allow_bf16_reduced_precision_reduction`` (on by default): with it on,
    cuBLAS may add a split-K bf16 product's partial sums in bf16 (at a
    contraction of 1,024 it does, ``splitKreduce_kernel`` on bf16
    partials), where the JAX package sums every dot in f32 and rounds
    once.  Every bf16 product of the port on the card then sums in f32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available (torch.cuda.is_available() is false): "
                "the port runs on the GPU; pass device=\"cpu\" to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


def kept_arrays(batch, model: nn.Module) -> dict:
    """The batch without the arrays ``model`` says it never reads (a kNN
    GraphNet builds its own edges)."""
    unused = getattr(model, "unused_batch_keys", ())
    return {k: v for k, v in batch.items() if k not in unused}


def put_batch(batch, model: nn.Module, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's kept arrays (:func:`kept_arrays`) on ``device``; a tensor
    already on the device is used as it is."""
    return {k: torch.as_tensor(v).to(device) for k, v in kept_arrays(batch, model).items()}


class _ScalarLog:
    """``metrics.jsonl`` writer with optional TensorBoard mirroring.
    ``write=False`` (a mesh rank other than 0) writes nothing, and
    ``tb_on`` still says whether TensorBoard is on, as on the rank that
    writes."""

    def __init__(self, log_dir: Optional[str], write: bool = True):
        if log_dir and write:
            os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl") if log_dir and write else None
        self._tb = None
        self.tb_on = False
        if log_dir and os.environ.get("PCC_TENSORBOARD") == "1":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb_on = True
                if write:
                    self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")
        if self._tb:
            self._tb.add_scalar(tag, value, step)

    def histograms(self, named_arrays, step: int) -> None:
        """One TensorBoard histogram per ``(tag, array)``."""
        if self._tb:
            for name, arr in named_arrays:
                self._tb.add_histogram(name, np.asarray(arr), step)

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
        # initial weights from it before the model reaches this wrapper, and
        # the resident cache shuffles from it
        data_parallel, n_model = pmesh.mesh_options(data_parallel, n_model)
        self.fuse_steps = fuse_steps_from_env(fuse_steps)
        env_resident = os.environ.get("PCC_RESIDENT")
        if env_resident is not None:
            device_resident = env_resident == "1"
        self.device_resident = bool(device_resident)
        self.seed = seed
        if mesh is not None or data_parallel or n_model > 1:
            self.device = pmesh.rank_device(device)
            if mesh is None:
                mesh = pmesh.make_mesh(n_model=n_model, device=self.device)
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.model = model.to(self.device).eval()
        for mod in self.model.modules():
            if isinstance(mod, MaskedBatchNorm):
                mod.axis = mesh  # global moments under a mesh, the batch's without
        self._shards = {}  # name → this rank's row block of a sharded weight
        if mesh is not None:
            self._attach_mesh()
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
        # the fused windows' CUDA graphs (none on the CPU, where a window's
        # steps run one after another)
        self.windows = (
            WindowGraphs(self.device, f"{model.name} {json.dumps(getattr(model, 'config', {}))}",
                         collectives=mesh is not None)
            if self.device.type == "cuda" and self.fuse_steps > 1 and (mesh is None or mesh.capturable)
            else None
        )
        self.optimizer = self._new_optimizer()
        self._shapes_seen = set()

    @property
    def writer(self) -> bool:
        """Whether this process writes the run's files and prints: always
        without a mesh, rank 0 under one."""
        return self.mesh is None or self.mesh.writer

    def _attach_mesh(self) -> None:
        """Rank 0's weights and buffers on every rank, and this rank's row
        blocks of the weights the model axis splits."""
        for t in [*self.model.parameters(), *self.model.buffers()]:
            dist.broadcast(t.data, src=0)
        self._shards = {
            name: nn.Parameter(pmesh.row_block(p.detach(), self.mesh).clone())
            for name, p in self.model.named_parameters()
            if pmesh.param_is_sharded(p, self.mesh.n_model)
        }

    def _trained_params(self) -> list:
        """The tensors the optimizer steps, in the model's parameter order:
        a sharded weight's row block in its place."""
        return [self._shards.get(name, p) for name, p in self.model.named_parameters()]

    def _forward(self, batch: Dict[str, torch.Tensor], train: bool) -> torch.Tensor:
        """The model's logits; on the model axis over the full weights
        gathered from the row blocks."""
        if not self._shards:
            return self.model(batch, train=train)
        full = {name: pmesh.gather_rows(s, self.mesh) for name, s in self._shards.items()}
        return functional_call(self.model, full, (batch,), {"train": train})

    def _sync_full(self) -> None:
        """The model's own copies of the sharded weights from the row blocks
        (before they are saved or read); every rank of the mesh calls it."""
        with torch.no_grad():
            for name, s in self._shards.items():
                self.model.get_parameter(name).copy_(pmesh.gather_rows(s, self.mesh))

    def _loss(self, logits, batch) -> torch.Tensor:
        """:func:`masked_bce`; under a mesh this rank's sum over its real
        rows divided by the global batch's count of them (summed over the
        data ranks, without a gradient), so that the ranks' losses add up to
        the global batch's."""
        if self.mesh is None:
            return masked_bce(logits, batch["y"], batch["y_mask"])
        per = F.binary_cross_entropy_with_logits(logits, batch["y"], reduction="none")
        w = batch["y_mask"][:, None]
        count = w.sum().detach().clone()
        dist.all_reduce(count, group=self.mesh.data_group)
        return (per * w).sum() / torch.clamp(count, min=1.0)

    def _reduce_grads(self) -> None:
        """Each gradient summed over the data ranks, in one all-reduce per
        kind: row blocks over their data group; replicated tensors, alike on
        the model ranks, over every rank and divided by the model-axis size
        (which keeps the model ranks' copies equal)."""
        m = self.mesh
        if m is None:
            return
        sharded = list(self._shards.values())
        replicated = [p for name, p in self.model.named_parameters() if name not in self._shards]
        world = m.data_group if m.n_model == 1 else None
        for params, group, scale in ((sharded, m.data_group, 1.0), (replicated, world, 1.0 / m.n_model)):
            if not params:
                continue
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            if scale != 1.0:
                flat.mul_(scale)
            offset = 0
            for p in params:
                p.grad = flat[offset : offset + p.numel()].view_as(p)
                offset += p.numel()

    def _new_optimizer(self) -> torch.optim.Optimizer:
        if self.windows is not None:
            self.windows.clear()  # the graphs hold the old optimizer's state
        return _make_optimizer(
            self.optimizer_name, self._trained_params(), self.learning_rate,
            capturable=self.windows is not None,
        )

    def _put(self, batch) -> Dict[str, torch.Tensor]:
        return put_batch(batch, self.model, self.device)

    def _rank_stream(self, loader: Iterable) -> Iterable:
        """The loader, or under a mesh this data rank's shares of it."""
        if self.mesh is None or isinstance(loader, (ResidentCache, pmesh.RankShares)):
            return loader
        return pmesh.RankShares(loader, self.mesh)

    def _batches(self, loader: Iterable) -> Iterable:
        """The batch stream of a training or evaluation loop: a resident
        cache as it is; else the loader (this rank's shares of it under a
        mesh), packed on a background thread with ``PCC_BG_LOADER=1`` and
        copied ahead to the device with ``PCC_PREFETCH=1``."""
        if isinstance(loader, ResidentCache):
            return loader
        loader = self._rank_stream(loader)
        if os.environ.get("PCC_BG_LOADER") == "1":
            loader = BackgroundIterator(loader, prefetch=2)
        if os.environ.get("PCC_PREFETCH") == "1":
            return prefetch_to_device(loader, size=2, device=self.device)
        return loader

    def _windows_of(self, loader: Iterable, k: int, record: bool = False) -> Iterable[list]:
        """The loader's batches in windows of up to ``k`` consecutive
        batches of one shape (a change of shape or the end flushes a shorter
        one); ``record`` notes each shape seen (training does)."""
        pending = []
        for batch in self._batches(loader):
            key = shape_key(batch)
            if record:
                self._shapes_seen.add(key)
            if pending and (len(pending) >= k or shape_key(pending[0]) != key):
                yield pending
                pending = []
            pending.append(batch)
        if pending:
            yield pending

    # -- training ------------------------------------------------------------

    def _step(self, batch: Dict[str, torch.Tensor]):
        """One optimizer step on a device batch: ``(loss, logits)``, both on
        the device (no host sync); under a mesh the loss is this rank's part
        of the global batch's."""
        logits = self._forward(batch, train=True)
        loss = self._loss(logits, batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._reduce_grads()
        self.optimizer.step()
        return loss.detach(), logits.detach()

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on a host batch; returns the batch's loss on
        the device (no host sync)."""
        return self._step(self._put(batch))[0]

    def train_window(self, window) -> torch.Tensor:
        """The steps of a window of same-shape batches, in order: their
        losses ``[K]`` on the device.  On the card a window of two or more
        batches is one replay of its CUDA graph (``models/windows.py``)."""
        if self.windows is None or len(window) == 1:
            return torch.stack([self.train_step(b) for b in window])

        def body(views):
            return (torch.stack([self._step(v)[0] for v in views]),)

        return self.windows.run("train", [kept_arrays(b, self.model) for b in window], body)[0]

    def fit(self, train_loader: Iterable, val_loader: Iterable = None, resume: bool = False) -> None:
        log = _ScalarLog(self.log_dir, write=self.writer)
        t0 = time.time()
        start_epoch = self.restore_state() if resume else 0
        if self.device_resident:
            if not isinstance(train_loader, ResidentCache):
                # replays shuffle the batch order from the seed, by whole
                # windows (shuffle_block), so that a window's composition
                # stays as the first epoch made it; a resumed run counts
                # its epochs on from start_epoch
                train_loader = ResidentCache(
                    self._rank_stream(train_loader),
                    device=self.device,
                    shuffle_seed=self.seed,
                    epoch_offset=start_epoch,
                    shuffle_block=self.fuse_steps,
                )
            if val_loader is not None and not isinstance(val_loader, ResidentCache):
                val_loader = ResidentCache(self._rank_stream(val_loader), device=self.device)
        # histogram mode (the torch reference logs the last batch's logits
        # and every parameter's weight and gradient each epoch): windows of
        # one step, so that the last batch's gradients are there to read
        hist_on = log.tb_on and os.environ.get("PCC_TB_HISTOGRAMS") == "1"
        self.model.train()
        try:
            for epoch in range(start_epoch, self.epochs):
                if self._fit_epoch(epoch, train_loader, val_loader, log, hist_on):
                    self._print("Early stopping triggered.")
                    self.save_state(epoch, force=self.state_every > 0)
                    break
                self.save_state(epoch)
        finally:
            self.model.eval()
        log.scalar("train_wall_seconds", time.time() - t0, 0)
        # each distinct batch shape is a separate bucket the loader emits
        log.scalar("compile/distinct_batch_shapes", len(self._shapes_seen), 0)
        log.close()

    def _fit_epoch(self, epoch, train_loader, val_loader, log, hist_on=False) -> bool:
        """One epoch of training and validation; True when early stopping
        triggers."""
        losses = []  # one [K] tensor a window
        timer = StepTimer()
        last_logits = None
        epoch_t0 = time.perf_counter()
        with maybe_trace(self.log_dir if self.writer else None):
            for window in self._windows_of(train_loader, 1 if hist_on else self.fuse_steps, record=True):
                # the host's side of the window: on a card, kernels run on
                # after it
                with timer.step():
                    if hist_on:
                        loss, last_logits = self._step(self._put(window[0]))
                        losses.append(loss[None])
                    else:
                        losses.append(self.train_window(window))
        if not losses:
            raise ValueError(
                "train loader produced no batches — empty dataset/split "
                "or an over-aggressive filter"
            )
        # one device→host copy per epoch; the wall time is taken after it,
        # so it covers every step's device work.  Under a mesh each step's
        # loss is the sum of the ranks' parts
        step_losses = torch.cat(losses)
        if self.mesh is not None:
            dist.all_reduce(step_losses, group=self.mesh.data_group)
        epoch_loss = float(step_losses.mean())
        epoch_wall = time.perf_counter() - epoch_t0
        log.scalar("Loss/train", epoch_loss, epoch)
        if not np.isfinite(epoch_loss):
            log.close()
            state = self._state_dir()
            raise FloatingPointError(
                f"Non-finite training loss ({epoch_loss}) at epoch {epoch + 1}"
                + (f"; last good checkpoint in {state}" if state else "")
            )
        # the throughput rows count micro-steps; the p50 is a window's
        n_steps = sum(int(l.shape[0]) for l in losses)
        log.scalar("Throughput/steps_per_sec", n_steps / max(epoch_wall, 1e-9), epoch)
        log.scalar("StepTime/p50_ms", timer.summary()["p50_ms"], epoch)
        log.scalar("StepTime/wall_ms_per_step", 1e3 * epoch_wall / n_steps, epoch)

        stop_early = False
        if val_loader is not None:
            val_loss, val_acc = self._evaluate(val_loader)
            log.scalar("Loss/val", val_loss, epoch)
            log.scalar("Accuracy/val", val_acc, epoch)
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.early_stop_counter = 0
                if self.checkpoint_path:
                    self._write_checkpoint(self.checkpoint_path)
                self._print(f"Epoch {epoch+1}: New best model saved (val_loss={val_loss:.4f})")
            else:
                self.early_stop_counter += 1
                self._print(f"Epoch {epoch+1}: No improvement ({self.early_stop_counter}/{self.patience})")
            stop_early = self.early_stop_counter >= self.patience
        if hist_on:
            # every executed epoch, the one that stops early included
            named = [(f"{k}_weight", p.detach().cpu()) for k, p in self.model.named_parameters()]
            if last_logits is not None:
                named.append(("logits", last_logits.cpu()))
                named += [
                    (f"{k}_grad", p.grad.detach().cpu())
                    for k, p in self.model.named_parameters()
                    if p.grad is not None
                ]
            log.histograms(named, epoch)
        return stop_early

    # -- evaluation and inference ---------------------------------------------

    def _eval_window(self, window) -> list:
        """``[loss sums [K], real rows [K], probs [K, B, 1], y [K, B, 1],
        y_mask [K, B]]`` of a window of same-shape batches, on the device: one
        replay of its CUDA graph on the card, the batches one after another
        elsewhere.  A batch's masked loss is its sum over its count (at
        least 1), :func:`masked_bce`'s division."""

        def body(views):
            sums, counts, probs = [], [], []
            for v in views:
                logits = self._forward(v, train=False)
                per = F.binary_cross_entropy_with_logits(logits, v["y"], reduction="none")
                w = v["y_mask"][:, None]
                sums.append((per * w).sum())
                counts.append(w.sum())
                probs.append(torch.sigmoid(logits))
            return (
                torch.stack(sums), torch.stack(counts), torch.stack(probs),
                torch.stack([v["y"] for v in views]).float(),
                torch.stack([v["y_mask"] for v in views]).float(),
            )

        if self.windows is None or len(window) == 1:
            return list(body([self._put(b) for b in window]))
        return list(self.windows.run("eval", [kept_arrays(b, self.model) for b in window], body))

    def _eval_dispatch(self, loader: Iterable):
        """Per-batch masked losses ``[N]`` (host), probabilities, labels and
        masks, with one device→host copy for every batch's outputs; up to
        ``fuse_steps`` consecutive same-shape batches run as one window.

        Under a mesh every data rank's outputs are gathered (one all-gather
        a pass): a batch's loss sums the ranks' loss sums and counts, and
        the probabilities, labels and masks come batch by batch, each
        batch's shares in rank order, which is the global batch's row
        order."""
        outs = []  # each window's loss sums, counts, probs, y and y_mask
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                for window in self._windows_of(loader, self.fuse_steps):
                    outs += self._eval_window(window)
                if not outs:
                    raise ValueError("eval loader produced no batches")
                flat = torch.cat([t.reshape(-1) for t in outs])
                ranks = [flat] if self.mesh is None else self._gather_data_ranks(flat)
                ranks = [r.cpu().numpy() for r in ranks]
        finally:
            self.model.train(was_training)
        cuts = np.cumsum([t.numel() for t in outs])[:-1]
        host = [[p.reshape(t.shape) for p, t in zip(np.split(r, cuts), outs)] for r in ranks]
        sums = sum(np.concatenate(h[0::5]) for h in host)
        counts = sum(np.concatenate(h[1::5]) for h in host)
        losses = sums / np.maximum(counts, np.float32(1.0))

        def rows(i):
            # batch by batch, each batch's shares in rank order
            per_rank = [[a for group in h[i::5] for a in group] for h in host]
            return [a for batch in zip(*per_rank) for a in batch]

        return losses, rows(2), rows(3), [m.astype(bool) for m in rows(4)]

    def _gather_data_ranks(self, flat: torch.Tensor) -> list:
        """Every data rank's ``flat`` (one length on all: the shares' shapes
        agree), in rank order."""
        group = self.mesh.data_group
        length = torch.tensor([flat.numel()], device=flat.device)
        lengths = pmesh.gather_tensor(length, group).reshape(-1).tolist()
        if len(set(lengths)) != 1:
            raise RuntimeError(f"the data ranks' evaluation outputs differ in length: {lengths}")
        return list(pmesh.gather_tensor(flat, group).unbind(0))

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

    def _print(self, *args) -> None:
        if self.writer:
            print(*args)

    def _host_state_dict(self):
        """The model's ``state_dict`` on the host, the full weights under the
        model axis (every rank of a mesh calls it)."""
        self._sync_full()
        return {k: v.detach().cpu() for k, v in self.model.state_dict().items()}

    def _write_checkpoint(self, path: str) -> None:
        state = self._host_state_dict()
        if self.writer:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            torch.save(state, path)

    def _reshard(self) -> None:
        """The row blocks again from the model's full weights (after a
        load)."""
        with torch.no_grad():
            for name, s in self._shards.items():
                s.copy_(pmesh.row_block(self.model.get_parameter(name), self.mesh))

    def _sharded_positions(self) -> list:
        """The optimizer's indices of the row blocks."""
        names = [name for name, _ in self.model.named_parameters()]
        return [i for i, name in enumerate(names) if name in self._shards]

    def _full_optimizer_state(self) -> dict:
        """The optimizer's ``state_dict`` with each row block's state
        gathered into the full weight's (every rank of a mesh calls it)."""
        state = self.optimizer.state_dict()
        for i in self._sharded_positions():
            if i in state["state"]:
                # a new dict: state_dict() hands out the optimizer's own
                state["state"][i] = {
                    key: torch.cat(list(pmesh.gather_tensor(t, self.mesh.model_group))) if t.ndim else t
                    for key, t in state["state"][i].items()
                }
        return state

    def _block_optimizer_state(self, state: dict) -> dict:
        """A full optimizer ``state_dict`` cut to this rank's row blocks."""
        for i in self._sharded_positions():
            if i in state["state"]:
                state["state"][i] = {key: pmesh.row_block(t, self.mesh).clone() if t.ndim else t
                                     for key, t in state["state"][i].items()}
        return state

    def save(self, save_dir: str) -> None:
        self._write_checkpoint(os.path.join(save_dir, "model.pt"))

    def load(self, model_path: str) -> None:
        """Load a JAX-format pickle or a port ``state_dict`` (strict keys),
        with a fresh optimizer state as the JAX ``load`` has.

        The pickle is unpickled as the JAX package's ``load`` does: read only
        checkpoints this project wrote."""
        state = convert.read_state_dict(self.model.name, {"model": self.model.config}, model_path)
        self.model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()}, strict=True
        )
        self._reshard()
        self.optimizer = self._new_optimizer()

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
        state = {"model": self._host_state_dict(), "optimizer": self._full_optimizer_state()}
        if not self.writer:
            return
        os.makedirs(path, exist_ok=True)
        torch.save(state, os.path.join(path, STATE_FILE))
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
        self._reshard()
        self.optimizer = self._new_optimizer()
        self.optimizer.load_state_dict(self._block_optimizer_state(raw["optimizer"]))
        with open(meta_path) as f:
            meta = json.load(f)
        self.best_val_loss = meta["best_val_loss"]
        self.early_stop_counter = meta["early_stop_counter"]
        return meta["epoch"] + 1

    def get_trainable_parameters(self) -> int:
        return int(sum(p.numel() for p in self.model.parameters()))

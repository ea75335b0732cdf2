"""Vmapped multi-config training: several sweep arms in one step.

Counterpart of ``point_cloud_classifier_tpu/parallel/vmap_sweep.py``.  Arms
that share an architecture (the same widths, flags, batch size and
optimizer) differ only in values: their learning rate and initial weights.
Their parameters and BatchNorm buffers are stacked on a leading arm axis
(``torch.func.stack_module_state``), and one step runs
``torch.func.vmap(torch.func.grad_and_value(loss))`` over the stack with the
batch shared by every arm.  The model's kernels take part through their
``vmap`` rules (``ops/dispatch.per_arm``): on the card each arm launches its
own K1/K2 (DeepSets), K3/K4 and mirror (GAT) or K6 (GraphConv with
``fused_inrow``), and no raw binding sees a batched tensor.

Semantics, per arm, as in the JAX package (and as a sequential
``ModelWrapper`` run with that arm's seed and learning rate):

- initial weights: those ``factory.get_model`` draws for the arm's seed, or
  the port ``state_dict`` given in ``init_states`` (the tests carry the JAX
  package's ``vmap``-ed init across with ``convert.py``);
- the optimizer: adam or adamw with ``models/wrapper.py``'s constants,
  applied by :func:`_adam_step` in the operation order of
  ``torch.optim.Adam``'s foreach update (the card's) and single-tensor one
  (the CPU's), which agree, with each arm's learning rate and step count:
  the counterpart of ``optax.inject_hyperparams``.  ``torch.optim`` takes
  one scalar learning rate and cannot serve K arms;
- per epoch the val loss (the mean of batch means), the best-val-loss
  checkpoint and the stall count; an arm whose stall count reaches
  ``patience`` freezes: its parameters, BatchNorm buffers and optimizer
  state (step count included) stay as they are while the others train on;
- ``val_accs`` from the last epoch's val pass, ``train_accs`` from a pass
  over the train loader with the final parameters, both at sigmoid ≥ 0.5
  over the real rows.

:class:`VmappedArms` holds the stacks and takes the steps;
:func:`train_configs_vmapped` runs the epochs and the bookkeeping.

The JAX package probes one batch for ``model.init`` and rewinds the
loader's shuffle epoch after it; a torch module knows its shapes without a
batch, so nothing is probed and arm k sees the batch order of a sequential
run without a rewind.

With a mesh (``parallel/mesh.py``) the arm axis splits over the data ranks,
as the JAX package shards it over its mesh's ``data`` axis: where K divides
by the data-axis size each rank trains its contiguous K/n arms, with no
collective until the end, when every rank gathers every arm's results;
otherwise every rank trains all K arms (the JAX package replicates them).
"""

from __future__ import annotations

import copy
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call, grad_and_value, stack_module_state, vmap

from point_cloud_classifier_tpu_torch.models.wrapper import masked_bce, put_batch, resolve_device
from point_cloud_classifier_tpu_torch.parallel.mesh import rank_device

# models/wrapper.py:_make_optimizer's constants
_BETA1, _BETA2, _EPS, _WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01


def _arm_modules(model: nn.Module, seeds, init_states, device) -> List[nn.Module]:
    """One module per arm: the weights ``factory.get_model`` draws for each
    seed (the model's class over its own constructor arguments), or the
    given ``state_dict``s."""
    arms = []
    for i, seed in enumerate(seeds):
        arm = type(model)(**model.config, generator=torch.Generator().manual_seed(int(seed)))
        if init_states is not None:
            arm.load_state_dict(
                {k: torch.tensor(np.asarray(v)) for k, v in init_states[i].items()}, strict=True
            )
        arms.append(arm.to(device))
    return arms


def _adam_step(params, grads, exp_avgs, exp_avg_sqs, lrs, steps, decoupled: bool) -> None:
    """One adam (adamw: ``decoupled``) update, in place, of the arms' views:
    ``params[i]``, ``grads[i]``, … are lists of one arm's tensors, ``lrs[i]``
    its learning rate and ``steps[i]`` its step count after this step.  The
    operations and their order are ``torch.optim.Adam``'s foreach update
    (``_multi_tensor_adam``, without amsgrad or capture), which on the CPU
    runs tensor by tensor as its single-tensor update does; the bias
    corrections and step sizes are host floats, as there."""
    p, g, m, v = ([t for arm in group for t in arm] for group in (params, grads, exp_avgs, exp_avg_sqs))
    index = [i for i, arm in enumerate(params) for _ in arm]  # each tensor's arm
    if decoupled:
        torch._foreach_mul_(p, [1 - lrs[i] * _WEIGHT_DECAY for i in index])
    torch._foreach_lerp_(m, g, 1 - _BETA1)
    torch._foreach_mul_(v, _BETA2)
    torch._foreach_addcmul_(v, g, g, 1 - _BETA2)
    bias_correction1 = [1 - _BETA1 ** steps[i] for i in index]
    bias_correction2 = [1 - _BETA2 ** steps[i] for i in index]
    step_size = [(lrs[i] / bc) * -1 for i, bc in zip(index, bias_correction1)]
    denom = torch._foreach_sqrt(v)
    torch._foreach_div_(denom, [bc**0.5 for bc in bias_correction2])
    torch._foreach_add_(denom, _EPS)
    torch._foreach_addcdiv_(p, m, denom, step_size)


class VmappedArms:
    """K arms of one architecture, stacked: their parameters, BatchNorm
    buffers and adam state on a leading arm axis, one ``torch.func`` step
    over them.  :func:`train_configs_vmapped` drives it; ``chip_smoke.py``
    times and checks its step."""

    def __init__(self, model: nn.Module, learning_rates: Sequence[float], optimizer: str,
                 seeds: Sequence[int] = None, init_states: Optional[Sequence[dict]] = None,
                 device: Optional[str] = None):
        if optimizer not in ("adam", "adamw"):
            raise ValueError(f"Unknown optimizer: {optimizer}")
        self.device = resolve_device(device)
        self.k = k = len(learning_rates)
        seeds = [0] * k if seeds is None else list(seeds)
        if len(seeds) != k or (init_states is not None and len(init_states) != k):
            raise ValueError("one seed (and initial state) per learning rate")
        self.learning_rates = [float(lr) for lr in learning_rates]
        self.decoupled = optimizer == "adamw"
        arms = _arm_modules(model, seeds, init_states, self.device)
        self.state_keys = list(arms[0].state_dict().keys())
        params, self.buffers = stack_module_state(arms)
        self.params = {n: t.detach() for n, t in params.items()}
        self.base = copy.deepcopy(arms[0]).to("meta")
        self.steps = [0] * k
        exp_avgs = {n: torch.zeros_like(t) for n, t in self.params.items()}
        exp_avg_sqs = {n: torch.zeros_like(t) for n, t in self.params.items()}
        # per arm, its views into the stacks: the update writes through them
        self._views = [self._arm_views(d) for d in (self.params, exp_avgs, exp_avg_sqs)]
        base = self.base

        def loss_fn(p, b, batch):
            # the forward moves the BatchNorm buffers in place: give it
            # copies, and return them
            b = {n: t.clone() for n, t in b.items()}
            logits = functional_call(base, (p, b), (batch,), {"train": True})
            return masked_bce(logits, batch["y"], batch["y_mask"]), b

        def eval_fn(p, b, batch):
            logits = functional_call(base, (p, b), (batch,), {"train": False})
            correct = ((torch.sigmoid(logits) >= 0.5) == (batch["y"] >= 0.5))[:, 0]
            return masked_bce(logits, batch["y"], batch["y_mask"]), (correct * batch["y_mask"]).sum()

        self._grads = vmap(grad_and_value(loss_fn, has_aux=True), in_dims=(0, 0, None))
        self._eval = vmap(eval_fn, in_dims=(0, 0, None))

    def _arm_views(self, stacked: dict):
        views = [t.unbind(0) for t in stacked.values()]
        return [[v[i] for v in views] for i in range(self.k)]

    def put(self, batch) -> dict:
        """The batch on the device, as ``ModelWrapper`` puts it there."""
        return put_batch(batch, self.base, self.device)

    def grads(self, batch):
        """``(gradients, losses [K], moved buffers)`` of every arm on one
        batch, nothing updated."""
        grads, (loss, buffers) = self._grads(self.params, self.buffers, self.put(batch))
        return grads, loss, buffers

    def step(self, batch, arms: Optional[Sequence[int]] = None) -> torch.Tensor:
        """One train step of ``arms`` (default all); the others stay as they
        are, BatchNorm buffers and step counts included.  Returns the
        losses ``[K]`` on the device."""
        arms = list(range(self.k)) if arms is None else list(arms)
        grads, loss, buffers = self.grads(batch)
        grad_views = self._arm_views(grads)
        for i in arms:
            self.steps[i] += 1
        params, avgs, avg_sqs = self._views
        _adam_step(
            [params[i] for i in arms], [grad_views[i] for i in arms], [avgs[i] for i in arms],
            [avg_sqs[i] for i in arms], [self.learning_rates[i] for i in arms],
            [self.steps[i] for i in arms], self.decoupled,
        )
        if len(arms) == self.k:
            self.buffers = buffers
        else:
            for n, t in buffers.items():
                for i in arms:
                    self.buffers[n][i].copy_(t[i])
        return loss

    def evaluate(self, loader):
        """``(per-batch losses [N, K], correct counts [K], rows)`` on the
        host, eval mode."""
        losses, correct, total = [], torch.zeros(self.k, device=self.device), 0.0
        with torch.no_grad():
            for batch in loader:
                loss, c = self._eval(self.params, self.buffers, self.put(batch))
                losses.append(loss)
                correct = correct + c
                total += float(np.sum(batch["y_mask"]))
        if not losses:
            raise ValueError("eval loader produced no batches")
        return torch.stack(losses).cpu().numpy(), correct.cpu().numpy(), total

    def state_dicts(self, tensors: Optional[dict] = None) -> List[dict]:
        """Each arm's ``state_dict`` on the host (of ``tensors``, stacked
        parameters and buffers, default the current ones)."""
        tensors = {**self.params, **self.buffers} if tensors is None else tensors
        return [{n: tensors[n][i].detach().cpu().clone() for n in self.state_keys} for i in range(self.k)]


def train_configs_vmapped(
    model: nn.Module,
    learning_rates: Sequence[float],
    optimizer: str,
    epochs: int,
    train_loader: Iterable,
    val_loader: Iterable,
    seeds: Sequence[int] = None,
    patience: int = 10,
    mesh=None,
    init_states: Optional[Sequence[dict]] = None,
    device: Optional[str] = None,
):
    """Train K same-architecture configurations at once, one learning rate
    (and seed, default 0) per arm; ``model`` gives the architecture.

    Runs on the card, and raises where there is none, unless ``device``
    says otherwise (``"cpu"``).  Under ``mesh`` (a ``parallel/mesh.Mesh``)
    each data rank trains its share of the arms where K divides by the
    data-axis size, else all of them; every rank returns every arm's
    results.

    Returns a dict of per-arm ``val_accs`` and ``train_accs`` (the final
    weights'), ``final_state`` and ``best_state`` (port ``state_dict``s on
    the host, as ``ModelWrapper.save`` writes them), ``best_improved``
    (False for an arm whose val loss never improved, e.g. NaN from the first
    epoch: its best state is its initial one), and ``n_params`` (per arm)."""
    k = len(learning_rates)
    seeds = [0] * k if seeds is None else list(seeds)
    if mesh is not None:
        device = rank_device(device)
    if mesh is None or mesh.n_data == 1 or k % mesh.n_data:
        return _train_arms(model, learning_rates, optimizer, epochs, train_loader, val_loader, seeds,
                           patience, init_states, device)
    per = k // mesh.n_data
    mine = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    local = _train_arms(model, learning_rates[mine], optimizer, epochs, train_loader, val_loader, seeds[mine],
                        patience, None if init_states is None else init_states[mine], device)
    parts = [None] * mesh.n_data
    dist.all_gather_object(parts, local, group=mesh.data_group)
    return {
        **{key: [v for part in parts for v in part[key]]
           for key in ("val_accs", "train_accs", "final_state", "best_state", "best_improved")},
        "n_params": local["n_params"],
    }


def _train_arms(model, learning_rates, optimizer, epochs, train_loader, val_loader, seeds, patience,
                init_states, device):
    """:func:`train_configs_vmapped` of the given arms on this process."""
    arms = VmappedArms(model, learning_rates, optimizer, seeds, init_states, device)
    k = arms.k
    best_val_loss = [float("inf")] * k
    stall = [0] * k
    best = {n: t.clone() for n, t in {**arms.params, **arms.buffers}.items()}

    val_correct, val_total = None, 0.0
    for _ in range(epochs):
        active = [i for i in range(k) if stall[i] < patience]
        if active:  # frozen arms only: the epoch changes nothing
            n_batches = 0
            for batch in train_loader:
                arms.step(batch, active)
                n_batches += 1
            if not n_batches:
                raise ValueError(
                    "train loader produced no batches — empty dataset/split "
                    "or an over-aggressive filter"
                )
        # the last epoch's val pass doubles as the final val accuracy
        losses, val_correct, val_total = arms.evaluate(val_loader)
        val_loss = losses.astype(np.float64).mean(axis=0)
        current = {**arms.params, **arms.buffers}
        for i in active:
            if val_loss[i] < best_val_loss[i]:
                best_val_loss[i] = float(val_loss[i])
                stall[i] = 0
                for n, t in current.items():
                    best[n][i].copy_(t[i])
            else:
                stall[i] += 1

    if val_correct is None:
        _, val_correct, val_total = arms.evaluate(val_loader)
    _, train_correct, train_total = arms.evaluate(train_loader)
    return {
        "val_accs": [float(c) / max(val_total, 1.0) for c in val_correct],
        "train_accs": [float(c) / max(train_total, 1.0) for c in train_correct],
        "n_params": int(sum(t[0].numel() for t in arms.params.values())),
        "final_state": arms.state_dicts(),
        "best_state": arms.state_dicts(best),
        "best_improved": [bool(np.isfinite(v)) for v in best_val_loss],
    }

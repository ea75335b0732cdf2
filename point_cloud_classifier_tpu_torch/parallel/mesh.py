"""Data parallelism and the model axis on ``torch.distributed``.

Counterpart of ``point_cloud_classifier_tpu/parallel/mesh.py``.  There, a
``jax.sharding.Mesh`` with axes ``("data", "model")`` declares the layout
and XLA adds the collectives; here the ranks of a ``torch.distributed``
process group form the same grid (a ``DeviceMesh`` with those dim names)
and the trainer makes the collectives itself.  A mesh changes the layout,
never the math: a run on n ranks gives the single-device run's losses,
BatchNorm statistics, metrics and probabilities on the same global batches.

- ``data``: every rank keeps the global batch order (the same seed, shuffle
  and length sort) and takes a contiguous share of each global batch's
  example slots, ``ceil(B / n_data)`` of them (``data/batching.share_slices``); the
  loaders pack that share themselves (``iter_shard``), with every padded size
  agreed from the global index list so that all ranks see the same shapes;
  any other batch stream is cut by :func:`share_of_batch`.  The JAX package
  shards each array's leading dimension instead, so its flat point buffer
  can split an event across devices; here an event, however large, lands on
  one rank (``docs/parity_torch.md`` §13).
- the loss is the global masked mean (each rank's sum over its valid rows
  over the all-reduced count of valid rows), the gradients are summed over
  the data ranks, and ``MaskedBatchNorm`` takes exact global-batch moments
  through :func:`all_reduce_sum`, whose backward all-reduces too.
- ``model``: a rank-2 parameter whose leading (output) dimension divides by
  the model-axis size and is at least twice it is stored in row blocks, one
  per model rank (:func:`param_is_sharded`, the JAX ``param_shardings`` rule
  on torch's ``[out, in]`` layout); each forward gathers the full weight
  (:func:`gather_rows`, whose backward takes the rank's rows), as XLA gathers
  a ``pallas_call``'s operands, so the kernels see the chain's full weights.

Ranks come from ``torchrun`` (its ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``
environment) or, where no launcher set them, a group of one rank made here
(:func:`init_process_group`).  The backend is NCCL for the card and gloo for
the CPU; a caller may start gloo over card tensors itself (several ranks
sharing one card, which NCCL refuses), and the mesh then takes that group.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from point_cloud_classifier_tpu_torch.data.batching import share_slices


def resolve_device(device=None) -> torch.device:
    """``models/wrapper.resolve_device`` (imported here at the call: the
    wrapper imports this module)."""
    from point_cloud_classifier_tpu_torch.models.wrapper import resolve_device as resolve

    return resolve(device)


_TORCHRUN = "torchrun --nproc-per-node {n} -m point_cloud_classifier_tpu_torch train <model> ..."


def init_process_group(device=None) -> None:
    """The default process group, if none exists yet: from ``torchrun``'s
    environment (NCCL on the card, gloo on the CPU), else a world of one
    rank over an in-process store."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` where given, else the card
    ``cuda:LOCAL_RANK`` (0 without a launcher), made the current one; raises
    where there is no card or no such card."""
    if device is not None:
        device = resolve_device(device)
    else:
        resolve_device(None)  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK={local} but only {torch.cuda.device_count()} CUDA device(s) are visible"
            )
        device = torch.device("cuda", local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


class Mesh:
    """A ``(data, model)`` grid over every rank of the default process
    group: rank r sits at ``(r // n_model, r % n_model)``, as the JAX mesh
    reshapes its device list.  ``data_group`` holds the ranks of this rank's
    model index (they split each batch), ``model_group`` those of its data
    index (they hold the same share and split the wide weights)."""

    def __init__(self, n_data: int, n_model: int, device_type: str):
        from torch.distributed.device_mesh import DeviceMesh

        self.shape = {"data": n_data, "model": n_model}
        self.n_data, self.n_model = n_data, n_model
        self.rank = dist.get_rank()
        self.data_rank, self.model_rank = divmod(self.rank, n_model)
        self.backend = str(dist.get_backend())
        self.device_mesh = DeviceMesh(
            device_type,
            torch.arange(n_data * n_model).reshape(n_data, n_model),
            mesh_dim_names=("data", "model"),
        )
        self.data_group = self.device_mesh.get_group("data")
        self.model_group = self.device_mesh.get_group("model")

    @property
    def writer(self) -> bool:
        """Whether this rank writes the run's files (rank 0)."""
        return self.rank == 0

    @property
    def capturable(self) -> bool:
        """Whether the collectives can sit inside a CUDA graph (NCCL's can;
        gloo's copy through the host)."""
        return self.backend == "nccl"

    def __deepcopy__(self, memo):
        # modules hold the mesh (MaskedBatchNorm.axis): a copy shares it
        return self

    def __repr__(self) -> str:
        return f"Mesh(data={self.n_data}, model={self.n_model}, rank={self.rank}, backend={self.backend})"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices: Optional[Sequence] = None,
              device=None) -> Mesh:
    """A ``(data, model)`` mesh over every rank (``devices``, default the
    ranks of the default process group, which :func:`init_process_group`
    starts if need be).  Raises the JAX ``make_mesh``'s ``ValueError`` for a
    grid the ranks cannot fill, and also for one that leaves ranks out; on
    the card, where more cards are visible than there are ranks, it raises
    and names the ``torchrun`` line that uses them all.  A group it started
    itself is destroyed again where it raises."""
    started = not dist.is_initialized()
    try:
        return _make_mesh(n_data, n_model, devices, device)
    except BaseException:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        raise


def _make_mesh(n_data, n_model, devices, device) -> Mesh:
    if devices is None:
        init_process_group(device)
        devices = range(dist.get_world_size())
    n = len(devices)
    if n_data is None:
        n_data = n // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > n:
        raise ValueError(f"mesh {n_data}x{n_model} needs {max(n_data, 1) * n_model} devices, have {n}")
    if n_data * n_model != n:
        raise ValueError(
            f"mesh {n_data}x{n_model} leaves {n - n_data * n_model} of {n} ranks out: "
            "every rank of the process group takes part"
        )
    device_type = resolve_device(device).type
    if device_type == "cuda" and torch.cuda.device_count() > n:
        raise RuntimeError(
            f"{torch.cuda.device_count()} CUDA devices are visible but the process group has {n} "
            f"rank(s): a mesh spans every visible card, one rank each; launch "
            f"`{_TORCHRUN.format(n=torch.cuda.device_count())}` (or narrow CUDA_VISIBLE_DEVICES)"
        )
    init_process_group(device)
    if n != dist.get_world_size():
        raise ValueError(f"a mesh spans every rank of the process group ({dist.get_world_size()}), got {n}")
    return Mesh(n_data, n_model, device_type)


def default_mesh(device=None) -> Mesh:
    """A data-axis mesh over every rank."""
    return make_mesh(device=device)


def mesh_options(data_parallel, n_model):
    """``(data_parallel, n_model)`` after ``PCC_DATA_PARALLEL`` (strictly
    ``0`` or ``1``) and ``PCC_N_MODEL`` (an integer), read as the JAX
    trainer reads them."""
    env_dp = os.environ.get("PCC_DATA_PARALLEL")
    if env_dp is not None:
        if env_dp not in ("0", "1"):
            raise ValueError(f"PCC_DATA_PARALLEL must be '0' or '1', got {env_dp!r}")
        data_parallel = env_dp == "1"
    env_nm = os.environ.get("PCC_N_MODEL")
    if env_nm is not None:
        try:
            n_model = int(env_nm)
        except ValueError as e:
            raise ValueError(f"PCC_N_MODEL must be an integer, got {env_nm!r}") from e
    return bool(data_parallel), int(n_model)


# -- collectives that autograd follows ------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group``; its backward sums the gradients over the
    group, as a loss that is the sum of every rank's part needs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


class _GatherRows(torch.autograd.Function):
    """The full weight from each model rank's row block; the backward takes
    this rank's rows of the full weight's gradient, which every rank of the
    model group computes alike (they hold the same data share)."""

    @staticmethod
    def forward(ctx, shard, group, index):
        parts = [torch.empty_like(shard) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, shard.contiguous(), group=group)
        ctx.rows = (index * shard.shape[0], (index + 1) * shard.shape[0])
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None, None


def gather_rows(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _GatherRows.apply(shard, mesh.model_group, mesh.model_rank)


def param_is_sharded(p: torch.Tensor, n_model: int) -> bool:
    """The JAX ``param_shardings`` rule on torch's ``[out, in]`` layout: a
    rank-2 parameter whose output dimension divides by ``n_model`` and is at
    least ``2·n_model`` is split in row blocks over ``model``."""
    return n_model > 1 and p.ndim == 2 and p.shape[0] % n_model == 0 and p.shape[0] >= 2 * n_model


def row_block(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's row block of a full (sharded) tensor."""
    rows = t.shape[0] // mesh.n_model
    return t[mesh.model_rank * rows : (mesh.model_rank + 1) * rows]


def gather_tensor(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) stacked on a new leading
    axis, in rank order of ``group``."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


# -- each rank's share of a global batch --------------------------------------


# per-example arrays (leading dim = the batch's example slots) of every wire
_PER_EXAMPLE = {"x", "y", "y_mask", "node_mask", "in_deg", "in_src", "in_w",
                "out_dst", "out_w", "out_pos", "adj"}
# segment ids whose padding value is the slot count
_SEGMENT_IDS = {"seg", "node_seg", "edge_slot"}
# flat per-point / per-node / per-edge buffers, kept whole
_FLAT = {"src", "dst", "edge_w", "edge_mask", "edge_src", "edge_dst"}


def _rows(a: np.ndarray, sl: slice, per: int) -> np.ndarray:
    """``a[sl]`` zero-padded to ``per`` rows."""
    out = np.zeros((per, *a.shape[1:]), dtype=a.dtype)
    part = a[sl]
    out[: len(part)] = part
    return out


def _relabel(ids: np.ndarray, sl: slice, per: int, dtype=None) -> np.ndarray:
    """Segment ids of the share: ids in ``sl`` shifted to start at 0, every
    other id the share's padding id ``per`` (in ``ids``' dtype unless
    ``dtype`` is given)."""
    wide = ids.astype(np.int64)
    mine = (wide >= sl.start) & (wide < sl.stop)
    return np.where(mine, wide - sl.start, per).astype(dtype or ids.dtype)


def share_of_batch(batch: Dict[str, np.ndarray], rank: int, n: int) -> Dict[str, np.ndarray]:
    """Data rank ``rank``'s share of a packed global batch, for a batch
    stream that cannot pack shares itself (a list of packed batches).

    Per-example arrays keep the share's ``ceil(B / n)`` slots; the dense
    wires' counts keep theirs plus the padding count.  The flat wires keep
    their whole point, node and edge buffers, and the examples outside the
    share join the padding segment (a counts encoding becomes segment ids):
    the share then runs each of its examples exactly as the whole batch
    does, edges between examples included, and every rank sees the global
    batch's buffer shapes."""
    b = len(batch["y_mask"])
    per, slices = share_slices(b, n)
    sl = slices[rank]
    out = {}
    for key, a in batch.items():
        a = np.asarray(a)
        if key in _PER_EXAMPLE or (key in ("points", "nodes") and a.ndim == 3):
            out[key] = _rows(a, sl, per)
        elif key in _SEGMENT_IDS:
            out[key] = _relabel(a, sl, per)
        elif key in _FLAT or key in ("points", "nodes"):
            out[key] = a
        elif key == "event_feats":
            out[key] = np.concatenate([_rows(a[:b], sl, per), np.zeros_like(a[b:])])
        elif key in ("seg_counts", "node_seg_counts"):
            if key == "seg_counts" and np.asarray(batch["points"]).ndim == 3:
                counts = _rows(a[:b], sl, per)
                row_m = batch["points"].shape[1]
                out[key] = np.concatenate([counts, [per * row_m - counts.sum()]]).astype(a.dtype)
            else:
                ids = np.repeat(np.arange(b + 1), a.astype(np.int64))
                out["seg" if key == "seg_counts" else "node_seg"] = _relabel(ids, sl, per, np.int32)
        else:
            raise ValueError(f"share_of_batch: no share rule for batch array {key!r}")
    return out


class RankShares:
    """The data rank's shares of a batch stream, re-iterable: a loader with
    ``iter_shard`` packs them itself; any other stream's batches go through
    :func:`share_of_batch`."""

    def __init__(self, loader, mesh: Mesh):
        self.loader = loader
        self.rank, self.n = mesh.data_rank, mesh.n_data

    def __iter__(self):
        if hasattr(self.loader, "iter_shard"):
            return self.loader.iter_shard(self.rank, self.n)
        return (share_of_batch(b, self.rank, self.n) for b in self.loader)

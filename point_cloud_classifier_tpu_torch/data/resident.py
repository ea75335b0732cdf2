"""A device-resident batch cache: upload once, train from device memory.

Counterpart of ``point_cloud_classifier_tpu/data/resident.py``, with its
semantics:

- ``ResidentCache`` wraps a re-iterable batch loader.  The first iteration
  streams the loader's batches, puts each on the device and keeps it; every
  later one replays the kept batches, so no host→device copy happens after
  the first epoch.  The cached tensors hold the bytes the streaming path
  would have sent, so training from the cache reproduces streaming training
  where the order is the same.
- By default each replay takes the first epoch's order.  ``shuffle_seed``
  permutes the order of the batches every replay (their composition stays
  as the first epoch made it), from ``default_rng(shuffle_seed + epoch)``
  with the epoch counted from ``epoch_offset``.  ``shuffle_block > 1``
  permutes blocks of that many consecutive batches instead (a partial last
  block stays last), where at least 8 full blocks exist; with fewer it
  permutes batches (``_replay_block``).
- Caching stops at ``budget_bytes`` (2 GiB unless given or set by
  ``PCC_RESIDENT_BUDGET_MB``): if the first pass goes over it, the cache
  gives up, and this and every later iteration yields the loader's host
  batches unchanged.

Upload: each batch goes from pinned host memory to the card on its own
(``upload_chunk=1``, the default here).  The JAX cache stacks up to 64
same-shape batches into one ``device_put`` (``upload_chunk``,
``PCC_RESIDENT_UPLOAD_CHUNK``) because each small transfer could stall on
the TPU's remote transport; ``upload_chunk > 1`` stacks here too, into one
pinned copy per chunk whose per-batch slices are views.  On the CPU a
batch's arrays become tensors over the same memory.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

_CHUNK_BYTES_CAP = 128 << 20  # a stacked chunk holds at most this much


def _default_budget_bytes() -> int:
    mb = os.environ.get("PCC_RESIDENT_BUDGET_MB")
    return int(mb) * (1 << 20) if mb else 2 << 30


def _default_upload_chunk() -> int:
    return max(1, int(os.environ.get("PCC_RESIDENT_UPLOAD_CHUNK", "1")))


def _nbytes(batch: Dict[str, np.ndarray]) -> int:
    return int(sum(np.asarray(v).nbytes for v in batch.values()))


def shape_key(batch) -> tuple:
    """One batch shape: each array's key, shape and dtype (host arrays or
    device tensors)."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))


class ResidentCache:
    """A re-iterable wrapper that keeps a loader's batches on ``device``."""

    def __init__(
        self,
        loader: Iterable[Dict[str, np.ndarray]],
        device=None,
        budget_bytes: Optional[int] = None,
        shuffle_seed: Optional[int] = None,
        epoch_offset: int = 0,
        upload_chunk: Optional[int] = None,
        shuffle_block: int = 1,
    ):
        self.loader = loader
        self.device = torch.device("cuda" if device is None else device)
        self.budget_bytes = _default_budget_bytes() if budget_bytes is None else budget_bytes
        self.upload_chunk = (
            _default_upload_chunk() if upload_chunk is None else max(1, upload_chunk)
        )
        self.shuffle_seed = shuffle_seed
        self.shuffle_block = max(1, int(shuffle_block))
        # a resumed run passes its start epoch, so that replays do not repeat
        # the orders the interrupted run used; its first epoch streams in the
        # loader's own order, as a fresh run's does
        self._epoch = int(epoch_offset)
        self._cached: Optional[list] = None  # device batches once complete
        self._abandoned = False

    @property
    def cached(self) -> bool:
        return self._cached is not None

    def _put_many(self, batches: List[Dict[str, np.ndarray]]) -> List[Dict[str, torch.Tensor]]:
        """The batches on the device: one pinned copy each, or one for all of
        them (the same shapes) when several are given."""
        pin = self.device.type == "cuda"
        if len(batches) == 1:
            host = {k: torch.as_tensor(v) for k, v in batches[0].items()}
            return [{
                k: (t.pin_memory() if pin else t).to(self.device, non_blocking=pin)
                for k, t in host.items()
            }]
        stacked = {}
        for k in batches[0]:
            t = torch.from_numpy(np.stack([np.asarray(b[k]) for b in batches]))
            stacked[k] = (t.pin_memory() if pin else t).to(self.device, non_blocking=pin)
        return [{k: v[i] for k, v in stacked.items()} for i in range(len(batches))]

    def _replay_block(self) -> int:
        """The shuffle's granularity on replay: ``shuffle_block`` where that
        leaves at least 8 full blocks to permute (8! orders), else 1, since
        a permutation of 1–7 blocks repeats orders within a few epochs."""
        if self.shuffle_seed is None or self.shuffle_block <= 1:
            return 1
        n = len(self._cached) if self._cached is not None else 0
        return self.shuffle_block if n // self.shuffle_block >= 8 else 1

    def replay_is_window_stable(self, k: int) -> bool:
        """True when replays keep the composition of every ``k`` consecutive
        batches (a fused step window) fixed: not while the first pass
        streams, not after the budget tripped, and not when replays shuffle
        single batches."""
        if self._cached is None or self._abandoned:
            return False
        if self.shuffle_seed is None:
            return True
        return k > 1 and self._replay_block() == k

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        self._epoch += 1
        if self._abandoned:
            yield from self.loader
            return
        if self._cached is not None:
            n = len(self._cached)
            order = range(n)
            if self.shuffle_seed is not None:
                rng = np.random.default_rng(self.shuffle_seed + self._epoch)
                blk = self._replay_block()
                if blk <= 1:
                    order = rng.permutation(n)
                else:
                    # full blocks permuted, a partial tail block kept last
                    n_full = (n // blk) * blk
                    starts = rng.permutation(n // blk) * blk
                    order = np.concatenate(
                        [(starts[:, None] + np.arange(blk)).reshape(-1), np.arange(n_full, n)]
                    )
            for i in order:
                yield self._cached[i]
            return
        # the first pass: stream, put on the device, keep
        pinned, used = [], 0
        chunk: List[Dict[str, np.ndarray]] = []  # same-shape host batches
        chunk_key, chunk_bytes = None, 0
        it = iter(self.loader)
        for batch in it:
            nbytes = _nbytes(batch)
            used += nbytes
            if used > self.budget_bytes:
                # over budget: keep nothing and stream host batches from here
                # on, this epoch and every later one
                self._abandoned = True
                pinned.clear()
                yield from chunk
                chunk.clear()
                yield batch
                yield from it
                return
            key = shape_key(batch) if self.upload_chunk > 1 else None
            if chunk and (
                len(chunk) >= self.upload_chunk
                or key != chunk_key
                or chunk_bytes >= _CHUNK_BYTES_CAP
            ):
                devs = self._put_many(chunk)
                chunk.clear()
                chunk_bytes = 0
                pinned.extend(devs)
                yield from devs
            chunk_key = key
            chunk_bytes += nbytes
            chunk.append(batch)
        if chunk:
            devs = self._put_many(chunk)
            pinned.extend(devs)
            yield from devs
        self._cached = pinned

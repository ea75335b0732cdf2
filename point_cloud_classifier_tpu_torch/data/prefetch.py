"""Host→device batch prefetch on a side CUDA stream.

Counterpart of ``point_cloud_classifier_tpu/data/prefetch.py``, which keeps
``size`` asynchronous ``device_put``s in flight.  Here each host batch is
copied into pinned memory and sent to the card with ``non_blocking=True``
on a side stream, ``size`` batches ahead of the consumer; the consumer's
stream waits on an event recorded after each batch's copies, and
``record_stream`` tells the caching allocator that the consumer's stream
uses those buffers.  The trainer takes it with ``PCC_PREFETCH=1``.

On the CPU the move is the identity: each array becomes a tensor over the
same memory.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


def prefetch_to_device(
    iterator: Iterable[Dict[str, np.ndarray]], size: int = 2, device=None
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of ``iterator`` on ``device`` (the card unless
    named), keeping ``size`` batches' copies in flight."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        return

    stream = torch.cuda.Stream(device)
    in_flight = collections.deque()

    def ready(dev, event):
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in dev.values():
            t.record_stream(current)
        return dev

    for batch in iterator:
        pinned = {k: torch.as_tensor(v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(stream):
            dev = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(stream)
        in_flight.append((dev, event))
        if len(in_flight) > size:
            yield ready(*in_flight.popleft())
    while in_flight:
        yield ready(*in_flight.popleft())

"""A batch producer on a background thread.

Counterpart of ``point_cloud_classifier_tpu/data/background.py``.  The
loaders assemble batches with numpy copies, which release the GIL, so one
producer thread hides the packing behind the device's work.

``BackgroundIterator`` wraps any batch iterable: a daemon thread fills a
bounded queue and the consumer pops from it.  An exception in the producer
reaches the consumer; the producer stops at the end (a sentinel) or when the
consumer walks away.  The trainer takes it with ``PCC_BG_LOADER=1``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class BackgroundIterator:
    """Iterate ``iterable`` on a daemon thread through a bounded queue."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, prefetch: int = 2):
        self._iterable = iterable
        self._prefetch = max(1, prefetch)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """A bounded put that gives up once the consumer has gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self._iterable:
                    if not put(item):
                        return
            except BaseException as e:  # raised again in the consumer
                put(e)
                return
            put(self._SENTINEL)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # done, or abandoned mid-epoch: retire the producer, which would
            # otherwise wait on a full queue holding whole batches
            stop.set()

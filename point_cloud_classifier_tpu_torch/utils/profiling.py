"""Step timing and tracing.

Counterpart of ``point_cloud_classifier_tpu/utils/profiling.py``:

- :class:`StepTimer` — per-step wall times, with throughput (examples per
  second) and latency percentiles (p50/p90/p99), the percentile being the
  sorted sample at index ``round(q/100 · (n − 1))``.  ``summary()`` and
  ``dump()`` give the JAX package's keys.
- :func:`maybe_trace` — ``torch.profiler.profile`` around the wrapped region
  when ``PCC_TRACE=1`` (or ``force=True``): CPU activity, and CUDA activity
  where a card is present, written as a Chrome trace under
  ``{log_dir}/trace/``.  Otherwise it does nothing, so the hot loop never
  pays for it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import List, Optional

_TRACE_SEQ = itertools.count()


class StepTimer:
    """Accumulates step wall times; derives throughput and latency
    percentiles."""

    def __init__(self, examples_per_step: Optional[int] = None):
        self.examples_per_step = examples_per_step
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def _percentile(self, q: float) -> float:
        if not self.times:
            return 0.0
        xs = sorted(self.times)
        idx = min(int(round(q / 100.0 * (len(xs) - 1))), len(xs) - 1)
        return xs[idx]

    def summary(self) -> dict:
        n = len(self.times)
        total = sum(self.times)
        out = {
            "steps": n,
            "total_seconds": total,
            "mean_ms": (total / n * 1e3) if n else 0.0,
            "p50_ms": self._percentile(50) * 1e3,
            "p90_ms": self._percentile(90) * 1e3,
            "p99_ms": self._percentile(99) * 1e3,
        }
        if self.examples_per_step and total > 0:
            out["examples_per_sec"] = self.examples_per_step * n / total
        return out

    def dump(self, path: str) -> dict:
        s = self.summary()
        parent = os.path.dirname(path)
        if parent:  # a bare filename has no directory to create
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(s, f, indent=4)
        return s


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str], force: bool = False):
    """``torch.profiler.profile`` when ``PCC_TRACE=1`` (or ``force``); else
    nothing.  The Chrome trace lands in ``{log_dir}/trace/``, one file per
    traced region; with ``log_dir`` None a requested trace warns and writes
    nothing."""
    enabled = force or os.environ.get("PCC_TRACE") == "1"
    if not (enabled and log_dir):
        if enabled and log_dir is None:
            import warnings

            warnings.warn(
                "maybe_trace: capture requested but log_dir is None — "
                "no trace will be written",
                stacklevel=3,
            )
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(log_dir, "trace")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    name = f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}_{next(_TRACE_SEQ)}.json"
    prof.export_chrome_trace(os.path.join(trace_dir, name))

"""Fused step windows on the card: K same-shape steps as one CUDA graph.

The counterpart of the JAX trainer's ``fuse_steps`` scan
(``train_step_fused``, ``eval_step_fused``): up to K consecutive batches of
one shape run as one dispatched program, with results equal to their K
steps run in sequence.  On the card a window is one replay of a CUDA graph
that holds its K steps; on the CPU, where there is no graph, the trainer
runs the K steps one after another (``models/wrapper.py``).

:class:`WindowGraphs` keeps one graph per (kind, shape key, window length),
all of them in one memory pool:

- the window's batches are copied into static ``[K, ...]`` input buffers
  (a host window is stacked once and copied once; a window already on the
  device is stacked into them, one copy kernel a key);
- the first window of a key runs its K steps eagerly on those buffers,
  under ``torch.cuda.set_sync_debug_mode("error")``: it is the warm-up that
  creates the optimizer state and builds the kernels, and it finds any
  operation that reads a result on the host, which a graph cannot hold;
- the second captures the K steps; every later one copies its inputs and
  replays.  The outputs land in static tensors and are cloned out.

Nothing falls back: a route that reads the device from the host raises
``NotImplementedError`` at its first window, naming the route and the
operation, and a capture that fails raises the same way.

A replay launches the kernels its capture recorded without passing through
their wrappers, so each window adds the launches its capture counted to the
kernels' counters at every replay (and the capture, which runs nothing,
takes its own counts back): ``phi_pool.launches`` and the rest stay the
number of kernel executions.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from point_cloud_classifier_tpu_torch.data.resident import shape_key

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


def kernel_counters() -> List[Tuple[object, str]]:
    """Every kernel's launch counter, as ``(wrapper, attribute)``."""
    from point_cloud_classifier_tpu_torch.ops.fused_phi import phi_pool
    from point_cloud_classifier_tpu_torch.ops.gat import gat_attention, gat_out_rows
    from point_cloud_classifier_tpu_torch.ops.inrow_graph import inrow_aggregate
    from point_cloud_classifier_tpu_torch.ops.knn import knn_aggregate, knn_select

    return [
        (phi_pool, "launches"), (phi_pool, "bwd_launches"),
        (gat_attention, "launches"), (gat_attention, "bwd_launches"),
        (gat_out_rows, "launches"),
        (inrow_aggregate, "launches"), (inrow_aggregate, "bwd_launches"),
        (knn_select, "launches"), (knn_aggregate, "launches"), (knn_aggregate, "bwd_launches"),
    ]


def _read_counters() -> List[int]:
    return [getattr(fn, attr) for fn, attr in kernel_counters()]


def _add_counters(deltas: Sequence[int]) -> None:
    for (fn, attr), d in zip(kernel_counters(), deltas):
        setattr(fn, attr, getattr(fn, attr) + d)


def _where(exc: BaseException) -> str:
    """The innermost frame outside torch in ``exc``'s traceback, as
    ``file:line (code)``: the operation that cannot run in a graph."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not os.path.abspath(f.filename).startswith(_TORCH_DIR)]
    if not frames:
        return "an operation inside torch"
    f = frames[-1]
    rel = os.path.relpath(f.filename, _REPO_DIR) if f.filename.startswith(_REPO_DIR) else f.filename
    return f"{rel}:{f.lineno} ({(f.line or '').strip()})"


class _Window:
    def __init__(self, static: Dict[str, torch.Tensor]):
        self.static = static
        self.warm = False
        self.graph = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.launches: List[int] = []  # counter deltas of one replay

    def views(self) -> List[Dict[str, torch.Tensor]]:
        k = next(iter(self.static.values())).shape[0]
        return [{name: t[i] for name, t in self.static.items()} for i in range(k)]

    def load(self, batches: Sequence[Dict]) -> None:
        first = next(iter(batches[0].values()))
        if isinstance(first, torch.Tensor) and first.device == next(iter(self.static.values())).device:
            for name, t in self.static.items():
                torch.stack([b[name] for b in batches], out=t)
            return
        for name, t in self.static.items():
            host = torch.from_numpy(np.stack([np.asarray(b[name]) for b in batches]))
            t.copy_(host.pin_memory(), non_blocking=True)


class WindowGraphs:
    """The CUDA graphs of one trainer's fused windows, in one memory pool.

    ``route`` names the model route in errors.  ``captures``,
    ``capture_seconds`` and ``replays`` say what the graphs cost and how
    often they ran."""

    def __init__(self, device: torch.device, route: str):
        self.device = device
        self.route = route
        self._pool = None
        self._windows: Dict[tuple, _Window] = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0

    def clear(self) -> None:
        """Drop every graph: their captures hold the optimizer's state
        tensors, which a new optimizer replaces."""
        self._windows.clear()

    def __len__(self) -> int:
        return sum(w.graph is not None for w in self._windows.values())

    def run(
        self, kind: str, batches: Sequence[Dict], body: Callable[[List[Dict]], Tuple[torch.Tensor, ...]]
    ) -> Tuple[torch.Tensor, ...]:
        """``body`` over the window ``batches`` (dicts of the keys the model
        reads, host arrays or device tensors of one shape): eagerly the first
        time, captured the second, replayed after.  ``body`` takes the K
        batches as views of the static buffers and returns device tensors;
        the result is a copy of them."""
        key = (kind, shape_key(batches[0]), len(batches))
        win = self._windows.get(key)
        if win is None:
            static = {
                name: torch.empty((len(batches), *v.shape), dtype=_dtype(v), device=self.device)
                for name, v in batches[0].items()
            }
            win = self._windows[key] = _Window(static)
        win.load(batches)
        if not win.warm:
            out = self._warm(kind, len(batches), body, win.views())
            win.warm = True
            return out
        if win.graph is None:
            self._capture(kind, win, body)
        win.graph.replay()
        _add_counters(win.launches)
        self.replays += 1
        return tuple(t.clone() for t in win.outputs)

    def _refuse(self, what: str, kind: str, k: int, exc: BaseException):
        return NotImplementedError(
            f"fuse_steps={k}: the {kind} step of {self.route} cannot run as a CUDA graph: "
            f"{what} at {_where(exc)}: {exc}"
        )

    def _warm(self, kind, k, body, views):
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return tuple(body(views))
        except RuntimeError as e:
            if "synchronizing" not in str(e):
                raise
            raise self._refuse("it reads the device on the host", kind, k, e) from e
        finally:
            torch.cuda.set_sync_debug_mode(previous)

    def _capture(self, kind, win, body):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _read_counters()
        t0 = time.perf_counter()
        views = win.views()
        k = len(views)
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                outputs = tuple(body(views))
        except RuntimeError as e:
            raise self._refuse("its capture failed", kind, k, e) from e
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        after = _read_counters()
        win.launches = [a - b for a, b in zip(after, before)]
        _add_counters([-d for d in win.launches])  # the capture ran nothing
        win.graph, win.outputs = graph, outputs


def _dtype(v) -> torch.dtype:
    return v.dtype if isinstance(v, torch.Tensor) else torch.from_numpy(np.empty(0, np.asarray(v).dtype)).dtype

"""Several ranks on one machine, each a process, for the mesh's checks.

:func:`run_ranks` spawns ``n`` processes (``multiprocessing``'s ``spawn``:
a fresh interpreter each, which imports the function's module and no more),
joins them into one ``torch.distributed`` group over a ``file://`` store in
a temporary directory, runs ``fn(rank, n, *args)`` on each and returns the
results in rank order.  The CPU tests run gloo worlds of 1, 2 and 4 CPU
ranks through it, and ``chip_smoke.py`` gloo ranks that share one card
(NCCL refuses two ranks on one device).  ``fn`` and its arguments and
results cross process boundaries pickled: ``fn`` is a module-level function
of a module that imports neither jax nor the JAX package.
"""

from __future__ import annotations

import multiprocessing
import queue
import tempfile
import time
import traceback
from typing import Callable, List

import torch
import torch.distributed as dist


def _rank_main(fn, rank, n, init_method, results, args) -> None:
    try:
        torch.set_num_threads(1)  # the ranks share the machine's cores
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=n)
        results.put((rank, True, fn(rank, n, *args)))
    except BaseException:  # noqa: B036 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, *args, timeout: float = 600.0) -> List[object]:
    """``[fn(0, n, *args), …, fn(n - 1, n, *args)]``, each on its own process
    of one gloo group, with one torch thread each.  A rank that
    raises, or a world that does not finish within ``timeout`` seconds,
    ends every rank and raises here with the rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="pcc_ranks_") as tmp:
        init_method = f"file://{tmp}/store"
        procs = [
            ctx.Process(target=_rank_main, args=(fn, r, n, init_method, results, args))
            for r in range(n)
        ]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} of {n} in {fn.__name__} exited with code "
                            f"{procs[dead[0]].exitcode} before returning"
                        ) from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{n} ranks of {fn.__name__} did not finish in {timeout:.0f} s"
                        ) from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed in {fn.__name__}:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(n)]

"""Kernel dispatch policy: the hand-written CUDA kernels vs the plain versions.

Counterpart of ``point_cloud_classifier_tpu/ops/dispatch.py``.  An op whose
kernel the port has asks :func:`use_cuda_kernels` with the tensor it was
given: a CUDA tensor launches the kernel, a CPU tensor takes the plain
PyTorch version.  :func:`force_plain` is the counterpart of ``force_xla``:
inside it every such op takes its plain version, on the card too.  It is the
package's own switch, used to hold a kernel route against its plain route
(``chip_smoke.py``, the card tests); it is not a fallback, and nothing in
the package enters it on its own.

The flag is read when the op is called (PyTorch runs eagerly), so the
context covers exactly the calls made inside it.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_FORCE_PLAIN = False


def use_cuda_kernels(t: torch.Tensor) -> bool:
    """True when an op on ``t`` launches its CUDA kernel."""
    return t.device.type == "cuda" and not _FORCE_PLAIN


@contextmanager
def force_plain():
    """Within this context, every op takes its plain PyTorch version."""
    global _FORCE_PLAIN
    prev = _FORCE_PLAIN
    _FORCE_PLAIN = True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev

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

Under ``torch.func`` (the vmapped sweep arms of ``parallel/vmap_sweep.py``)
each kernel's autograd Function carries a ``vmap`` rule, :func:`per_arm`:
the arm axis is unbound, the Function is applied to each arm's plain
tensors, and the results are stacked.  A raw binding never sees a batched
or gradient-tracking wrapper: :func:`require_plain_tensors` raises where one
would reach it.
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


def require_plain_tensors(*tensors) -> None:
    """Raise if any of ``tensors`` is a ``torch.func`` wrapper (a batched or
    gradient-tracking tensor): a kernel's C entry reads raw device pointers
    and would read the wrapped storage as if it were one arm's."""
    for t in tensors:
        if torch._C._functorch.is_functorch_wrapped_tensor(t):
            raise TypeError(
                "a torch.func-wrapped tensor reached a kernel binding; the op's "
                "vmap rule must unbind the arm axis first"
            )


def per_arm(fn, info, in_dims, *args):
    """A ``vmap`` rule of an autograd Function: ``fn(*args)`` once per arm,
    each batched argument taken at that arm, and the outputs stacked on a
    leading arm axis.  Returns ``(outputs, out_dims)`` as
    ``torch.autograd.Function.vmap`` must."""
    outs = [
        fn(*(a.select(d, arm) if d is not None else a for a, d in zip(args, in_dims)))
        for arm in range(info.batch_size)
    ]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs)), (0,) * len(outs[0])
    return torch.stack(outs), 0

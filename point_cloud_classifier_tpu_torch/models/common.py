"""Shared model building blocks with PyTorch's default semantics.

Counterpart of ``point_cloud_classifier_tpu/models/common.py``:

- Linear: weight ``[out, in]`` and bias both ~ U(-1/sqrt(fan_in),
  +1/sqrt(fan_in)), drawn from an explicit ``torch.Generator``;
- LayerNorm: eps 1e-5, moments in f32;
- BatchNorm1d over the unmasked rows (``MaskedBatchNorm``): eps 1e-5,
  momentum 0.1, the biased batch variance to normalize and the unbiased one
  into ``running_var``, statistics in f32;
- mixed precision: parameters stay f32, and a layer runs in its input's
  dtype (the dot accumulates in f32 and is rounded to that dtype, then the
  bias is added in it), as the JAX package's ``TorchLinear`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from point_cloud_classifier_tpu_torch.ops.activations import resolve_activation

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name) -> torch.dtype:
    """'float32' | 'bfloat16' | 'float16' (config strings) → torch dtype."""
    if name is None:
        return torch.float32
    if name not in _DTYPES:
        raise ValueError(f"Unknown compute dtype: {name}")
    return _DTYPES[name]


class TorchLinear(nn.Module):
    """``nn.Linear``'s layout and default init, run in the input's dtype."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        generator: torch.Generator | None = None,
        bias: bool = True,
    ):
        super().__init__()
        bound = in_features**-0.5 if in_features > 0 else 0.0
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(
                -bound, bound, generator=generator
            )
        )
        self.bias = (
            nn.Parameter(torch.empty(out_features).uniform_(-bound, bound, generator=generator))
            if bias
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class TorchLayerNorm(nn.Module):
    """LayerNorm with torch defaults (eps 1e-5, affine), moments in f32."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f32 = x.float()
        mean = f32.mean(dim=-1, keepdim=True)
        var = ((f32 - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (f32 - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over rows ``[N, F]`` that leaves masked (padding) rows out
    of the batch statistics.

    Train mode normalizes with the biased variance of the rows whose mask is
    nonzero and moves ``running_mean``/``running_var`` (the unbiased
    variance) by ``momentum``; eval mode normalizes with the running
    statistics.  Everything is computed in f32 and the output returns to the
    input's dtype.  ``num_batches_tracked`` is kept, at 0, only so that
    torch's BatchNorm1d state_dicts load strictly: the fixed momentum never
    reads it (as in the JAX package, where it has no counterpart)."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,
        train: bool = False,
        update_stats: bool = True,
    ) -> torch.Tensor:
        """``update_stats`` false leaves the running statistics as they are
        in train mode: a rematerialised forward, run again in the backward,
        passes it so that they move once a step."""
        in_dtype = x.dtype
        x = x.float()
        if train:
            if mask is None:
                n = torch.tensor(float(x.shape[0]), device=x.device)
                mean = x.mean(dim=0)
                var = ((x - mean) ** 2).mean(dim=0)
            else:
                w = mask.reshape(-1, 1).float()
                n = torch.clamp(w.sum(), min=1.0)
                mean = (w * x).sum(dim=0) / n
                var = (w * (x - mean) ** 2).sum(dim=0) / n
            if update_stats:
                with torch.no_grad():
                    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                    m = self.momentum
                    self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                    self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(in_dtype)


class Activation(nn.Module):
    """A parameterless activation layer.  ``gelu`` resolves ``PCC_GELU`` when
    called, as the JAX package resolves it when tracing."""

    def __init__(self, activation: str):
        super().__init__()
        resolve_activation(activation)  # unknown names fail at construction
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resolve_activation(self.activation)(x)

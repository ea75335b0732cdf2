"""Shared model building blocks with PyTorch's default semantics.

Counterpart of ``point_cloud_classifier_tpu/models/common.py``:

- Linear: weight ``[out, in]`` and bias both ~ U(-1/sqrt(fan_in),
  +1/sqrt(fan_in)), drawn from an explicit ``torch.Generator``;
- LayerNorm: eps 1e-5, moments in f32;
- mixed precision: parameters stay f32, and a layer runs in its input's
  dtype (the dot accumulates in f32 and is rounded to that dtype, then the
  bias is added in it), as the JAX package's ``TorchLinear`` does.

``MaskedBatchNorm`` waits for the FCN or GraphNet slice.
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
    ):
        super().__init__()
        bound = in_features**-0.5 if in_features > 0 else 0.0
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(
                -bound, bound, generator=generator
            )
        )
        self.bias = nn.Parameter(
            torch.empty(out_features).uniform_(-bound, bound, generator=generator)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


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


class Activation(nn.Module):
    """A parameterless activation layer.  ``gelu`` resolves ``PCC_GELU`` when
    called, as the JAX package resolves it when tracing."""

    def __init__(self, activation: str):
        super().__init__()
        resolve_activation(activation)  # unknown names fail at construction
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resolve_activation(self.activation)(x)

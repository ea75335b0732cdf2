"""Activations shared by the φ chain, its kernel and the MLP stacks.

Counterpart of ``point_cloud_classifier_tpu/ops/activations.py``.
``resolve_activation("gelu")`` follows ``PCC_GELU``:

- ``quick`` (the default): ``x·sigmoid(1.702x)``;
- ``exact``: what ``jax.nn.gelu`` computes by default, which is the tanh
  approximation, so ``F.gelu(approximate="tanh")`` and not PyTorch's erf form.

The JAX package's Mosaic workaround forms and its polynomial GELU
(``PCC_GELU=poly``) have no counterpart here.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU, ``x * sigmoid(1.702 x)``, evaluated in the input dtype."""
    return x * torch.sigmoid(1.702 * x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _silu(x: torch.Tensor) -> torch.Tensor:
    # written out like the JAX form (two roundings in bf16, not F.silu's one)
    return x * torch.sigmoid(x)


def gelu_variant() -> str:
    """``PCC_GELU``: ``quick`` (default) or ``exact``."""
    variant = os.environ.get("PCC_GELU", "quick")
    if variant not in ("quick", "exact"):
        raise ValueError(f"PCC_GELU must be 'quick' or 'exact', got {variant!r}")
    return variant


def resolve_activation(name: str):
    """The activation function for a config name."""
    if name == "gelu":
        return quick_gelu if gelu_variant() == "quick" else _gelu_tanh
    table = {"relu": torch.relu, "silu": _silu, "tanh": torch.tanh}
    if name not in table:
        raise ValueError(f"Unknown activation: {name}")
    return table[name]

"""MLP classifier over the nine tabular features.

Counterpart of ``point_cloud_classifier_tpu/models/fully_connected_net.py``:
``[Linear → BatchNorm1d? → ReLU]*`` over ``hidden_layers``, then a final
Linear to ``output_dim``, logits in f32.  It reads the padded tabular batch
(``x [B, F]``, ``y_mask [B]``); the mask keeps the batch-norm statistics to
the real rows of an epoch's final partial batch.

Module names follow the original torch reference's ``state_dict`` layout
(``network.N.weight``, ``network.N.running_mean``, …), so
``convert.to_torch_state_dict`` output loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from point_cloud_classifier_tpu_torch.models.common import (
    MaskedBatchNorm,
    TorchLinear,
    resolve_dtype,
)


class FullyConnectedNet(nn.Module):
    name = "fully_connected_net"

    def __init__(
        self,
        input_dim: int,
        hidden_layers: Sequence[int],
        batch_normalization: bool,
        output_dim: int,
        compute_dtype: str = "float32",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        # the JAX constructor's keyword arguments: what convert.py's key
        # mapping and a checkpoint's config describe
        self.config = dict(
            input_dim=input_dim,
            hidden_layers=list(hidden_layers),
            batch_normalization=batch_normalization,
            output_dim=output_dim,
            compute_dtype=compute_dtype,
        )
        self.compute_dtype = resolve_dtype(compute_dtype)
        layers, last = [], input_dim
        for width in hidden_layers:
            layers.append(TorchLinear(last, width, generator))
            if batch_normalization:
                layers.append(MaskedBatchNorm(width))
            layers.append(nn.ReLU())
            last = width
        layers.append(TorchLinear(last, output_dim, generator))
        self.network = nn.Sequential(*layers)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False) -> torch.Tensor:
        x = batch["x"].to(self.compute_dtype)
        mask = batch.get("y_mask")
        for layer in self.network:
            x = layer(x, mask=mask, train=train) if isinstance(layer, MaskedBatchNorm) else layer(x)
        return x.float()

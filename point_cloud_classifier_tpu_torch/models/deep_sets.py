"""DeepSets over flattened point batches.

Counterpart of ``point_cloud_classifier_tpu/models/deep_sets.py``, with the
same semantics:

- φ point encoder: per hidden width, a residual block ``x + act(LN?(Linear
  x))`` when ``residual_block`` is set and the width repeats, else
  ``Linear → LN? → act``; then one bare ``Linear(last, last)``;
- pooling per event: ``"sum"`` is sum/√N (the original reference's quirk),
  ``"mean"``, or ``"max"`` (an empty event pools to 0);
- ρ set encoder: ``Linear → LN? → act`` per width (never residual), then the
  classification head; logits come out in f32.

The bare final φ linear commutes with mean and sum/√N pooling, so for those
it runs per event after pooling, in f32, with its bias scaled by ``√N`` (sum)
or masked for empty events (mean).  ``PCC_PHI_POSTPOOL=0`` restores the
per-point placement.

Routing: a config with no layer norm and sum or mean pooling sends φ and its
pooling through ``ops/fused_phi.phi_pool`` — the K1 kernel on a CUDA tensor,
the plain version on a CPU one.  Layer norm or max pooling take the plain
path, which is model semantics and not a fallback.  ``fused_phi="off"``
forces the plain path (the reference for checking the kernel).

Module names follow the original torch reference's ``state_dict`` layout
(``phi.N.weight``, ``phi.N.linear.weight``, ``rho.N.weight``, …) so that
``convert.to_torch_state_dict`` output loads with ``strict=True``.

Not yet ported: the dense per-cloud-row wire (``points [B, M, F]``),
``factored_cols``/``event_feats``, ``fused_phi="tail"`` and int8 ``quant``.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import torch
from torch import nn

from point_cloud_classifier_tpu_torch.models.common import (
    Activation,
    TorchLayerNorm,
    TorchLinear,
    resolve_dtype,
)
from point_cloud_classifier_tpu_torch.ops.fused_phi import phi_forward, phi_pool
from point_cloud_classifier_tpu_torch.ops.segment import (
    counts_to_segment_ids,
    segment_count,
    segment_max,
    segment_sum,
)


class ResidualBlock(nn.Module):
    """Holds a residual φ layer's parameters under the reference's keys
    (``linear``, ``layer_norm``); ``ops/fused_phi`` runs it."""

    def __init__(self, dim: int, layer_norm: bool, generator=None):
        super().__init__()
        self.linear = TorchLinear(dim, dim, generator)
        self.layer_norm = TorchLayerNorm(dim) if layer_norm else None


class DeepSets(nn.Module):
    name = "deep_sets"

    def __init__(
        self,
        input_dim: int,
        phi_layers: Sequence[int],
        rho_layers: Sequence[int],
        output_dim: int,
        activation: str,
        layer_norm: bool = True,
        residual_block: bool = False,
        sparse_batching: bool = True,  # config compat; the wire is flat
        pooling: str = "sum",
        compute_dtype: str = "float32",
        fused_phi: str = "auto",
        factored_cols: Sequence[int] = (),
        quant: str = "none",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if pooling not in ("sum", "mean", "max"):
            raise ValueError("pooling must be 'mean', 'sum', or 'max'")
        if fused_phi not in ("auto", "on", "off"):
            raise NotImplementedError(
                f"fused_phi={fused_phi!r} is not ported (auto, on and off are)"
            )
        if factored_cols or quant != "none":
            raise NotImplementedError(
                "factored_cols and int8 quant are not ported yet (ROADMAP Queue 1)"
            )
        # the JAX constructor's keyword arguments: what convert.py's key
        # mapping and a checkpoint's config describe
        self.config = dict(
            input_dim=input_dim,
            phi_layers=list(phi_layers),
            rho_layers=list(rho_layers),
            output_dim=output_dim,
            activation=activation,
            layer_norm=layer_norm,
            residual_block=residual_block,
            sparse_batching=sparse_batching,
            pooling=pooling,
            compute_dtype=compute_dtype,
            fused_phi=fused_phi,
        )
        self.activation = activation
        self.layer_norm = layer_norm
        self.pooling = pooling
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.fused_phi = fused_phi

        # φ: the reference's Sequential indices, activations included
        phi, self._phi_slots = [], []  # slots: (kind, module index)
        last = input_dim
        for width in phi_layers:
            if residual_block and last == width:
                self._phi_slots.append(("residual", len(phi)))
                phi.append(ResidualBlock(width, layer_norm, generator))
            else:
                self._phi_slots.append(("plain", len(phi)))
                phi.append(TorchLinear(last, width, generator))
                if layer_norm:
                    phi.append(TorchLayerNorm(width))
                phi.append(Activation(activation))
            last = width
        self._phi_final = len(phi)
        phi.append(TorchLinear(last, last, generator))
        self.phi = nn.ModuleList(phi)

        rho = []
        for width in rho_layers:
            rho.append(TorchLinear(last, width, generator))
            if layer_norm:
                rho.append(TorchLayerNorm(width))
            rho.append(Activation(activation))
            last = width
        rho.append(TorchLinear(last, output_dim, generator))
        self.rho = nn.Sequential(*rho)

    def _phi_spec_params(self):
        """The φ layer spec and its ``(w [in, out], b, ln_scale, ln_bias)``
        params, in ``ops/fused_phi``'s layout, plus the final ``(w, b)``."""
        spec, params = [], []
        for kind, i in self._phi_slots:
            if kind == "residual":
                lin, ln = self.phi[i].linear, self.phi[i].layer_norm
            else:
                lin = self.phi[i]
                ln = self.phi[i + 1] if self.layer_norm else None
            spec.append((kind, self.layer_norm))
            ln_params = (ln.weight, ln.bias) if ln is not None else (None, None)
            params.append((lin.weight.t(), lin.bias, *ln_params))
        final = self.phi[self._phi_final]
        params.append((final.weight.t(), final.bias))
        return tuple(spec), tuple(params)

    def _use_kernel(self) -> bool:
        return (
            self.fused_phi != "off"
            and not self.layer_norm
            and self.pooling in ("sum", "mean")
        )

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False):
        points = batch["points"]
        if points.ndim == 3 or "event_feats" in batch:
            raise NotImplementedError(
                "the dense per-cloud-row wire and event_feats are not ported "
                "yet (ROADMAP Queue 1); use PointCloudLoader(layout='flat')"
            )
        points = points.to(self.compute_dtype)
        num_events = batch["y"].shape[0]
        num_segments = num_events + 1  # the last slot collects padding points
        if "seg" in batch:
            seg = batch["seg"].to(torch.int32)
        else:
            seg = counts_to_segment_ids(batch["seg_counts"], points.shape[0])

        spec, params = self._phi_spec_params()
        if "seg_counts" in batch:
            counts = batch["seg_counts"][:num_events].float()
        else:
            counts = segment_count(seg, num_segments)[:num_events]
        safe = torch.clamp(counts, min=1.0).reshape(-1, 1)

        post_pool = (
            self.pooling in ("sum", "mean")
            and os.environ.get("PCC_PHI_POSTPOOL", "1") != "0"
        )
        phi_params = params[:-1] if post_pool else params
        if self._use_kernel():
            total = phi_pool(
                points, seg, spec, phi_params, self.activation, num_segments
            )[:num_events]
        else:
            h32 = phi_forward(points, spec, phi_params, self.activation).float()
            if self.pooling == "max":
                pooled = segment_max(h32, seg, num_segments)[:num_events]
            else:
                total = segment_sum(h32, seg, num_segments)[:num_events]
        if self.pooling == "sum":
            pooled = total / torch.sqrt(safe)
        elif self.pooling == "mean":
            pooled = total / safe

        if post_pool:
            wf, bf = params[-1]
            if self.pooling == "sum":
                bias_scale = torch.sqrt(counts).reshape(-1, 1)
            else:
                # an empty event pools to 0 on the per-point path and never
                # sees the bias, so mask it here too
                bias_scale = (counts > 0).float().reshape(-1, 1)
            pooled = torch.matmul(pooled.float(), wf.float()) + bf.float() * bias_scale

        return self.rho(pooled.to(points.dtype)).float()

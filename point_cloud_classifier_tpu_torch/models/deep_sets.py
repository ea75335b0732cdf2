"""DeepSets over point batches on the flat or the dense per-cloud-row wire.

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

Wires: the flat one (``points [P, F]`` with ``seg`` or ``seg_counts``) and
the dense one (``points [B, M, F]`` with ``seg_counts``: each event's points
at the start of its row).  ``factored_cols`` names the columns the loader
shipped once per event as ``event_feats [B + 1, C]`` (its
``factor_event_cols``); the model puts them back in their places before φ,
by a broadcast over M on the dense wire and ``ops/segment.spread_by_segment``
on the flat one.

Routing: a config with no layer norm and sum or mean pooling sends φ and its
pooling through ``ops/fused_phi.phi_pool`` — the K1 kernel on a CUDA tensor,
the plain version on a CPU one — on both wires: the dense one is flattened
to ``[B·M, F]`` with int32 ids made on the device (the event's index where
the point's place in its row is below the event's count, else the padding id
``B``).  The JAX package sends the dense wire to XLA only, since its Pallas
kernels have no per-point validity; the port's kernels skip the padding id.
Layer norm, max pooling, and a φ chain whose tiles K1 and K2 cannot hold
(``ops/fused_phi.kernel_takes_chain``; φ [1024] × 4, which the sweep's
sampler draws, is the narrowest) take the plain path, decided before any
launch; this is model semantics and not a fallback: on the dense wire a masked row sum (max: ``-inf`` outside
the mask, an empty event pools to 0).  ``fused_phi="off"`` forces the plain
path (the reference for checking the kernel).

``fused_phi="tail"`` under sum or mean pooling runs the hidden chain on the
plain path (layer norm included), then the bare final linear and the pooling
in the K1/K2 pair as a chain of one ``linear`` layer, ``[H, H]``
(``phi_pool(h, seg, (), (final,), …)``); the final linear is then not moved
after the pooling.  The dense wire takes ``dense_segment_ids`` here too,
where the JAX model sends dense tail batches to XLA with the post-pool
linear (the values agree to rounding, ``docs/parity_torch.md`` §10).  Max
pooling keeps the plain path.

``PCC_PHI_REMAT=1`` recomputes the plain path's φ chain in the backward,
each hidden layer on its own span (``torch.utils.checkpoint``,
non-reentrant), keeping only the layers' inputs; it changes no value.  On an
H100 it lowers the train step's peak memory by 36–40% and costs 1.3–1.6×
the step time (φ [256, 256] to [1024, 1024] with layer norm at B=256,
PERF.md §6).  ``0`` and the default ``auto`` keep the activations: the JAX
package's ``auto`` rematerialises post-pool chains up to 384 wide, a TPU
finding, and on the card the recomputation is slower at every width.  The
kernel routes never keep activations and are untouched.

``quant="int8"`` evaluates φ through the s8 product
(``ops/quant.phi_forward_int8``: per-row and per-channel abs-max codes, s32
sums) in eval, and only without layer norm (the JAX ``_phi_mode``); a
train-mode forward stays float.  The route is decided before the kernel and
tail routes, so an int8 forward launches no K1, and the bare final linear
runs per event in f32 after sum or mean pooling under ``fused_phi="tail"``
too, as in the JAX package; under max pooling it runs per point in int8.

Module names follow the original torch reference's ``state_dict`` layout
(``phi.N.weight``, ``phi.N.linear.weight``, ``rho.N.weight``, …) so that
``convert.to_torch_state_dict`` output loads with ``strict=True``.
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
from point_cloud_classifier_tpu_torch.ops.fused_phi import (
    kernel_takes_chain,
    phi_forward,
    phi_hidden,
    phi_pool,
)
from point_cloud_classifier_tpu_torch.ops.quant import phi_forward_int8
from point_cloud_classifier_tpu_torch.ops.segment import (
    counts_to_segment_ids,
    segment_count,
    segment_max,
    segment_sum,
    spread_by_segment,
)


def dense_segment_ids(seg_counts: torch.Tensor, row_m: int) -> torch.Tensor:
    """int32 ids ``[B·M]`` of the dense wire's flattened points: the event's
    index where the point's place in its row is below the event's count
    (``seg_counts[:B]``), else ``B``, the flat wire's padding segment."""
    num_events = seg_counts.shape[0]
    pos = torch.arange(row_m, dtype=torch.int32, device=seg_counts.device)
    event = torch.arange(num_events, dtype=torch.int32, device=seg_counts.device)
    ids = torch.where(pos[None, :] < seg_counts.to(torch.int32)[:, None], event[:, None], num_events)
    return ids.reshape(-1)


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
        sparse_batching: bool = True,  # config compat
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
        if fused_phi not in ("auto", "on", "off", "tail"):
            raise ValueError(f"fused_phi must be 'auto', 'on', 'off' or 'tail', got {fused_phi!r}")
        if quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
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
            factored_cols=list(factored_cols),
            quant=quant,
        )
        self.input_dim = input_dim
        # the loader ships factored columns in ascending order
        self.factored_cols = tuple(sorted(factored_cols))
        self.activation = activation
        self.layer_norm = layer_norm
        self.pooling = pooling
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.fused_phi = fused_phi
        self.quant = quant

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

    def _tail(self) -> bool:
        """Whether the bare final φ linear and the pooling run in the K1/K2
        pair after the hidden chain on the plain path (``fused_phi="tail"``
        under sum or mean pooling, the ``[H, H]`` layer within the kernels'
        tiles)."""
        width = self.config["phi_layers"][-1] if self.config["phi_layers"] else self.input_dim
        return (
            self.fused_phi == "tail"
            and self.pooling in ("sum", "mean")
            and kernel_takes_chain([width, width], ["linear"])
        )

    def _int8(self, train: bool) -> bool:
        """Whether φ runs the int8 chain: ``quant="int8"`` in eval, without
        layer norm (the JAX ``_phi_mode``)."""
        return not train and self.quant == "int8" and not self.layer_norm

    def _post_pool(self, int8: bool = False) -> bool:
        """Whether the bare final φ linear runs per event after pooling: under
        sum or mean pooling, off the tail route, which an ``int8`` forward
        never takes."""
        return (
            self.pooling in ("sum", "mean")
            and (int8 or not self._tail())
            and os.environ.get("PCC_PHI_POSTPOOL", "1") != "0"
        )

    @staticmethod
    def _remat() -> bool:
        """Whether the plain path recomputes its φ chain in the backward:
        ``PCC_PHI_REMAT=1`` only (``auto``, measured on the card, never)."""
        return os.environ.get("PCC_PHI_REMAT", "auto") == "1"

    def _use_kernel(self) -> bool:
        """The route, decided before any launch: the kernels for a chain
        without layer norm under sum or mean pooling that K1 and K2 take
        (``ops/fused_phi.kernel_takes_chain``: their 8-row tiles fit 227 KB
        of shared memory, which φ [1024] × 4 does not), else the plain
        path."""
        if self.fused_phi in ("off", "tail") or self.layer_norm or self.pooling not in ("sum", "mean"):
            return False
        post_pool = self._post_pool()
        kinds = [kind for kind, _ in self._phi_slots] + ([] if post_pool else ["linear"])
        widths = self.config["phi_layers"]
        dims = [self.input_dim, *widths] + ([] if post_pool else widths[-1:])
        return kernel_takes_chain(dims, kinds)

    def _reassemble(self, points, event_feats, seg, num_events, row_m):
        """The full ``[P, input_dim]`` point features, the factored columns
        spread back from ``event_feats`` in their original places."""
        if row_m is not None:
            # the dense wire's rows have one stride: a broadcast
            ef = event_feats[:num_events].to(points.dtype)
            per_point = ef[:, None, :].expand(num_events, row_m, ef.shape[-1])
            per_point = per_point.reshape(points.shape[0], ef.shape[-1])
        else:
            per_point = spread_by_segment(event_feats, seg, dtype=points.dtype)
        cols, ki, fi = [], 0, 0
        for c in range(self.input_dim):
            if c in self.factored_cols:
                cols.append(per_point[:, fi : fi + 1])
                fi += 1
            else:
                cols.append(points[:, ki : ki + 1])
                ki += 1
        return torch.cat(cols, dim=1)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False):
        points = batch["points"].to(self.compute_dtype)
        num_events = batch["y"].shape[0]
        num_segments = num_events + 1  # the last slot collects padding points
        row_m = None  # the dense wire's row length
        seg = None
        if points.ndim == 3:
            row_m = points.shape[1]
            points = points.reshape(num_events * row_m, points.shape[-1])
        elif "seg" in batch:
            seg = batch["seg"].to(torch.int32)
        else:
            seg = counts_to_segment_ids(batch["seg_counts"], points.shape[0])
        if self.factored_cols:
            points = self._reassemble(points, batch["event_feats"], seg, num_events, row_m)

        spec, params = self._phi_spec_params()
        if "seg_counts" in batch:
            counts = batch["seg_counts"][:num_events].float()
        else:
            counts = segment_count(seg, num_segments)[:num_events]
        safe = torch.clamp(counts, min=1.0).reshape(-1, 1)

        # the int8 route first: it takes neither the kernels nor the tail
        int8 = self._int8(train)
        post_pool = self._post_pool(int8)
        phi_params = params[:-1] if post_pool else params
        if not int8 and (self._use_kernel() or self._tail()):
            if row_m is not None:
                seg = dense_segment_ids(batch["seg_counts"][:num_events], row_m)
            if self._tail():
                # the hidden chain on the plain path, then the final linear
                # and the pooling in the kernel pair
                points = phi_hidden(points, spec, params[:-1], self.activation)
                spec, phi_params = (), params[-1:]
            total = phi_pool(
                points, seg, spec, phi_params, self.activation, num_segments
            )[:num_events]
        else:
            if int8:
                h = phi_forward_int8(points, spec, phi_params, self.activation)
            else:
                h = phi_forward(points, spec, phi_params, self.activation,
                                remat=self._remat() and torch.is_grad_enabled())
            h32 = h.float()
            if row_m is not None:
                pooled, total = self._dense_pool(h32, counts, row_m)
            elif self.pooling == "max":
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

    def _dense_pool(self, h32, counts, row_m):
        """``(max-pooled, None)`` or ``(None, f32 row sums)`` of the dense
        wire's ``[B·M, H]`` features, masked to each event's points."""
        rows = h32.reshape(counts.shape[0], row_m, h32.shape[-1])
        pos = torch.arange(row_m, device=h32.device, dtype=torch.float32)
        mask = pos[None, :] < counts[:, None]
        if self.pooling == "max":
            pooled = torch.where(mask[:, :, None], rows, float("-inf")).amax(dim=1)
            # an empty event pools to 0, as on the flat wire
            return torch.where(counts[:, None] > 0, pooled, 0.0), None
        return None, torch.einsum("bm,bmh->bh", mask.float(), rows)

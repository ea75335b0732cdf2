"""GraphNet over the dense in-row graph wire.

Counterpart of ``point_cloud_classifier_tpu/models/graph_net.py``'s
``_dense_forward`` on the in-row wire (``nodes [B, M, F]``, ``node_mask
[B, M]``, ``in_deg [B, M]``, ``in_src``/``in_w [B, M, D]``, from
``data/batching.GraphLoader``), with the same semantics:

- two convolutions, each followed by the activation and a ``MaskedBatchNorm``
  over the real nodes;
- ``GraphConv`` (torch_geometric's: ``lin_rel`` of the neighbour aggregate,
  biased, plus a bias-free ``lin_root`` of the node) with add or mean
  aggregation.  The aggregate is ``adj @ h`` over the adjacency built from
  the in-row lists (``ops/inrow_graph.inrow_adjacency``), accumulated in
  f32; mean divides by the wire's exact per-occurrence in-degree
  (``in_deg``), floored at 1.  With ``fused_inrow=True`` (opt-in, as in the
  JAX package) the aggregate always comes from
  ``ops/inrow_graph.inrow_aggregate`` instead — kernel K6 on a CUDA tensor,
  forward over the in-rows and backward over the batch's out-row lists — and
  no adjacency is built.  A batch without out-rows serves inference (the
  forward reads none) and raises under ``train=True``, where the JAX model
  warns and takes the adjacency route; on a GAT model the option warns, as
  in the JAX model, and changes nothing;
- ``GATConv`` (GATv1, self-loops, heads concatenated, LeakyReLU 0.2): the
  score vectors are ``xw · att`` at the activation dtype summed in f32, and
  the attention runs in ``ops/gat.gat_attention`` — kernel K3 on a CUDA
  tensor.  GAT ignores the edge weights (existence is ``w != 0``);
- the readout: ``deepchem_style`` runs ``fc1 → act → bn3`` per node before
  the masked mean pool, otherwise after it (bn3 then masked by ``y_mask``);
  the pool is always a mean (the reference's quirk); logits in f32;
- ``compute_dtype`` f32 or bf16: convolutions and linears at that dtype,
  aggregation sums, softmax and norms in f32.

Module names follow the torch reference's ``state_dict`` (``conv1``,
``bn1``, ``conv2``, ``bn2``, ``fc1``, ``bn3``, ``fc2``), registered in the
JAX module's instantiation order, so ``convert`` maps the two parameter
trees 1:1.  ``PCC_GRAPH_REMAT`` (JAX rematerialisation of the head) changes
no value and has no counterpart here.

Not ported yet, each raising ``NotImplementedError``: SAG pooling, max
aggregation, ``knn_k``, and batches without the in-row lists (the edge-slot
triples and the flat edge-list wire).
"""

from __future__ import annotations

import math
import warnings
from typing import Dict

import torch
from torch import nn

from point_cloud_classifier_tpu_torch.models.common import (
    Activation,
    MaskedBatchNorm,
    TorchLinear,
    resolve_dtype,
)
from point_cloud_classifier_tpu_torch.ops.gat import SLOPE, gat_attention
from point_cloud_classifier_tpu_torch.ops.inrow_graph import inrow_adjacency, inrow_aggregate


def _glorot(shape, fan_in: int, fan_out: int, generator) -> nn.Parameter:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


class GraphConv(nn.Module):
    """torch_geometric GraphConv on a precomputed neighbour aggregate."""

    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.lin_rel = TorchLinear(in_features, features, generator)
        self.lin_root = TorchLinear(in_features, features, generator, bias=False)

    def forward(self, x: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
        return self.lin_rel(agg.to(x.dtype)) + self.lin_root(x)


class GATConv(nn.Module):
    """Multi-head GATv1 on the in-row wire, torch_geometric's parameters:
    ``lin`` (bias-free, glorot), ``att_src``/``att_dst [1, H, dh]``, ``bias``."""

    def __init__(self, in_features: int, features: int, heads: int = 4,
                 negative_slope: float = SLOPE, generator=None):
        super().__init__()
        self.heads, self.features, self.negative_slope = heads, features, negative_slope
        self.lin = nn.Module()
        self.lin.weight = _glorot((heads * features, in_features), in_features,
                                  heads * features, generator)
        self.att_src = _glorot((1, heads, features), heads, features, generator)
        self.att_dst = _glorot((1, heads, features), heads, features, generator)
        self.bias = nn.Parameter(torch.zeros(heads * features))

    def forward(self, x, in_src, in_w):
        b, m, _ = x.shape
        h, d = self.heads, self.features
        xw = torch.matmul(x, self.lin.weight.t().to(x.dtype)).reshape(b, m, h, d)
        # the product at the activation dtype, summed in f32
        s_src = (xw * self.att_src.to(x.dtype)).float().sum(dim=-1)  # [B, M, H]
        s_dst = (xw * self.att_dst.to(x.dtype)).float().sum(dim=-1)
        out = gat_attention(
            s_dst, s_src, in_src, in_w, xw.reshape(b, m, h * d), self.negative_slope
        )
        return out.to(x.dtype) + self.bias.to(x.dtype)


class GraphNet(nn.Module):
    name = "graph_net"

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int,
        output_dim: int,
        activation: str,
        use_gat: bool = False,
        gat_heads: int = 4,
        sag_pool: bool = False,
        pool_ratio: float = 0.5,
        local_pooling: str = "add",
        global_pooling: str = "mean",  # config compat: the readout is a mean
        deepchem_style: bool = False,
        compute_dtype: str = "float32",
        fused_inrow: bool = False,
        knn_k: int = 0,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        refused = {
            "sag_pool (ROADMAP Queue 1, GraphNet slice 2)": sag_pool,
            "local_pooling='max' (ROADMAP Queue 1, GraphNet slice 2)": (
                not use_gat and local_pooling == "max"
            ),
            "knn_k > 0 (ROADMAP Queue 1, the kNN slice with kernel K5)": knn_k > 0,
        }
        for what, requested in refused.items():
            if requested:
                raise NotImplementedError(f"GraphNet {what} is not ported to PyTorch yet")
        if local_pooling not in ("add", "mean", "max"):
            raise ValueError(f"Unknown aggregation: {local_pooling}")
        # the JAX constructor's keyword arguments: what convert.py's key
        # mapping and a checkpoint's config describe
        self.config = dict(
            input_dim=input_dim, hidden_dim=hidden_dim, output_dim=output_dim,
            activation=activation, use_gat=use_gat, gat_heads=gat_heads,
            sag_pool=sag_pool, pool_ratio=pool_ratio, local_pooling=local_pooling,
            global_pooling=global_pooling, deepchem_style=deepchem_style,
            compute_dtype=compute_dtype, fused_inrow=fused_inrow, knn_k=knn_k,
        )
        self.use_gat = use_gat
        self.fused_inrow = fused_inrow
        self.local_pooling = local_pooling
        self.deepchem_style = deepchem_style
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.act = Activation(activation)

        def conv(in_features):
            if use_gat:
                per_head = hidden_dim // gat_heads
                return GATConv(in_features, per_head, gat_heads, generator=generator), per_head * gat_heads
            return GraphConv(in_features, hidden_dim, generator), hidden_dim

        # the JAX module's instantiation order: conv, bn, conv, bn, fc1, bn3, fc2
        self.conv1, width = conv(input_dim)
        self.bn1 = MaskedBatchNorm(width)
        self.conv2, width = conv(width)
        self.bn2 = MaskedBatchNorm(width)
        self.fc1 = TorchLinear(width, 256, generator)
        self.bn3 = MaskedBatchNorm(256)
        self.fc2 = TorchLinear(256, output_dim, generator)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False) -> torch.Tensor:
        if "in_src" not in batch:
            raise NotImplementedError(
                "GraphNet takes only the dense in-row wire so far (in_src/in_w); "
                "the edge-slot triples and the flat edge-list wire are not ported "
                "yet (ROADMAP Queue 1, GraphNet slice 2)"
            )
        dtype = self.compute_dtype
        x = batch["nodes"].to(dtype)
        node_mask = batch["node_mask"].float()
        b, m, _ = x.shape
        in_src, in_w = batch["in_src"], batch["in_w"]

        fused = self.fused_inrow and not self.use_gat
        if self.fused_inrow and self.use_gat:
            # GAT attends through its own kernels whatever this option says
            warnings.warn(
                "GraphNet(fused_inrow=True) has no effect on this batch: "
                "it needs the dense in-row wire WITH out-row lists "
                "(GraphLoader(emit_out_rows=True); train.py sets it when "
                "model.fused_inrow is on) and no GAT/SAG; running the "
                "ordinary path instead",
                stacklevel=2,
            )
        if fused and train and "out_dst" not in batch:
            # the JAX model warns and aggregates over the adjacency here; the
            # port runs nothing else in the fused aggregation's place
            raise ValueError(
                "GraphNet(fused_inrow=True) cannot train on this batch: it has no "
                "out-row lists (out_dst/out_w), which the fused aggregation's "
                "backward reads.  GraphLoader(emit_out_rows=True) ships them "
                "(train.py sets it when model.fused_inrow is on), except for a "
                "batch whose out-degree needs more than max_in_degree_wire slots"
            )
        mean = self.local_pooling == "mean"
        deg = batch.get("in_deg")

        if self.use_gat:
            def conv(mod, h):
                return mod(h, in_src, in_w)
        elif fused:
            # the out-rows only route the backward: inference needs none
            out_dst, out_w = batch.get("out_dst"), batch.get("out_w")

            def conv(mod, h):
                if mean and deg is not None:
                    # the aggregation sums; the exact-degree division stays
                    # outside the Function (it is linear, autograd composes it)
                    agg = inrow_aggregate(h, in_src, in_w, out_dst, out_w, "add")
                    agg = (agg.float() / torch.clamp(deg.float(), min=1.0)[..., None]).to(h.dtype)
                else:
                    agg = inrow_aggregate(h, in_src, in_w, out_dst, out_w, self.local_pooling)
                return mod(h, agg)
        else:
            adj = inrow_adjacency(in_src, in_w, m, dtype)
            if mean and deg is None:
                deg = (adj != 0).float().sum(dim=2)  # hand-built batches

            def conv(mod, h):
                # f32 accumulation, as the JAX einsum's preferred_element_type
                agg = torch.matmul(adj.float(), h.float())
                if mean:
                    agg = agg / torch.clamp(deg.float(), min=1.0)[..., None]
                return mod(h, agg.to(h.dtype))

        def bn(mod, h, mask):
            return mod(h.reshape(b * m, -1), mask=mask.reshape(-1), train=train).reshape(b, m, -1)

        x = bn(self.bn1, self.act(conv(self.conv1, x)), node_mask)
        x = bn(self.bn2, self.act(conv(self.conv2, x)), node_mask)

        def mean_pool(h, mask):
            total = (h.float() * mask[..., None]).sum(dim=1)
            counts = torch.clamp(mask.sum(dim=1), min=1.0)
            return (total / counts[:, None]).to(h.dtype)

        if self.deepchem_style:
            x = bn(self.bn3, self.act(self.fc1(x)), node_mask)
            x = mean_pool(x, node_mask)
        else:
            x = mean_pool(x, node_mask)
            x = self.bn3(self.act(self.fc1(x)), mask=batch.get("y_mask"), train=train)
        return self.fc2(x).float()

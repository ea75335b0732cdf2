"""GraphNet over the dense in-row graph wire, and over the flat wire with
kNN graphs built on the device.

Counterpart of ``point_cloud_classifier_tpu/models/graph_net.py``:
``_dense_forward`` on the in-row wire (``nodes [B, M, F]``, ``node_mask
[B, M]``, ``in_deg [B, M]``, ``in_src``/``in_w [B, M, D]``, from
``data/batching.GraphLoader``), and the flat forward's kNN arm (below), with
the same semantics:

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
  tensor, K4 its backward.  A training forward on the card builds the lists'
  mirror once (``ops/gat.gat_backward_mirror``) and both convolutions' backward
  reads it.  GAT ignores the edge weights (existence is ``w != 0``);
- the readout: ``deepchem_style`` runs ``fc1 → act → bn3`` per node before
  the masked mean pool, otherwise after it (bn3 then masked by ``y_mask``);
  the pool is always a mean (the reference's quirk); logits in f32;
- ``compute_dtype`` f32 or bf16: convolutions and linears at that dtype,
  aggregation sums, softmax and norms in f32.

With ``knn_k > 0`` (GraphConv add or mean, no SAG) the model takes the flat
wire (``nodes [N, F]``, ``node_seg [N]`` or ``node_seg_counts [B + 1]``,
``y``) and ignores the batch's edges: each node's neighbours are its k
nearest nodes of the same graph by the position features ``nodes[:, 1:4]``,
taken in f32 BEFORE the compute-dtype cast (bf16 coordinates would change
the topology), ties at the k-th distance all admitted.  The topology is
selected once per forward (``ops/knn.knn_select``) and both convolutions'
aggregates come from ``ops/knn.knn_aggregate`` over that plan — kernel K5 on
a CUDA tensor, forward and backward, with no edge list and no ``[N, N]``
tensor — and feed the same ``GraphConv`` modules (the JAX package's
``DenseGraphConv``).
``MaskedBatchNorm`` runs over the real nodes (``node_seg < B``), the readout
is the per-graph mean by segment sums in f32.  A dense batch raises, as in
the JAX model.

Module names follow the torch reference's ``state_dict`` (``conv1``,
``bn1``, ``conv2``, ``bn2``, ``fc1``, ``bn3``, ``fc2``), registered in the
JAX module's instantiation order, so ``convert`` maps the two parameter
trees 1:1.  ``PCC_GRAPH_REMAT`` (JAX rematerialisation of the head) changes
no value and has no counterpart here.

Not ported yet, each raising ``NotImplementedError``: SAG pooling, max
aggregation, ``knn_k`` with GAT, SAG or max (the kNN edge-list arm), and
batches of edges without the in-row lists (the edge-slot triples, and the
flat edge-list wire with ``knn_k == 0``).
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
from point_cloud_classifier_tpu_torch.ops.gat import SLOPE, gat_attention, gat_backward_mirror
from point_cloud_classifier_tpu_torch.ops.inrow_graph import inrow_adjacency, inrow_aggregate
from point_cloud_classifier_tpu_torch.ops.knn import knn_aggregate, knn_select
from point_cloud_classifier_tpu_torch.ops.segment import (
    counts_to_segment_ids,
    segment_count,
    segment_sum,
)


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

    def forward(self, x, in_src, in_w, mirror=None):
        b, m, _ = x.shape
        h, d = self.heads, self.features
        xw = torch.matmul(x, self.lin.weight.t().to(x.dtype)).reshape(b, m, h, d)
        # the product at the activation dtype, summed in f32
        s_src = (xw * self.att_src.to(x.dtype)).float().sum(dim=-1)  # [B, M, H]
        s_dst = (xw * self.att_dst.to(x.dtype)).float().sum(dim=-1)
        out = gat_attention(
            s_dst, s_src, in_src, in_w, xw.reshape(b, m, h * d), self.negative_slope, mirror
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
            "knn_k > 0 with GAT, SAG or max aggregation (the kNN edge-list arm; ROADMAP "
            "Queue 1, GraphNet slice 2)": (
                knn_k > 0 and (use_gat or sag_pool or local_pooling == "max")
            ),
            "sag_pool (ROADMAP Queue 1, GraphNet slice 2)": sag_pool,
            "local_pooling='max' (ROADMAP Queue 1, GraphNet slice 2)": (
                not use_gat and local_pooling == "max"
            ),
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
        self.knn_k = int(knn_k)
        # under knn_k the model builds its own graph: the wrapper leaves the
        # batch's edge arrays on the host
        self.unused_batch_keys = ("src", "dst", "edge_w", "edge_mask") if knn_k > 0 else ()
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
        if "in_src" not in batch and "adj" not in batch and "edge_slot" not in batch:
            return self._flat_forward(batch, train)
        if self.knn_k > 0:
            raise ValueError(
                "dense graph layout supports GraphConv add/mean, GAT, and "
                "max over the in-row device wire "
                "(GraphLoader(require_inrow=True) — the factory sets it "
                "for pinned dense/auto max configs; require_inrow routes "
                "degree-outlier batches to the flat wire instead of this "
                "error); use the flat (edge list) layout otherwise / for "
                "knn_k"
            )
        if "in_src" not in batch:
            raise NotImplementedError(
                "GraphNet takes only the in-row lists of the dense wire so far "
                "(in_src/in_w); the edge-slot triples and the host adjacency are "
                "not ported yet (ROADMAP Queue 1, GraphNet slice 2)"
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
            # the lists' mirror, which the attention's backward kernel reads:
            # once for both convolutions, and only where a backward will run
            mirror = gat_backward_mirror(in_src, in_w) if train else None

            def conv(mod, h):
                return mod(h, in_src, in_w, mirror)
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

    def _flat_forward(self, batch: Dict[str, torch.Tensor], train: bool) -> torch.Tensor:
        """The flat wire: kNN graphs from the position features, both
        aggregates through ``knn_aggregate``."""
        if self.knn_k == 0:
            raise NotImplementedError(
                "GraphNet with knn_k == 0 takes only the dense in-row wire so far "
                "(in_src/in_w); the edge-slot triples and the flat edge-list wire "
                "(src/dst/edge_w) are not ported yet (ROADMAP Queue 1, GraphNet slice 2)"
            )
        if self.config["input_dim"] < 4:
            raise ValueError("knn_k needs position features (n_features=4)")
        nodes = batch["nodes"]
        x = nodes.to(self.compute_dtype)
        num_graphs = batch["y"].shape[0]
        # compact int16/int32 ids, or the counts encoding (graphs are
        # node-contiguous): ids rebuilt on the device without a host sync
        if "node_seg" in batch:
            node_seg = batch["node_seg"].to(torch.int32)
        else:
            node_seg = counts_to_segment_ids(batch["node_seg_counts"], x.shape[0])
        # positions from the features BEFORE the cast: a graph built from
        # bf16-rounded coordinates would have another topology; one selection
        # serves both convolutions and their backward
        pos3 = nodes[:, 1:4].float().contiguous()
        node_valid = (node_seg < num_graphs).float()
        plan = knn_select(pos3, node_seg, self.knn_k, num_graphs)

        def block(conv, bn, h):
            agg = knn_aggregate(h, pos3, node_seg, self.knn_k, num_graphs, self.local_pooling, plan)
            return bn(self.act(conv(h, agg)), mask=node_valid, train=train)

        x = block(self.conv1, self.bn1, x)
        x = block(self.conv2, self.bn2, x)

        def mean_pool(h):
            h32 = (h * node_valid[:, None].to(h.dtype)).float()
            total = segment_sum(h32, node_seg, num_graphs + 1)
            counts = segment_count(node_seg, num_graphs + 1)
            return (total / torch.clamp(counts, min=1.0)[:, None])[:num_graphs].to(h.dtype)

        if self.deepchem_style:
            x = mean_pool(self.bn3(self.act(self.fc1(x)), mask=node_valid, train=train))
        else:
            x = self.bn3(self.act(self.fc1(mean_pool(x))), mask=batch.get("y_mask"), train=train)
        return self.fc2(x).float()

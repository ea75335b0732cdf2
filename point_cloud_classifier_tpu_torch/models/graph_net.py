"""GraphNet over every graph wire of ``data/batching.GraphLoader``: the dense
in-row wire, the host adjacency, the edge-slot triples and the flat edge
list, and over kNN graphs built on the device.

Counterpart of ``point_cloud_classifier_tpu/models/graph_net.py``, with the
same semantics:

- two convolutions, each followed by the activation and a ``MaskedBatchNorm``
  over the real nodes, then (``sag_pool``) SAG pooling between them;
- ``GraphConv`` (torch_geometric's: ``lin_rel`` of the neighbour aggregate,
  biased, plus a bias-free ``lin_root`` of the node) with add, mean or max
  aggregation;
- ``GATConv`` (GATv1, self-loops on every node, heads concatenated,
  LeakyReLU 0.2): the score vectors are ``xw · att`` at the activation dtype
  summed in f32.  GAT ignores the edge weights;
- ``SAGPool``: scores from an unweighted ``GraphConv(→1)`` add, the top
  ``ceil(ratio · n)`` nodes of each graph kept (ties to the lower node
  index) and scaled by ``tanh(score)``, every edge touching a dropped node
  dropped.  Rank and mask, never compaction: shapes stay static.  Counts and
  ranks are f32/int32 whatever the compute dtype (a bf16 count cannot hold
  301);
- the readout: ``deepchem_style`` runs ``fc1 → act → bn3`` per node before
  the masked mean pool, otherwise after it (bn3 then masked by ``y_mask``);
  the pool is always a mean (the reference's quirk); logits in f32;
- ``compute_dtype`` f32 or bf16: convolutions and linears at that dtype,
  aggregation sums, softmax and norms in f32.

**The dense wires** (``nodes [B, M, F]``, ``node_mask [B, M]``, and the
edges as in-row lists ``in_src``/``in_w [B, M, D]``, a host adjacency
``adj [B, M, M]``, or edge-slot triples ``edge_slot``/``edge_dst``/
``edge_src``/``edge_w``, summed into ``[B, M, M]`` with the padding at the
out-of-range slot ``B`` dropped):

- GraphConv add/mean: ``adj @ h`` accumulated in f32; mean divides by the
  wire's per-occurrence in-degree (``in_deg``), else by the count of nonzero
  adjacency entries, floored at 1.  With ``fused_inrow=True`` (opt-in, as in
  the JAX package, and not with SAG or max, where it warns as the JAX model
  does and takes the adjacency route) the aggregate comes from
  ``ops/inrow_graph.inrow_aggregate`` instead — kernel K6 on a CUDA tensor,
  forward over the in-rows and backward over the batch's out-row lists — and
  no adjacency is built.  A batch without out-rows serves inference (the
  forward reads none) and raises under ``train=True``, where the JAX model
  warns and takes the adjacency route;
- GraphConv max: ``ops/inrow_graph.inrow_max_aggregate`` over the in-row
  lists only (max does not factor through an adjacency; other dense batches
  raise, as in the JAX model);
- GAT on the in-row lists: ``ops/gat.gat_attention`` — kernel K3 on a CUDA
  tensor, K4 its backward.  A training forward on the card builds the lists'
  mirror (``ops/gat.gat_backward_mirror``) that K4 reads; GAT on a host
  adjacency or triples: ``gat_attention_masked`` over ``adj != 0`` and the
  self-loop diagonal (plain PyTorch, as the JAX model's XLA form);
- SAG: the adjacency is built once for the score conv (over ``adj != 0``),
  then conv2 sees the keep-masked graph: the adjacency times ``keep`` on both
  sides, or, on the in-row routes (GAT, max), the in-row weights times
  ``keep[src] · keep[dst]``.  GAT then attends over keep-masked lists, so
  conv2's K4 reads a second mirror, built from those lists: a mirror of the
  unmasked ones would give wrong gradients without an error.  After SAG the
  mean counts nonzero entries (``in_deg`` no longer holds).

**The flat wire** (``nodes [N, F]``, ``node_seg [N]`` or ``node_seg_counts
[B + 1]``, edges ``src``/``dst``/``edge_w``/``edge_mask``): messages
``x[src] · (edge_w · edge_mask)`` in f32, summed per destination; mean
divides by ``Σ edge_mask``; max gates on ``edge_mask > 0`` without
multiplying by it (on a demoted loader's merged multigraph ``edge_mask``
carries the multiplicity) and gives 0 to a node with no kept edge.  GAT
softmaxes each destination's incoming edges and its self-loop
(``ops/segment.segment_softmax``); SAG ranks by ``segment_rank_desc``.  All
of it is PyTorch's scatters and gathers: no TPU kernel serves this wire.

With ``knn_k > 0`` the model takes the flat wire and ignores the batch's
edges: each node's neighbours are its k nearest nodes of the same graph by
the position features ``nodes[:, 1:4]``, taken in f32 BEFORE the
compute-dtype cast (bf16 coordinates would change the topology).  GraphConv
add or mean without SAG selects the topology once per forward
(``ops/knn.knn_select``, ties at the k-th distance all admitted) and takes
both aggregates from ``ops/knn.knn_aggregate`` — kernel K5 on a CUDA tensor,
forward and backward, no edge list — into the same ``GraphConv`` modules
(the JAX package's ``DenseGraphConv``).  GAT, SAG or max take the kNN edge
list instead (``ops/knn.knn_edges``, k per node, all-ones weights) through
the flat wire's code, as the JAX model does.  A dense batch raises.

Module names follow the torch reference's ``state_dict`` (``conv1``,
``bn1``, ``pool.gnn`` as torch_geometric's ``SAGPooling``, ``conv2``,
``bn2``, ``fc1``, ``bn3``, ``fc2``), registered in the JAX module's
instantiation order, so ``convert`` maps the two parameter trees 1:1.
``PCC_GRAPH_REMAT=1`` recomputes the dense wire's deepchem head (``fc1``,
the activation, ``bn3`` and the mean pool) in the backward instead of
keeping its ``[B, M, 256]`` activations, as the JAX package's
``nn.remat(_head)`` does (``torch.utils.checkpoint``, non-reentrant).  The
recomputation leaves ``bn3``'s running statistics alone, so they move once a
step, as without it; it changes no value.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from point_cloud_classifier_tpu_torch.models.common import (
    Activation,
    MaskedBatchNorm,
    TorchLinear,
    resolve_dtype,
)
from point_cloud_classifier_tpu_torch.ops.gat import (
    SLOPE,
    _leaky_relu,
    gat_attention,
    gat_attention_masked,
    gat_backward_mirror,
)
from point_cloud_classifier_tpu_torch.ops.inrow_graph import (
    inrow_adjacency,
    inrow_aggregate,
    inrow_max_aggregate,
)
from point_cloud_classifier_tpu_torch.ops.knn import knn_aggregate, knn_edges, knn_select
from point_cloud_classifier_tpu_torch.ops.segment import (
    counts_to_segment_ids,
    segment_count,
    segment_max,
    segment_rank_desc,
    segment_softmax,
    segment_sum,
)


def _glorot(shape, fan_in: int, fan_out: int, generator) -> nn.Parameter:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


def edge_aggregate(x, src, dst, edge_w, edge_valid, aggr: str):
    """The flat wire's neighbour aggregate ``[N, F]`` in ``x``'s dtype, over
    ``x``'s rows (the JAX ``GraphConv``'s edge branch): messages ``x[src]``
    times the weight at ``x``'s dtype, reduced per ``dst`` in f32.  ``add``
    and ``mean`` weigh by ``edge_w · edge_valid`` and ``mean`` divides by
    ``Σ edge_valid``; ``max`` takes ``x[src] · edge_w`` over the edges with
    ``edge_valid > 0`` and gives 0 where there is none."""
    n = x.shape[0]
    rows = x.index_select(0, src)
    if aggr == "max":
        msg = (rows * edge_w[:, None]).float()
        masked = torch.where(edge_valid[:, None] > 0, msg, float("-inf"))
        agg = segment_max(masked, dst, n)
    elif aggr in ("add", "mean"):
        agg = segment_sum((rows * (edge_w * edge_valid)[:, None]).float(), dst, n)
        if aggr == "mean":
            counts = segment_count(dst, n, valid=edge_valid)
            agg = agg / torch.clamp(counts, min=1.0)[:, None]
    else:
        raise ValueError(f"Unknown aggregation: {aggr}")
    return agg.to(x.dtype)


class GraphConv(nn.Module):
    """torch_geometric GraphConv on a precomputed neighbour aggregate."""

    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.lin_rel = TorchLinear(in_features, features, generator)
        self.lin_root = TorchLinear(in_features, features, generator, bias=False)

    def forward(self, x: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
        return self.lin_rel(agg.to(x.dtype)) + self.lin_root(x)


class GATConv(nn.Module):
    """Multi-head GATv1 with torch_geometric's parameters: ``lin``
    (bias-free, glorot), ``att_src``/``att_dst [1, H, dh]``, ``bias``.  One
    parameter set serves every wire: the in-row lists (:meth:`forward`), a
    ``[B, M, M]`` mask (:meth:`forward_masked`) and the flat edge list
    (:meth:`forward_edges`)."""

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

    def _scores(self, x):
        """``(xw [..., H, dh], s_src [..., H], s_dst [..., H])``: the product
        at the activation dtype, summed in f32."""
        xw = torch.matmul(x, self.lin.weight.t().to(x.dtype))
        xw = xw.reshape(*x.shape[:-1], self.heads, self.features)
        s_src = (xw * self.att_src.to(x.dtype)).float().sum(dim=-1)
        s_dst = (xw * self.att_dst.to(x.dtype)).float().sum(dim=-1)
        return xw, s_src, s_dst

    def forward(self, x, in_src, in_w, mirror=None):
        b, m, _ = x.shape
        xw, s_src, s_dst = self._scores(x)
        out = gat_attention(
            s_dst, s_src, in_src, in_w, xw.reshape(b, m, -1), self.negative_slope, mirror
        )
        return out.to(x.dtype) + self.bias.to(x.dtype)

    def forward_masked(self, x, adj_mask):
        """Attention over ``adj_mask [B, M, M]`` (bool) and the self-loops."""
        b, m, _ = x.shape
        xw, s_src, s_dst = self._scores(x)
        mask = adj_mask | torch.eye(m, dtype=torch.bool, device=x.device)[None]
        out = gat_attention_masked(s_dst, s_src, mask, xw.reshape(b, m, -1), self.negative_slope)
        return out.to(x.dtype) + self.bias.to(x.dtype)

    def forward_edges(self, x, src, dst, edge_valid):
        """Attention over the flat edge list plus a self-loop on every node:
        a softmax over each destination's incoming edges, then the
        α-weighted sum of ``xw[src]`` in f32."""
        n = x.shape[0]
        xw, s_src, s_dst = self._scores(x)
        loops = torch.arange(n, dtype=src.dtype, device=src.device)
        src_all, dst_all = torch.cat([src, loops]), torch.cat([dst, loops])
        valid_all = torch.cat([edge_valid, edge_valid.new_ones(n)])
        # index_select, whose backward is one index_add_, where an indexing
        # backward sorts the indices: 76% of the B=256 step on an H100
        e = _leaky_relu(s_src.index_select(0, src_all) + s_dst.index_select(0, dst_all),
                        self.negative_slope)  # [E + N, H]
        alpha = segment_softmax(e, dst_all, n, valid=valid_all[:, None])
        rows = xw.index_select(0, src_all)
        out = segment_sum((alpha[:, :, None] * rows).reshape(src_all.shape[0], -1), dst_all, n)
        return out.to(x.dtype) + self.bias.to(x.dtype)


class SAGPool(nn.Module):
    """Self-attention top-k pooling by rank and mask; torch_geometric's
    ``SAGPooling`` layout, its score network ``gnn`` a ``GraphConv(→1)``."""

    def __init__(self, in_features: int, ratio: float = 0.5, generator=None):
        super().__init__()
        self.ratio = ratio
        self.gnn = GraphConv(in_features, 1, generator)

    def forward(self, x, node_seg, src, dst, edge_w, edge_valid, node_valid, num_graphs: int):
        """The flat wire: ``(x, edge_valid, keep)`` with ``x`` scaled by
        ``tanh(score) · keep`` and the edges touching a dropped node masked."""
        agg = edge_aggregate(x, src, dst, torch.ones_like(edge_w), edge_valid, "add")
        score = self.gnn(x, agg)[:, 0]
        ranks = segment_rank_desc(score, node_seg, num_graphs + 1, node_valid)
        k = torch.ceil(self.ratio * segment_count(node_seg, num_graphs + 1, valid=node_valid))
        keep = node_valid * (ranks < k[node_seg.long()]).to(node_valid.dtype)
        x = x * torch.tanh(score)[:, None] * keep[:, None]
        return x, edge_valid * keep.index_select(0, src) * keep.index_select(0, dst), keep

    def forward_dense(self, x, adj_unw, node_mask):
        """The dense wires: ``(x, keep [B, M])`` over the 0/1 adjacency
        ``adj_unw``; a stable double argsort ranks each row."""
        agg = torch.matmul(adj_unw.float(), x.float()).to(x.dtype)
        score = self.gnn(x, agg)[..., 0]  # [B, M]
        masked = torch.where(node_mask > 0, score.float(), float("-inf"))
        order = torch.argsort(-masked, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True)
        # counts and ranks in f32/int32, never the compute dtype: a bf16 sum
        # cannot hold an odd count above 256
        kk = torch.ceil(self.ratio * node_mask.float().sum(dim=1)).to(torch.int32)
        keep = node_mask * (ranks < kk[:, None]).to(node_mask.dtype)
        return x * torch.tanh(score)[..., None] * keep[..., None].to(x.dtype), keep


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
        self.sag_pool = sag_pool
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

        # the JAX module's instantiation order: conv, bn, [SAG], conv, bn, fc1, bn3, fc2
        self.conv1, width = conv(input_dim)
        self.bn1 = MaskedBatchNorm(width)
        if sag_pool:
            self.pool = SAGPool(width, pool_ratio, generator)
        self.conv2, width = conv(width)
        self.bn2 = MaskedBatchNorm(width)
        self.fc1 = TorchLinear(width, 256, generator)
        self.bn3 = MaskedBatchNorm(256)
        self.fc2 = TorchLinear(256, output_dim, generator)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False) -> torch.Tensor:
        if "in_src" not in batch and "adj" not in batch and "edge_slot" not in batch:
            return self._flat_forward(batch, train)
        # max runs over the in-row lists only
        max_pool = not self.use_gat and self.local_pooling == "max"
        if self.knn_k > 0 or (max_pool and "in_src" not in batch):
            raise ValueError(
                "dense graph layout supports GraphConv add/mean, GAT, and "
                "max over the in-row device wire "
                "(GraphLoader(require_inrow=True) — the factory sets it "
                "for pinned dense/auto max configs; require_inrow routes "
                "degree-outlier batches to the flat wire instead of this "
                "error); use the flat (edge list) layout otherwise / for "
                "knn_k"
            )
        dtype = self.compute_dtype
        x = batch["nodes"].to(dtype)
        node_mask = batch["node_mask"].float()
        b, m, _ = x.shape
        in_src, in_w = batch.get("in_src"), batch.get("in_w")
        inrow_gat = self.use_gat and in_src is not None

        fused = (self.fused_inrow and in_src is not None and not self.use_gat
                 and not self.sag_pool and not max_pool)
        if self.fused_inrow and not fused:
            # GAT attends through its own kernels, and SAG and max need the
            # adjacency or the in-row max, whatever this option says
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

        if fused or ((inrow_gat or max_pool) and not self.sag_pool):
            adj = None  # SAG's score conv needs it; nothing else here does
        elif "adj" in batch:
            adj = batch["adj"].to(dtype)
        elif in_src is not None:
            adj = inrow_adjacency(in_src, in_w, m, dtype)
        else:
            # the edge-slot triples, padded at the out-of-range slot b: a
            # spare slot takes the padding and is dropped
            adj = torch.zeros((b + 1, m, m), dtype=dtype, device=x.device)
            adj.index_put_(
                (batch["edge_slot"].long(), batch["edge_dst"].long(), batch["edge_src"].long()),
                batch["edge_w"].to(dtype),
                accumulate=True,
            )
            adj = adj[:b]

        # the in-row weights the convolutions read (SAG masks conv2's), and
        # their mirror, which the attention's backward kernel reads: built
        # once for both convolutions, and only where a backward will run
        conv_w = in_w
        mirror = gat_backward_mirror(in_src, in_w) if inrow_gat and train else None
        out_dst, out_w = batch.get("out_dst"), batch.get("out_w")

        def conv(mod, h):
            if inrow_gat:
                return mod(h, in_src, conv_w, mirror)
            if self.use_gat:
                return mod.forward_masked(h, adj != 0)
            if max_pool:
                return mod(h, inrow_max_aggregate(h, in_src, conv_w))
            if fused:
                # the out-rows only route the backward: inference needs none
                if mean and deg is not None:
                    # the aggregation sums; the exact-degree division stays
                    # outside the Function (it is linear, autograd composes it)
                    agg = inrow_aggregate(h, in_src, in_w, out_dst, out_w, "add")
                    return mod(h, (agg.float() / torch.clamp(deg.float(), min=1.0)[..., None]).to(h.dtype))
                return mod(h, inrow_aggregate(h, in_src, in_w, out_dst, out_w, self.local_pooling))
            # f32 accumulation, as the JAX einsum's preferred_element_type
            agg = torch.matmul(adj.float(), h.float())
            if mean:
                count = deg.float() if deg is not None else (adj != 0).float().sum(dim=2)
                agg = agg / torch.clamp(count, min=1.0)[..., None]
            return mod(h, agg.to(h.dtype))

        def bn(mod, h, mask):
            return mod(h.reshape(b * m, -1), mask=mask.reshape(-1), train=train).reshape(b, m, -1)

        x = bn(self.bn1, self.act(conv(self.conv1, x)), node_mask)
        if self.sag_pool:
            x, keep = self.pool.forward_dense(x, (adj != 0).to(dtype), node_mask.to(dtype))
            keep = keep.float()
            if inrow_gat or max_pool:
                # conv2 reads the in-row weights of the kept edges only: w
                # times keep[src] · keep[dst] (a source outside [0, M) keeps
                # nothing, as the JAX package's compare passes give)
                src = in_src.long()
                keep_src = torch.gather(keep, 1, src.clamp(0, m - 1).reshape(b, -1)).reshape(src.shape)
                keep_src = keep_src * ((src >= 0) & (src < m))
                conv_w = in_w * keep_src.to(in_w.dtype) * keep[:, :, None].to(in_w.dtype)
                if mirror is not None:
                    # conv2's backward kernel must read the mirror of THESE
                    # lists: over conv1's, K4's gradients would be wrong
                    # without an error
                    mirror = gat_backward_mirror(in_src, conv_w)
            else:
                adj = adj * keep[:, :, None].to(dtype) * keep[:, None, :].to(dtype)
            node_mask = keep
            deg = None  # the degrees changed: count the nonzero entries
        x = bn(self.bn2, self.act(conv(self.conv2, x)), node_mask)

        def mean_pool(h, mask):
            total = (h.float() * mask[..., None]).sum(dim=1)
            counts = torch.clamp(mask.sum(dim=1), min=1.0)
            return (total / counts[:, None]).to(h.dtype)

        if self.deepchem_style:
            def head(h, mask, update_stats=True):
                h = self.act(self.fc1(h))
                h = self.bn3(h.reshape(b * m, -1), mask=mask.reshape(-1), train=train,
                             update_stats=update_stats)
                return mean_pool(h.reshape(b, m, -1), mask)

            if os.environ.get("PCC_GRAPH_REMAT", "0") == "1" and torch.is_grad_enabled():
                runs = []

                def head_once(h, mask):
                    # the backward's recomputation leaves the running
                    # statistics as the forward moved them
                    runs.append(None)
                    return head(h, mask, update_stats=len(runs) == 1)

                x = checkpoint(head_once, x, node_mask, use_reentrant=False)
            else:
                x = head(x, node_mask)
        else:
            x = mean_pool(x, node_mask)
            x = self.bn3(self.act(self.fc1(x)), mask=batch.get("y_mask"), train=train)
        return self.fc2(x).float()

    def _flat_forward(self, batch: Dict[str, torch.Tensor], train: bool) -> torch.Tensor:
        """The flat wire: the batch's edge list, or kNN graphs from the
        position features."""
        nodes = batch["nodes"]
        x = nodes.to(self.compute_dtype)
        num_graphs = batch["y"].shape[0]
        # compact int16/int32 ids, or the counts encoding (graphs are
        # node-contiguous): ids rebuilt on the device without a host sync
        if "node_seg" in batch:
            node_seg = batch["node_seg"].to(torch.int32)
        else:
            node_seg = counts_to_segment_ids(batch["node_seg_counts"], x.shape[0])
        node_valid = (node_seg < num_graphs).to(x.dtype)
        aggregate = None
        if self.knn_k > 0:
            if self.config["input_dim"] < 4:
                raise ValueError("knn_k needs position features (n_features=4)")
            # positions from the features BEFORE the cast: a graph built from
            # bf16-rounded coordinates would have another topology
            pos3 = nodes[:, 1:4].float().contiguous()
            if not (self.use_gat or self.sag_pool or self.local_pooling == "max"):
                # one selection serves both convolutions and their backward
                plan = knn_select(pos3, node_seg, self.knn_k, num_graphs)

                def aggregate(h):
                    return knn_aggregate(h, pos3, node_seg, self.knn_k, num_graphs,
                                         self.local_pooling, plan)
            else:
                src, dst, edge_valid = knn_edges(pos3, node_seg, self.knn_k, num_graphs)
                edge_w = torch.ones_like(edge_valid)
        else:
            src, dst = batch["src"], batch["dst"]
            edge_w, edge_valid = batch["edge_w"], batch["edge_mask"]
        if aggregate is None:
            src, dst = src.long(), dst.long()
            edge_w, edge_valid = edge_w.to(x.dtype), edge_valid.to(x.dtype)

        def conv(mod, h):
            if aggregate is not None:
                return mod(h, aggregate(h))
            if self.use_gat:
                return mod.forward_edges(h, src, dst, edge_valid)
            return mod(h, edge_aggregate(h, src, dst, edge_w, edge_valid, self.local_pooling))

        x = self.bn1(self.act(conv(self.conv1, x)), mask=node_valid, train=train)
        if self.sag_pool:
            x, edge_valid, node_valid = self.pool(
                x, node_seg, src, dst, edge_w, edge_valid, node_valid, num_graphs
            )
        x = self.bn2(self.act(conv(self.conv2, x)), mask=node_valid, train=train)

        def mean_pool(h):
            h32 = (h * node_valid[:, None]).float()
            total = segment_sum(h32, node_seg, num_graphs + 1)
            counts = segment_count(node_seg, num_graphs + 1, valid=node_valid)
            return (total / torch.clamp(counts, min=1.0)[:, None])[:num_graphs].to(h.dtype)

        if self.deepchem_style:
            x = mean_pool(self.bn3(self.act(self.fc1(x)), mask=node_valid, train=train))
        else:
            x = self.bn3(self.act(self.fc1(mean_pool(x))), mask=batch.get("y_mask"), train=train)
        return self.fc2(x).float()

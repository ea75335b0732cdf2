"""kNN graphs built on the device from node positions, and the fused
kNN-and-aggregate — plain PyTorch, and kernel K5.

Counterpart of ``point_cloud_classifier_tpu/ops/knn.py`` and
``ops/knn_pallas.py``.  A flat node batch holds ``positions [N, 3]`` and
``node_seg [N]`` (the graph of each node; padding nodes carry
``num_graphs``; ids lie in ``[0, num_graphs]``).  A pair ``(i, j)`` is
*allowed* when both nodes are real, lie in one graph, and ``i != j``.

- :func:`knn_adjacency` is the ``[N, N]`` 0/1 adjacency by the per-row
  threshold: ``j`` is a neighbour of ``i`` when the pair is allowed and
  ``d2(i, j) <= kth(i)``, the k-th smallest allowed squared distance of the
  row, counted with multiplicity.  Exact ties at the k-th distance admit
  every tied candidate, so a row's degree can exceed k; a row with fewer
  than k candidates admits them all (its threshold is the f32 maximum);
- :func:`knn_edges` is the edge list with exactly k neighbours per row
  (nearest first, the lowest index winning a tie, by a stable sort), masked
  where a row has fewer candidates: the kNN graph of GraphNet's GAT, SAG and
  max arms;
- :func:`adjacency_aggregate` is ``adj @ x`` (the adjacency cast to ``x``'s
  dtype, summed in f32), ``mean`` divided in f32 by the degree floored at 1,
  the result in ``x``'s dtype;
- :func:`knn_aggregate_plain` and :func:`knn_aggregate_bwd_plain` are the
  plain versions of K5 and of its backward (``adjᵀ @ g``, for ``mean`` with
  ``g / max(deg, 1)``; the autograd of the plain forward).  They walk the
  rows in blocks, so no ``[N, N]`` tensor exists at N = 65,536;
- :func:`knn_select` works out a batch's topology once, as a
  :class:`KnnPlan`: the index range of each segment bucket, each node's
  ``(x, y, z, sq)``, and each row's threshold ``kth`` and degree ``deg``.  On
  a CUDA tensor it launches the selection kernel of ``csrc/knn_aggregate.cu``
  or raises; :func:`knn_select_plain` (:func:`segment_ranges` and
  :func:`knn_degree_plain`) is its plain version.  ``knn_select.launches``
  counts the kernel's launches;
- :func:`knn_aggregate` is the entry point, an autograd Function
  (``knn_aggregate_pallas``'s ``custom_vjp``), differentiable in ``x`` only:
  the adjacency is piecewise constant in the positions.  Given a plan it
  only gathers; without one it selects for itself first.  On a CUDA tensor
  forward and backward launch the gather kernel of ``csrc/knn_aggregate.cu``
  (K5, which replaces the TPU kernel of ``_knn_aggregate_pallas_impl``) or
  raise; on a CPU tensor, or inside ``force_plain``, both take the plain
  versions, which read the plan's thresholds instead of selecting again.
  ``knn_aggregate.launches`` counts K5's forward gathers and
  ``knn_aggregate.bwd_launches`` its backward ones.  Under
  ``torch.func.vmap`` (a sweep's arms, over one shared plan) each arm
  gathers on its own, both ways.

**One order of operations for the distance**, in the plain version and in
the kernel alike, because membership is decided by comparing f32 values
that cancel, and two roundings would flip the neighbour at the k-th boundary
in a few rows::

    sq(a)    = (ax*ax + ay*ay) + az*az
    dot(a,b) = (ax*bx + ay*by) + az*bz
    d2(a,b)  = (sq(a) + sq(b)) - 2*dot(a,b)

every product and sum rounded to f32 on its own (no fused multiply-add, no
matrix product).  Each step is commutative in ``a`` and ``b``, so ``d2(i,
j) == d2(j, i)`` bit for bit, which the backward relies on: row ``j`` asks
whether it was admitted by row ``i`` with ``d2(i, j) <= kth(i)``.  The JAX
package forms the dot by a matrix product; the two agree exactly on
positions that are small multiples of a power of two (the CPU tests use
such grids wherever membership must not depend on rounding).

The TPU kernel scans all N columns per row tile and needs N to be a
power-of-two multiple of its tile; K5 scans only the index range that holds
the row's graph (the loaders ship graphs node-contiguous), still testing
``node_seg[j] == node_seg[i]`` per candidate, so any ``node_seg`` gives the
right answer and a contiguous one gives it fast.  Any N, any width.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch

from point_cloud_classifier_tpu_torch.ops.dispatch import (
    per_arm,
    require_plain_tensors,
    use_cuda_kernels,
)

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
# elements of one [rows, N] temporary of the plain versions (256 MiB in f32)
_BLOCK_ELEMENTS = 1 << 26


def _check_aggr(aggr: str) -> None:
    if aggr not in ("add", "mean"):
        raise ValueError("aggr must be 'add' or 'mean'")


def _sq_norm(pos: torch.Tensor) -> torch.Tensor:
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    return (x * x + y * y) + z * z


def _masked_sqdist_rows(
    positions: torch.Tensor, node_seg: torch.Tensor, num_graphs: int, start: int, stop: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(masked [R, N], allowed [R, N])`` for the rows ``start:stop``:
    squared distances in the module's order of operations, with the f32
    maximum where the pair is not allowed."""
    pos = positions.float()
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"positions must be [N, 3], got {tuple(positions.shape)}")
    seg = node_seg.to(torch.int32)
    a = pos[start:stop]
    dot = (a[:, 0:1] * pos[:, 0] + a[:, 1:2] * pos[:, 1]) + a[:, 2:3] * pos[:, 2]
    d2 = (_sq_norm(a)[:, None] + _sq_norm(pos)[None, :]) - 2.0 * dot
    valid = seg < num_graphs
    rows = torch.arange(start, stop, device=pos.device)
    cols = torch.arange(pos.shape[0], device=pos.device)
    allowed = (
        (seg[start:stop, None] == seg[None, :])
        & (rows[:, None] != cols[None, :])
        & valid[None, :]
        & valid[start:stop, None]
    )
    big = torch.finfo(torch.float32).max
    return torch.where(allowed, d2, d2.new_full((), big)), allowed


def _masked_sqdist(positions, node_seg, num_graphs: int):
    return _masked_sqdist_rows(positions, node_seg, num_graphs, 0, positions.shape[0])


def _adjacency_rows(
    positions, node_seg, k: int, num_graphs: int, start: int, stop: int, kth=None
):
    """``(adj bool [R, N], kth f32 [R])`` for the rows ``start:stop``; with
    every row's threshold ``kth [N]`` given (a plan's), nothing is selected."""
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    masked, allowed = _masked_sqdist_rows(positions, node_seg, num_graphs, start, stop)
    if kth is not None:
        kth = kth[start:stop]
    else:
        # the k-th smallest of the row with multiplicity; a row of fewer than k
        # candidates reaches a masked entry, so its threshold admits them all
        kth = torch.topk(masked, min(k, masked.shape[1]), dim=1, largest=False).values[:, -1]
    return allowed & (masked <= kth[:, None]), kth


def _row_blocks(n: int, block_rows) -> Iterator[Tuple[int, int]]:
    rows = block_rows or max(1, _BLOCK_ELEMENTS // max(n, 1))
    for start in range(0, n, rows):
        yield start, min(start + rows, n)


def knn_adjacency(positions, node_seg, k: int, num_graphs: int) -> torch.Tensor:
    """Dense ``[N, N]`` f32 kNN adjacency by the admit-ties threshold."""
    adj, _ = _adjacency_rows(positions, node_seg, k, num_graphs, 0, positions.shape[0])
    return adj.float()


def knn_edges(positions, node_seg, k: int, num_graphs: int):
    """``(src, dst, edge_mask)``, each ``[N·k]``: edge ``src[e] → dst[e]``
    brings the e-th nearest neighbour into node ``dst[e] = e // k``.
    ``edge_mask`` (f32) is 0 where the row has fewer than k candidates, and
    such edges point at the node itself."""
    n = positions.shape[0]
    masked, _ = _masked_sqdist(positions, node_seg, num_graphs)
    order = torch.argsort(masked, dim=1, stable=True)[:, :k]  # the lowest index wins a tie
    picked = torch.gather(masked, 1, order)
    dst = torch.arange(n * k, device=positions.device, dtype=torch.int32) // k
    edge_mask = (picked < torch.finfo(torch.float32).max).reshape(-1).float()
    src = torch.where(edge_mask > 0, order.reshape(-1).to(torch.int32), dst)
    return src, dst, edge_mask


def adjacency_aggregate(adj: torch.Tensor, x: torch.Tensor, aggr: str = "add") -> torch.Tensor:
    """``adj @ x`` summed in f32, or its row mean, in ``x``'s dtype."""
    _check_aggr(aggr)
    agg = torch.matmul(adj.to(x.dtype).float(), x.float())
    if aggr == "mean":
        agg = agg / torch.clamp(adj.float().sum(dim=1, keepdim=True), min=1.0)
    return agg.to(x.dtype)


def knn_aggregate_plain(
    x, positions, node_seg, k: int, num_graphs: int, aggr: str = "add", block_rows=None, kth=None
) -> torch.Tensor:
    """The plain version of K5: ``adjacency_aggregate(knn_adjacency(...), x)``
    computed ``block_rows`` rows at a time (by default as many as keep one
    ``[rows, N]`` f32 temporary at 256 MiB).  ``kth [N]``, where given, is
    every row's threshold as :func:`knn_degree_plain` finds it."""
    _check_aggr(aggr)
    blocks = [
        adjacency_aggregate(
            _adjacency_rows(positions, node_seg, k, num_graphs, start, stop, kth)[0], x, aggr
        )
        for start, stop in _row_blocks(x.shape[0], block_rows)
    ]
    return torch.cat(blocks) if blocks else torch.zeros_like(x)


def knn_degree_plain(positions, node_seg, k: int, num_graphs: int, block_rows=None):
    """``(deg int32 [N], kth f32 [N])``: each row's neighbour count and
    threshold, what K5's forward keeps for its backward."""
    parts = [
        _adjacency_rows(positions, node_seg, k, num_graphs, start, stop)
        for start, stop in _row_blocks(positions.shape[0], block_rows)
    ]
    if not parts:  # N = 0
        return positions.new_zeros(0, dtype=torch.int32), positions.new_zeros(0, dtype=torch.float32)
    deg = torch.cat([adj.sum(dim=1) for adj, _ in parts]).to(torch.int32)
    return deg, torch.cat([kth for _, kth in parts])


def knn_aggregate_bwd_plain(
    g, positions, node_seg, k: int, num_graphs: int, aggr: str = "add", block_rows=None, kth=None
) -> torch.Tensor:
    """The plain version of K5's backward, ``dx = adjᵀ @ g`` (``mean``:
    ``adjᵀ @ (g / max(deg, 1))``) summed in f32, in ``g``'s dtype: what
    autograd gives for :func:`knn_aggregate_plain`, a block of rows at a
    time."""
    _check_aggr(aggr)
    dx = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    for start, stop in _row_blocks(g.shape[0], block_rows):
        adj, _ = _adjacency_rows(positions, node_seg, k, num_graphs, start, stop, kth)
        adj = adj.float()
        rows = g[start:stop].float()
        if aggr == "mean":
            rows = rows / torch.clamp(adj.sum(dim=1, keepdim=True), min=1.0)
        dx += torch.matmul(adj.t(), rows)
    return dx.to(g.dtype)


def segment_ranges(node_seg: torch.Tensor, num_graphs: int):
    """``(lo, hi)`` int32 ``[num_graphs + 1]``: the first and last index that
    carries each segment id.  Ids outside ``[0, num_graphs]`` fall into the
    nearest bucket, so a bucket's range always covers every node that could
    share its nodes' id; an empty bucket has ``lo = N > hi = -1``.  The plain
    version of the small kernels that run ahead of K5's selection
    (``csrc/knn_aggregate.cu``); a row then scans its bucket's range instead
    of all N columns."""
    n = node_seg.shape[0]
    bucket = node_seg.long().clamp(0, num_graphs)
    index = torch.arange(n, dtype=torch.int32, device=node_seg.device)
    lo = torch.full((num_graphs + 1,), n, dtype=torch.int32, device=node_seg.device)
    hi = torch.full((num_graphs + 1,), -1, dtype=torch.int32, device=node_seg.device)
    lo.scatter_reduce_(0, bucket, index, reduce="amin")
    hi.scatter_reduce_(0, bucket, index, reduce="amax")
    return lo, hi


@dataclass(frozen=True)
class KnnPlan:
    """The topology of one flat batch for one ``k``, worked out once and read
    by every aggregation over it, forward and backward."""

    positions: torch.Tensor  # [N, 3] f32, contiguous
    node_seg: torch.Tensor  # [N] int32
    k: int
    num_graphs: int
    lo: torch.Tensor  # [num_graphs + 1] int32, segment_ranges'
    hi: torch.Tensor
    points: torch.Tensor  # [N, 4] f32: x, y, z and sq, the kernels' candidates
    kth: torch.Tensor  # [N] f32: each row's threshold
    deg: torch.Tensor  # [N] int32: each row's neighbour count

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.positions, self.node_seg, self.lo, self.hi, self.points, self.kth, self.deg)


def _check_topology(positions, node_seg, k: int) -> None:
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if positions.ndim != 2 or positions.shape[1] != 3 or node_seg.ndim != 1:
        raise ValueError(
            f"K5 takes positions [N, 3] and node_seg [N], got {tuple(positions.shape)} "
            f"and {tuple(node_seg.shape)}"
        )
    if node_seg.shape[0] != positions.shape[0]:
        raise ValueError("K5's operands disagree on N")
    if node_seg.dtype not in (torch.int16, torch.int32, torch.int64):
        raise TypeError(f"K5 takes integer segment ids, got {node_seg.dtype}")
    if node_seg.device != positions.device:
        raise ValueError("K5's operands must all lie on one device")


def knn_select_plain(positions, node_seg, k: int, num_graphs: int, block_rows=None) -> KnnPlan:
    """The plain version of K5's selection: :func:`segment_ranges`,
    :func:`knn_degree_plain`, and the points in the module's order of
    operations."""
    _check_topology(positions, node_seg, k)
    pos = positions.float().contiguous()
    seg = node_seg.to(torch.int32).contiguous()
    lo, hi = segment_ranges(seg, num_graphs)
    deg, kth = knn_degree_plain(pos, seg, k, num_graphs, block_rows)
    points = torch.cat([pos, _sq_norm(pos)[:, None]], dim=1)
    return KnnPlan(pos, seg, k, num_graphs, lo, hi, points, kth, deg)


def knn_select(positions, node_seg, k: int, num_graphs: int) -> KnnPlan:
    """The batch's topology for ``k`` neighbours, once: hand the plan to every
    :func:`knn_aggregate` over the same positions and ids."""
    if positions.device.type not in ("cpu", "cuda"):
        raise ValueError(f"knn_select takes CPU or CUDA tensors, got {positions.device}")
    if use_cuda_kernels(positions):
        return _knn_select_cuda(positions, node_seg, k, num_graphs)
    return knn_select_plain(positions, node_seg, k, num_graphs)


knn_select.launches = 0


class _KnnAggregateFn(torch.autograd.Function):
    @staticmethod
    def forward(x, plan, aggr):
        if use_cuda_kernels(x):
            return _knn_aggregate_cuda(x, plan, aggr)
        return knn_aggregate_plain(
            x, plan.positions, plan.node_seg, plan.k, plan.num_graphs, aggr, kth=plan.kth
        )

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, plan, aggr = inputs
        ctx.plan_args = (plan.k, plan.num_graphs)
        ctx.aggr = aggr
        ctx.save_for_backward(*plan.tensors())

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        k, num_graphs = ctx.plan_args
        plan = KnnPlan(*ctx.saved_tensors[:2], k, num_graphs, *ctx.saved_tensors[2:])
        return _KnnAggregateBwdFn.apply(g, plan, ctx.aggr), None, None

    @staticmethod
    def vmap(info, in_dims, x, plan, aggr):
        return per_arm(lambda a: _KnnAggregateFn.apply(a, plan, aggr), info, in_dims[:1], x)


class _KnnAggregateBwdFn(torch.autograd.Function):
    """K5's backward (``adjᵀ @ g``) as a Function, on CUDA tensors the kernel,
    on CPU ones (and inside ``force_plain``) the plain version; its ``vmap``
    rule unbinds the arm axis before K5 sees a tensor.  Not differentiable
    itself."""

    @staticmethod
    def forward(g, plan, aggr):
        if use_cuda_kernels(g):
            return _knn_aggregate_bwd_cuda(g, plan, aggr)
        return knn_aggregate_bwd_plain(
            g, plan.positions, plan.node_seg, plan.k, plan.num_graphs, aggr, kth=plan.kth
        )

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, g, plan, aggr):
        return per_arm(lambda a: _KnnAggregateBwdFn.apply(a, plan, aggr), info, in_dims[:1], g)


def knn_aggregate(
    x, positions, node_seg, k: int, num_graphs: int, aggr: str = "add",
    plan: Optional[KnnPlan] = None,
):
    """Fused kNN construction and neighbour aggregation ``[N, H]`` in ``x``'s
    dtype, with no edge list and no ``[N, N]`` tensor on a CUDA tensor;
    differentiable in ``x``.  ``plan``, where given, is :func:`knn_select`'s
    for the same ``positions``, ``node_seg``, ``k`` and ``num_graphs``: the
    call then selects nothing and reads the plan's own positions and ids.  Only
    ``k``, ``num_graphs`` and N are checked against it: the caller answers for
    the plan being this batch's (a plan of other positions with the same N
    gives another graph's sums without an error)."""
    _check_aggr(aggr)
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"knn_aggregate takes CPU or CUDA tensors, got {x.device}")
    if plan is None:
        _check_operands(x, positions, node_seg)
        plan = knn_select(positions, node_seg, k, num_graphs)
    elif (plan.k, plan.num_graphs) != (k, num_graphs) or plan.kth.shape[0] != x.shape[0]:
        raise ValueError(
            f"the plan is for k={plan.k}, {plan.num_graphs} graphs and {plan.kth.shape[0]} "
            f"nodes; the call has k={k}, {num_graphs} graphs and {x.shape[0]} nodes"
        )
    return _KnnAggregateFn.apply(x, plan, aggr)


knn_aggregate.launches = 0
knn_aggregate.bwd_launches = 0


def _check_operands(x, positions, node_seg) -> None:
    """Raise on anything K5 does not take."""
    if x.dtype not in _X_CODES:
        raise TypeError(f"K5 takes f32 or bf16 features, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"K5 takes x [N, H], got {tuple(x.shape)}")
    _check_topology(positions, node_seg, 1)
    if positions.shape[0] != x.shape[0]:
        raise ValueError("K5's operands disagree on N")
    if positions.device != x.device:
        raise ValueError("K5's operands must all lie on one device")


def _knn_select_cuda(positions, node_seg, k: int, num_graphs: int):
    """K5's selection: the CUDA counterpart of :func:`knn_select_plain`, same
    contract."""
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    _check_topology(positions, node_seg, k)
    require_plain_tensors(positions, node_seg)
    n = positions.shape[0]
    dev = positions.device
    pos = positions.float().contiguous()
    seg = node_seg.to(torch.int32).contiguous()
    lo, hi = torch.empty((2, num_graphs + 1), dtype=torch.int32, device=dev)  # the entry fills them
    points = torch.empty((n, 4), dtype=torch.float32, device=dev)
    kth = torch.empty((n,), dtype=torch.float32, device=dev)
    deg = torch.empty((n,), dtype=torch.int32, device=dev)
    plan = KnnPlan(pos, seg, k, num_graphs, lo, hi, points, kth, deg)
    if n == 0:  # nothing to launch: every bucket is empty
        lo.fill_(0)
        hi.fill_(-1)
        return plan
    lib = kernel_library().lib
    with torch.cuda.device(dev):
        code = lib.pcc_knn_select(
            pos.data_ptr(), seg.data_ptr(), lo.data_ptr(), hi.data_ptr(), points.data_ptr(),
            kth.data_ptr(), deg.data_ptr(), n, k, num_graphs,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(code)
    knn_select.launches += 1
    return plan


def _knn_gather_cuda(src, plan: KnnPlan, aggr: str, backward: bool):
    from point_cloud_classifier_tpu_torch.native import check, kernel_library

    _check_aggr(aggr)
    _check_operands(src, plan.positions, plan.node_seg)
    require_plain_tensors(src, *plan.tensors())
    out = torch.empty_like(src, memory_format=torch.contiguous_format)
    if src.numel() == 0:
        return out, False
    src = src.contiguous()
    n, width = src.shape
    lib = kernel_library().lib
    with torch.cuda.device(src.device):
        code = lib.pcc_knn_gather(
            src.data_ptr(), plan.points.data_ptr(), plan.node_seg.data_ptr(), plan.lo.data_ptr(),
            plan.hi.data_ptr(), plan.kth.data_ptr(), plan.deg.data_ptr(), out.data_ptr(),
            n, width, plan.num_graphs, int(aggr == "mean"), int(backward), _X_CODES[src.dtype],
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    check(code)
    return out, True


def _knn_aggregate_cuda(x, plan: KnnPlan, aggr: str = "add"):
    """K5 given a plan: the CUDA counterpart of :func:`knn_aggregate_plain`
    with ``kth``, same contract.  Row ``i`` sums ``x[j]`` over the rows ``j`` of
    its graph with ``d2(i, j) <= kth[i]``, in index order."""
    out, launched = _knn_gather_cuda(x, plan, aggr, backward=False)
    knn_aggregate.launches += launched
    return out


def _knn_aggregate_bwd_cuda(g, plan: KnnPlan, aggr: str = "add"):
    """K5's backward, the counterpart of :func:`knn_aggregate_bwd_plain`: row
    ``j`` sums ``g[i]`` (``mean``: ``g[i] / max(deg[i], 1)``) over the rows
    ``i`` of its graph that admitted it, ``d2(i, j) <= kth[i]``, in index order
    and without atomics."""
    dx, launched = _knn_gather_cuda(g, plan, aggr, backward=True)
    knn_aggregate.bwd_launches += launched
    return dx

"""GraphNet slice 2's building blocks against the JAX package, from the same
seeded numpy inputs on the CPU: the segment ops of the flat edge-list wire
(``segment_count`` with a mask, ``segment_mean``, ``segment_softmax``,
``segment_rank_desc``), the in-row max aggregation and the in-row gather
(forward and gradient), and SAG pooling's keep sets, with ties, on the flat
and the dense wires, and at 301 nodes under bf16.  f32 values to 1e-5,
gradients to 1e-4 relative (the same sums in other orders); integer results,
ranks and keep sets exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.data.batching import GraphLoader as JaxGraphLoader  # noqa: E402
from point_cloud_classifier_tpu.models.graph_net import SAGPool as JaxSAGPool  # noqa: E402
from point_cloud_classifier_tpu.ops import inrow_graph as jax_inrow  # noqa: E402
from point_cloud_classifier_tpu.ops import segment as jax_segment  # noqa: E402
from point_cloud_classifier_tpu_torch.models.graph_net import SAGPool  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import inrow_graph, segment  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _ids(rng, n, segments, sorted_ids):
    ids = rng.integers(0, segments, size=n).astype(np.int32)
    return np.sort(ids) if sorted_ids else ids


@pytest.mark.parametrize("sorted_ids", [True, False], ids=["sorted", "unsorted"])
def test_segment_count_and_mean_match_jax(sorted_ids):
    """Counts with and without a mask; the mean of f32 data and of integer
    data, which truncates towards zero as the JAX package's does (the sum
    divided in f32, cast once)."""
    rng = np.random.default_rng(1)
    ids = _ids(rng, 60, 7, sorted_ids)
    valid = (rng.random(60) < 0.7).astype(np.float32)
    for v in (None, valid):
        want = jax_segment.segment_count(jnp.asarray(ids), 9, None if v is None else jnp.asarray(v))
        got = segment.segment_count(torch.from_numpy(ids), 9, None if v is None else torch.from_numpy(v))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    data = rng.normal(size=(60, 3)).astype(np.float32)
    want = jax_segment.segment_mean(jnp.asarray(data), jnp.asarray(ids), 9)
    np.testing.assert_allclose(segment.segment_mean(torch.from_numpy(data), torch.from_numpy(ids), 9).numpy(),
                               np.asarray(want), **F32)
    ints = rng.integers(-20, 20, size=(60, 2)).astype(np.int32)
    want = np.asarray(jax_segment.segment_mean(jnp.asarray(ints), jnp.asarray(ids), 9))
    got = segment.segment_mean(torch.from_numpy(ints), torch.from_numpy(ids), 9)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # truncation, not rounding: -7 / 2 is -3
    two = segment.segment_mean(torch.tensor([[-3], [-4]], dtype=torch.int32), torch.tensor([0, 0]), 1)
    assert two.item() == -3


@pytest.mark.parametrize("masked", [True, False], ids=["valid", "no-mask"])
def test_segment_softmax_matches_jax_with_gradients(masked):
    """Per-segment softmax over ``[E, H]`` logits: masked elements out of the
    max and the sum, an empty segment, a segment whose elements are all
    masked (0s, no NaN), and the gradient through the max as JAX takes it."""
    rng = np.random.default_rng(2)
    n, heads, segments = 70, 3, 12  # segment 11 is empty
    ids = rng.integers(0, 11, size=n).astype(np.int32)
    logits = (3 * rng.normal(size=(n, heads))).astype(np.float32)
    logits[:4] = logits[0]  # ties
    valid = (rng.random((n, 1)) < 0.7).astype(np.float32)
    valid[ids == 3] = 0.0  # segment 3 all masked
    cot = rng.normal(size=(n, heads)).astype(np.float32)
    v_j = jnp.asarray(valid) if masked else None

    def jax_loss(x):
        out = jax_segment.segment_softmax(x, jnp.asarray(ids), segments, v_j)
        return jnp.sum(out * cot), out

    (_, want), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = segment.segment_softmax(x, torch.from_numpy(ids), segments,
                                  torch.from_numpy(valid) if masked else None)
    (got * torch.from_numpy(cot)).sum().backward()
    assert torch.isfinite(got).all() and torch.isfinite(x.grad).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **GRAD)
    if masked:
        assert (got.detach().numpy()[ids == 3] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sorted_ids", [True, False], ids=["sorted", "unsorted"])
def test_segment_rank_desc_matches_jax_lexsort(sorted_ids, dtype):
    """Ranks by descending score within each segment, exactly: ties (a score
    pool of five values) break by element index, invalid elements rank
    last, and signed zeros tie."""
    rng = np.random.default_rng(3)
    n = 200
    ids = _ids(rng, n, 9, sorted_ids)
    score = rng.choice(np.array([-1.5, -0.0, 0.0, 0.25, 2.0], np.float32), size=n)
    valid = (rng.random(n) < 0.8).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax_segment.segment_rank_desc(
        jnp.asarray(score, jdt), jnp.asarray(ids), 10, jnp.asarray(valid, jdt)))
    got = segment.segment_rank_desc(torch.from_numpy(score).to(tdt), torch.from_numpy(ids), 10,
                                    torch.from_numpy(valid).to(tdt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _inrow(seed, b=3, m=24, d=8, width=5, pool=None, frac=0.6, ties=False):
    """Features and in-row lists; ``pool`` draws sources from a few ids
    (duplicate sources, self-edges), ``ties`` gives every node the same
    rows of small integers (max ties)."""
    rng = np.random.default_rng(seed)
    in_src = rng.integers(0, pool or m, size=(b, m, d)).astype(np.int32)
    in_w = (rng.random((b, m, d)) < frac).astype(np.float32)
    if not ties:
        in_w *= rng.uniform(0.2, 1.5, size=in_w.shape).astype(np.float32)
    in_w[:, :2] = 0.0  # rows with every slot masked
    h = (rng.integers(-2, 3, size=(b, m, width)) if ties else rng.normal(size=(b, m, width)))
    return h.astype(np.float32), in_src, in_w


@pytest.mark.parametrize("case", ["random", "duplicate-sources", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inrow_max_aggregate_matches_jax_with_gradients(case, dtype):
    """``max_d in_w·h[src_d]`` over slots with ``w != 0``, 0 on fully masked
    rows; the gradient splits each tie as ``jnp.maximum``'s fold splits it
    (half to each side at each fold)."""
    kw = {"random": {}, "duplicate-sources": dict(pool=5), "ties": dict(ties=True, pool=6)}[case]
    h, in_src, in_w = _inrow(seed=4, **kw)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    cot = np.random.default_rng(5).normal(size=h.shape).astype(np.float32)

    def jax_loss(x):
        out = jax_inrow.inrow_max_aggregate(x, jnp.asarray(in_src), jnp.asarray(in_w))
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, want), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(h, jdt))
    x = torch.from_numpy(h).to(tdt).requires_grad_()
    got = inrow_graph.inrow_max_aggregate(x, torch.from_numpy(in_src), torch.from_numpy(in_w))
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == tdt and (got[:, :2] == 0).all()
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want).astype(np.float32))
    # bf16: a cotangent summed over slots in another order lands up to two
    # bf16 steps away
    grad_tol = GRAD if dtype == "float32" else dict(rtol=2 ** -6, atol=1e-6)
    np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(want_grad).astype(np.float32), **grad_tol)
    if case == "ties" and dtype == "float32":
        # one amax over the slots would give 1/n to each of n ties: not JAX's split
        y = torch.from_numpy(h).requires_grad_()
        rows = y[torch.arange(h.shape[0])[:, None, None], torch.from_numpy(in_src).long()]
        w = torch.from_numpy(in_w)[..., None]
        amax = torch.where(w != 0, rows * w, float("-inf")).amax(dim=2)
        (torch.where(torch.isfinite(amax), amax, 0.0) * torch.from_numpy(cot)).sum().backward()
        assert not np.allclose(y.grad.numpy(), np.asarray(want_grad), **GRAD)


def _loader_lists(seed=6):
    """In-row lists with the out-row mirror from the JAX loader (a merged
    multigraph: repeated sources, summed weights)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(5):
        n = int(rng.integers(3, 30))
        e = 3 * n
        src, dst = rng.integers(0, n, size=e), rng.integers(0, n, size=e)
        graphs.append({"features": rng.normal(size=(n, 4)).astype(np.float32),
                       "edges": np.stack([src, dst]), "weights": rng.uniform(0.1, 1.0, e).astype(np.float32),
                       "label": 1})
    batch = next(iter(JaxGraphLoader(graphs, 6, shuffle=False, layout="dense", emit_out_rows=True)))
    return batch, rng.normal(size=batch["nodes"].shape[:2] + (7,)).astype(np.float32)


def test_inrow_gather_matches_jax_with_gradients():
    """``values[b, in_src[b, i, d]]`` forward; backward the gather over the
    out-row mirror, equal to ``jax.grad`` of the JAX custom VJP and to plain
    autograd's scatter, for a cotangent that is 0 on padding slots."""
    batch, values = _loader_lists()
    lists = [batch[k] for k in ("in_src", "out_dst", "out_pos", "out_w")]
    g = np.random.default_rng(7).normal(size=batch["in_src"].shape + (7,)).astype(np.float32)
    g *= (batch["in_w"] != 0)[..., None]  # the contract: 0 on padding slots

    def jax_loss(v):
        out = jax_inrow.inrow_gather(v, *(jnp.asarray(a) for a in lists))
        return jnp.sum(out * g), out

    (_, want), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(values))
    v = torch.from_numpy(values).requires_grad_()
    got = inrow_graph.inrow_gather(v, *(torch.from_numpy(a) for a in lists))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_grad), **GRAD)
    plain = torch.from_numpy(values).requires_grad_()
    idx = torch.from_numpy(batch["in_src"]).long()
    (plain[torch.arange(idx.shape[0])[:, None, None], idx] * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), plain.grad.numpy(), **GRAD)
    with pytest.raises(ValueError, match="out-row mirror"):
        v2 = torch.from_numpy(values).requires_grad_()
        inrow_graph.inrow_gather(v2, torch.from_numpy(batch["in_src"])).sum().backward()


def _pool_params(rng, width):
    """SAG's score network, as the JAX tree and as the port's module."""
    kernel = rng.normal(size=(width, 1)).astype(np.float32)
    bias = rng.normal(size=(1,)).astype(np.float32)
    root = rng.normal(size=(width, 1)).astype(np.float32)
    params = {"GraphConv_0": {"TorchLinear_0": {"kernel": kernel, "bias": bias},
                              "TorchLinear_1": {"kernel": root}}}
    pool = SAGPool(width, 0.5)
    with torch.no_grad():
        pool.gnn.lin_rel.weight.copy_(torch.from_numpy(kernel.T))
        pool.gnn.lin_rel.bias.copy_(torch.from_numpy(bias))
        pool.gnn.lin_root.weight.copy_(torch.from_numpy(root.T))
    return params, pool


def test_flat_sag_keeps_the_jax_nodes_with_ties():
    """Flat SAG: ``ceil(0.5 n)`` nodes a graph by descending score, ties to
    the lower node index (whole graphs of identical rows tie), the padding
    nodes never kept; x scaled by ``tanh(score)``, edges to dropped nodes
    masked."""
    rng = np.random.default_rng(8)
    counts = [7, 5, 1, 6]
    n, b = sum(counts) + 5, len(counts)
    node_seg = np.repeat(np.arange(b + 1), counts + [5]).astype(np.int32)
    x = rng.integers(-1, 2, size=(n, 4)).astype(np.float32)
    x[node_seg == 0] = x[0]  # graph 0: identical rows, no edges, every score ties
    e = 40
    src = rng.integers(7, n - 5, size=e)
    other = rng.integers(7, n - 5, size=e)
    dst = np.where(node_seg[src] == node_seg[other], other, src)
    edge_w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    edge_valid = (rng.random(e) < 0.9).astype(np.float32)
    node_valid = (node_seg < b).astype(np.float32)
    params, pool = _pool_params(rng, 4)
    args = (node_seg, src.astype(np.int32), dst.astype(np.int32), edge_w, edge_valid, node_valid)
    want = JaxSAGPool(0.5).apply({"params": params}, jnp.asarray(x), *(jnp.asarray(a) for a in args), b)
    got = pool(torch.from_numpy(x), *(torch.from_numpy(a) for a in args[:1]),
               *(torch.from_numpy(a).long() for a in args[1:3]),
               *(torch.from_numpy(a) for a in args[3:]), b)
    keep = got[2].detach().numpy()
    np.testing.assert_array_equal(keep, np.asarray(want[2]))
    assert [int(keep[node_seg == g].sum()) for g in range(b)] == [4, 3, 1, 3]
    assert keep[:4].all() and not keep[4:7].any()  # graph 0's ties: the lowest indices
    np.testing.assert_array_equal(got[1].detach().numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_sag_keeps_the_jax_nodes_with_ties_and_301_nodes(dtype):
    """Dense SAG on ``[B, M]`` rows: graphs of 301 and 300 nodes keep 151 and
    150 under bf16 too (counts and ranks in f32/int32; a bf16 count of 301
    would round to 300), ties (a graph of identical rows) keep the lowest
    indices, and the keep set and the scaled features equal the JAX
    model's."""
    rng = np.random.default_rng(9)
    b, m, width = 3, 304, 4
    sizes = [301, 300, 9]
    node_mask = np.zeros((b, m), np.float32)
    for g, size in enumerate(sizes):
        node_mask[g, :size] = 1.0
    x = rng.normal(size=(b, m, width)).astype(np.float32) * node_mask[..., None]
    x[2, :9] = x[2, 0]  # graph 2: every score ties
    adj = (rng.random((b, m, m)) < 0.02).astype(np.float32) * node_mask[:, :, None] * node_mask[:, None, :]
    adj[2] = 0.0
    params, pool = _pool_params(rng, width)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want_x, want_keep = JaxSAGPool(0.5).apply(
        {"params": params}, jnp.asarray(x, jdt), adj_unw=jnp.asarray(adj, jdt),
        node_mask=jnp.asarray(node_mask, jdt))
    got_x, got_keep = pool.forward_dense(torch.from_numpy(x).to(tdt), torch.from_numpy(adj).to(tdt),
                                         torch.from_numpy(node_mask).to(tdt))
    keep = got_keep.float().numpy()
    np.testing.assert_array_equal(keep, np.asarray(want_keep).astype(np.float32))
    assert keep.sum(axis=1).tolist() == [151, 150, 5]
    assert keep[2, :5].all() and not keep[2, 5:].any()
    if dtype == "float32":
        np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x), **F32)
    else:  # the same bf16 roundings on both sides
        np.testing.assert_allclose(got_x.detach().float().numpy(), np.asarray(want_x).astype(np.float32),
                                   rtol=2 ** -7, atol=1e-6)

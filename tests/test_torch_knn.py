"""The port's kNN ops against the JAX package's, on the CPU: ``knn_adjacency``,
``knn_edges``, ``adjacency_aggregate`` and ``knn_aggregate`` (the plain version
of kernel K5, reached through the autograd Function) against
``ops/knn.knn_aggregate`` and against the Pallas kernel in interpret mode,
forward and gradient.

Positions are grid-valued (small multiples of 1/64, or of 1/2 where exact
ties are wanted) wherever membership must not depend on rounding: on such a
grid every squared distance is exact in f32, so the JAX package's matrix
product and the port's elementwise order of operations pick the same
neighbours bit for bit.  What is left to differ is the order of the f32
sums over the neighbours."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.ops import knn as jax_knn  # noqa: E402
from point_cloud_classifier_tpu.ops.knn_pallas import knn_aggregate_pallas  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import knn  # noqa: E402
from point_cloud_classifier_tpu_torch.ops.dispatch import force_plain  # noqa: E402

# f32: the same 0/1 adjacency on both sides; sums of at most a few dozen
# values of size ~1 in other orders
F32 = dict(rtol=1e-5, atol=1e-5)
# bf16: exact f32 sums of bf16 values rounded once on both sides, so at most
# one bf16 value apart (2^-8 relative) where the f32 sums round apart
BF16_REL = 2.0**-8


def _inputs(n=64, h=16, graphs=3, seed=0, grid=64, span=64, padding=4):
    """Seeded features, positions on multiples of ``1/grid`` in ±span/grid,
    sorted segment ids with ``padding`` padding nodes at the end."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h)).astype(np.float32)
    pos = (rng.integers(-span, span + 1, size=(n, 3)) / grid).astype(np.float32)
    seg = np.sort(rng.integers(0, graphs, size=n)).astype(np.int32)
    if padding:
        seg[-padding:] = graphs
    return x, pos, seg, graphs


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_aggregates(x, pos, seg, k, graphs, aggr):
    """(XLA oracle, Pallas kernel in interpret mode) on the same inputs."""
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(seg), k, graphs, aggr)
    return np.asarray(jax_knn.knn_aggregate(*args)), np.asarray(knn_aggregate_pallas(*args, 32, True))


@pytest.mark.parametrize("k", [1, 4, 9])
def test_knn_adjacency_is_the_jax_adjacency(k):
    _, pos, seg, graphs = _inputs()
    want = np.asarray(jax_knn.knn_adjacency(jnp.asarray(pos), jnp.asarray(seg), k, graphs))
    got = knn.knn_adjacency(_t(pos), _t(seg), k, graphs)
    assert got.dtype == torch.float32 and got.shape == (64, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0 and not want[-4:].any() and not want[:, -4:].any()


@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("k", [1, 4, 9])
def test_knn_aggregate_matches_jax_and_pallas(aggr, k):
    x, pos, seg, graphs = _inputs()
    oracle, pallas = _jax_aggregates(x, pos, seg, k, graphs, aggr)
    before = (knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches)
    got = knn.knn_aggregate(_t(x), _t(pos), _t(seg), k, graphs, aggr)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), oracle, **F32)
    np.testing.assert_allclose(got.numpy(), pallas, **F32)
    assert not got[-4:].any()  # padding nodes aggregate nothing
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert before == (knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches)


@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_knn_aggregate_bf16_is_within_one_bf16_value_of_jax(aggr):
    x, pos, seg, graphs = _inputs(seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_knn.knn_aggregate(xb, jnp.asarray(pos), jnp.asarray(seg), 4, graphs, aggr)
                      .astype(jnp.float32))
    got = knn.knn_aggregate(_t(x).to(torch.bfloat16), _t(pos), _t(seg), 4, graphs, aggr)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= BF16_REL * np.maximum(np.abs(want), 1e-3)).all()


def test_rows_with_fewer_than_k_candidates_admit_them_all():
    x, pos, seg, graphs = _inputs(n=32, graphs=8)  # graphs of ~4 nodes, k = 6
    oracle, pallas = _jax_aggregates(x, pos, seg, 6, graphs, "add")
    got = knn.knn_aggregate(_t(x), _t(pos), _t(seg), 6, graphs, "add").numpy()
    np.testing.assert_allclose(got, oracle, **F32)
    np.testing.assert_allclose(got, pallas, **F32)
    deg, kth = knn.knn_degree_plain(_t(pos), _t(seg), 6, graphs)
    sizes = np.bincount(seg, minlength=graphs + 1)[seg]
    real = seg < graphs
    np.testing.assert_array_equal(deg.numpy()[real], np.minimum(sizes[real] - 1, deg.numpy()[real]))
    assert (deg.numpy()[real & (sizes <= 6)] == sizes[real & (sizes <= 6)] - 1).all()
    assert (kth.numpy()[real & (sizes <= 6)] == np.finfo(np.float32).max).all()


def test_ties_at_the_kth_distance_are_all_admitted():
    """Four nodes on a line: nodes 1 and 2 are equally near node 0, so its
    single-nearest query admits both."""
    pos = np.array([[0.0, 0, 0], [1.0, 0, 0], [-1.0, 0, 0], [5.0, 0, 0]], np.float32)
    x, seg = np.eye(4, dtype=np.float32), np.zeros(4, np.int32)
    oracle, pallas = _jax_aggregates(x, pos, seg, 1, 1, "add")
    got = knn.knn_aggregate(_t(x), _t(pos), _t(seg), 1, 1, "add").numpy()
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)
    assert got[0, 1] == 1.0 and got[0, 2] == 1.0
    mean = knn.knn_aggregate(_t(x), _t(pos), _t(seg), 1, 1, "mean").numpy()
    assert mean[0, 1] == 0.5 and mean[0, 2] == 0.5


@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_coarse_grid_degrees_exceed_k_as_in_jax(aggr):
    """Positions on a grid of step 1/2 in a small box: many exact ties."""
    x, pos, seg, graphs = _inputs(n=96, graphs=2, seed=2, grid=2, span=2)
    adj = np.asarray(jax_knn.knn_adjacency(jnp.asarray(pos), jnp.asarray(seg), 4, graphs))
    assert adj.sum(axis=1).max() > 4
    deg, _ = knn.knn_degree_plain(_t(pos), _t(seg), 4, graphs)
    np.testing.assert_array_equal(deg.numpy(), adj.sum(axis=1).astype(np.int32))
    oracle, pallas = _jax_aggregates(x, pos, seg, 4, graphs, aggr)
    got = knn.knn_aggregate(_t(x), _t(pos), _t(seg), 4, graphs, aggr).numpy()
    np.testing.assert_allclose(got, oracle, **F32)
    np.testing.assert_allclose(got, pallas, **F32)


@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("k", [1, 4, 9])
def test_gradient_matches_jax_grad(aggr, k):
    """The Function's backward (``knn_aggregate_bwd_plain`` on the CPU)
    against ``jax.grad`` of the XLA oracle and of the Pallas kernel's VJP."""
    x, pos, seg, graphs = _inputs(seed=3)
    cot = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def loss(fn):
        return lambda xx: jnp.sum(fn(xx) * jnp.asarray(cot))

    jpos, jseg = jnp.asarray(pos), jnp.asarray(seg)
    want = jax.grad(loss(lambda xx: jax_knn.knn_aggregate(xx, jpos, jseg, k, graphs, aggr)))(jnp.asarray(x))
    want_pallas = jax.grad(
        loss(lambda xx: knn_aggregate_pallas(xx, jpos, jseg, k, graphs, aggr, 32, True)))(jnp.asarray(x))
    leaf = _t(x).requires_grad_()
    out = knn.knn_aggregate(leaf, _t(pos), _t(seg), k, graphs, aggr)
    (got,) = torch.autograd.grad(out, leaf, _t(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **F32)
    assert not got[-4:].any()  # no row admits a padding node


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_plain_backward_is_the_autograd_of_the_plain_forward(aggr, dtype):
    x, pos, seg, graphs = _inputs(seed=5, grid=2, span=3)  # with ties
    cot = _t(np.random.default_rng(6).normal(size=x.shape).astype(np.float32)).to(dtype)
    leaf = _t(x).to(dtype).requires_grad_()
    out = knn.knn_aggregate_plain(leaf, _t(pos), _t(seg), 4, graphs, aggr)
    (want,) = torch.autograd.grad(out, leaf, cot)
    got = knn.knn_aggregate_bwd_plain(cot, _t(pos), _t(seg), 4, graphs, aggr)
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    else:
        err = (got.float() - want.float()).abs()
        assert (err <= BF16_REL * want.float().abs().clamp(min=1e-3)).all()


@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_row_blocks_change_nothing(aggr):
    """The plain versions walk the rows in blocks (so that N = 65,536 needs no
    [N, N] tensor); any block size gives the same rows."""
    x, pos, seg, graphs = _inputs(seed=7)
    args = (_t(pos), _t(seg), 4, graphs, aggr)
    whole = knn.knn_aggregate_plain(_t(x), *args)
    np.testing.assert_array_equal(knn.knn_aggregate_plain(_t(x), *args, block_rows=7).numpy(), whole.numpy())
    d_whole = knn.knn_aggregate_bwd_plain(_t(x), *args)
    d_blocks = knn.knn_aggregate_bwd_plain(_t(x), *args, block_rows=7)
    np.testing.assert_allclose(d_blocks.numpy(), d_whole.numpy(), **F32)
    deg, kth = knn.knn_degree_plain(*args[:-1])
    deg_b, kth_b = knn.knn_degree_plain(*args[:-1], block_rows=5)
    assert torch.equal(deg, deg_b) and torch.equal(kth, kth_b)


def test_distance_is_symmetric_bit_for_bit():
    """``d2(i, j) == d2(j, i)`` exactly, on positions that do round: the
    backward asks row i's threshold about the pair from row j's side."""
    rng = np.random.default_rng(8)
    pos = _t(rng.normal(size=(50, 3)).astype(np.float32) * 3.7)
    seg = torch.zeros(50, dtype=torch.int32)
    masked, allowed = knn._masked_sqdist(pos, seg, 1)
    assert torch.equal(masked, masked.t()) and torch.equal(allowed, allowed.t())
    assert allowed.sum() == 50 * 49


def test_unsorted_segment_ids_give_the_jax_answer():
    """Graphs need not be node-contiguous: membership is by id."""
    x, pos, seg, graphs = _inputs(seed=9)
    perm = np.random.default_rng(10).permutation(len(seg))
    x, pos, seg = x[perm], pos[perm], seg[perm]
    oracle, _ = _jax_aggregates(x, pos, seg, 4, graphs, "mean")
    got = knn.knn_aggregate(_t(x), _t(pos), _t(seg.astype(np.int16)), 4, graphs, "mean")
    np.testing.assert_allclose(got.numpy(), oracle, **F32)


def test_knn_edges_match_jax_lowest_index_first():
    """Exactly k per row, nearest first, the lowest index winning a tie (the
    grid makes some), masked where a graph has fewer than k + 1 nodes."""
    _, pos, seg, graphs = _inputs(n=48, graphs=9, seed=11)
    want = jax_knn.knn_edges(jnp.asarray(pos), jnp.asarray(seg), 4, graphs)
    got = knn.knn_edges(_t(pos), _t(seg), 4, graphs)
    for ours, theirs, dtype in zip(got, want, (torch.int32, torch.int32, torch.float32), strict=True):
        assert ours.dtype == dtype and ours.shape == (48 * 4,)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert 0 < got[2].sum() < 48 * 4


def test_edge_list_sum_equals_the_aggregate_without_ties():
    """On tie-free positions the k edges per row are the adjacency's."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    pos = rng.permutation(64 * 64)[:120].reshape(40, 3).astype(np.float32) ** 0.5  # distinct distances
    seg = np.sort(rng.integers(0, 2, size=40)).astype(np.int32)
    adj = knn.knn_adjacency(_t(pos), _t(seg), 3, 2)
    assert adj.sum(dim=1).max() == 3
    src, dst, mask = knn.knn_edges(_t(pos), _t(seg), 3, 2)
    summed = torch.zeros(40, 8).index_add_(0, dst.long(), _t(x)[src.long()] * mask[:, None])
    np.testing.assert_allclose(
        summed.numpy(), knn.knn_aggregate(_t(x), _t(pos), _t(seg), 3, 2, "add").numpy(), **F32)


def test_adjacency_aggregate_matches_jax():
    x, pos, seg, graphs = _inputs(seed=13)
    adj = np.asarray(jax_knn.knn_adjacency(jnp.asarray(pos), jnp.asarray(seg), 4, graphs))
    for aggr in ("add", "mean"):
        want = np.asarray(jax_knn.adjacency_aggregate(jnp.asarray(adj), jnp.asarray(x), aggr))
        np.testing.assert_allclose(knn.adjacency_aggregate(_t(adj.copy()), _t(x), aggr).numpy(), want, **F32)
    with pytest.raises(ValueError, match="aggr must be"):
        knn.adjacency_aggregate(_t(adj.copy()), _t(x), "max")


def test_segment_ranges_cover_every_id_that_could_match():
    seg = torch.tensor([0, 0, 2, 2, 2, 5, 5, 1, 3, 3], dtype=torch.int32)  # 3 graphs; 5 and 3 are padding
    lo, hi = knn.segment_ranges(seg, 3)
    assert lo.dtype == hi.dtype == torch.int32
    assert lo.tolist() == [0, 7, 2, 5] and hi.tolist() == [1, 7, 4, 9]
    lo, hi = knn.segment_ranges(torch.tensor([1, 1, 3], dtype=torch.int16), 3)
    assert lo.tolist() == [3, 0, 3, 2] and hi.tolist() == [-1, 1, -1, 2]  # empty buckets: lo > hi


def test_inside_force_plain_the_function_is_the_plain_version():
    x, pos, seg, graphs = _inputs(seed=14)
    want = knn.knn_aggregate_plain(_t(x), _t(pos), _t(seg), 4, graphs, "mean")
    with force_plain():
        got = knn.knn_aggregate(_t(x), _t(pos), _t(seg), 4, graphs, "mean")
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "kwargs, error, match",
    [
        (dict(aggr="max"), ValueError, "aggr must be"),
        (dict(k=0), ValueError, "k must be at least 1"),
    ],
    ids=["aggr", "k"],
)
def test_bad_arguments_raise(kwargs, error, match):
    x, pos, seg, graphs = _inputs()
    args = dict(k=4, num_graphs=graphs, aggr="add") | kwargs
    with pytest.raises(error, match=match):
        knn.knn_aggregate(_t(x), _t(pos), _t(seg), **args)


def test_no_gradient_flows_to_positions():
    x, pos, seg, graphs = _inputs(seed=15)
    p = _t(pos).requires_grad_()
    leaf = _t(x).requires_grad_()
    out = knn.knn_aggregate(leaf, p, _t(seg), 4, graphs, "add")
    out.sum().backward()
    assert p.grad is None and leaf.grad is not None


@pytest.mark.parametrize("k", [1, 4, 9])
def test_select_plain_is_the_ranges_the_degrees_and_the_thresholds(k):
    """``knn_select``'s plain version carries ``segment_ranges`` and
    ``knn_degree_plain`` unchanged, and the points in the module's order of
    operations."""
    _, pos, seg, graphs = _inputs(seed=16)
    plan = knn.knn_select(_t(pos), _t(seg).to(torch.int16), k, graphs)
    lo, hi = knn.segment_ranges(_t(seg), graphs)
    deg, kth = knn.knn_degree_plain(_t(pos), _t(seg), k, graphs)
    assert (plan.k, plan.num_graphs) == (k, graphs)
    assert plan.node_seg.dtype == torch.int32 and torch.equal(plan.node_seg, _t(seg))
    assert torch.equal(plan.positions, _t(pos))
    assert torch.equal(plan.lo, lo) and torch.equal(plan.hi, hi)
    assert plan.deg.dtype == torch.int32 and torch.equal(plan.deg, deg)
    assert plan.kth.dtype == torch.float32 and torch.equal(plan.kth, kth)
    sq = (pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1]) + pos[:, 2] * pos[:, 2]
    assert torch.equal(plan.points, _t(np.concatenate([pos, sq[:, None]], axis=1)))


def test_select_plain_on_short_graphs_ties_and_padding():
    """Rows with fewer than k candidates get the f32 maximum, ties at the k-th
    distance raise the degree over k, padding rows have degree 0."""
    _, pos, seg, graphs = _inputs(n=40, graphs=9, seed=17, grid=2, span=1, padding=6)
    plan = knn.knn_select(_t(pos), _t(seg), 4, graphs)
    sizes = np.bincount(seg[seg < graphs], minlength=graphs)
    short = np.isin(seg, np.flatnonzero(sizes < 5)) & (seg < graphs)
    big = torch.finfo(torch.float32).max
    assert short.any() and bool((plan.kth[_t(short)] == big).all())
    assert bool((plan.deg[_t(short)] == _t(sizes[seg[short]] - 1)).all())
    assert int(plan.deg.max()) > 4
    assert bool((plan.deg[-6:] == 0).all()) and bool((plan.kth[-6:] == big).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_a_plan_changes_no_bit_forward_or_gradient(aggr, dtype):
    x, pos, seg, graphs = _inputs(seed=18, grid=2, span=3)  # ties at the k-th distance too
    g = _t(np.random.default_rng(19).normal(size=x.shape).astype(np.float32)).to(dtype)
    plan = knn.knn_select(_t(pos), _t(seg), 4, graphs)
    outs = []
    for kwargs in ({}, {"plan": plan}):
        leaf = _t(x).to(dtype).requires_grad_()
        out = knn.knn_aggregate(leaf, _t(pos), _t(seg), 4, graphs, aggr, **kwargs)
        outs.append((out.detach(), torch.autograd.grad(out, leaf, g)[0]))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert outs[1][0].dtype == dtype and outs[1][1].dtype == dtype


def test_with_a_plan_nothing_is_selected_again(monkeypatch):
    x, pos, seg, graphs = _inputs(seed=20)
    plan = knn.knn_select(_t(pos), _t(seg), 4, graphs)
    calls = []
    monkeypatch.setattr(knn, "knn_select", lambda *a, **kw: calls.append(a) or plan)
    monkeypatch.setattr(torch, "topk", lambda *a, **kw: pytest.fail("selected again"))
    leaf = _t(x).requires_grad_()
    knn.knn_aggregate(leaf, _t(pos), _t(seg), 4, graphs, "mean", plan=plan).sum().backward()
    assert calls == [] and leaf.grad is not None
    monkeypatch.undo()
    knn.knn_aggregate(_t(x), _t(pos), _t(seg), 4, graphs, "mean")  # selects for itself


@pytest.mark.parametrize(
    "k, graphs_off, rows", [(5, 0, None), (4, 1, None), (4, 0, 10)], ids=["k", "graphs", "nodes"]
)
def test_a_plan_of_another_batch_raises(k, graphs_off, rows):
    x, pos, seg, graphs = _inputs(seed=21)
    plan = knn.knn_select(_t(pos), _t(seg), 4, graphs)
    with pytest.raises(ValueError, match="the plan is for"):
        knn.knn_aggregate(_t(x)[:rows], _t(pos)[:rows], _t(seg)[:rows], k, graphs + graphs_off, "add", plan=plan)


def test_inside_force_plain_the_selection_is_the_plain_version():
    _, pos, seg, graphs = _inputs(seed=22)
    want = knn.knn_select_plain(_t(pos), _t(seg), 4, graphs)
    with force_plain():
        got = knn.knn_select(_t(pos), _t(seg), 4, graphs)
    assert all(torch.equal(a, b) for a, b in zip(got.tensors(), want.tensors(), strict=True))
    assert knn.knn_select.launches == 0

"""The port's fused in-row aggregation (``ops/inrow_graph.py``) against the JAX
package's, from the same seeded numpy inputs: ``inrow_aggregate_plain`` (what
kernel K6 is held to on a card) against the XLA oracle and against the Pallas
kernel in interpret mode, and the autograd Function's gradients (``dh`` over
the out-row lists, ``din_w``) against ``jax.grad`` of both.  f32 forward to
1e-5; gradients to 1e-4 relative (the same sums in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.ops import inrow_graph as jax_inrow  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import inrow_graph  # noqa: E402
from point_cloud_classifier_tpu_torch.ops.dispatch import force_plain, use_cuda_kernels  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _lists(seed=0, b=3, m=32, d=4, width=8, frac=0.5, id_pool=None, isolated=0):
    """Features, in-row lists and the out-row mirror (the transposed
    adjacency's rows).  ``id_pool`` draws sources from a tiny pool, so rows
    hold duplicate sources (their weights sum) and self-edges; the first
    ``isolated`` nodes of each graph get no incoming edge."""
    rng = np.random.default_rng(seed)
    in_src = rng.integers(0, id_pool or m, size=(b, m, d)).astype(np.int32)
    in_w = (rng.random((b, m, d)) * (rng.random((b, m, d)) < frac)).astype(np.float32)
    in_w[:, :isolated] = 0.0
    h = rng.normal(size=(b, m, width)).astype(np.float32)
    adj_t = np.swapaxes(np.asarray(jax_inrow.inrow_adjacency_xla(in_src, in_w, m, jnp.float32)), 1, 2)
    d_out = max(4, int((adj_t != 0).sum(axis=2).max()))
    out_dst = np.zeros((b, m, d_out), np.int32)
    out_w = np.zeros((b, m, d_out), np.float32)
    for g in range(b):
        for row in range(m):
            cols = np.flatnonzero(adj_t[g, row])
            out_dst[g, row, : len(cols)] = cols
            out_w[g, row, : len(cols)] = adj_t[g, row, cols]
    return h, in_src, in_w, out_dst, out_w


CASES = {
    "random": dict(seed=0),
    "duplicates-self-edges": dict(seed=7, b=2, m=32, d=8, id_pool=6, frac=0.7),
    "isolated": dict(seed=3, isolated=9),
    "m24-d8": dict(seed=4, b=2, m=24, d=8, frac=0.8),  # M not a power of two
}


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_oracle(case, aggr):
    h, in_src, in_w, _, _ = _lists(**CASES[case])
    want = np.asarray(jax_inrow.inrow_aggregate_xla(h, in_src, in_w, aggr))
    got = inrow_graph.inrow_aggregate_plain(*_torch(h, in_src, in_w), aggr)
    assert got.dtype == torch.float32 and got.shape == h.shape
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("case", ["random", "duplicates-self-edges", "isolated"])
def test_plain_matches_interpret_kernel(case, aggr):
    """K6's TPU original in interpret mode (power-of-two M, which it needs)."""
    h, in_src, in_w, out_dst, out_w = _lists(**CASES[case])
    want = np.asarray(jax_inrow.inrow_aggregate(h, in_src, in_w, out_dst, out_w, aggr, True))
    got = inrow_graph.inrow_aggregate_plain(*_torch(h, in_src, in_w), aggr)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("wire", ["f32-int32", "f16-int16"])
@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_bf16_plain_matches_jax_oracle(aggr, wire):
    """Weights rounded to bf16 (through fp16 on the half wire), products and
    sum in f32, one rounding of the output.  Loader-like lists: no duplicate
    source within a row."""
    rng = np.random.default_rng(5)
    b, m, d, width = 2, 32, 4, 16
    in_src = np.stack([np.stack([rng.permutation(m)[:d] for _ in range(m)]) for _ in range(b)]).astype(np.int32)
    in_w = (rng.random((b, m, d)) * (rng.random((b, m, d)) < 0.7)).astype(np.float32)
    h = rng.normal(size=(b, m, width)).astype(np.float32)
    if wire == "f16-int16":
        in_src, in_w = in_src.astype(np.int16), in_w.astype(np.float16)
    want = jax_inrow.inrow_aggregate_xla(jnp.asarray(h, jnp.bfloat16), in_src, in_w, aggr)
    got = inrow_graph.inrow_aggregate_plain(torch.from_numpy(h).bfloat16(), *_torch(in_src, in_w), aggr)
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the output where the f32 sums round apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2**-8, atol=1e-6)


def _port_grads(arrays, cot, aggr, w_grad=True):
    h, in_src, in_w, out_dst, out_w = _torch(*arrays)
    h.requires_grad_()
    in_w.requires_grad_(w_grad)
    out = inrow_graph.inrow_aggregate(h, in_src, in_w, out_dst, out_w, aggr)
    out.backward(torch.from_numpy(cot))
    return out.detach(), h.grad, in_w.grad


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "interpret-kernel"])
@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("case", ["random", "duplicates-self-edges", "isolated"])
def test_function_gradients_match_jax_grad(case, aggr, interpret):
    """``dh`` (the aggregation over the out-rows) and ``din_w`` against
    ``jax.grad`` of the JAX ``custom_vjp``: off the TPU it runs the XLA oracle,
    and with ``interpret`` the Pallas kernel both ways."""
    arrays = _lists(**CASES[case])
    h, in_src, in_w, out_dst, out_w = arrays
    cot = np.random.default_rng(11).normal(size=h.shape).astype(np.float32)

    def loss(hh, ww):
        return jnp.sum(jax_inrow.inrow_aggregate(hh, in_src, ww, out_dst, out_w, aggr, interpret) * cot)

    want_h, want_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(in_w))
    out, dh, din_w = _port_grads(arrays, cot, aggr)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_inrow.inrow_aggregate_xla(h, in_src, in_w, aggr)), **F32)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_h), **GRAD)
    np.testing.assert_allclose(din_w.numpy(), np.asarray(want_w), **GRAD)


@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("case", list(CASES))
def test_function_dh_matches_autograd_of_the_plain_version(case, aggr):
    arrays = _lists(**CASES[case])
    cot = np.random.default_rng(12).normal(size=arrays[0].shape).astype(np.float32)
    h, in_src, in_w = _torch(*arrays[:3])
    h.requires_grad_()
    inrow_graph.inrow_aggregate_plain(h, in_src, in_w, aggr).backward(torch.from_numpy(cot))
    _, dh, din_w = _port_grads(arrays, cot, aggr, w_grad=False)
    assert din_w is None  # computed only when in_w asks for it
    np.testing.assert_allclose(dh.numpy(), h.grad.numpy(), **GRAD)


def test_backward_without_out_rows_raises_the_jax_message():
    h, in_src, in_w, _, _ = _torch(*_lists(seed=1))
    out = inrow_graph.inrow_aggregate(h.requires_grad_(), in_src, in_w)  # inference-only use
    torch.testing.assert_close(out, inrow_graph.inrow_aggregate_plain(h, in_src, in_w), rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs the out-row lists"):
        out.sum().backward()
    with pytest.raises(ValueError, match="needs the out-row lists"):
        jax.grad(lambda x: jnp.sum(jax_inrow.inrow_aggregate(x, in_src.numpy(), in_w.numpy(), None, None)))(
            jnp.asarray(h.detach().numpy()))


def test_unknown_aggregation_raises_as_jax_does():
    h, in_src, in_w, out_dst, out_w = _lists(seed=1)
    for call in (
        lambda: inrow_graph.inrow_aggregate(*_torch(h, in_src, in_w, out_dst, out_w), "max"),
        lambda: inrow_graph.inrow_aggregate_plain(*_torch(h, in_src, in_w), "max"),
        lambda: jax_inrow.inrow_aggregate(h, in_src, in_w, out_dst, out_w, "max"),
    ):
        with pytest.raises(ValueError, match="supports 'add'/'mean'"):
            call()


def test_entry_point_on_cpu_takes_the_plain_version_and_counts_no_launch():
    arrays = _lists(seed=2)
    h = torch.from_numpy(arrays[0])
    assert not use_cuda_kernels(h)
    before = (inrow_graph.inrow_aggregate.launches, inrow_graph.inrow_aggregate.bwd_launches)
    cot = np.ones(arrays[0].shape, np.float32)
    out, dh, _ = _port_grads(arrays, cot, "add")
    with force_plain():
        again, dh_again, _ = _port_grads(arrays, cot, "add")
    assert (inrow_graph.inrow_aggregate.launches, inrow_graph.inrow_aggregate.bwd_launches) == before
    torch.testing.assert_close(out, inrow_graph.inrow_aggregate_plain(*_torch(*arrays[:3])), rtol=0, atol=0)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    torch.testing.assert_close(dh_again, dh, rtol=0, atol=0)


def test_kernel_operand_checks():
    h, in_src, in_w, _, _ = _torch(*_lists(seed=1))
    inrow_graph._check_operands(h.bfloat16(), in_src.short(), in_w.half())
    with pytest.raises(TypeError, match="f32 or bf16 h"):
        inrow_graph._check_operands(h.half(), in_src, in_w)
    with pytest.raises(TypeError, match="int32/int16"):
        inrow_graph._check_operands(h, in_src.long(), in_w)
    with pytest.raises(ValueError, match="shapes disagree"):
        inrow_graph._check_operands(h[:, :5], in_src, in_w)
    wide = torch.zeros(*in_src.shape[:2], 33, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 32"):
        inrow_graph._check_operands(h, wide, wide.float())


# K6's layout per shape, chosen on the host: (width, dtype) -> (channels a
# piece, lanes a node); two pieces a lane
AGGREGATE_FORMS = {
    "width 128 f32: 16 lanes a node, two nodes a warp": ((128, torch.float32), (4, 16)),
    "width 128 bf16: 8 lanes a node, four nodes a warp": ((128, torch.bfloat16), (8, 8)),
    "width 4 f32: a channel a piece, 2 lanes a node": ((4, torch.float32), (1, 2)),
    "width 4 bf16: a channel a piece, 2 lanes a node": ((4, torch.bfloat16), (1, 2)),
    "width 8 f32: a lane a node": ((8, torch.float32), (4, 1)),
    "width 48 f32": ((48, torch.float32), (4, 8)),
    "width 5": ((5, torch.float32), (1, 4)),
    "width 1": ((1, torch.bfloat16), (1, 1)),
    "width 260 f32: 32 lanes a node, two turns": ((260, torch.float32), (4, 32)),
    "width 260 bf16: a channel a piece, five turns": ((260, torch.bfloat16), (1, 32)),
}


@pytest.mark.parametrize("case", list(AGGREGATE_FORMS))
def test_aggregate_form_per_shape(case):
    (width, dtype), form = AGGREGATE_FORMS[case]
    assert inrow_graph.aggregate_form(width, dtype) == form
    # rows off 16-byte addresses go a channel a piece
    vec, _ = inrow_graph.aggregate_form(width, dtype, aligned=False)
    assert vec == 1

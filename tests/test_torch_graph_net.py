"""The port's GraphNet on the dense in-row wire against the JAX package's, from
the same seeded graphs and the same weights carried across by ``convert.py``:
GAT and GraphConv add/mean, ``deepchem_style`` on and off, eval and train
mode (``MaskedBatchNorm``'s batch statistics and running-stat updates), the
train-mode gradients, and the ``fused_inrow`` branch (kernel K6's route, here
through its plain version) against the adjacency branch and the JAX logits."""

import itertools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.data.batching import GraphLoader as JaxGraphLoader  # noqa: E402
from point_cloud_classifier_tpu.models import GraphNet as JaxGraphNet  # noqa: E402
from point_cloud_classifier_tpu.models.common import MaskedBatchNorm as JaxMaskedBatchNorm  # noqa: E402
from point_cloud_classifier_tpu_torch import convert  # noqa: E402
from point_cloud_classifier_tpu_torch.models import GraphNet  # noqa: E402
from point_cloud_classifier_tpu_torch.models import graph_net as graph_net_module  # noqa: E402
from point_cloud_classifier_tpu_torch.models.common import MaskedBatchNorm  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
# bf16 compute: the logits' relative Frobenius distance.  Both sides round
# every conv and linear to bf16 where the other does; a sum run in another
# order can still land a value on the neighbouring bf16 number (2^-8
# relative), which the next layers carry on.  The readings over these cases
# on an x86 CPU were 0 (bit-equal logits).
BF16_FRO = 2e-3

MODELS = {
    "gat": dict(use_gat=True),
    "graphconv-add": dict(local_pooling="add"),
    "graphconv-mean": dict(local_pooling="mean"),
}


def _model_cfg(name, deepchem_style=True, compute_dtype="float32"):
    """configs/graph_net.yaml at narrow width."""
    cfg = dict(
        input_dim=4, hidden_dim=16, output_dim=1, activation="tanh", use_gat=False,
        gat_heads=4, sag_pool=False, pool_ratio=0.5, local_pooling="add",
        global_pooling="mean", deepchem_style=deepchem_style, compute_dtype=compute_dtype,
    )
    cfg.update(MODELS[name])
    return cfg


def random_graphs(seed=0, n=11, duplicates=False):
    """Seeded graphs of 1-40 nodes with about three incoming edges per node
    and positive weights; graph 2 has no edges, node 0 of graph 3 none in."""
    rng = np.random.default_rng(seed)
    graphs = []
    for g in range(n):
        nodes = int(rng.integers(1, 41))
        e = 0 if g == 2 else 3 * nodes
        src, dst = rng.integers(0, nodes, size=e), rng.integers(0, nodes, size=e)
        if not duplicates:
            keep = np.unique(dst * nodes + src, return_index=True)[1]
            src, dst = src[keep], dst[keep]
        if g == 3:
            src, dst = src[dst != 0], dst[dst != 0]
        graphs.append({
            "features": rng.normal(size=(nodes, 4)).astype(np.float32),
            "edges": np.stack([src, dst]).astype(np.int64),
            "weights": rng.uniform(0.05, 1.0, size=len(src)).astype(np.float32),
            "label": np.int64(rng.integers(0, 2)),
        })
    return graphs


def _batch(graphs, batch_size=8, **kw):
    loader = JaxGraphLoader(graphs, batch_size, shuffle=False, layout="dense", **kw)
    batch = next(iter(loader))
    assert "in_src" in batch
    return batch


def _variables(cfg, batch, seed=0):
    """A JAX init, with every parameter and running statistic moved off its
    initial value so that none of them can pass by being 0 or 1."""
    variables = JaxGraphNet(**cfg).init(jax.random.PRNGKey(seed), batch, train=False)
    rng = np.random.default_rng(seed + 100)

    def move(a, lo=-0.2, hi=0.2):
        return (np.asarray(a) + rng.uniform(lo, hi, size=np.shape(a))).astype(np.float32)

    params = jax.tree.map(move, variables["params"])
    stats = jax.tree.map(lambda a: move(a, 0.0, 0.5), variables["batch_stats"])
    return params, stats


def _port_model(cfg, params, stats):
    model = GraphNet(**cfg)
    sd = convert.to_torch_state_dict("graph_net", {"model": cfg}, params, stats)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return model


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("deepchem_style", [True, False], ids=["deepchem", "pool-first"])
@pytest.mark.parametrize("name", list(MODELS))
def test_eval_logits_match_jax(name, deepchem_style):
    cfg = _model_cfg(name, deepchem_style)
    batch = _batch(random_graphs(), use_weights=name != "gat")
    params, stats = _variables(cfg, batch)
    want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    with torch.no_grad():
        got = _port_model(cfg, params, stats)(_to_torch(batch), train=False)
    assert got.dtype == torch.float32 and got.shape == want.shape == (8, 1)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("name", list(MODELS))
def test_fp16_wire_logits_match_jax(name):
    """int16 sources, fp16 weights and features on the wire."""
    cfg = _model_cfg(name)
    batch = _batch(random_graphs(seed=4), transfer_dtype="float16", use_weights=name != "gat")
    assert batch["in_src"].dtype == np.int16 and batch["in_w"].dtype == np.float16
    params, stats = _variables(cfg, batch, seed=4)
    want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    with torch.no_grad():
        got = _port_model(cfg, params, stats)(_to_torch(batch), train=False)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("deepchem_style", [True, False], ids=["deepchem", "pool-first"])
@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_logits_match_jax(name, deepchem_style):
    cfg = _model_cfg(name, deepchem_style, "bfloat16")
    batch = _batch(random_graphs(seed=2), use_weights=True)
    params, stats = _variables(cfg, batch, seed=2)
    want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    with torch.no_grad():
        got = _port_model(cfg, params, stats)(_to_torch(batch), train=False).numpy()
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= BF16_FRO * np.linalg.norm(want)


@pytest.mark.parametrize("deepchem_style", [True, False], ids=["deepchem", "pool-first"])
@pytest.mark.parametrize("name", list(MODELS))
def test_train_mode_logits_and_running_stats_match_jax(name, deepchem_style):
    """Train-mode forward: masked batch statistics (padding nodes and padding
    graphs left out) and the running-stat updates, every BatchNorm."""
    cfg = _model_cfg(name, deepchem_style)
    batch = _batch(random_graphs(seed=6, n=6), use_weights=True)  # 2 padding graphs
    params, stats = _variables(cfg, batch, seed=6)
    want, updated = JaxGraphNet(**cfg).apply(
        {"params": params, "batch_stats": stats}, batch, train=True, mutable=["batch_stats"]
    )
    model = _port_model(cfg, params, stats)
    got = model(_to_torch(batch), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    sd = model.state_dict()
    for k in (1, 2, 3):
        jax_stats = updated["batch_stats"][f"MaskedBatchNorm_{k - 1}"]
        np.testing.assert_allclose(sd[f"bn{k}.running_mean"].numpy(), np.asarray(jax_stats["mean"]), **F32)
        np.testing.assert_allclose(sd[f"bn{k}.running_var"].numpy(), np.asarray(jax_stats["var"]), **F32)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_batch_norm_matches_jax(dtype, masked):
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, size=(37, 5)).astype(np.float32)
    mask = (rng.random(37) < 0.6).astype(np.float32) if masked else None
    scale, bias = rng.normal(size=5).astype(np.float32), rng.normal(size=5).astype(np.float32)
    stats = {"mean": rng.normal(size=5).astype(np.float32), "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    jdtype = jax.numpy.dtype(dtype)
    bn = MaskedBatchNorm(5)
    bn.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(stats["mean"]), "running_var": torch.from_numpy(stats["var"]),
        "num_batches_tracked": torch.tensor(0),
    })
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tmask = None if mask is None else torch.from_numpy(mask)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": stats}
    for train in (False, True):
        jx = jax.numpy.asarray(x, jdtype)
        if train:
            want, upd = JaxMaskedBatchNorm().apply(variables, jx, mask, train=True, mutable=["batch_stats"])
        else:
            want = JaxMaskedBatchNorm().apply(variables, jx, mask, train=False)
        got = bn(tx, mask=tmask, train=train)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want).astype(np.float32), **F32)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), **F32)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), **F32)


def test_parameter_names_and_count_match_jax():
    for name in MODELS:
        cfg = _model_cfg(name)
        batch = _batch(random_graphs(n=3), batch_size=4)
        variables = JaxGraphNet(**cfg).init(jax.random.PRNGKey(0), batch, train=False)
        model = GraphNet(**cfg, generator=torch.Generator().manual_seed(0))
        n_jax = sum(np.size(a) for a in jax.tree.leaves(variables["params"]))
        assert sum(p.numel() for p in model.parameters()) == n_jax
        params, stats = convert.convert_torch_state_dict("graph_net", {"model": cfg}, model.state_dict())
        shapes = jax.tree.map(np.shape, params)
        assert shapes == jax.tree.map(np.shape, variables["params"])
        assert jax.tree.map(np.shape, stats) == jax.tree.map(np.shape, variables["batch_stats"])


def _on_grid(graphs, grid=1 / 64):
    """Positions on multiples of ``grid``: every kNN distance exact in f32
    on both sides (docs/parity_torch.md §3)."""
    for g in graphs:
        g["features"][:, 1:4] = np.round(g["features"][:, 1:4] / grid) * grid
    return graphs


def _assert_logits_and_grads_match(cfg, batch, seed):
    """Eval logits, then one train-mode forward and the gradient of every
    parameter, against the JAX model from the same weights."""
    params, stats = _variables(cfg, batch, seed=seed)
    want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    model = _port_model(cfg, params, stats)
    with torch.no_grad():
        np.testing.assert_allclose(model(_to_torch(batch)).numpy(), want, **F32)
    cot = np.random.default_rng(seed).normal(size=batch["y"].shape).astype(np.float32)

    def loss(p):
        logits, _ = JaxGraphNet(**cfg).apply(
            {"params": p, "batch_stats": stats}, batch, train=True, mutable=["batch_stats"])
        return jnp.sum(logits * cot), logits

    (_, want_logits), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    want_grads = convert.to_torch_state_dict(
        "graph_net", {"model": cfg}, jax.tree.map(np.asarray, want_grads), stats)
    logits, got = _grads(model, _to_torch(batch), torch.from_numpy(cot))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **F32)
    assert set(got) <= set(want_grads)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), want_grads[key], rtol=1e-4, atol=2e-5, err_msg=key)


@pytest.mark.parametrize(
    "kwargs, layout",
    [
        (dict(sag_pool=True), "dense"),
        (dict(local_pooling="max"), "dense"),
        (dict(knn_k=8, use_gat=True), "flat"),
        (dict(knn_k=8, sag_pool=True), "flat"),
        (dict(knn_k=8, local_pooling="max"), "flat"),
    ],
    ids=["sag", "max", "knn", "knn-sag", "knn-max"],
)
def test_unported_options_raise(kwargs, layout):
    """The options of GraphNet slice 2 against the JAX model: SAG pooling and
    max aggregation on the in-row wire, and ``knn_k`` with GAT, SAG or max
    (the kNN edge-list arm) on the flat wire, eval logits and train-mode
    gradients."""
    cfg = {**_model_cfg("graphconv-add"), **kwargs}
    graphs = _on_grid(random_graphs(seed=12, n=7))
    batch = next(iter(JaxGraphLoader(graphs, 8, shuffle=False, layout=layout)))
    assert ("in_src" in batch) == (layout == "dense")
    _assert_logits_and_grads_match(cfg, batch, seed=12)


def test_batches_without_inrow_lists_raise():
    """Dense batches without the in-row lists: the host adjacency and the
    edge-slot triples (a batch past ``max_in_degree_wire``) serve GAT and
    GraphConv as in the JAX model; max aggregation, which needs the in-row
    lists, raises as the JAX model does."""
    graphs = random_graphs(seed=13, n=7, duplicates=True)
    host = next(iter(JaxGraphLoader(graphs, 8, shuffle=False, layout="dense", adj_wire="host")))
    slots = next(iter(JaxGraphLoader(graphs, 8, shuffle=False, layout="dense", max_in_degree_wire=4)))
    assert "adj" in host and "edge_slot" in slots and "in_src" not in slots
    for name, batch in itertools.product(["gat", "graphconv-mean"], [host, slots]):
        _assert_logits_and_grads_match(_model_cfg(name), batch, seed=13)
    cfg = {**_model_cfg("graphconv-add"), "local_pooling": "max"}
    for batch in (host, slots):
        with pytest.raises(ValueError, match="in-row device wire"):
            GraphNet(**cfg)(_to_torch(batch))
        with pytest.raises(ValueError, match="in-row device wire"):
            JaxGraphNet(**cfg).init(jax.random.PRNGKey(0), batch, train=False)


def _grads(model, batch, cot):
    model.zero_grad()
    logits = model(batch, train=True)
    (logits * cot).sum().backward()
    return logits.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("fused", [False, True], ids=["adjacency", "fused-inrow"])
@pytest.mark.parametrize("name", list(MODELS))
def test_train_mode_gradients_match_jax(name, fused):
    """One train-mode forward and the gradient of every parameter (batch
    statistics are differentiated through, as in the JAX train step).  With
    ``fused_inrow`` the GraphConv models aggregate through the autograd
    Function (backward over the out-rows); the GAT model warns and takes its
    own route, as the JAX model does."""
    cfg = _model_cfg(name)
    batch = _batch(random_graphs(seed=8, n=7), use_weights=name != "gat", emit_out_rows=True)
    assert "out_dst" in batch
    params, stats = _variables(cfg, batch, seed=8)
    cot = np.random.default_rng(8).normal(size=(8, 1)).astype(np.float32)

    def loss(p):
        logits, _ = JaxGraphNet(**cfg).apply(
            {"params": p, "batch_stats": stats}, batch, train=True, mutable=["batch_stats"])
        return jnp.sum(logits * cot), logits

    (_, want_logits), want = jax.value_and_grad(loss, has_aux=True)(params)
    want = convert.to_torch_state_dict("graph_net", {"model": cfg}, jax.tree.map(np.asarray, want), stats)
    model = _port_model({**cfg, "fused_inrow": fused}, params, stats)
    with warnings.catch_warnings():
        warnings.simplefilter("error" if not (fused and name == "gat") else "ignore")
        logits, got = _grads(model, _to_torch(batch), torch.from_numpy(cot))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **F32)
    for key, g in got.items():
        # the same sums in other orders, through three batch normalisations
        np.testing.assert_allclose(g.numpy(), want[key], rtol=1e-4, atol=2e-5, err_msg=key)


@pytest.mark.parametrize("transfer_dtype", ["float32", "float16"])
@pytest.mark.parametrize("in_deg", [True, False], ids=["wire-in_deg", "no-in_deg"])
@pytest.mark.parametrize("name", ["graphconv-add", "graphconv-mean"])
def test_fused_inrow_matches_adjacency_branch_and_jax(name, in_deg, transfer_dtype):
    """Eval logits of the fused branch against the adjacency branch and the
    JAX model, on a merged multigraph (``in_deg`` counts every occurrence, so
    mean divides by it outside the Function); without ``in_deg``, as in a
    hand-built batch, mean is the Function's own count of nonzero weights."""
    cfg = _model_cfg(name)
    batch = _batch(random_graphs(seed=9, duplicates=in_deg), use_weights=True,
                   emit_out_rows=True, transfer_dtype=transfer_dtype)
    if not in_deg:
        del batch["in_deg"]
    params, stats = _variables(cfg, batch, seed=9)
    want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    fused, plain = _port_model({**cfg, "fused_inrow": True}, params, stats), _port_model(cfg, params, stats)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the fused branch is taken: no warning
        with torch.no_grad():
            got, ref = fused(_to_torch(batch)), plain(_to_torch(batch))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32)


def test_fused_inrow_on_a_gat_model_warns_as_jax_and_changes_nothing():
    """The JAX model's warning, word for word, and GAT's own logits."""
    cfg = {**_model_cfg("gat"), "fused_inrow": True}
    batch = _batch(random_graphs(seed=3), use_weights=False, emit_out_rows=True)
    params, stats = _variables(cfg, batch, seed=3)
    with pytest.warns(UserWarning, match="has no effect on this batch") as jax_warned:
        want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    with pytest.warns(UserWarning, match="has no effect on this batch") as warned:
        with torch.no_grad():
            got = _port_model(cfg, params, stats)(_to_torch(batch))
    assert str(warned[0].message) == str(jax_warned[0].message)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("name", ["graphconv-add", "graphconv-mean"])
def test_fused_inrow_without_out_rows_serves_and_refuses_to_train(name, monkeypatch):
    """A batch without the out-row lists (a loader without ``emit_out_rows``,
    or an out-degree over the wire's slots): the JAX model warns and takes the
    adjacency route.  The port never leaves the fused aggregation: inference
    goes through it (the forward reads no out-rows) and gives the JAX logits,
    and a train-mode forward raises, naming the loader option."""
    cfg = {**_model_cfg(name), "fused_inrow": True}
    batch = _batch(random_graphs(seed=3), use_weights=True, emit_out_rows=False)
    assert "out_dst" not in batch
    params, stats = _variables(cfg, batch, seed=3)
    with pytest.warns(UserWarning, match="has no effect on this batch"):
        want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    model = _port_model(cfg, params, stats)
    monkeypatch.setattr(graph_net_module, "inrow_adjacency", None)  # the adjacency route would fail
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.no_grad():
            got = model(_to_torch(batch))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    with pytest.raises(ValueError, match="emit_out_rows=True"):
        model(_to_torch(batch), train=True)
    # differentiating an eval-mode forward reaches the Function's own refusal
    with pytest.raises(ValueError, match="needs the out-row lists"):
        model(_to_torch(batch)).sum().backward()


def test_gat_forward_on_the_cpu_builds_no_mirror(monkeypatch):
    """The lists' mirror is for the attention's backward KERNEL: a CPU forward,
    train mode or not, differentiates the plain version and builds none."""
    from point_cloud_classifier_tpu_torch.ops import gat as gat_ops

    monkeypatch.setattr(gat_ops, "gat_out_rows",
                        lambda *args: pytest.fail("a mirror was built on the CPU"))
    seen = []
    attention = graph_net_module.gat_attention
    monkeypatch.setattr(graph_net_module, "gat_attention",
                        lambda *args: seen.append(args[-1]) or attention(*args))
    rng = np.random.default_rng(3)
    b, m, d = 2, 12, 4
    batch = {
        "nodes": torch.from_numpy(rng.normal(size=(b, m, 4)).astype(np.float32)),
        "node_mask": torch.ones(b, m),
        "in_deg": torch.ones(b, m),
        "in_src": torch.from_numpy(rng.integers(0, m, size=(b, m, d)).astype(np.int32)),
        "in_w": torch.from_numpy((rng.random((b, m, d)) < 0.5).astype(np.float32)),
    }
    model = GraphNet(input_dim=4, hidden_dim=16, output_dim=1, activation="tanh", use_gat=True,
                     gat_heads=4, generator=torch.Generator().manual_seed(0))
    model(batch, train=True).sum().backward()
    assert seen == [None, None]  # both convolutions were handed no mirror
    assert all(p.grad is not None for p in model.parameters())

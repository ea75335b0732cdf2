"""The kNN GraphNet slice against the JAX package, on the CPU: the model on the
flat wire (``knn_k > 0``, GraphConv add and mean) from the same batches and
the same weights carried across by ``convert.py`` — logits, train-mode
statistics and gradients — then the entry points: ``factory.get_model`` on a
JAX-format ``best_model.pt`` (``DenseGraphConv_*`` keys) with ``predict``,
``fit`` against the JAX ``fit``, ``train_model`` and ``resume_training``.

The synthetic S2PG caches carry positions on a grid of 1/64
(``write_s2pg_cache(position_grid=...)``): every squared distance is then
exact in f32, so the JAX package's matrix product and the port's elementwise
order of operations choose the same neighbours, and what is compared is the
arithmetic after the choice.  One cache uses a grid of 1/2, where exact ties
push a node's degree over k."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu.data.batching import GraphLoader as JaxGraphLoader  # noqa: E402
from point_cloud_classifier_tpu.models import GraphNet as JaxGraphNet  # noqa: E402
from point_cloud_classifier_tpu.ops import knn as jax_knn  # noqa: E402
from point_cloud_classifier_tpu_torch import convert, factory  # noqa: E402
from point_cloud_classifier_tpu_torch import train as port_train  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs, write_s2pg_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.models import GraphNet  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import knn  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
# bf16 compute: the logits' relative Frobenius distance.  Both sides round
# every aggregate, conv and linear to bf16 where the other does; a sum run in
# another order can land a value on the neighbouring bf16 number (2^-8
# relative), which the next layers carry on.
BF16_FRO = 2e-3
# f32 training, a few Adam steps: the same math in other summation orders
PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-5
N_GRAPHS = (24, 8, 21)  # train, val, test: the test split is 3 batches of 8
K = 4


def _model_cfg(local_pooling="add", deepchem_style=True, compute_dtype="float32", knn_k=K, **kw):
    """configs/graph_net.yaml at narrow width, with model.knn_k."""
    return dict(
        input_dim=4, hidden_dim=16, output_dim=1, activation="tanh", use_gat=False, gat_heads=4,
        sag_pool=False, pool_ratio=0.5, local_pooling=local_pooling, global_pooling="mean",
        deepchem_style=deepchem_style, compute_dtype=compute_dtype, knn_k=knn_k, **kw,
    )


def _flat_batch(seed=0, n=6, grid=1 / 64, **kw):
    """One flat batch of 8 slots from the JAX loader: ``n`` lineage-like
    graphs of 12-40 nodes on a position grid (8 - n padding graphs)."""
    graphs = lineage_graphs(np.random.default_rng(seed), n, 12, 40, position_grid=grid)
    for g in graphs:
        g["features"] = g["features"].astype(np.float32)
    batch = next(iter(JaxGraphLoader(graphs, 8, shuffle=False, layout="flat", **kw)))
    assert "src" in batch and "in_src" not in batch
    return batch


def _variables(cfg, batch, seed=0):
    """A JAX init with every parameter and running statistic moved off its
    initial value."""
    variables = JaxGraphNet(**cfg).init(jax.random.PRNGKey(seed), batch, train=False)
    rng = np.random.default_rng(seed + 100)

    def move(a, lo=-0.2, hi=0.2):
        return (np.asarray(a) + rng.uniform(lo, hi, size=np.shape(a))).astype(np.float32)

    params = jax.tree.map(move, variables["params"])
    return params, jax.tree.map(lambda a: move(a, 0.0, 0.5), variables["batch_stats"])


def _port_model(cfg, params, stats):
    model = GraphNet(**cfg)
    sd = convert.to_torch_state_dict("graph_net", {"model": cfg}, params, stats)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return model


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("deepchem_style", [True, False], ids=["deepchem", "pool-first"])
@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_eval_logits_match_jax(local_pooling, deepchem_style):
    cfg = _model_cfg(local_pooling, deepchem_style)
    batch = _flat_batch()
    params, stats = _variables(cfg, batch)
    assert "DenseGraphConv_0" in params and "GraphConv_0" not in params
    want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    launches = (knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches)
    with torch.no_grad():
        got = _port_model(cfg, params, stats)(_to_torch(batch), train=False)
    assert got.dtype == torch.float32 and got.shape == want.shape == (8, 1)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert launches == (knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches)


@pytest.mark.parametrize(
    "loader_kw",
    [dict(seg_encoding="counts"), dict(transfer_dtype="float16"),
     dict(seg_encoding="counts", transfer_dtype="float16")],
    ids=["counts", "fp16-wire", "counts-fp16-wire"],
)
def test_wire_encodings_match_jax(loader_kw):
    """``node_seg_counts`` decoded on the device, int16 ids and fp16
    features (a grid of 1/64 is exact in fp16 at these magnitudes)."""
    cfg = _model_cfg("mean")
    batch = _flat_batch(seed=1, **loader_kw)
    assert ("node_seg_counts" in batch) == (loader_kw.get("seg_encoding") == "counts")
    params, stats = _variables(cfg, batch, seed=1)
    want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    with torch.no_grad():
        got = _port_model(cfg, params, stats)(_to_torch(batch), train=False)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_coarse_grid_with_ties_matches_jax(local_pooling):
    cfg = _model_cfg(local_pooling)
    batch = _flat_batch(seed=2, grid=0.5)
    seg = jnp.asarray(batch["node_seg"].astype(np.int32))
    adj = jax_knn.knn_adjacency(jnp.asarray(batch["nodes"][:, 1:4]), seg, K, 8)
    assert np.asarray(adj).sum(axis=1).max() > K  # exact ties: a degree over k
    params, stats = _variables(cfg, batch, seed=2)
    want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    with torch.no_grad():
        got = _port_model(cfg, params, stats)(_to_torch(batch), train=False)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("deepchem_style", [True, False], ids=["deepchem", "pool-first"])
@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_bf16_logits_match_jax(local_pooling, deepchem_style):
    """The positions stay f32 under bf16 compute, so the graph is the f32
    one on both sides."""
    cfg = _model_cfg(local_pooling, deepchem_style, "bfloat16")
    batch = _flat_batch(seed=3)
    params, stats = _variables(cfg, batch, seed=3)
    want = np.asarray(JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
    with torch.no_grad():
        got = _port_model(cfg, params, stats)(_to_torch(batch), train=False).numpy()
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= BF16_FRO * np.linalg.norm(want)


@pytest.mark.parametrize("deepchem_style", [True, False], ids=["deepchem", "pool-first"])
@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_train_mode_logits_and_running_stats_match_jax(local_pooling, deepchem_style):
    cfg = _model_cfg(local_pooling, deepchem_style)
    batch = _flat_batch(seed=4)  # 2 padding graphs and padding nodes
    params, stats = _variables(cfg, batch, seed=4)
    want, updated = JaxGraphNet(**cfg).apply(
        {"params": params, "batch_stats": stats}, batch, train=True, mutable=["batch_stats"])
    model = _port_model(cfg, params, stats)
    got = model(_to_torch(batch), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    sd = model.state_dict()
    for k in (1, 2, 3):
        jax_stats = updated["batch_stats"][f"MaskedBatchNorm_{k - 1}"]
        np.testing.assert_allclose(sd[f"bn{k}.running_mean"].numpy(), np.asarray(jax_stats["mean"]), **F32)
        np.testing.assert_allclose(sd[f"bn{k}.running_var"].numpy(), np.asarray(jax_stats["var"]), **F32)


@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_train_mode_gradients_match_jax(local_pooling):
    """The gradient of every parameter through the Function's backward (the
    batch statistics are differentiated through, as in the JAX train step)."""
    cfg = _model_cfg(local_pooling)
    batch = _flat_batch(seed=5)
    params, stats = _variables(cfg, batch, seed=5)
    cot = np.random.default_rng(6).normal(size=(8, 1)).astype(np.float32)

    def loss(p):
        logits, _ = JaxGraphNet(**cfg).apply(
            {"params": p, "batch_stats": stats}, batch, train=True, mutable=["batch_stats"])
        return jnp.sum(logits * jnp.asarray(cot))

    want = convert.to_torch_state_dict("graph_net", {"model": cfg}, jax.tree.map(np.asarray, jax.grad(loss)(params)), stats)
    model = _port_model(cfg, params, stats)
    (model(_to_torch(batch), train=True) * torch.from_numpy(cot)).sum().backward()
    for name, p in model.named_parameters():
        scale = max(1.0, float(np.abs(want[name]).max()))
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def test_positions_are_taken_before_the_compute_dtype_cast(monkeypatch):
    """Under bf16 compute the graph is still built from the f32 coordinates:
    on positions that bf16 cannot hold, ``knn_aggregate`` receives them
    unrounded (a grid of 1/64 would hide the difference)."""
    from point_cloud_classifier_tpu_torch.models import graph_net as graph_net_module

    batch = _to_torch(_flat_batch(seed=9, grid=None))
    want = batch["nodes"][:, 1:4].clone()
    assert not torch.equal(want, want.to(torch.bfloat16).float())
    seen = []

    def spy(h, positions, *args):
        seen.append((h.dtype, positions.clone()))
        return knn.knn_aggregate(h, positions, *args)

    monkeypatch.setattr(graph_net_module, "knn_aggregate", spy)
    with torch.no_grad():
        GraphNet(**_model_cfg(compute_dtype="bfloat16"))(batch)
    assert [dtype for dtype, _ in seen] == [torch.bfloat16, torch.bfloat16]
    assert all(pos.dtype == torch.float32 and torch.equal(pos, want) for _, pos in seen)


def test_refusals_are_the_jax_models():
    batch = _to_torch(_flat_batch(seed=7))
    with pytest.raises(ValueError, match="knn_k needs position features"):
        GraphNet(**{**_model_cfg(), "input_dim": 3})({**batch, "nodes": batch["nodes"][:, :3]})
    dense = next(iter(JaxGraphLoader(
        lineage_graphs(np.random.default_rng(7), 3, 12, 20), 4, shuffle=False, layout="dense")))
    with pytest.raises(ValueError, match="use the flat \\(edge list\\) layout otherwise / for knn_k"):
        GraphNet(**_model_cfg())(_to_torch(dense))
    with pytest.raises(ValueError, match="for knn_k"):
        JaxGraphNet(**_model_cfg()).init(jax.random.PRNGKey(0), dense, train=False)
    # a flat batch with knn_k == 0 goes through the batch's own edge list, as
    # in the JAX model
    cfg = _model_cfg(knn_k=0)
    params, stats = _variables(cfg, _flat_batch(seed=7))
    want = JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, _flat_batch(seed=7), train=False)
    with torch.no_grad():
        got = _port_model(cfg, params, stats)(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- the entry points ------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("s2pg_knn"))
    write_s2pg_cache(path, n_graphs=N_GRAPHS, min_nodes=24, max_nodes=48, seed=5, position_grid=1 / 64)
    return path


def _config(data_dir, log_dir=None, epochs=2, local_pooling="add", **trainer):
    """configs/base.yaml + configs/graph_net.yaml at narrow width, with
    model.knn_k: no graph_layout, so both factories choose the flat wire."""
    model = _model_cfg(local_pooling)
    del model["compute_dtype"]
    return {
        "meta": {"model_name": "", "dataset_name": ""},
        "dataset": {"data_dir": data_dir, "batch_size": 8, "use_weights": False, "n_features": 4},
        "logging": {"log_dir": None if log_dir is None else str(log_dir)},
        "model": model,
        "trainer": {"epochs": epochs, "learning_rate": 0.001, **trainer},
    }


def _metrics(log_dir):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append(row["value"])
    return out


@pytest.mark.parametrize("pinned", [None, "flat", "auto"], ids=["default", "pinned-flat", "pinned-auto"])
def test_factory_chooses_the_layout_the_jax_factory_chooses(data_dir, pinned):
    """A ``knn_k`` config defaults to the flat wire; a pinned layout is kept
    (and a pinned dense or auto then fails in the model, on both sides)."""
    cfg = _config(data_dir)
    if pinned:
        cfg["dataset"]["graph_layout"] = pinned
    jax_data, data = jax_factory.get_dataloader("s2pg", cfg), factory.get_dataloader("s2pg", cfg)
    for key, value in data.loader_kwargs.items():
        assert value == getattr(jax_data, {"layout": "graph_layout"}.get(key, key)), key
    assert data.loader_kwargs["layout"] == (pinned or "flat")
    batch = next(iter(data.get_test_loader()))
    assert ("src" in batch) == (pinned != "auto")
    if pinned == "auto":
        with pytest.raises(ValueError, match="for knn_k"):
            factory.get_model("graph_net", cfg, device="cpu").predict([batch])


@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_predict_matches_jax(data_dir, tmp_path, local_pooling):
    """get_model on a JAX ``best_model.pt`` whose convolutions are named
    ``DenseGraphConv_*``, then predict over the flat test loader."""
    cfg = _config(data_dir, local_pooling=local_pooling)
    jax_data, port_data = jax_factory.get_dataloader("s2pg", cfg), factory.get_dataloader("s2pg", cfg)
    jax_batches, port_batches = list(jax_data.get_test_loader()), list(port_data.get_test_loader())
    for a, b in zip(port_batches, jax_batches, strict=True):
        assert sorted(a) == sorted(b) and all(a[k].tobytes() == b[k].tobytes() for k in a)
    params, stats = _variables(cfg["model"], jax_batches[0], seed=8)
    assert sorted(params) == ["DenseGraphConv_0", "DenseGraphConv_1", "MaskedBatchNorm_0", "MaskedBatchNorm_1",
                              "MaskedBatchNorm_2", "TorchLinear_0", "TorchLinear_1"]
    with open(tmp_path / "best_model.pt", "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats}, f)

    y_ref, p_ref = jax_factory.get_model("graph_net", cfg, str(tmp_path)).predict(
        jax_data.get_test_loader(), return_prob=True)
    served = factory.get_model("graph_net", cfg, str(tmp_path), device="cpu")
    assert served.device.type == "cpu"
    # the model builds its own edges: the wrapper leaves the batch's on the host
    assert sorted(served._put(port_batches[0])) == ["node_seg", "nodes", "y", "y_mask"]
    y, p = served.predict(port_data.get_test_loader(), return_prob=True)
    np.testing.assert_array_equal(y, y_ref)
    assert p.shape == p_ref.shape == (N_GRAPHS[2], 1) and p.dtype == np.float32
    np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)
    # and back: the port's state_dict converts to the tree the JAX model reads
    back, _ = convert.convert_torch_state_dict("graph_net", cfg, served.model.state_dict())
    np.testing.assert_array_equal(
        back["DenseGraphConv_1"]["TorchLinear_1"]["kernel"], params["DenseGraphConv_1"]["TorchLinear_1"]["kernel"])


@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_fit_matches_jax_fit(data_dir, tmp_path, local_pooling):
    port_cfg = _config(data_dir, tmp_path / "port", local_pooling=local_pooling, state_every=0)
    jax_cfg = _config(data_dir, tmp_path / "jax", local_pooling=local_pooling, state_every=0)
    port = factory.get_model("graph_net", port_cfg, device="cpu")
    ref = jax_factory.get_model("graph_net", jax_cfg)
    params, stats = convert.convert_torch_state_dict("graph_net", port_cfg, port.model.state_dict())
    ref.params = jax.tree.map(jnp.asarray, params)  # the JAX fit takes assigned params
    ref.batch_stats = jax.tree.map(jnp.asarray, stats)

    data, jax_data = factory.get_dataloader("s2pg", port_cfg), jax_factory.get_dataloader("s2pg", jax_cfg)
    launches = (knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches)
    port.fit(data.get_train_loader(), data.get_val_loader())
    ref.fit(jax_data.get_train_loader(), jax_data.get_val_loader())
    assert launches == (knn.knn_aggregate.launches, knn.knn_aggregate.bwd_launches)

    trained = convert.to_torch_state_dict(
        "graph_net", port_cfg, jax.tree.map(np.asarray, ref.params), jax.tree.map(np.asarray, ref.batch_stats))
    moved = convert.to_torch_state_dict("graph_net", port_cfg, params, stats)
    for key, value in port.model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), trained[key], rtol=0, atol=PARAM_ATOL, err_msg=key)
        assert not np.array_equal(value.numpy(), moved[key]), f"{key} did not train"
    ours, theirs = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    for tag in ("Loss/train", "Loss/val", "Accuracy/val"):
        assert len(ours[tag]) == len(theirs[tag]) == 2
        np.testing.assert_allclose(ours[tag], theirs[tag], rtol=METRIC_RTOL, err_msg=tag)
    y, p = port.predict(data.get_test_loader(), return_prob=True)
    y_ref, p_ref = ref.predict(jax_data.get_test_loader(), return_prob=True)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)


def test_train_model_and_resume_training(data_dir, tmp_path):
    cfg = _config(data_dir, tmp_path / "log", epochs=1)
    # train_model writes the run's names and directory into cfg
    log_dir = port_train.train_model("graph_net", "s2pg", cfg, return_log_dir=True, device="cpu")
    assert log_dir == str(tmp_path / "log" / "version_0")
    with open(os.path.join(log_dir, "meta.json")) as f:
        meta = json.load(f)
    assert (meta["dataset"], meta["model"]) == ("s2pg", "graph_net")
    artifacts = {"best_model.pt", "config.yaml", "meta.json", "metrics.jsonl", "model.pt", "state"}
    assert artifacts <= set(os.listdir(log_dir))
    with open(os.path.join(log_dir, "config.yaml")) as f:
        assert "knn_k: 4" in f.read()
    final = torch.load(os.path.join(log_dir, "model.pt"), weights_only=True)
    assert {"conv1.lin_rel.weight", "conv2.lin_root.weight", "bn1.running_mean"} <= set(final)

    # model.pt holds the weights and running statistics that gave meta's accuracy/val
    reloaded = factory.get_model("graph_net", cfg, device="cpu")
    reloaded.load(os.path.join(log_dir, "model.pt"))
    y, pred = reloaded.predict(factory.get_dataloader("s2pg", cfg).get_val_loader())
    assert round(port_train.accuracy(y, pred), 6) == meta["metrics"]["accuracy/val"]

    cfg["trainer"]["epochs"] = 3
    resumed = port_train.resume_training(log_dir, cfg, device="cpu")
    assert len(_metrics(log_dir)["Loss/train"]) == 3  # epoch 1, then 2 and 3
    for key, value in resumed.model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert not torch.equal(value, final[key]), f"{key} did not move after the resume"


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_one_selection_per_forward_serves_both_convolutions(monkeypatch, train):
    """The flat forward selects the topology once and hands that plan to both
    aggregations; the logits and the gradients are those of two calls that
    each select for themselves."""
    from point_cloud_classifier_tpu_torch.models import graph_net as graph_net_module

    batch = _to_torch(_flat_batch(seed=11))
    model = GraphNet(**_model_cfg(), generator=torch.Generator().manual_seed(2))
    selections, plans = [], []

    def select(*args):
        selections.append(args)
        return knn.knn_select(*args)

    def aggregate(h, positions, node_seg, k, num_graphs, aggr, plan):
        plans.append(plan)
        return knn.knn_aggregate(h, positions, node_seg, k, num_graphs, aggr, plan)

    monkeypatch.setattr(graph_net_module, "knn_select", select)
    monkeypatch.setattr(graph_net_module, "knn_aggregate", aggregate)
    logits = model(batch, train=train)
    logits.sum().backward()
    grads = [p.grad.clone() for p in model.parameters()]
    assert len(selections) == 1 and len(plans) == 2 and plans[0] is plans[1] is not None
    assert plans[0].k == _model_cfg()["knn_k"] and plans[0].num_graphs == batch["y"].shape[0]

    # the same forward with every aggregation selecting for itself
    monkeypatch.setattr(graph_net_module, "knn_select", lambda *args: None)
    monkeypatch.setattr(graph_net_module, "knn_aggregate", knn.knn_aggregate)
    model.zero_grad()
    if train:  # the first forward moved the running statistics
        model.load_state_dict(GraphNet(**_model_cfg(), generator=torch.Generator().manual_seed(2)).state_dict())
    alone = model(batch, train=train)
    alone.sum().backward()
    assert torch.equal(alone, logits)
    assert all(torch.equal(p.grad, g) for p, g in zip(model.parameters(), grads))

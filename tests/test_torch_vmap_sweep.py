"""The port's vmapped sweep arms on the CPU: each kernel op's autograd
Function under ``torch.func.vmap(torch.func.grad(...))`` (its plain CPU
version, through the same ``vmap`` rule the card takes) against a per-arm
loop; ``parallel/vmap_sweep.train_configs_vmapped`` against K sequential
``ModelWrapper`` runs for each arm family of the JAX package's
``tests/test_vmap_sweep.py``; and against the JAX ``train_configs_vmapped``
from the JAX init, for an FCN with BatchNorm and for DeepSets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.func import grad, vmap  # noqa: E402

from point_cloud_classifier_tpu.data.batching import PointCloudLoader as JaxPointCloudLoader  # noqa: E402
from point_cloud_classifier_tpu.models import DeepSets as JaxDeepSets  # noqa: E402
from point_cloud_classifier_tpu.models import FullyConnectedNet as JaxFCN  # noqa: E402
from point_cloud_classifier_tpu.parallel.vmap_sweep import (  # noqa: E402
    train_configs_vmapped as jax_train_configs_vmapped,
)
from point_cloud_classifier_tpu_torch import convert  # noqa: E402
from point_cloud_classifier_tpu_torch.data.batching import (  # noqa: E402
    GraphLoader,
    PointCloudLoader,
    TabularLoader,
)
from point_cloud_classifier_tpu_torch.models import (  # noqa: E402
    DeepSets,
    FullyConnectedNet,
    GraphNet,
    ModelWrapper,
)
from point_cloud_classifier_tpu_torch.ops import dispatch, fused_phi, gat, inrow_graph, knn  # noqa: E402
from point_cloud_classifier_tpu_torch.parallel import train_configs_vmapped  # noqa: E402
from point_cloud_classifier_tpu_torch.utils.metrics import accuracy  # noqa: E402

# the same op per arm: only the loss's own reduction may round otherwise
OP = dict(rtol=1e-6, atol=1e-7)
# vmapped against sequential: the same f32 math, its matrix products batched
# (other summation orders), over a few Adam steps
PARAM_ATOL = 1e-5
VAL_ACC_ATOL = 1e-6
# against the JAX package: the tolerances of the fit parity tests
# (test_torch_tabular.py, test_torch_deep_sets.py): weights within 1e-5
# after a few Adam steps, probabilities within rtol 1e-5, atol 1e-6
JAX_PARAM_ATOL = 1e-5
JAX_PROBS = dict(rtol=1e-5, atol=1e-6)
# A Linear's bias ahead of a BatchNorm has a gradient of 0 in exact
# arithmetic; each route's rounding leaves ~1e-9 that Adam scales to steps
# near lr, so those biases and the running means that take them in drift
# apart (as in test_torch_tabular.py).  Train-mode outputs do not see them;
# they are held by swapping one run's into the other and comparing outputs.
FCN_FREE = ("network.0.bias", "network.3.bias", "network.1.running_mean", "network.4.running_mean")
# The same for fc1's bias ahead of bn3 over four graphs' rows through a tanh
# that is nearly linear there (drift 2.4e-5 at lr 1e-2), and for conv2's
# att_dst after SAG, whose gradient vanishes in exact arithmetic where every
# logit of a node's softmax lies on one side of the LeakyReLU (a shift of
# s_dst leaves the softmax as it was; drift 1.4e-3 at lr 1e-2).
SAG_MAX_FREE = ("fc1.bias", "bn3.running_mean")
GAT_SAG_FREE = ("conv2.att_dst",)
K = 3


def _rng_tensor(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _vmap_against_loop(loss, batched, shared, argnums):
    """``vmap(grad(loss))`` over the arm axis of ``batched`` against the
    per-arm loop of ``grad(loss)``; also the forward values."""
    in_dims = (0,) * len(batched) + (None,) * len(shared)
    got = vmap(grad(loss, argnums=argnums), in_dims=in_dims)(*batched, *shared)
    for arm in range(batched[0].shape[0]):
        want = grad(loss, argnums=argnums)(*(t[arm] for t in batched), *shared)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[arm], w, **OP)


# -- each kernel op under vmap(grad) ------------------------------------------------


@pytest.mark.parametrize("points_per_arm", [False, True], ids=["shared-points", "points-per-arm"])
def test_phi_pool_function_under_vmap_grad_equals_the_per_arm_loop(points_per_arm):
    rng = np.random.default_rng(0)
    p, s = 97, 6
    seg = torch.from_numpy(np.sort(rng.integers(0, s, size=p)).astype(np.int32))
    spec = (("plain", False), ("residual", False))
    weights = [_rng_tensor(rng, K, 6, 16) * 0.4, _rng_tensor(rng, K, 16) * 0.1,
               _rng_tensor(rng, K, 16, 16) * 0.25, _rng_tensor(rng, K, 16) * 0.1]
    points = _rng_tensor(rng, K, p, 6) if points_per_arm else _rng_tensor(rng, p, 6)
    cot = _rng_tensor(rng, s, 16)

    def loss(w0, b0, w1, b1, pts):
        return (fused_phi.phi_pool(pts, seg, spec, ((w0, b0), (w1, b1)), "gelu", s) * cot).sum()

    if points_per_arm:
        _vmap_against_loop(loss, [*weights, points], [], argnums=(0, 1, 2, 3, 4))
    else:
        _vmap_against_loop(loss, weights, [points], argnums=(0, 1, 2, 3))
    if not points_per_arm:  # the forward values too
        pooled = vmap(lambda w0, b0, w1, b1: fused_phi.phi_pool(
            points, seg, spec, ((w0, b0), (w1, b1)), "gelu", s))(*weights)
        for arm in range(K):
            layers = ((weights[0][arm], weights[1][arm]), (weights[2][arm], weights[3][arm]))
            want = fused_phi.phi_pool_plain(points, seg, spec, layers, "gelu", s)
            torch.testing.assert_close(pooled[arm], want, rtol=0, atol=0)


def _gat_operands(rng, b=2, m=13, d=4, h=2, c=8):
    in_src = torch.from_numpy(rng.integers(0, m, size=(b, m, d)).astype(np.int32))
    in_w = torch.from_numpy((rng.random((b, m, d)) * (rng.random((b, m, d)) < 0.7)).astype(np.float32))
    return in_src, in_w, (_rng_tensor(rng, K, b, m, h), _rng_tensor(rng, K, b, m, h), _rng_tensor(rng, K, b, m, c))


@pytest.mark.parametrize("lists", ["shared", "keep-masked-per-arm"])
def test_gat_function_and_mirror_under_vmap_grad_equal_the_per_arm_loop(lists):
    rng = np.random.default_rng(1)
    in_src, in_w, feats = _gat_operands(rng)
    cot = _rng_tensor(rng, *feats[2].shape[1:])
    keep = torch.from_numpy((rng.random((K,) + tuple(in_w.shape)) < 0.6).astype(np.float32))

    def loss(s_dst, s_src, xw, w):
        mirror = gat.gat_out_rows(in_src, w)
        out = gat._GatAttentionFn.apply(s_dst, s_src, in_src, w, xw, gat.SLOPE, *mirror)
        return (out * cot).sum()

    if lists == "shared":
        _vmap_against_loop(loss, list(feats), [in_w], argnums=(0, 1, 2))
    else:
        masked = in_w * keep
        _vmap_against_loop(loss, [*feats, masked], [], argnums=(0, 1, 2))
        mirrors = vmap(gat.gat_out_rows)(in_src.expand(K, *in_src.shape), masked)
        for arm in range(K):
            want = gat.gat_out_rows_plain(in_src, masked[arm])
            assert torch.equal(mirrors.out_off[arm], want.out_off)
            assert torch.equal(mirrors.out_dst[arm], want.out_dst)
    # the Function's closed-form backward is the plain version's autograd
    s_dst, s_src, xw = (t[0].clone().requires_grad_() for t in feats)
    (gat.gat_attention_plain(s_dst, s_src, in_src, in_w, xw) * cot).sum().backward()
    want = grad(loss, argnums=(0, 1, 2))(feats[0][0], feats[1][0], feats[2][0], in_w)
    for g, w in zip((s_dst.grad, s_src.grad, xw.grad), want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def _inrow_operands(rng, b=2, m=11, d=4, width=5):
    in_src = np.stack([np.stack([rng.permutation(m)[:d] for _ in range(m)]) for _ in range(b)]).astype(np.int32)
    in_w = (rng.random((b, m, d)) * (rng.random((b, m, d)) < 0.7)).astype(np.float32)
    adj = np.zeros((b, m, m), np.float32)
    np.add.at(adj, (np.arange(b)[:, None, None], np.arange(m)[None, :, None], in_src), in_w)
    adj_t = np.swapaxes(adj, 1, 2)
    d_out = max(1, int((adj_t != 0).sum(axis=2).max()))
    out_dst = np.zeros((b, m, d_out), np.int32)
    out_w = np.zeros((b, m, d_out), np.float32)
    for g in range(b):
        for row in range(m):
            cols = np.flatnonzero(adj_t[g, row])
            out_dst[g, row, : len(cols)], out_w[g, row, : len(cols)] = cols, adj_t[g, row, cols]
    return (*map(torch.from_numpy, (in_src, in_w, out_dst, out_w)), _rng_tensor(rng, K, b, m, width))


@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("weights", ["shared", "per-arm"])
def test_inrow_function_under_vmap_grad_equals_the_per_arm_loop(aggr, weights):
    rng = np.random.default_rng(2)
    in_src, in_w, out_dst, out_w, h = _inrow_operands(rng)
    cot = _rng_tensor(rng, *h.shape[1:])

    def loss(hh, w):
        return (inrow_graph.inrow_aggregate(hh, in_src, w, out_dst, out_w, aggr) * cot).sum()

    if weights == "shared":
        _vmap_against_loop(loss, [h], [in_w], argnums=(0,))
    else:
        # a per-arm in_w also takes its cotangent (the row gather and dot)
        scaled = in_w * torch.from_numpy(rng.uniform(0.5, 1.5, size=(K, 1, 1, 1)).astype(np.float32))
        _vmap_against_loop(loss, [h, scaled], [], argnums=(0, 1))


@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_knn_function_under_vmap_grad_equals_the_per_arm_loop(aggr):
    rng = np.random.default_rng(3)
    n, graphs = 40, 3
    seg = torch.from_numpy(np.repeat(np.arange(graphs + 1, dtype=np.int32), [12, 15, 9, 4]))
    pos = torch.from_numpy((np.round(rng.normal(size=(n, 3)) * 16) / 16).astype(np.float32))
    plan = knn.knn_select(pos, seg, 4, graphs)
    x = _rng_tensor(rng, K, n, 6)
    cot = _rng_tensor(rng, n, 6)

    def loss(xx):
        return (knn.knn_aggregate(xx, pos, seg, 4, graphs, aggr, plan) * cot).sum()

    _vmap_against_loop(loss, [x], [], argnums=(0,))


def test_a_wrapped_tensor_never_reaches_a_kernel_binding():
    """The guard every C entry's wrapper calls: a batched or gradient-tracking
    tensor raises before a pointer is read."""
    x = torch.zeros(3, 4)
    with pytest.raises(TypeError, match="vmap rule"):
        vmap(lambda t: (dispatch.require_plain_tensors(t), t)[1])(x)
    with pytest.raises(TypeError, match="vmap rule"):
        grad(lambda t: (dispatch.require_plain_tensors(t), t.sum())[1])(x)
    dispatch.require_plain_tensors(x)


def test_deep_sets_routes_chains_too_wide_for_the_kernels_to_the_plain_path():
    """φ [1024] × 4 does not fit K2's 8-row tile: DeepSets takes the plain
    path for it before any launch; φ [1024] × 3 and every narrower sampled
    chain take the kernels."""
    def model(n):
        return DeepSets(input_dim=6, phi_layers=[1024] * n, rho_layers=[128], output_dim=1,
                        activation="gelu", layer_norm=False, residual_block=True, pooling="mean")

    assert model(3)._use_kernel() and not model(4)._use_kernel()
    assert not fused_phi.kernel_takes_chain([6] + [1024] * 3 + [1024], ["plain"] + ["residual"] * 2 + ["linear"])
    assert fused_phi.kernel_takes_chain([6] + [512] * 4 + [512], ["plain"] + ["residual"] * 3 + ["linear"])


# -- train_configs_vmapped against sequential runs ------------------------------------


def _tabular(seed, b=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 9)).astype(np.float32)
    y = (x[:, :1] + 0.5 * rng.normal(size=(b, 1)) > 0).astype(np.float32)
    return {"x": x, "y": y, "y_mask": np.ones((b,), np.float32)}


def _tabular_loaders():
    return [_tabular(s) for s in range(4)], [_tabular(99, 64)]


def _clouds(n=24):
    rng = np.random.default_rng(0)
    events = [rng.normal(size=(rng.integers(5, 80), 6)).astype(np.float32) for _ in range(n)]
    labels = np.array([float(e[:, 0].mean() > 0) for e in events])
    return events, labels


def _graphs(n=16, weighted=True, seed=5):
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(n):
        size = int(rng.integers(3, 10))
        pairs = sorted({(int(a), int(b)) for a, b in rng.integers(0, size, size=(2 * size, 2)) if a != b})
        edges = np.array(pairs, dtype=np.int32).T.reshape(2, -1)
        w = rng.uniform(0.1, 1.0, size=(edges.shape[1],)) if weighted else np.ones(edges.shape[1])
        graphs.append({"features": rng.normal(size=(size, 4)).astype(np.float32), "edges": edges,
                       "weights": w.astype(np.float32), "label": float(i % 2)})
    return graphs


FAMILIES = {
    # the JAX tests' arm families (tests/test_vmap_sweep.py)
    "fcn-bn": (FullyConnectedNet, dict(input_dim=9, hidden_layers=[16, 16], batch_normalization=True,
                                       output_dim=1), "adam", 3, _tabular_loaders, FCN_FREE),
    "fcn-adamw-shuffled": (FullyConnectedNet, dict(input_dim=9, hidden_layers=[8], batch_normalization=False,
                                                   output_dim=1), "adamw", 3,
                           lambda: (TabularLoader(*_xy(200), batch_size=32, shuffle=True, seed=4),
                                    TabularLoader(*_xy(64, 9), batch_size=32, shuffle=False)), ()),
    "deep-sets": (DeepSets, dict(input_dim=6, phi_layers=[16], rho_layers=[16], output_dim=1,
                                 activation="gelu", layer_norm=False, pooling="mean"), "adamw", 2,
                  lambda: (PointCloudLoader(_clouds()[0][:16], _clouds()[1][:16], batch_size=8, shuffle=False,
                                            min_bucket=64),
                           PointCloudLoader(_clouds()[0][16:], _clouds()[1][16:], batch_size=8, shuffle=False,
                                            min_bucket=64)), ()),
    "graphconv-dense-inrow": (GraphNet, dict(input_dim=4, hidden_dim=8, output_dim=1, activation="tanh",
                                             local_pooling="add", deepchem_style=True), "adam", 2,
                              lambda: (GraphLoader(_graphs()[:12], batch_size=4, shuffle=False, layout="dense"),
                                       GraphLoader(_graphs()[12:], batch_size=4, shuffle=False, layout="dense")), ()),
    "sag-max-flat": (GraphNet, dict(input_dim=4, hidden_dim=8, output_dim=1, activation="tanh", sag_pool=True,
                                    local_pooling="max", deepchem_style=False), "adamw", 2,
                     lambda: (GraphLoader(_graphs(weighted=False, seed=7)[:12], batch_size=4, shuffle=False,
                                          layout="flat", use_weights=False),
                              GraphLoader(_graphs(weighted=False, seed=7)[12:], batch_size=4, shuffle=False,
                                          layout="flat", use_weights=False)), SAG_MAX_FREE),
    "gat-sag-inrow": (GraphNet, dict(input_dim=4, hidden_dim=8, output_dim=1, activation="tanh", use_gat=True,
                                     gat_heads=2, sag_pool=True, deepchem_style=True), "adam", 2,
                      lambda: (GraphLoader(_graphs()[:12], batch_size=4, shuffle=False, layout="dense",
                                           use_weights=False),
                               GraphLoader(_graphs()[12:], batch_size=4, shuffle=False, layout="dense",
                                           use_weights=False)), GAT_SAG_FREE),
}


def _xy(n, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 9)).astype(np.float32)
    return x, (x[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(np.float32)


def _sequential(cls, cfg, lr, seed, optimizer, epochs, loaders):
    train, val = loaders()
    net = cls(**cfg, generator=torch.Generator().manual_seed(seed))
    wrapper = ModelWrapper(net, learning_rate=lr, epochs=epochs, optimizer=optimizer, seed=seed, device="cpu")
    wrapper.fit(train, val)
    y, pred = wrapper.predict(val)
    return wrapper, accuracy(y, pred)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_vmapped_arms_match_sequential_runs(family):
    """K vmapped arms equal K sequential ``ModelWrapper`` runs with the same
    seeds and learning rates: val accuracy within 1e-6, final weights within
    1e-5 (a BatchNorm's free biases: the outputs with them swapped in)."""
    cls, cfg, optimizer, epochs, loaders, free = FAMILIES[family]
    lrs, seeds = [1e-2, 3e-3, 1e-3], [0, 1, 2]
    train, val = loaders()
    result = train_configs_vmapped(cls(**cfg), lrs, optimizer, epochs, train, val, seeds=seeds, device="cpu")
    assert set(result) == {"val_accs", "train_accs", "n_params", "final_state", "best_state", "best_improved"}
    for arm, (lr, seed) in enumerate(zip(lrs, seeds)):
        wrapper, val_acc = _sequential(cls, cfg, lr, seed, optimizer, epochs, loaders)
        state = wrapper._host_state_dict()
        ours = result["final_state"][arm]
        assert list(ours) == list(state)
        for key, value in state.items():
            if key not in free:
                np.testing.assert_allclose(ours[key].numpy(), value.numpy(), rtol=0, atol=PARAM_ATOL,
                                           err_msg=f"arm {arm} {key}")
        if free:  # with the sequential run's free tensors the val outputs agree
            wrapper.model.load_state_dict({**ours, **{k: state[k] for k in free}})
            y, pred = wrapper.predict(loaders()[1])
            assert accuracy(y, pred) == pytest.approx(val_acc, abs=VAL_ACC_ATOL)
            # and the vmapped val accuracy is that of its own final weights
            wrapper.model.load_state_dict(ours)
            y, pred = wrapper.predict(loaders()[1])
            assert result["val_accs"][arm] == pytest.approx(accuracy(y, pred), abs=VAL_ACC_ATOL)
        else:
            assert result["val_accs"][arm] == pytest.approx(val_acc, abs=VAL_ACC_ATOL), f"arm {arm}"
        assert result["best_improved"][arm]
    assert result["n_params"] == wrapper.get_trainable_parameters()


def test_vmapped_nan_arm_reports_no_best_improvement():
    """An arm whose loss goes NaN from the first epoch never improves: its
    best state is its initial one and ``best_improved`` says so; the healthy
    arm beside it keeps its flag."""
    train, val = _tabular_loaders()
    model = FullyConnectedNet(input_dim=9, hidden_layers=[8], batch_normalization=False, output_dim=1)
    result = train_configs_vmapped(model, [float("nan"), 1e-2], "adam", 3, train, val, device="cpu")
    assert result["best_improved"] == [False, True]
    init = FullyConnectedNet(input_dim=9, hidden_layers=[8], batch_normalization=False, output_dim=1,
                             generator=torch.Generator().manual_seed(0)).state_dict()
    for key, value in init.items():
        assert torch.equal(result["best_state"][0][key], value)
        assert torch.isnan(result["final_state"][0][key]).all()


def test_vmapped_arms_refuse_a_mesh_and_an_unknown_optimizer():
    """A mesh is ported (tests/test_torch_mesh_sweep.py splits the arms over
    2 and 4 ranks): on a world of one rank the arms train as without it.
    An unknown optimizer is refused."""
    import torch.distributed as dist

    from point_cloud_classifier_tpu_torch.parallel import make_mesh

    train, val = _tabular_loaders()
    model = FullyConnectedNet(input_dim=9, hidden_layers=[8], batch_normalization=False, output_dim=1)
    try:
        meshed = train_configs_vmapped(model, [1e-2, 1e-3], "adam", 1, train, val, mesh=make_mesh(device="cpu"),
                                       device="cpu")
    finally:
        dist.destroy_process_group()
    plain = train_configs_vmapped(model, [1e-2, 1e-3], "adam", 1, train, val, device="cpu")
    assert meshed["val_accs"] == plain["val_accs"]
    for a, b in zip(meshed["final_state"], plain["final_state"]):
        for key in a:
            assert torch.equal(a[key], b[key])
    with pytest.raises(ValueError, match="Unknown optimizer"):
        train_configs_vmapped(model, [1e-2], "sgd", 1, train, val, device="cpu")


def test_an_arm_stopped_early_freezes_while_the_others_train():
    """patience=1: an arm stalls once and freezes, its weights those of the
    epoch it stopped at, as a sequential run that stops early."""
    train, val = _tabular_loaders()
    cfg = dict(input_dim=9, hidden_layers=[8], batch_normalization=False, output_dim=1)
    lrs = [0.3, 1e-3]
    result = train_configs_vmapped(FullyConnectedNet(**cfg), lrs, "adam", 6, train, val, patience=1,
                                   device="cpu")
    for arm, lr in enumerate(lrs):
        net = FullyConnectedNet(**cfg, generator=torch.Generator().manual_seed(0))
        wrapper = ModelWrapper(net, learning_rate=lr, epochs=6, seed=0, device="cpu")
        wrapper.patience = 1
        wrapper.fit(train, val)
        for key, value in wrapper._host_state_dict().items():
            np.testing.assert_allclose(result["final_state"][arm][key].numpy(), value.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"arm {arm} {key}")


# -- against the JAX package -------------------------------------------------------------


def _jax_init(jax_model, first, seeds):
    return jax.vmap(lambda s: jax_model.init(jax.random.PRNGKey(s), first, train=False))(
        jnp.asarray(seeds, dtype=jnp.uint32))


def _arm(tree, arm):
    return jax.tree.map(lambda x: np.asarray(x)[arm], tree)


@pytest.mark.parametrize("family", ["fcn-bn", "deep-sets"])
def test_vmapped_arms_match_the_jax_vmapped_arms(family):
    """From the JAX package's ``jax.vmap(model.init)`` over the same seeds,
    carried across by ``convert.py``, the port's arms end where the JAX
    ``train_configs_vmapped``'s do: weights within 1e-5 (the fit parity
    tests' tolerance; a BatchNorm's free biases aside), and the eval
    probabilities on the val batches within rtol 1e-5, atol 1e-6 once the
    JAX run's free tensors are swapped in."""
    lrs, seeds = [1e-2, 1e-3], [0, 1]
    if family == "fcn-bn":
        cfg = dict(input_dim=9, hidden_layers=[16, 16], batch_normalization=True, output_dim=1)
        name, cls, jax_model, optimizer, epochs, free = "fully_connected_net", FullyConnectedNet, JaxFCN(**cfg), \
            "adam", 3, FCN_FREE
        train, val = _tabular_loaders()
        jax_train, jax_val = _tabular_loaders()
    else:
        cfg = dict(input_dim=6, phi_layers=[16], rho_layers=[16], output_dim=1, activation="gelu",
                   layer_norm=False, pooling="mean")
        name, cls, jax_model, optimizer, epochs, free = "deep_sets", DeepSets, JaxDeepSets(**cfg), "adamw", 2, ()
        events, labels = _clouds()
        train, val = (PointCloudLoader(events[a:b], labels[a:b], batch_size=8, shuffle=False, min_bucket=64)
                      for a, b in ((0, 16), (16, 24)))
        jax_train, jax_val = (JaxPointCloudLoader(events[a:b], labels[a:b], batch_size=8, shuffle=False,
                                                  min_bucket=64) for a, b in ((0, 16), (16, 24)))
    variables = _jax_init(jax_model, next(iter(jax_train)), seeds)
    config = {"model": cfg}
    init_states = [convert.to_torch_state_dict(name, config, _arm(variables["params"], arm),
                                               _arm(variables.get("batch_stats", {}), arm))
                   for arm in range(len(seeds))]
    ours = train_configs_vmapped(cls(**cfg), lrs, optimizer, epochs, train, val, seeds=seeds,
                                 init_states=init_states, device="cpu")
    theirs = jax_train_configs_vmapped(jax_model, lrs, optimizer, epochs, jax_train, jax_val, seeds=seeds)
    model = cls(**cfg)
    for arm in range(len(seeds)):
        ref = {k: torch.tensor(np.asarray(v)) for k, v in convert.to_torch_state_dict(
            name, config, theirs["final_state"][arm]["params"], theirs["final_state"][arm]["batch_stats"]).items()}
        for key, value in ref.items():
            if key not in free:
                np.testing.assert_allclose(ours["final_state"][arm][key].numpy(), value.numpy(), rtol=0,
                                           atol=JAX_PARAM_ATOL, err_msg=f"arm {arm} {key}")
        probs = []
        for state in ({**ours["final_state"][arm], **{k: ref[k] for k in free}}, ref):
            model.load_state_dict({k: v.to(model.state_dict()[k].dtype) for k, v in state.items()})
            wrapper = ModelWrapper(model, learning_rate=1e-3, epochs=1, device="cpu")
            probs.append(wrapper.predict(val, return_prob=True)[1])
        np.testing.assert_allclose(probs[0], probs[1], **JAX_PROBS)
        if not free:
            assert ours["val_accs"][arm] == pytest.approx(theirs["val_accs"][arm], abs=VAL_ACC_ATOL)
    assert ours["n_params"] == theirs["n_params"]
    assert ours["best_improved"] == theirs["best_improved"]

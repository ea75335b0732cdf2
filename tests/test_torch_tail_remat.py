"""``fused_phi="tail"``, ``PCC_PHI_REMAT`` and ``PCC_GRAPH_REMAT`` in the
port, on the CPU.

- The tail route (the hidden φ chain on the plain path, then the final
  linear and the pooling through ``phi_pool``'s pair over a one-layer chain)
  against the JAX ``fused_phi="tail"``: on the flat wire the JAX side runs
  its Pallas pair in interpret mode, as the JAX package's tests run it; on
  the dense wire it takes XLA with the post-pool linear (the port keeps the
  pair there, ``docs/parity_torch.md`` §10).  Train-mode logits and every
  gradient within 1e-5.
- Rematerialisation changes no bit: the φ chain's (``PCC_PHI_REMAT=1``
  against ``0``) and the GraphNet head's (``PCC_GRAPH_REMAT=1`` against
  ``0``), gradients and BatchNorm running statistics both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu_torch import convert  # noqa: E402
from point_cloud_classifier_tpu_torch.models import DeepSets, GraphNet  # noqa: E402
from point_cloud_classifier_tpu_torch.models.wrapper import masked_bce  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi  # noqa: E402
from tests.test_torch_deep_sets import (  # noqa: E402
    _port_grads,
    _scaled_err,
    jax_and_port,
    model_cfg,
    wire_batch,
)

F32 = 1e-5  # the same math in f32 in other summation orders


@pytest.mark.parametrize(
    "wire, pooling, extra",
    [("flat", "sum", {}), ("flat", "mean", {}), ("dense", "sum", {}), ("dense", "mean", {}),
     ("flat", "mean", {"layer_norm": True}), ("flat", "sum", {"factored_cols": (1,)}),
     ("flat", "max", {})],
    ids=["flat-sum", "flat-mean", "dense-sum", "dense-mean", "flat-layer-norm", "flat-factored", "flat-max"],
)
def test_tail_matches_jax_forward_and_gradients(wire, pooling, extra):
    cfg = model_cfg(pooling=pooling, fused_phi="tail", **extra)
    batch = wire_batch(wire, factored=tuple(extra.get("factored_cols", ())))
    jax_model, variables, port = jax_and_port(cfg, batch)
    assert port._tail() == (pooling != "max") and not port._use_kernel()
    assert not port._post_pool() or pooling == "max"
    cot = np.random.default_rng(4).normal(size=(6, 1)).astype(np.float32)

    def loss(p):
        logits = jax_model.apply({"params": p}, batch, train=True)
        return jnp.sum(logits * cot), logits

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    want = convert.to_torch_state_dict("deep_sets", {"model": cfg}, jax.tree.map(np.asarray, grads), {})
    calls = []
    original = fused_phi._PhiPoolFn.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_phi._PhiPoolFn, "apply", lambda *a: calls.append(a[2:5]) or original(*a))
        out, got = _port_grads(port.train(), batch, cot)
    if pooling == "max":
        assert calls == []
    else:
        # one bare linear [H, H]: an empty spec, one (w, b) pair
        spec, activation, num_segments = calls[0]
        assert len(calls) == 1 and spec == () and num_segments == 7
    assert out.shape == (6, 1) and _scaled_err(out, np.asarray(ref)) <= F32
    assert set(got) == set(want)
    for key, g in got.items():
        assert _scaled_err(g, want[key]) <= F32, key


def test_tail_single_layer_backward_matches_autograd():
    """The pair's plain backward over a chain of one bare linear layer, the
    ``d_points`` that the hidden chain's gradient flows through included,
    against autograd of the plain forward, in f64."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(50, 8))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(8, 8))).requires_grad_()
    b = torch.from_numpy(rng.normal(size=(8,))).requires_grad_()
    seg = torch.from_numpy(np.sort(rng.integers(0, 6, size=50)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(6, 8)))
    out = fused_phi.phi_pool(h, seg, (), ((w, b),), "gelu", 6)
    d = torch.autograd.grad((out * g).sum(), (h, w, b))
    ref = fused_phi.phi_pool_plain(h, seg, (), ((w, b),), "gelu", 6)
    d_ref = torch.autograd.grad((ref * g).sum(), (h, w, b))
    for got, want in zip(d, d_ref):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_tail_falls_back_to_nothing_for_a_chain_the_kernels_cannot_hold():
    """The tail's one-layer chain fits the kernels' tiles at every width the
    sampler draws; max pooling is not a tail route."""
    for width in (128, 256, 512, 1024):
        assert fused_phi.kernel_takes_chain([width, width], ["linear"])
        assert DeepSets(**model_cfg(phi_layers=[width], fused_phi="tail"))._tail()
    assert not DeepSets(**model_cfg(fused_phi="tail", pooling="max"))._tail()


def _deep_sets_step(cfg, batch, seed=0):
    torch.manual_seed(seed)
    port = DeepSets(**cfg, generator=torch.Generator().manual_seed(seed)).train()
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = port(t, train=True)
    masked_bce(logits, t["y"], t["y_mask"]).backward()
    return logits.detach(), {k: p.grad.clone() for k, p in port.named_parameters()}


@pytest.mark.parametrize(
    "extra", [{"layer_norm": True}, {"pooling": "max"}, {"fused_phi": "off"},
              {"fused_phi": "off", "phi_layers": [512, 512]}],
    ids=["layer-norm", "max", "off", "off-512"])
def test_phi_remat_changes_no_bit(monkeypatch, extra):
    cfg = model_cfg(**{"phi_layers": [32, 32], **extra})
    batch = wire_batch("flat")
    calls = []
    original = fused_phi.checkpoint
    monkeypatch.setattr(fused_phi, "checkpoint", lambda *a, **k: calls.append(1) or original(*a, **k))
    monkeypatch.setenv("PCC_PHI_REMAT", "0")
    ref = _deep_sets_step(cfg, batch)
    assert calls == []
    monkeypatch.setenv("PCC_PHI_REMAT", "1")
    got = _deep_sets_step(cfg, batch)
    assert len(calls) == len(cfg["phi_layers"])  # one span a hidden layer
    assert torch.equal(got[0], ref[0])
    for key, g in got[1].items():
        assert torch.equal(g, ref[1][key]), key


@pytest.mark.parametrize(
    "extra", [{"fused_phi": "off"}, {"fused_phi": "off", "phi_layers": [384]},
              {"fused_phi": "off", "phi_layers": [512, 512]}, {"layer_norm": True}, {"pooling": "max"}],
    ids=["off-32", "off-384", "off-512", "layer-norm", "max"])
def test_phi_remat_auto_follows_the_card(monkeypatch, extra):
    """``auto`` and ``0`` keep the activations at every width (the JAX
    package's ``auto`` recomputes post-pool chains up to 384 wide; on the
    card the recomputation measured slower at every width); ``1`` forces
    the recomputation."""
    model = DeepSets(**model_cfg(**extra))
    monkeypatch.delenv("PCC_PHI_REMAT", raising=False)
    assert not model._remat()
    monkeypatch.setenv("PCC_PHI_REMAT", "0")
    assert not model._remat()
    monkeypatch.setenv("PCC_PHI_REMAT", "1")
    assert model._remat()


def _graph_batch(layout="dense", **kw):
    from point_cloud_classifier_tpu_torch.data import GraphLoader
    from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs

    graphs = lineage_graphs(np.random.default_rng(3), 8, 12, 30)
    batch = next(iter(GraphLoader(graphs, 8, shuffle=False, layout=layout, **kw)))
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize(
    "model", [{}, {"use_gat": True}, {"sag_pool": True}, {"fused_inrow": True}],
    ids=["graphconv", "gat", "sag", "fused-inrow"])
def test_graph_remat_changes_no_bit(monkeypatch, model):
    """Two train steps' logits, gradients and BatchNorm running statistics
    with the head rematerialised equal those without, bit for bit: the
    recomputation in the backward moves no running statistic."""
    batch = _graph_batch(use_weights=not model.get("use_gat"), emit_out_rows=bool(model.get("fused_inrow")))
    cfg = dict(input_dim=4, hidden_dim=16, output_dim=1, activation="tanh", deepchem_style=True, **model)

    def run(remat):
        monkeypatch.setenv("PCC_GRAPH_REMAT", remat)
        net = GraphNet(**cfg, generator=torch.Generator().manual_seed(0)).train()
        heads = []
        original = net.bn3.forward
        net.bn3.forward = lambda *a, **k: heads.append(k.get("update_stats", True)) or original(*a, **k)
        outs = []
        for _ in range(2):
            net.zero_grad()
            logits = net(batch, train=True)
            masked_bce(logits, batch["y"], batch["y_mask"]).backward()
            outs.append((logits.detach(), {k: p.grad.clone() for k, p in net.named_parameters()},
                         {k: b.clone() for k, b in net.named_buffers()}))
        return outs, heads

    ref, heads_ref = run("0")
    got, heads = run("1")
    assert heads_ref == [True, True] and heads == [True, False, True, False]
    for (lg, gg, bg), (lr, gr, br) in zip(got, ref):
        assert torch.equal(lg, lr)
        for key in gr:
            assert torch.equal(gg[key], gr[key]), key
        for key in br:
            assert torch.equal(bg[key], br[key]), key
    # the running statistics moved once a step
    fresh = GraphNet(**cfg, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(ref[0][2]["bn3.running_mean"], fresh.bn3.running_mean)


def test_graph_remat_is_off_in_eval_and_without_gradients(monkeypatch):
    monkeypatch.setenv("PCC_GRAPH_REMAT", "1")
    batch = _graph_batch(use_weights=True)
    net = GraphNet(input_dim=4, hidden_dim=16, output_dim=1, activation="tanh", deepchem_style=True,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = net(batch, train=False)
    monkeypatch.setenv("PCC_GRAPH_REMAT", "0")
    with torch.no_grad():
        b = net(batch, train=False)
    assert torch.equal(a, b)

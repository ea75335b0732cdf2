"""kNN membership off any grid: how often the port's ``knn_adjacency`` and the
JAX package's choose different neighbours, and what that does to the logits.

The two form the squared distance differently: the JAX package as
``|a|² + |b|² − 2·(a·b)`` with a matrix product
(``point_cloud_classifier_tpu/ops/knn.py``), the port with every step rounded
on its own (``ops/knn.py``, the order K5 repeats on the card).  On a position
grid every distance is exact and the choices are equal
(``test_torch_knn_slice.py``); with seeded random f32 positions a distance
that cancels can round apart and flip a neighbour at the k-th place.  Read on
x86 with these seeds:

- standardized positions as the synthetic caches hold them without
  ``position_grid`` (graphs of 160-288 nodes, k = 4 and 8): 0 of 7,610 rows
  differ at either k;
- the same positions scaled by 100 and shifted by 50 (raw detector
  coordinates, where ``|a|²`` dwarfs the distance): 1 of 7,610 rows at k = 4,
  0 at k = 8;
- logits of the narrow GraphNet over 8 seeded flat batches of graphs of 12-40
  nodes without a grid, add and mean: 0 of 1,676 rows differ, and the largest
  change in a logit is 4.2e-7 (relative to max(1, max |logit|)).

The bounds below leave room for another BLAS: a share of 1e-3 of rows for
standardized positions, 5e-3 shifted, and 1e-5 on the logits where no row
differs.  ``docs/parity_torch.md`` carries the same numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.data.batching import GraphLoader as JaxGraphLoader  # noqa: E402
from point_cloud_classifier_tpu.models import GraphNet as JaxGraphNet  # noqa: E402
from point_cloud_classifier_tpu.ops import knn as jax_knn  # noqa: E402
from point_cloud_classifier_tpu_torch import convert  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs  # noqa: E402
from point_cloud_classifier_tpu_torch.models import GraphNet  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import knn  # noqa: E402

SHARE_BOUND = {"standardized": 1e-3, "shifted": 5e-3}
LOGIT_BOUND = 1e-5
SLOTS = 8


def _differing_rows(pos, seg, k):
    want = np.asarray(jax_knn.knn_adjacency(jnp.asarray(pos), jnp.asarray(seg), k, SLOTS))
    got = knn.knn_adjacency(torch.from_numpy(pos), torch.from_numpy(seg), k, SLOTS).numpy()
    return int(((want != got).any(axis=1) & (seg < SLOTS)).sum())


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("scale", ["standardized", "shifted"])
def test_share_of_rows_with_another_neighbour_set(scale, k):
    rows = differ = 0
    for seed in range(4):
        graphs = lineage_graphs(np.random.default_rng(seed), SLOTS, 160, 288)  # no position_grid
        pos = np.concatenate([g["features"][:, 1:4] for g in graphs]).astype(np.float32)
        assert np.abs(pos * 64 - np.round(pos * 64)).max() > 1e-3  # off the parity tests' grid
        if scale == "shifted":
            pos = pos * np.float32(100) + np.float32(50)
        seg = np.concatenate(
            [np.full(len(g["features"]), i, np.int32) for i, g in enumerate(graphs)])
        rows += len(seg)
        differ += _differing_rows(pos, seg, k)
    print(f"kNN off the grid, {scale}, k={k}: {differ} of {rows} rows differ")
    assert rows > 7000 and differ / rows <= SHARE_BOUND[scale]


@pytest.mark.parametrize("local_pooling", ["add", "mean"])
def test_logits_off_the_grid(local_pooling):
    """The narrow GraphNet (``knn_k = 4``) on flat batches without a grid: the
    rows that differ, and the largest change in a logit."""
    cfg = dict(input_dim=4, hidden_dim=16, output_dim=1, activation="tanh", use_gat=False,
               gat_heads=4, sag_pool=False, pool_ratio=0.5, local_pooling=local_pooling,
               global_pooling="mean", deepchem_style=True, compute_dtype="float32", knn_k=4)
    rows = differ = 0
    worst = 0.0
    for seed in range(8):
        graphs = lineage_graphs(np.random.default_rng(seed), SLOTS, 12, 40)
        for g in graphs:
            g["features"] = g["features"].astype(np.float32)
        batch = next(iter(JaxGraphLoader(graphs, SLOTS, shuffle=False, layout="flat")))
        seg = batch["node_seg"].astype(np.int32)
        rows += int((seg < SLOTS).sum())
        differ += _differing_rows(batch["nodes"][:, 1:4].astype(np.float32), seg, 4)
        import jax

        variables = JaxGraphNet(**cfg).init(jax.random.PRNGKey(seed), batch, train=False)
        rng = np.random.default_rng(seed + 100)
        params = jax.tree.map(
            lambda a: (np.asarray(a) + rng.uniform(-0.2, 0.2, np.shape(a))).astype(np.float32),
            variables["params"])
        stats = jax.tree.map(
            lambda a: (np.asarray(a) + rng.uniform(0.0, 0.5, np.shape(a))).astype(np.float32),
            variables["batch_stats"])
        want = np.asarray(
            JaxGraphNet(**cfg).apply({"params": params, "batch_stats": stats}, batch, train=False))
        model = GraphNet(**cfg)
        sd = convert.to_torch_state_dict("graph_net", {"model": cfg}, params, stats)
        model.load_state_dict({key: torch.as_tensor(v) for key, v in sd.items()}, strict=True)
        with torch.no_grad():
            got = model({key: torch.from_numpy(np.asarray(v)) for key, v in batch.items()},
                        train=False).numpy()
        worst = max(worst, float(np.abs(got - want).max() / max(1.0, np.abs(want).max())))
    print(f"kNN off the grid, logits {local_pooling}: {differ} of {rows} rows differ, "
          f"largest relative change {worst:.3e}")
    assert rows > 1500 and differ / rows <= SHARE_BOUND["standardized"]
    if differ == 0:
        assert worst <= LOGIT_BOUND

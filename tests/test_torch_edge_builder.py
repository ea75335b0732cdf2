"""The port's S2PG builders against the JAX package's ``data/graph.py``,
exactly: the numpy ones (``nearest_recorded_ancestors``,
``build_event_edges``, ``gaussian_edge_weights``,
``scale_positions_inplace``) and the C++ edge builder
(``csrc/host/edge_builder.cpp`` through ``build_event_edges_native``), on
seeded lineage trees with unrecorded ancestors, several parents, the memo
cache's duplicate edges, tied times, and the two checks that refuse an
event."""

import numpy as np
import pytest

pytest.importorskip("torch")

from point_cloud_classifier_tpu.data import graph as jax_graph  # noqa: E402
from point_cloud_classifier_tpu_torch.data import graph  # noqa: E402
from point_cloud_classifier_tpu_torch.native.host import build_event_edges_native  # noqa: E402


def _event(seed, n_particles=8, unrecorded=0.4, max_steps=5, tie_every=0):
    """A seeded lineage tree and its step arrays, the incident node (pid 0,
    time 0) last; ``tie_every`` > 0 rounds times so that steps tie."""
    rng = np.random.default_rng(seed)
    parents = {0: []}
    for p in range(1, n_particles):
        parents[p] = [int(rng.integers(0, p))]
        if rng.random() < 0.2:  # a second parent now and then
            parents[p].append(int(rng.integers(0, p)))
    recorded = [0] + [p for p in range(1, n_particles) if rng.random() > unrecorded]
    pids, times = [], []
    for p in recorded:
        for _ in range(int(rng.integers(1, max_steps))):
            pids.append(p)
            times.append(float(rng.exponential(1.0)))
    times = np.asarray(times)
    if tie_every:  # up, so that the incident node stays the earliest step
        times = np.ceil(times * tie_every) / tie_every
    times = np.append(times, 0.0)
    return np.asarray(pids + [0], np.int64), times, np.arange(len(pids) + 1, dtype=np.int64), parents


EVENTS = {f"seed {s}": dict(seed=s) for s in range(16)}
EVENTS.update({
    "60 particles, half unrecorded": dict(seed=123, n_particles=60, unrecorded=0.5),
    "all recorded": dict(seed=7, n_particles=30, unrecorded=0.0),
    "short chains with ties": dict(seed=9, n_particles=20, tie_every=2),
    "long chains with ties": dict(seed=10, n_particles=6, max_steps=40, tie_every=4),
    "long chains without ties": dict(seed=11, n_particles=6, max_steps=40),
})


def _edges_and_output(build, capsys, *event):
    edges = build(*event)
    return edges, capsys.readouterr().out


@pytest.mark.parametrize("kw", EVENTS.values(), ids=EVENTS.keys())
def test_builders_equal_the_jax_builder(kw, capsys, monkeypatch):
    """Edges equal, in order and dtype, and the lines printed for particles
    without parents too: the port's numpy builder, the C++ builder and
    ``event_edges`` under both settings of ``PCC_NATIVE``."""
    event = _event(**kw)
    want, want_out = _edges_and_output(jax_graph.build_event_edges, capsys, *event)
    got = {"numpy": _edges_and_output(graph.build_event_edges, capsys, *event),
           "event_edges": _edges_and_output(graph.event_edges, capsys, *event)}
    native = _edges_and_output(build_event_edges_native, capsys, *event)
    if kw.get("max_steps", 5) > 15 and kw.get("tie_every"):
        assert native[0] is None  # a long chain with a tie goes to numpy, whose order it is
    else:
        got["c++"] = native
    monkeypatch.setenv("PCC_NATIVE", "0")
    assert build_event_edges_native(*event) is None
    got["event_edges, PCC_NATIVE=0"] = _edges_and_output(graph.event_edges, capsys, *event)
    for name, (edges, out) in got.items():
        assert edges.dtype == want.dtype == np.int64, name
        np.testing.assert_array_equal(edges, want, err_msg=name)
        assert out == want_out, name


def test_the_memo_cache_repeats_edges_as_the_jax_builder_does():
    """Particle 2 finds particle 1 and seeds the cache for 1's single-parent
    children 3 and 4 (unrecorded); particle 5, a child of both, then collects
    1 twice, and its edge from 1 appears twice."""
    pids = np.array([1, 2, 5, 0], np.int64)
    times = np.array([0.5, 1.0, 1.5, 0.0])
    keys = np.arange(4, dtype=np.int64)
    parent_map = {0: [], 1: [0], 2: [1], 3: [1], 4: [1], 5: [3, 4]}
    want = jax_graph.build_event_edges(pids, times, keys, parent_map)
    for build in (graph.build_event_edges, build_event_edges_native):
        np.testing.assert_array_equal(build(pids, times, keys, parent_map), want)
    assert len({tuple(e) for e in want.T}) < want.shape[1]


@pytest.mark.parametrize("seed", range(6))
def test_nearest_recorded_ancestors_equal_with_the_cache(seed):
    pids, _, _, parent_map = _event(seed, n_particles=25, unrecorded=0.5)
    recorded = frozenset(int(p) for p in np.unique(pids))
    ours, theirs = {}, {}
    for pid in sorted(parent_map):
        assert graph.nearest_recorded_ancestors(pid, recorded, parent_map, ours) == \
            jax_graph.nearest_recorded_ancestors(pid, recorded, parent_map, theirs)
        assert ours == theirs


@pytest.mark.parametrize("pids, times, message", [
    ([0, 0], [-1.0, 0.0], "Incident particle has parents"),  # a step of pid 0 before the incident node
    ([1, 0], [0.5, 0.0], "nodes with no parents found"),  # particle 1 has no ancestor
], ids=["incident with parents", "unconnected"])
def test_both_builders_refuse_what_the_jax_builder_refuses(pids, times, message, capsys):
    event = (np.array(pids, np.int64), np.array(times), np.arange(len(pids), dtype=np.int64), {0: [], 1: []})
    for build in (jax_graph.build_event_edges, graph.build_event_edges, build_event_edges_native):
        with pytest.raises(AssertionError, match=message):
            build(*event)


@pytest.mark.parametrize("seed", range(4))
def test_edge_weights_and_position_scaling_equal_the_jax_ones(seed):
    rng = np.random.default_rng(seed)
    pids, times, keys, parent_map = _event(seed, n_particles=12)
    edges = graph.build_event_edges(pids, times, keys, parent_map)
    features = rng.normal(size=(len(pids), 4)).astype(np.float32)
    features[:, 0] = rng.random(len(pids))
    assert graph.gaussian_edge_weights(features, edges).tobytes() == \
        jax_graph.gaussian_edge_weights(features, edges).tobytes()
    ours, theirs = features.copy(), features.copy()
    assert graph.scale_positions_inplace(ours) is ours
    jax_graph.scale_positions_inplace(theirs)
    assert ours.tobytes() == theirs.tobytes()

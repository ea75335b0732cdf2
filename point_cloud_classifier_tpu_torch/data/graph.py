"""The S2PG lineage-graph dataset, read from its cached per-graph ``.npz`` files.

Counterpart of the cached half of ``point_cloud_classifier_tpu/data/graph.py``
(``Step2PointGraph`` reading ``{data_dir}/S2PG/{split}/graph_{i:05d}.npz``,
each with ``features``, ``edges``, ``weights``, ``label`` and ``event_id``).
It needs numpy only; the JAX package's reader sits on a base class that
imports pandas and sklearn.  Its loaders are the port's ``GraphLoader``, made
with the JAX reader's arguments (train shuffled and, with ``length_sorted``,
sorted by size).

The numpy S2PG builders are here too, copies of the JAX module's (which
imports sklearn and joblib): ``nearest_recorded_ancestors``,
``build_event_edges``, ``gaussian_edge_weights`` and
``scale_positions_inplace``.  :func:`event_edges` builds one event's edges
with the C++ builder (``csrc/host/edge_builder.cpp``, through
``build_event_edges_native``) and with numpy under ``PCC_NATIVE=0``.

Not ported yet: building the cache from the raw HDF5 showers
(``create_dataset=True`` needs h5py and sklearn; ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from point_cloud_classifier_tpu_torch.data.batching import GraphLoader
from point_cloud_classifier_tpu_torch.native.host import build_event_edges_native

SPLITS = ("train", "val", "test")
GRAPH_KEYS = ("event_id", "features", "edges", "weights", "label")


def nearest_recorded_ancestors(
    pid: int,
    recorded: frozenset,
    parent_map: Dict[int, List[int]],
    cache: Dict[int, List[int]],
) -> List[int]:
    """Nearest ancestors of ``pid`` that actually left steps.

    BFS upward through the MC-truth tree; a recorded ancestor ends its
    branch, an unrecorded one expands to its own parents.  The memo ``cache``
    lives across the calls of one event and has the reference's two side
    channels: unrecorded ancestors consult it, and finding a recorded
    ancestor seeds it for every single-parent child of that ancestor.  Both
    can repeat an entry in the result, which becomes a duplicate edge, as in
    the reference.
    """
    if pid in cache:
        return cache[pid]

    collected: List[int] = []
    visited = set()
    queue = list(parent_map.get(pid, []))

    while queue:
        cur = int(queue.pop(0))
        if cur in visited:
            continue
        visited.add(cur)

        if cur not in recorded:
            if cur in cache:
                collected.extend(cache[cur])
            else:
                queue.extend(parent_map.get(cur, []))
        else:
            collected.append(cur)
            for child, parents in parent_map.items():
                if cur in parents and child not in cache and len(parents) == 1:
                    cache[child] = [cur]

    if collected:
        cache[pid] = collected
    return collected


def build_event_edges(
    pids: np.ndarray,
    times: np.ndarray,
    step_keys: np.ndarray,
    parent_map: Dict[int, List[int]],
) -> np.ndarray:
    """Edge list [2, 2E] (bidirectional) for one event's step arrays, the
    synthetic incident node last: temporal edges between a particle's
    time-ordered steps, then parent edges from each nearest recorded
    ancestor's steps closest in time to each of the child's earliest steps.
    """
    unique_pids = np.unique(pids)
    recorded = frozenset(int(p) for p in unique_pids)
    # index lists per pid, ascending array position
    indices_map = {int(p): np.nonzero(pids == p)[0] for p in unique_pids}

    cache: Dict[int, List[int]] = {}
    edges_time: List[tuple] = []
    edges_parent: List[tuple] = []

    for child_pid in unique_pids:
        child_pid = int(child_pid)
        child_idxs = indices_map[child_pid]
        # temporal chain over this particle's steps (np.argsort's default
        # kind, the reference's tie order)
        child_sorted = child_idxs[np.argsort(times[child_idxs])]
        for a, b in zip(child_sorted[:-1], child_sorted[1:]):
            edges_time.append((step_keys[a], step_keys[b]))

        ancestors = nearest_recorded_ancestors(child_pid, recorded, parent_map, cache)
        if not ancestors:
            if child_pid != 0:
                print(f"No parents exist for particle {child_pid}")
            continue

        child_times = times[child_idxs]
        min_time = child_times.min()
        child_targets = step_keys[child_idxs[np.nonzero(child_times == min_time)[0]]]

        for parent_pid in ancestors:
            cand_idxs = indices_map[int(parent_pid)]
            deltas = np.abs(times[cand_idxs] - min_time)
            parent_sources = step_keys[cand_idxs[np.nonzero(deltas == deltas.min())[0]]]
            for target in child_targets:
                for source in parent_sources:
                    edges_parent.append((source, target))

    directed = edges_time + edges_parent

    incident_key = int(step_keys[-1])
    in_degree = np.zeros(incident_key + 1, dtype=np.int64)
    bidirectional = np.empty((2 * len(directed), 2), dtype=np.int64)
    for i, (s, t) in enumerate(directed):
        bidirectional[2 * i] = (s, t)
        bidirectional[2 * i + 1] = (t, s)
        in_degree[t] += 1

    assert in_degree[incident_key] == 0, "Incident particle has parents, which should not happen"
    unconnected = np.nonzero(in_degree[:-1] == 0)[0]
    assert len(unconnected) == 0, f"{len(unconnected)} nodes with no parents found"

    return bidirectional.T


def event_edges(
    pids: np.ndarray,
    times: np.ndarray,
    step_keys: np.ndarray,
    parent_map: Dict[int, List[int]],
) -> np.ndarray:
    """One event's edges by the C++ builder, or by :func:`build_event_edges`
    under ``PCC_NATIVE=0`` and where the C++ builder could order tied times
    otherwise."""
    edges = build_event_edges_native(pids, times, step_keys, parent_map)
    return build_event_edges(pids, times, step_keys, parent_map) if edges is None else edges


def gaussian_edge_weights(features: np.ndarray, edges: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """exp(-d²/2σ²) with σ = the median endpoint distance + eps."""
    positions = features[:, 1:4]
    d = np.linalg.norm(positions[edges[0]] - positions[edges[1]], axis=1)
    sigma = np.median(d) + eps
    return np.exp(-(d**2) / (2 * sigma**2)).astype(np.float32)


def scale_positions_inplace(features: np.ndarray) -> np.ndarray:
    """Per-graph energy-weighted standardization of columns 1:4."""
    position = features[:, 1:4]
    energy = features[:, 0:1]
    mean = (position * energy).sum(axis=0) / (energy.sum() + 1e-8)
    std = np.sqrt((energy * (position - mean) ** 2).sum(axis=0) / (energy.sum() + 1e-8))
    features[:, 1:4] = (position - mean) / (std + 1e-8)
    return features


class Step2PointGraph:
    """The cached S2PG splits and their graph loaders."""

    name = "S2PG"

    def __init__(
        self,
        data_dir: str,
        n_features: int = 4,
        parts: int = None,  # read by dataset creation only
        use_weights: bool = True,
        transfer_dtype: str = "float32",
        seg_encoding: str = "ids",
        graph_layout: str = "flat",
        length_sorted: bool = False,
        emit_out_rows: bool = False,
        dense_w_is_existence: bool = False,
        require_inrow: bool = False,
        flat_if_multigraph: bool = False,
        batch_size: int = None,
        create_dataset: bool = False,
        # the reference DataModule's cache-building settings: the cache holds
        # their result, so reading it needs none of them
        particles=("proton", "piM"),
        feature_scaling: bool = True,
        workers: int = 1,
    ):
        if create_dataset:
            raise NotImplementedError(
                "building the S2PG cache from raw HDF5 needs h5py and sklearn and "
                "is not ported yet (ROADMAP Queue 1 item 6); build it with the "
                "JAX package, or write a synthetic one with "
                "data.synthetic.write_s2pg_cache, and point data_dir at it"
            )
        self.data_dir = data_dir
        self.batch_size = batch_size
        self.length_sorted = length_sorted
        self.loader_kwargs = dict(
            use_weights=use_weights,
            n_features=n_features,
            transfer_dtype=transfer_dtype,
            seg_encoding=seg_encoding,
            layout=graph_layout,
            emit_out_rows=emit_out_rows,
            dense_w_is_existence=dense_w_is_existence,
            require_inrow=require_inrow,
            flat_if_multigraph=flat_if_multigraph,
        )

    def _split_dir(self, split: str) -> str:
        return os.path.join(self.data_dir, self.name, split)

    def _load_split_graphs(self, split: str) -> List[Dict[str, np.ndarray]]:
        paths = sorted(glob.glob(os.path.join(self._split_dir(split), "graph_*.npz")))
        if not paths:
            raise FileNotFoundError(f"No .npz files found in {self._split_dir(split)}")
        graphs = []
        for path in paths:
            with np.load(path) as data:
                graphs.append({k: data[k] for k in GRAPH_KEYS})
        return graphs

    def _make_loader(self, split: str) -> GraphLoader:
        return GraphLoader(
            self._load_split_graphs(split),
            batch_size=self.batch_size,
            shuffle=split == "train",
            length_sorted=self.length_sorted and split == "train",
            **self.loader_kwargs,
        )

    def get_train_loader(self) -> GraphLoader:
        return self._make_loader("train")

    def get_val_loader(self) -> GraphLoader:
        return self._make_loader("val")

    def get_test_loader(self) -> GraphLoader:
        return self._make_loader("test")

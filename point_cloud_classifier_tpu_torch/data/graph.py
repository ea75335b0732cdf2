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

``create_dataset=True`` builds the cache from the raw files as the JAX
module does (``data/module.DataModule``, on a list of graphs): per event the
steps sorted by (event, particle, time), the synthetic incident node last,
the edges, the node features ``[energy / event total, x, y, z]`` and the
gaussian edge weights; a graph-level stratified split of each file; per
graph the energy-weighted position standardization, then the energy column
scaled by the train split's scaler; one file a graph, written by
``save_npz`` (the JAX bytes).  The loaders read the files through
``load_npz``, as the JAX module does.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from point_cloud_classifier_tpu_torch.data.batching import GraphLoader
from point_cloud_classifier_tpu_torch.data.module import (
    LABEL_MAP,
    SPLITS,
    DataModule,
    StandardScaler,
    save_scaler,
    scaler_path,
    train_test_split,
)
from point_cloud_classifier_tpu_torch.data.npz_io import load_npz, save_npz
from point_cloud_classifier_tpu_torch.native.host import build_event_edges_native

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


class Step2PointGraph(DataModule):
    """The S2PG splits: built from the raw files, or read from the cached
    graphs by each loader."""

    name = "S2PG"

    def __init__(
        self,
        data_dir: str,
        n_features: int = 4,
        parts: int = None,
        use_weights: bool = True,
        transfer_dtype: str = "float32",
        seg_encoding: str = "ids",
        graph_layout: str = "flat",
        length_sorted: bool = False,
        emit_out_rows: bool = False,
        dense_w_is_existence: bool = False,
        require_inrow: bool = False,
        flat_if_multigraph: bool = False,
        **kwargs,
    ):
        super().__init__(data_dir=data_dir, **kwargs)
        self.parts = parts
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
        if self.create_dataset:
            print("Creating Step2PointGraph (S2PG) dataset")
            self._create_dataset()

    # -- per-event graphs ------------------------------------------------------------

    def _preprocess_data(self, raw: Dict[str, np.ndarray], particle: str) -> List[Dict]:
        # steps sorted by (event, pid, time), a stable lexsort
        order = np.lexsort((raw["time"], raw["mcparticle_id"], raw["event_id"]))
        ev = raw["event_id"][order]
        pid = raw["mcparticle_id"][order].astype(np.int64)
        time = raw["time"][order].astype(np.float64)
        energy = raw["energy"][order].astype(np.float64)
        pos = raw["position"][order].astype(np.float64)

        p_ev = raw["particle_event_id"]
        p_id = raw["particle_id"].astype(np.int64)
        p_parent = raw["parent_id"].astype(np.int64)

        uniq_events = np.unique(ev)
        ev_bounds = np.append(np.searchsorted(ev, uniq_events), len(ev))
        label = LABEL_MAP[particle]
        graphs: List[Dict] = []
        for e_i, event in enumerate(uniq_events):
            lo, hi = ev_bounds[e_i], ev_bounds[e_i + 1]
            n_steps = hi - lo
            p_sel = p_ev == event
            ev_pids = p_id[p_sel]
            ev_parents = p_parent[p_sel]

            incident = ev_pids[ev_parents == -1]
            assert len(incident) == 1, f"Event {event}: expected 1 primary particle, found {len(incident)}"
            assert incident[0] == 0, f"Event {event}: primary particle ID is not 0"
            incident_pid = int(incident[0])

            # the event's steps and the synthetic incident node (last)
            pids_e = np.append(pid[lo:hi], incident_pid)
            times_e = np.append(time[lo:hi], 0.0)
            energy_e = np.append(energy[lo:hi], 0.0)
            pos_e = np.vstack([pos[lo:hi], np.zeros(3)])
            step_keys = np.arange(n_steps + 1, dtype=np.int64)

            parent_map: Dict[int, List[int]] = {}
            for child, parent in zip(ev_pids, ev_parents):
                parent_map.setdefault(int(child), [])
                if parent != -1:
                    parent_map[int(child)].append(int(parent))

            edges = event_edges(pids_e, times_e, step_keys, parent_map)
            total_energy = energy_e.sum()
            features = np.stack(
                [energy_e / total_energy, pos_e[:, 0], pos_e[:, 1], pos_e[:, 2]], axis=1
            ).astype(np.float32)
            graphs.append({
                "event_id": int(event),
                "features": features,
                "edges": edges,
                "weights": gaussian_edge_weights(features, edges),
                "label": label,
            })

        if self.remap_event_ids:
            for new_id, g in enumerate(graphs):
                g["event_id"] = new_id
        return graphs

    # -- the pipeline on a list of graphs ------------------------------------------------

    def _create_dataset(self) -> None:
        self.datasets = {s: [] for s in SPLITS}
        event_id_offset = 0
        jobs = self._file_jobs()
        for (particle, filepath), (num_events, graphs) in zip(jobs, self._map_files(jobs)):
            print(os.path.basename(filepath))
            for g in graphs:
                g["source_file"] = os.path.basename(filepath)
                g["event_id"] += event_id_offset
            event_id_offset += num_events
            for split, part in zip(SPLITS, self._split_dataset(graphs)):
                self.datasets[split].extend(part)

        print("total_events:", sum(len(self.datasets[s]) for s in SPLITS))
        print("event_id_offset:", event_id_offset)
        if self.feature_scaling:
            self._scale_features()
        self._save_datasets()
        for split in SPLITS:
            for g in self.datasets[split]:
                g.pop("source_file", None)

    def _split_dataset(self, graphs: List[Dict]):
        """Graph-level stratified 60/20/20 at seed 42; graphs keep their order."""
        train_frac, val_frac, test_frac = self.data_split
        event_ids = [g["event_id"] for g in graphs]
        labels = [g["label"] for g in graphs]
        train_val_ids, test_ids, train_val_labels, _ = train_test_split(
            event_ids, labels, test_size=test_frac, stratify=labels
        )
        train_ids, val_ids, _, _ = train_test_split(
            train_val_ids, train_val_labels, test_size=val_frac / (val_frac + train_frac),
            stratify=train_val_labels,
        )
        sets = set(train_ids), set(val_ids), set(test_ids)
        return tuple([g for g in graphs if g["event_id"] in ids] for ids in sets)

    def _scale_features(self) -> None:
        """Each graph's positions standardized with energy weights, then the
        energy column scaled by the train split's scaler (f32, as stacked)."""
        print("Scaling features")
        stacked = {
            s: np.vstack([scale_positions_inplace(g["features"]) for g in self.datasets[s]]) for s in SPLITS
        }
        scaler = StandardScaler()
        stacked["train"][:, 0:1] = scaler.fit_transform(stacked["train"][:, 0:1])
        stacked["val"][:, 0:1] = scaler.transform(stacked["val"][:, 0:1])
        stacked["test"][:, 0:1] = scaler.transform(stacked["test"][:, 0:1])
        self.scaler = scaler
        os.makedirs(os.path.join(self.data_dir, self.name), exist_ok=True)
        save_scaler(scaler, scaler_path(self.data_dir, self.name))
        for s in SPLITS:
            start = 0
            for g in self.datasets[s]:
                n = len(g["features"])
                g["features"] = stacked[s][start : start + n]
                start += n

    # -- cache -----------------------------------------------------------------------

    def _split_dir(self, split: str) -> str:
        return os.path.join(self.data_dir, self.name, split)

    def _save_datasets(self) -> None:
        for split in SPLITS:
            save_dir = self._split_dir(split)
            os.makedirs(save_dir, exist_ok=True)
            print(f"Saving {split} dataset")
            for i, g in enumerate(self.datasets[split]):
                save_npz(
                    os.path.join(save_dir, f"graph_{i:05d}.npz"),
                    features=g["features"],
                    edges=g["edges"],
                    weights=g["weights"],
                    label=g["label"],
                    event_id=g["event_id"],
                )
            print("Finished saving data")

    def _load_split_graphs(self, split: str) -> List[Dict[str, np.ndarray]]:
        paths = sorted(glob.glob(os.path.join(self._split_dir(split), "graph_*.npz")))
        if not paths:
            raise FileNotFoundError(f"No .npz files found in {self._split_dir(split)}")
        graphs = []
        for path in paths:
            data = load_npz(path)
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

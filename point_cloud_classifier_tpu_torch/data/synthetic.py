"""Seeded synthetic raw showers and S2PT, S2PPC and S2PG caches, written with numpy, for tests and smoke runs.

:func:`write_shower_file` and :func:`write_synthetic_dataset` are the JAX
package's generator (``point_cloud_classifier_tpu/data/synthetic.py``):
``_make_event`` makes the same draws in the same order, so a seed gives the
same arrays, and ``data/h5lite.write_h5`` writes them where the JAX package
calls h5py (``metadata/subdetector_names``, ``steps/*`` and
``particles/*``, files named ``{particle}_file{N}.h5``).  The class signal
lives in the shapes of the distributions and in the MC-truth trees (piM
fragments more), so it survives every representation's per-event
normalization, and some particles of each tree leave no steps, so that the
S2PG edges are found through unrecorded ancestors.

The cache writers below write the three caches directly, in the JAX
package's layouts, without raw files.

:func:`write_s2ppc_cache` writes ``{data_dir}/S2PPC/{split}/S2PPC_{split}_0.npz``
with the columns ``event_id``, ``energy``, ``energy_total``,
``position_x/y/z``, ``time`` and ``label``.  Each event's hits go through the
reference preprocessing: energy
as a fraction of the event total (the total kept as its own column), time
min-maxed per event, positions standardized per event with energy-fraction
weights, and the energy column standardized with the train split's mean and
standard deviation.

The class signal lives in the shape of the distributions, so it survives
those per-event normalizations (as in the JAX generator): label 0 tends to
spikier energy sharing (few dominant hits) than label 1, whose hit times are
heavy-tailed in half of its events, and whose positions are heavy-tailed
along z.  The ranges overlap, so a classifier learns the labels in a few
epochs without telling every event apart at once.

:func:`write_s2pg_cache` writes ``{data_dir}/S2PG/{split}/graph_{i:05d}.npz``
with ``features`` (energy fraction, x, y, z), ``edges [2, E]``, ``weights``,
``label`` and ``event_id``; :func:`lineage_graphs` makes the graphs.  Each
is lineage-like, as the reference's graph construction makes them: particle
tracks whose consecutive steps are joined both ways, each track's first step
joined both ways to a step of its parent track,
and a synthetic incident node (energy 0, at the origin) at the head of the
primary's track, stored last.  In-degrees stay at 8 or less.  Edge weights are
the reference's gaussians of the raw step distances (bandwidth the median
distance), floored at 1e-3 so that they stay nonzero on an fp16 wire (unless
``outliers`` asks for a zero, a duplicate edge and a node of 40 incoming
edges in each split's first graph); then
positions are standardized per graph with energy weights and the energy
column with the train split's mean and standard deviation.  The class signal:
label 0 tends to fewer, longer tracks and spikier energy sharing than label
1; the ranges overlap.

``write_s2pt_cache`` writes ``{data_dir}/S2PT/{split}/S2PT_{split}.npz``
with the nine event-level features of ``data/tabular.FEATURE_ORDER``, each
standardized with the train split's mean and standard deviation (float64, as
the reference's scaler leaves them), plus ``event_id`` and ``label``; each
split holds as many events of either label (one more of label 0 in an odd
split).  Label 1 tends to more energy in the HCal, more hits, more
particles, a deeper centroid and a longer elapsed time; the ranges overlap.

``position_grid`` rounds the standardized positions to multiples of that
step, for the kNN path's tests: on a power-of-two grid (1/64, say) every
squared distance is exact in f32 whatever the order of operations, so two
implementations pick the same neighbours bit for bit; a coarse grid (1/2)
also makes exact distance ties, where a row's kNN degree exceeds k.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from point_cloud_classifier_tpu_torch.data.h5lite import write_h5

SPLITS = ("train", "val", "test")


def _event(rng: np.random.Generator, n: int, label: int) -> Dict[str, np.ndarray]:
    # each event draws its shapes from ranges that overlap between labels,
    # so the labels cannot all be told apart
    energy = rng.gamma(rng.uniform(0.5, 2.0) if label == 0 else rng.uniform(1.0, 3.5), size=n)
    energy += 1e-6
    total = rng.lognormal(0.0, 0.5)  # the same for both labels
    heavy = label == 1 and rng.uniform() < 0.5
    time = rng.exponential(size=n) if heavy else rng.uniform(size=n)
    pos = rng.normal(size=(n, 3))
    if label == 1:
        pos[:, 2] = rng.laplace(size=n) * 3.0
    frac = energy / energy.sum()
    pos = (pos - frac @ pos) / (np.sqrt(frac @ (pos - frac @ pos) ** 2) + 1e-8)
    return {
        "energy": frac,
        "energy_total": np.full(n, total),
        "position_x": pos[:, 0],
        "position_y": pos[:, 1],
        "position_z": pos[:, 2],
        "time": (time - time.min()) / (time.max() - time.min() + 1e-8),
        "label": np.full(n, label, dtype=np.int64),
    }


def write_s2ppc_cache(
    data_dir: str,
    n_events: Sequence[int] = (1024, 256, 256),
    min_points: int = 160,
    max_points: int = 288,
    seed: int = 0,
) -> None:
    """Write train, val and test splits of ``n_events`` events each, of
    ``min_points``–``max_points`` hits, balanced labels, from ``seed``."""
    rng = np.random.default_rng(seed)
    splits, first_id = {}, 0
    for split, count in zip(SPLITS, n_events):
        events = []
        for i in range(count):
            n = int(rng.integers(min_points, max_points + 1))
            ev = _event(rng, n, int(rng.integers(0, 2)))
            ev["event_id"] = np.full(n, first_id + i, dtype=np.int64)
            events.append(ev)
        first_id += count
        splits[split] = {k: np.concatenate([e[k] for e in events]) for k in events[0]}
    mean, std = splits["train"]["energy"].mean(), splits["train"]["energy"].std()
    for split, cols in splits.items():
        cols["energy"] = (cols["energy"] - mean) / std
        out = os.path.join(data_dir, "S2PPC", split)
        os.makedirs(out, exist_ok=True)
        np.savez(os.path.join(out, f"S2PPC_{split}_0.npz"), **cols)


_MAX_PARENT_INDEG = 6  # a parent step takes links until this in-degree


def _graph(rng: np.random.Generator, n: int, label: int) -> Dict[str, np.ndarray]:
    """One lineage-like graph of ``n`` nodes (raw features, edges, weights)."""
    mean_track = rng.uniform(10, 24) if label == 0 else rng.uniform(5, 14)
    n_steps = n - 1  # the incident node comes last
    tracks, left = [], n_steps
    while left > 0:
        length = min(left, max(1, int(rng.poisson(mean_track))))
        tracks.append(np.arange(n_steps - left, n_steps - left + length))
        left -= length
    pos = np.zeros((n, 3))
    indeg = np.zeros(n, dtype=np.int64)
    src, dst = [], []

    def link(a, b):
        src.extend((a, b))
        dst.extend((b, a))
        indeg[a] += 1
        indeg[b] += 1

    for t, steps in enumerate(tracks):
        if t == 0:
            start, head = np.zeros(3), n - 1  # the incident node heads the primary
            direction = np.array([0.0, 0.0, 1.0])
        else:
            parent = tracks[int(rng.integers(0, t))]
            open_steps = parent[indeg[parent] < _MAX_PARENT_INDEG]
            head = int(rng.choice(open_steps if len(open_steps) else parent))
            start = pos[head]
            direction = rng.normal(size=3)
            direction /= np.linalg.norm(direction)
        pos[steps] = start + np.cumsum(
            direction + 0.3 * rng.normal(size=(len(steps), 3)), axis=0
        )
        link(head, int(steps[0]))
        for a, b in zip(steps[:-1], steps[1:]):
            link(int(a), int(b))
    energy = rng.gamma(rng.uniform(0.5, 2.0) if label == 0 else rng.uniform(1.0, 3.5), size=n)
    energy[-1] = 0.0
    features = np.concatenate([(energy / energy.sum())[:, None], pos], axis=1)
    edges = np.array([src, dst], dtype=np.int64)
    d = np.linalg.norm(pos[edges[0]] - pos[edges[1]], axis=1)
    sigma = np.median(d) + 1e-6
    weights = np.maximum(np.exp(-(d**2) / (2 * sigma**2)), 1e-3).astype(np.float32)
    return {"features": features, "edges": edges, "weights": weights}


def _scale_positions(features: np.ndarray) -> None:
    """Per-graph energy-weighted standardization of columns 1:4, in place."""
    position, energy = features[:, 1:4], features[:, 0:1]
    mean = (position * energy).sum(axis=0) / (energy.sum() + 1e-8)
    std = np.sqrt((energy * (position - mean) ** 2).sum(axis=0) / (energy.sum() + 1e-8))
    features[:, 1:4] = (position - mean) / (std + 1e-8)


OUTLIER_IN_DEGREE = 40


def _add_outliers(g: Dict[str, np.ndarray]) -> None:
    """The three inputs on which a dense graph loader ships another wire:
    the graph's first edge twice (a multigraph), its second edge's weight an
    exact zero, and node 0 the target of ``OUTLIER_IN_DEGREE`` more edges,
    from nodes 1, 2, … (an in-degree past 32 slots where the graph has more
    than ``OUTLIER_IN_DEGREE`` nodes)."""
    n = len(g["features"])
    hub = np.stack([np.arange(1, OUTLIER_IN_DEGREE + 1) % n, np.zeros(OUTLIER_IN_DEGREE, np.int64)])
    g["edges"] = np.concatenate([g["edges"], g["edges"][:, :1], hub], axis=1)
    weights = np.concatenate([g["weights"], g["weights"][:1], np.full(OUTLIER_IN_DEGREE, 0.5)])
    weights[1] = 0.0
    g["weights"] = weights.astype(g["weights"].dtype)


def lineage_graphs(
    rng: np.random.Generator,
    count: int,
    min_nodes: int = 160,
    max_nodes: int = 288,
    position_grid: float | None = None,
    outliers: bool = False,
) -> List[Dict[str, np.ndarray]]:
    """``count`` lineage-like graphs of ``min_nodes``–``max_nodes`` nodes with
    random labels: ``features`` (energy fraction, then positions standardized
    per graph and, with ``position_grid``, rounded to its multiples),
    ``edges``, ``weights`` and ``label``.  With ``outliers`` the first graph
    also holds a duplicate edge, an exact-zero weight and a node of
    ``OUTLIER_IN_DEGREE`` more incoming edges (:func:`_add_outliers`); the
    draws from ``rng`` are the same either way."""
    graphs = []
    for _ in range(count):
        label = int(rng.integers(0, 2))
        g = _graph(rng, int(rng.integers(min_nodes, max_nodes + 1)), label)
        _scale_positions(g["features"])
        if position_grid:
            g["features"][:, 1:4] = np.round(g["features"][:, 1:4] / position_grid) * position_grid
        g["label"] = np.int64(label)
        graphs.append(g)
    if outliers and graphs:
        _add_outliers(graphs[0])
    return graphs


def write_s2pg_cache(
    data_dir: str,
    n_graphs: Sequence[int] = (1024, 256, 256),
    min_nodes: int = 160,
    max_nodes: int = 288,
    seed: int = 0,
    position_grid: float | None = None,
    outliers: bool = False,
) -> None:
    """Write train, val and test splits of ``n_graphs`` graphs each, of
    ``min_nodes``–``max_nodes`` nodes, balanced labels, from ``seed``;
    positions on multiples of ``position_grid`` when it is given; with
    ``outliers``, the first graph of each split as :func:`lineage_graphs`
    makes it."""
    rng = np.random.default_rng(seed)
    splits, first_id = {}, 0
    for split, count in zip(SPLITS, n_graphs):
        splits[split] = lineage_graphs(rng, count, min_nodes, max_nodes, position_grid, outliers)
        for i, g in enumerate(splits[split]):
            g["event_id"] = np.int64(first_id + i)
        first_id += count
    energy = np.concatenate([g["features"][:, 0] for g in splits["train"]])
    mean, std = energy.mean(), energy.std()
    for split, graphs in splits.items():
        out = os.path.join(data_dir, "S2PG", split)
        os.makedirs(out, exist_ok=True)
        for i, g in enumerate(graphs):
            g["features"][:, 0] = (g["features"][:, 0] - mean) / std
            g["features"] = g["features"].astype(np.float32)
            np.savez(os.path.join(out, f"graph_{i:05d}.npz"), **g)


def _tabular_features(rng: np.random.Generator, label: np.ndarray) -> Dict[str, np.ndarray]:
    """Raw event-level features for the given labels."""
    n = len(label)
    hcal = rng.beta(2.0 + 1.5 * label, 3.0, size=n)
    return {
        "energy_total": rng.lognormal(0.1 * label, 0.5),
        "hits_total": rng.poisson(200 + 12 * label).astype(np.float64),
        "energy_hcal_frac": hcal,
        "hits_hcal_frac": np.clip(hcal + rng.normal(0.0, 0.1, size=n), 0.0, 1.0),
        "energy_weighted_x": rng.normal(size=n),
        "energy_weighted_y": rng.normal(size=n),
        "energy_weighted_z": rng.normal(0.4 * label, 1.0),
        "n_particles": (rng.poisson(20 + 6 * label) + 1).astype(np.float64),
        "elapsed_time": rng.gamma(2.0 + 0.5 * label, 1.0),
    }


def write_s2pt_cache(data_dir: str, n_events: Sequence[int] = (1024, 256, 256), seed: int = 0) -> None:
    """Write train, val and test splits of ``n_events`` events each, with
    balanced labels, from ``seed``."""
    rng = np.random.default_rng(seed)
    splits, first_id = {}, 0
    for split, count in zip(SPLITS, n_events):
        label = rng.permutation(np.arange(count) % 2)
        splits[split] = {
            "event_id": np.arange(first_id, first_id + count, dtype=np.int64),
            "label": label.astype(np.int64),
            **_tabular_features(rng, label),
        }
        first_id += count
    for name in splits["train"]:
        if name in ("event_id", "label"):
            continue
        mean, std = splits["train"][name].mean(), splits["train"][name].std()
        for cols in splits.values():
            cols[name] = (cols[name] - mean) / std
    for split, cols in splits.items():
        out = os.path.join(data_dir, "S2PT", split)
        os.makedirs(out, exist_ok=True)
        np.savez(os.path.join(out, f"S2PT_{split}.npz"), **cols)


# -- raw showers (the JAX package's generator) -----------------------------------

SUBDETECTOR_NAMES = [
    b"HCalBarrel",
    b"HCalEndcap",
    b"ECalBarrel",
    b"ECalEndcap",
    b"TrackerBarrel",  # maps to "Other" and is dropped by the tabular pipeline
]


def _make_event(rng: np.random.Generator, particle: str) -> Tuple[Dict, Dict]:
    """One event: a small particle tree plus its steps (the JAX generator's
    draws, in its order)."""
    is_proton = particle == "proton"

    # pid 0 is the incident particle (parent -1), then a few secondaries,
    # each the child of an earlier particle; piM trees are deeper and wider
    n_secondaries = int(rng.integers(2, 5)) if is_proton else int(rng.integers(5, 9))
    pids = [0] + list(range(1, n_secondaries + 1))
    parents = [-1]
    for pid in pids[1:]:
        parents.append(int(rng.integers(0, pid)))

    # the secondaries that leave steps (pid 0 always does, and at least one other)
    recorded = {0}
    for pid in pids[1:]:
        if rng.random() > 0.3:
            recorded.add(pid)
    if len(recorded) == 1 and n_secondaries >= 1:
        recorded.add(pids[1])

    hcal_frac = 0.75 if is_proton else 0.35
    spread = 12.0 if is_proton else 7.0
    # piM showers elongated along z, protons isotropic; proton energy spiky,
    # piM shared near uniformly; proton times uniform, piM heavy-tailed
    axis_scale = np.array([1.0, 1.0, 1.0]) if is_proton else np.array([0.8, 0.8, 1.6])
    energy_shape = 1.0 if is_proton else 2.2
    center = rng.normal(0.0, 3.0, size=3) + (np.array([0, 0, 40.0]))

    step_rows = {k: [] for k in ["energy", "time", "pos", "pid", "subdet"]}
    t_base = 0.05
    for pid in sorted(recorded):
        n_steps = int(rng.integers(2, 7)) if pid == 0 else int(rng.integers(1, 5))
        for s in range(n_steps):
            step_rows["pid"].append(pid)
            if is_proton:
                dt = rng.uniform(0.0, 3.0)
            else:
                dt = rng.exponential(1.2)
            step_rows["time"].append(t_base + dt + 0.2 * s + 0.1 * pid)
            step_rows["energy"].append(float(rng.gamma(energy_shape, 0.05) + 0.005))
            step_rows["pos"].append(center + rng.normal(0.0, spread, size=3) * axis_scale)
            in_hcal = rng.random() < hcal_frac
            if rng.random() < 0.05:
                step_rows["subdet"].append(4)  # TrackerBarrel → Other
            elif in_hcal:
                step_rows["subdet"].append(int(rng.integers(0, 2)))
            else:
                step_rows["subdet"].append(int(rng.integers(2, 4)))

    steps = {
        "energy": np.asarray(step_rows["energy"], dtype=np.float32),
        "time": np.asarray(step_rows["time"], dtype=np.float32),
        "position": np.stack(step_rows["pos"]).astype(np.float32),
        "mcparticle_id": np.asarray(step_rows["pid"], dtype=np.int64),
        "subdetector": np.asarray(step_rows["subdet"], dtype=np.int64),
    }
    particles_tbl = {
        "id": np.asarray(pids, dtype=np.int64),
        "parent_id": np.asarray(parents, dtype=np.int64),
    }
    return steps, particles_tbl


def write_shower_file(path: str, particle: str, n_events: int, seed: int) -> Dict[str, np.ndarray]:
    """``n_events`` events of ``particle`` from ``seed`` as one raw shower
    file; returns the arrays written, by their paths in the file."""
    rng = np.random.default_rng(seed)
    all_steps: List[Dict] = []
    all_particles: List[Dict] = []
    for event in range(n_events):
        steps, particles_tbl = _make_event(rng, particle)
        steps["event_id"] = np.full(len(steps["energy"]), event, dtype=np.int64)
        particles_tbl["event_id"] = np.full(len(particles_tbl["id"]), event, dtype=np.int64)
        all_steps.append(steps)
        all_particles.append(particles_tbl)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {"metadata/subdetector_names": np.array(SUBDETECTOR_NAMES)}
    for key in ("energy", "time", "position", "mcparticle_id", "subdetector", "event_id"):
        arrays[f"steps/{key}"] = np.concatenate([s[key] for s in all_steps])
    for key in ("id", "parent_id", "event_id"):
        arrays[f"particles/{key}"] = np.concatenate([p[key] for p in all_particles])
    write_h5(path, arrays)
    return arrays


def write_synthetic_dataset(
    data_dir: str,
    n_events_per_file: int = 40,
    n_files_per_particle: int = 1,
    seed: int = 0,
    particles: Tuple[str, ...] = ("proton", "piM"),
) -> str:
    """A tree of raw shower files, ``{particle}_file{N}.h5`` (file N of the
    particle of index p from seed ``seed + 1000·p + N``); returns
    ``data_dir``."""
    os.makedirs(data_dir, exist_ok=True)
    for p_i, particle in enumerate(particles):
        for n in range(n_files_per_particle):
            write_shower_file(
                os.path.join(data_dir, f"{particle}_file{n}.h5"),
                particle,
                n_events_per_file,
                seed=seed + 1000 * p_i + n,
            )
    return data_dir

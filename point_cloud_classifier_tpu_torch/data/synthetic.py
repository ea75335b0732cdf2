"""A seeded synthetic S2PPC cache, written with numpy, for tests and smoke runs.

Counterpart of ``point_cloud_classifier_tpu/data/synthetic.py``, which writes
raw HDF5 showers for the JAX package's preprocessing; the port reads only the
cache, so this writes the cache itself, in the JAX package's layout
(``{data_dir}/S2PPC/{split}/S2PPC_{split}_0.npz`` with the columns
``event_id``, ``energy``, ``energy_total``, ``position_x/y/z``, ``time`` and
``label``).  Each event's hits go through the reference preprocessing: energy
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
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

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

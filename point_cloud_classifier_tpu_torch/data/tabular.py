"""The S2PT tabular dataset: nine event-level features, built from the raw
showers and cached as one ``.npz`` a split (numpy).

Counterpart of ``point_cloud_classifier_tpu/data/tabular.py``
(``Step2PointTabular``).  The JAX module holds each split in a pandas frame;
this one keeps it as numpy columns in :data:`COLUMN_ORDER`, so it runs on a
machine without pandas or sklearn.

``create_dataset=True`` builds ``{data_dir}/S2PT/{split}/S2PT_{split}.npz``
from the raw files as the JAX module does (``data/module.DataModule``):
subdetectors other than HCal and ECal dropped; per event the HCal and ECal
energy and hit sums, the energy-weighted centroid, the distinct MC
particles and the 99th percentile of the step times; a stratified split of
the *rows* (not the events) of each file, which also sets the cache's row
order; every feature scaled by the train split's scaler; the splits written
by ``save_npz`` (the JAX bytes).  Otherwise the cache is read
(``load_cache=False`` reads nothing: raw inference preprocesses alone).

``event_id`` is dropped when a loader is first asked for, as the JAX module
does.  ``convert_to_tensor=True`` gives a :class:`TabularLoader` (the train
split shuffled), byte-identical to the JAX one; ``False`` gives the split's
columns themselves (the features in :data:`COLUMN_ORDER`, then ``label``),
which ``LogRegression`` reads where the JAX package hands it a DataFrame.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from point_cloud_classifier_tpu_torch.data.batching import TabularLoader
from point_cloud_classifier_tpu_torch.data.hdf5 import decode_subdetectors, detector_category
from point_cloud_classifier_tpu_torch.data.module import (
    LABEL_MAP,
    Columns,
    SPLITS,
    DataModule,
    remap_event_ids,
    train_test_split,
)
from point_cloud_classifier_tpu_torch.data.npz_io import load_npz, save_npz

FEATURE_ORDER = [
    "energy_total",
    "hits_total",
    "energy_hcal_frac",
    "hits_hcal_frac",
    "energy_weighted_x",
    "energy_weighted_y",
    "energy_weighted_z",
    "n_particles",
    "elapsed_time",
]
# the columns of a split: the JAX package's frame, in its order
COLUMN_ORDER = [
    "event_id",
    "energy_total",
    "hits_total",
    "energy_hcal_frac",
    "hits_hcal_frac",
    "energy_weighted_x",
    "energy_weighted_y",
    "energy_weighted_z",
    "n_particles",
    "elapsed_time",
    "label",
]


def feature_matrix(columns: Columns) -> np.ndarray:
    """The rows' features ``[N, F]``: every column but ``label`` (and
    ``event_id``), in their order, stacked as pandas' ``to_numpy`` stacks
    them (a common dtype, float64 for these)."""
    return np.stack([v for k, v in columns.items() if k not in ("event_id", "label")], axis=1)


class Step2PointTabular(DataModule):
    """The S2PT splits: built from the raw files or read from the cache, and
    their loaders."""

    name = "S2PT"

    def __init__(self, data_dir: str, convert_to_tensor: bool = False, load_cache: bool = True, **kwargs):
        super().__init__(data_dir=data_dir, **kwargs)
        self.convert_to_tensor = convert_to_tensor
        if self.create_dataset:
            print("Creating Step2PointTabular (S2PT) dataset")
            self._create_dataset()
        elif load_cache:
            self._load_dataset()

    # -- preprocessing -------------------------------------------------------------

    def _preprocess_data(self, raw: Dict[str, np.ndarray], particle: str) -> Columns:
        category = detector_category(decode_subdetectors(raw["subdetector"]))
        keep = category != "Other"
        n_other = int((~keep).sum())
        if n_other:
            print(f"Unknown detector part encountered. Count: {n_other}")

        event_id = raw["event_id"][keep]
        energy = raw["energy"][keep].astype(np.float64)
        time = raw["time"][keep].astype(np.float64)
        pos = raw["position"][keep].astype(np.float64)
        pid = raw["mcparticle_id"][keep]
        is_hcal = category[keep] == "HCal"

        uniq_events, inv = np.unique(event_id, return_inverse=True)
        n_ev = len(uniq_events)
        energy_hcal = np.bincount(inv, weights=np.where(is_hcal, energy, 0.0), minlength=n_ev)
        energy_ecal = np.bincount(inv, weights=np.where(is_hcal, 0.0, energy), minlength=n_ev)
        hits_hcal = np.bincount(inv, weights=is_hcal.astype(np.float64), minlength=n_ev)
        hits_ecal = np.bincount(inv, weights=(~is_hcal).astype(np.float64), minlength=n_ev)
        energy_total = energy_hcal + energy_ecal
        hits_total = hits_hcal + hits_ecal

        w_sum = np.bincount(inv, weights=energy, minlength=n_ev)
        cx = np.bincount(inv, weights=energy * pos[:, 0], minlength=n_ev) / w_sum
        cy = np.bincount(inv, weights=energy * pos[:, 1], minlength=n_ev) / w_sum
        cz = np.bincount(inv, weights=energy * pos[:, 2], minlength=n_ev) / w_sum

        ev_pid = np.unique(np.stack([event_id, pid], axis=1), axis=0)
        n_particles = np.bincount(np.searchsorted(uniq_events, ev_pid[:, 0]), minlength=n_ev).astype(np.int64)

        # 99th percentile of each event's step times (np.percentile's default
        # linear interpolation), event by event as the JAX module does
        order = np.argsort(inv, kind="stable")
        sorted_time_by_event = time[order]
        boundaries = np.concatenate([[0], np.cumsum(np.bincount(inv, minlength=n_ev))])
        elapsed = np.empty(n_ev)
        for e in range(n_ev):
            elapsed[e] = np.percentile(sorted_time_by_event[boundaries[e] : boundaries[e + 1]], 99)

        columns = {
            "event_id": uniq_events,
            "energy_total": energy_total,
            "hits_total": hits_total,
            "energy_hcal_frac": energy_hcal / energy_total,
            "hits_hcal_frac": hits_hcal / hits_total,
            "energy_weighted_x": cx,
            "energy_weighted_y": cy,
            "energy_weighted_z": cz,
            "n_particles": n_particles,
            "elapsed_time": elapsed,
            "label": np.full(n_ev, LABEL_MAP[particle], dtype=np.int64),
        }
        if self.remap_event_ids:
            columns["event_id"] = remap_event_ids(columns["event_id"])
        nan = any(np.isnan(v).any() for v in columns.values() if v.dtype.kind == "f")
        print("There are NaN values in the dataset!" if nan else "No NaN values detected.")
        return columns

    def _split_dataset(self, columns: Columns):
        """Row-level stratified 60/20/20 at seed 42: the rows of each part in
        scikit-learn's permuted order, which the cache keeps."""
        train_frac, val_frac, test_frac = self.data_split
        train, test = train_test_split(columns, test_size=test_frac, stratify=columns["label"])
        train, val = train_test_split(
            train, test_size=val_frac / (train_frac + val_frac), stratify=train["label"]
        )
        return train, val, test

    # -- cache -----------------------------------------------------------------------

    def _split_path(self, split: str) -> str:
        return os.path.join(self.data_dir, self.name, split, f"{self.name}_{split}.npz")

    def _save_datasets(self) -> None:
        for split in SPLITS:
            columns = self.datasets[split]
            print(f"Saving {split} dataset")
            path = self._split_path(split)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            save_npz(path, event_id=columns["event_id"], label=columns["label"],
                     **{k: columns[k] for k in FEATURE_ORDER})
        print("Finished saving data")

    def _load_dataset(self) -> None:
        for split in SPLITS:
            path = self._split_path(split)
            if not os.path.exists(path):
                raise FileNotFoundError(f"Required file is missing: {path}")
            print(f"Loading {split} dataset from {path}")
            data = load_npz(path)
            self.datasets[split] = {k: data[k] for k in COLUMN_ORDER}
        print("Finished loading datasets")

    # -- loaders ---------------------------------------------------------------------

    def _get_loader(self, split: str):
        columns = self.datasets[split]
        columns.pop("event_id", None)
        if not self.convert_to_tensor:
            return columns
        return TabularLoader(
            feature_matrix(columns), columns["label"], self.batch_size, shuffle=split == "train"
        )

    def get_train_loader(self):
        return self._get_loader("train")

    def get_val_loader(self):
        return self._get_loader("val")

    def get_test_loader(self):
        return self._get_loader("test")

"""The S2PPC point-cloud dataset: per-hit features, built from the raw showers
and cached as ``.npz`` shards by part (numpy).

Counterpart of ``point_cloud_classifier_tpu/data/pointcloud.py``
(``Step2PointPointCloud`` and ``frame_to_point_loader``).  The JAX module
holds the rows in a pandas frame and its base class imports sklearn; this
one keeps them as numpy columns, so it runs on a machine with neither.

``create_dataset=True`` builds ``{data_dir}/S2PPC/{split}/S2PPC_{split}_{part}.npz``
from the raw files as the JAX module does (``data/module.DataModule``): hits
under ``energy_cutoff`` dropped; per event the energy as a fraction of the
event's total (the total kept as its own column), the time min-maxed and the
positions standardized with energy-fraction weights; an event-level split of
each file; the energy column scaled by the train split's scaler; one shard a
source part, written by ``np.savez``.  Otherwise the shards are read
(``load_cache=False`` reads nothing: raw inference preprocesses alone).

Batches are byte-identical to the JAX loader's, on every wire it ships: flat
or dense (``layout``), f32 or fp16 (``transfer_dtype``), with or without
``factor_event_cols``, and with ``length_sorted`` (the train split only, as
in the JAX package).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np

from point_cloud_classifier_tpu_torch.data.batching import PointCloudLoader
from point_cloud_classifier_tpu_torch.data.hdf5 import parse_part_number
from point_cloud_classifier_tpu_torch.data.module import (
    LABEL_MAP,
    Columns,
    SPLITS,
    DataModule,
    remap_event_ids,
    take_rows,
)

FEATURE_COLS = ["energy", "energy_total", "position_x", "position_y", "position_z", "time"]


def frame_to_point_loader(
    columns: Columns, batch_size: int, shuffle: bool, **loader_kwargs
) -> Tuple[PointCloudLoader, np.ndarray]:
    """Per-hit columns → (PointCloudLoader, event ids in loader order).

    Rows group by event in order of first appearance, features in
    :data:`FEATURE_COLS` order; an event's label is that of its first row."""
    event_ids = columns["event_id"]
    uniq, first_idx, inv = np.unique(event_ids, return_index=True, return_inverse=True)
    appearance_order = np.argsort(first_idx, kind="stable")
    feats_all = np.stack([columns[c] for c in FEATURE_COLS], axis=1).astype(np.float32)
    order = np.argsort(inv, kind="stable")
    boundaries = np.concatenate([[0], np.cumsum(np.bincount(inv, minlength=len(uniq)))])

    event_features, labels = [], []
    for e in appearance_order:
        rows = order[boundaries[e] : boundaries[e + 1]]
        event_features.append(feats_all[rows])
        labels.append(columns["label"][rows[0]])
    loader = PointCloudLoader(
        event_features, np.asarray(labels), batch_size=batch_size, shuffle=shuffle,
        **loader_kwargs,
    )
    return loader, uniq[appearance_order]


class Step2PointPointCloud(DataModule):
    """The S2PPC splits: built from the raw files or read from the cache, and
    their loaders (train shuffled, and length-sorted when asked)."""

    name = "S2PPC"

    def __init__(
        self,
        data_dir: str,
        parts: int = None,
        sparse_batching: bool = True,  # config compat: the static-shape wire covers both
        energy_cutoff: float = None,
        seg_encoding: str = "ids",
        layout: str = "flat",
        transfer_dtype: str = "float32",
        factor_event_cols=(),
        bucket_factor: float = 2.0,
        length_sorted: bool = False,
        load_cache: bool = True,
        **kwargs,
    ):
        super().__init__(data_dir=data_dir, **kwargs)
        self.parts = parts
        self.energy_cutoff = energy_cutoff
        self.length_sorted = length_sorted
        self.loader_kwargs = dict(
            transfer_dtype=transfer_dtype,
            seg_encoding=seg_encoding,
            factor_event_cols=tuple(factor_event_cols),
            bucket_factor=bucket_factor,
            layout=layout,
        )
        if self.create_dataset:
            print("Creating Step2PointPointCloud (S2PPC) dataset")
            self._create_dataset()
        elif load_cache:
            self.datasets = {split: self._load_split(split) for split in SPLITS}
            print("Finished loading datasets")

    # -- preprocessing -------------------------------------------------------------

    def _preprocess_data(self, raw: Dict[str, np.ndarray], particle: str) -> Columns:
        energy = raw["energy"].astype(np.float64)
        time = raw["time"].astype(np.float64)
        pos = raw["position"].astype(np.float64)
        event_id = raw["event_id"]

        print("Length before:", len(energy))
        if self.energy_cutoff:
            keep = energy >= self.energy_cutoff
            energy, time, pos, event_id = energy[keep], time[keep], pos[keep], event_id[keep]
        print("Length after:", len(energy))

        uniq, inv = np.unique(event_id, return_inverse=True)
        n_ev = len(uniq)
        energy_total = np.bincount(inv, weights=energy, minlength=n_ev)[inv]
        energy_frac = energy / energy_total

        tmin = np.full(n_ev, np.inf)
        tmax = np.full(n_ev, -np.inf)
        np.minimum.at(tmin, inv, time)
        np.maximum.at(tmax, inv, time)
        time_norm = (time - tmin[inv]) / (tmax[inv] - tmin[inv] + 1e-8)

        # each coordinate standardized with the energy fractions as weights
        w = energy_frac
        w_sum = np.bincount(inv, weights=w, minlength=n_ev)
        pos_norm = np.empty_like(pos)
        for c in range(3):
            mean_c = np.bincount(inv, weights=w * pos[:, c], minlength=n_ev) / w_sum
            var_c = np.bincount(inv, weights=w * (pos[:, c] - mean_c[inv]) ** 2, minlength=n_ev) / w_sum
            std_c = np.sqrt(var_c)
            pos_norm[:, c] = (pos[:, c] - mean_c[inv]) / (std_c[inv] + 1e-8)

        columns = {
            "event_id": event_id,
            "energy": energy_frac,
            "energy_total": energy_total,
            "position_x": pos_norm[:, 0],
            "position_y": pos_norm[:, 1],
            "position_z": pos_norm[:, 2],
            "time": time_norm,
            "label": np.full(len(energy), LABEL_MAP[particle], dtype=np.int64),
        }
        if self.remap_event_ids:
            columns["event_id"] = remap_event_ids(event_id)
        nan = any(np.isnan(v).any() for v in columns.values() if v.dtype.kind == "f")
        print("There are NaN values in the dataset!" if nan else "No NaN values detected.")
        return columns

    def _scale_features(self) -> None:
        super()._scale_features(feature_cols=["energy"])

    # -- cache -----------------------------------------------------------------------

    def _split_dir(self, split: str) -> str:
        return os.path.join(self.data_dir, self.name, split)

    def _save_datasets(self) -> None:
        for split in SPLITS:
            columns = self.datasets[split]
            save_dir = self._split_dir(split)
            os.makedirs(save_dir, exist_ok=True)
            print(f"Saving {split} dataset")
            names, inv = np.unique(columns["source_file"], return_inverse=True)
            part_col = np.array([parse_part_number(str(n)) for n in names], dtype=np.int64)[inv]
            for part in np.unique(part_col):
                sel = take_rows(columns, part_col == part)
                np.savez(
                    os.path.join(save_dir, f"{self.name}_{split}_{part}.npz"),
                    **{k: sel[k] for k in ("event_id", *FEATURE_COLS, "label")},
                )
            print("Finished saving data")

    def _load_split(self, split: str) -> Columns:
        pattern = os.path.join(self._split_dir(split), f"{self.name}_{split}_*.npz")
        paths = sorted(glob.glob(pattern))
        if self.parts:
            paths = paths[: self.parts]
        if not paths:
            raise FileNotFoundError(f"No files found for pattern: {pattern}")
        print(f"Loading {split} dataset from {len(paths)} files")
        parts = []
        for path in paths:
            with np.load(path) as data:
                parts.append({k: data[k] for k in ("event_id", *FEATURE_COLS, "label")})
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    # -- loaders ---------------------------------------------------------------------

    def _make_loader(self, split: str) -> PointCloudLoader:
        loader, _ = frame_to_point_loader(
            self.datasets[split], self.batch_size, shuffle=split == "train",
            length_sorted=self.length_sorted and split == "train",
            **self.loader_kwargs,
        )
        return loader

    def get_train_loader(self) -> PointCloudLoader:
        return self._make_loader("train")

    def get_val_loader(self) -> PointCloudLoader:
        return self._make_loader("val")

    def get_test_loader(self) -> PointCloudLoader:
        return self._make_loader("test")

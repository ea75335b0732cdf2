"""The S2PPC point-cloud dataset, read from its cached ``.npz`` splits (numpy).

Counterpart of the cached-split half of
``point_cloud_classifier_tpu/data/pointcloud.py`` (``Step2PointPointCloud``
loading ``{data_dir}/S2PPC/{split}/S2PPC_{split}_*.npz``, and
``frame_to_point_loader``).  The reference holds the rows in a pandas frame
and its base class imports sklearn; this one keeps them as numpy columns, so
it runs on a machine with neither.  Batches are byte-identical to the JAX
loader's, on every wire it ships: flat or dense (``layout``), f32 or fp16
(``transfer_dtype``), with or without ``factor_event_cols``, and with
``length_sorted`` (the train split only, as in the JAX package).

Not ported yet: building the cache from the raw HDF5 showers
(``create_dataset=True`` needs h5py and sklearn).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np

from point_cloud_classifier_tpu_torch.data.batching import PointCloudLoader

FEATURE_COLS = ["energy", "energy_total", "position_x", "position_y", "position_z", "time"]
SPLITS = ("train", "val", "test")
Columns = Dict[str, np.ndarray]


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


class Step2PointPointCloud:
    """The cached S2PPC splits and their loaders (train shuffled, and
    length-sorted when asked)."""

    name = "S2PPC"

    def __init__(
        self,
        data_dir: str,
        parts: int = None,
        sparse_batching: bool = True,  # config compat
        energy_cutoff: float = None,  # applied when the cache was built
        seg_encoding: str = "ids",
        layout: str = "flat",
        batch_size: int = None,
        create_dataset: bool = False,
        transfer_dtype: str = "float32",
        factor_event_cols=(),
        bucket_factor: float = 2.0,
        length_sorted: bool = False,
        # the reference DataModule's cache-building settings: the cache holds
        # their result, so reading it needs none of them
        particles=("proton", "piM"),
        feature_scaling: bool = True,
        workers: int = 1,
    ):
        if create_dataset:
            raise NotImplementedError(
                "building the S2PPC cache from raw HDF5 needs h5py and is not "
                "ported yet (ROADMAP Queue 1 item 6); build it with the JAX "
                "package and point data_dir at it"
            )
        self.data_dir = data_dir
        self.parts = parts
        self.batch_size = batch_size
        self.length_sorted = length_sorted
        self.loader_kwargs = dict(
            transfer_dtype=transfer_dtype,
            seg_encoding=seg_encoding,
            factor_event_cols=tuple(factor_event_cols),
            bucket_factor=bucket_factor,
            layout=layout,
        )
        self.datasets = {split: self._load_split(split) for split in SPLITS}
        print("Finished loading datasets")

    def _load_split(self, split: str) -> Columns:
        pattern = os.path.join(self.data_dir, self.name, split, f"{self.name}_{split}_*.npz")
        paths = sorted(glob.glob(pattern))
        if self.parts:
            paths = paths[: self.parts]
        if not paths:
            raise FileNotFoundError(f"No files found for pattern: {pattern}")
        print(f"Loading {split} dataset from {len(paths)} files")
        parts = []
        for path in paths:
            with np.load(path) as data:
                parts.append({k: data[k] for k in ("event_id", "label", *FEATURE_COLS)})
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

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

"""The S2PT tabular dataset, read from its cached ``.npz`` splits (numpy).

Counterpart of the cache-load half of
``point_cloud_classifier_tpu/data/tabular.py`` (``Step2PointTabular``
reading ``{data_dir}/S2PT/{split}/S2PT_{split}.npz``).  The reference holds
each split in a pandas frame; this one keeps it as numpy columns, in
:data:`COLUMN_ORDER`, so it runs on a machine without pandas or sklearn.
``event_id`` is dropped when a loader is first asked for, as the JAX module
does.  ``convert_to_tensor=True`` gives a :class:`TabularLoader` (the train
split shuffled), byte-identical to the JAX one; ``False`` gives the split's
columns themselves (the features in :data:`COLUMN_ORDER`, then ``label``),
which ``LogRegression`` reads where the JAX package hands it a DataFrame.

Not ported yet: building the cache from the raw HDF5 showers
(``create_dataset=True`` needs h5py and sklearn).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from point_cloud_classifier_tpu_torch.data.batching import TabularLoader
from point_cloud_classifier_tpu_torch.data.pointcloud import SPLITS

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
# the columns of a loaded split: the JAX package's frame, in its order
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
Columns = Dict[str, np.ndarray]


def feature_matrix(columns: Columns) -> np.ndarray:
    """The rows' features ``[N, F]``: every column but ``label`` (and
    ``event_id``), in their order, stacked as pandas' ``to_numpy`` stacks
    them (a common dtype, float64 for these)."""
    return np.stack([v for k, v in columns.items() if k not in ("event_id", "label")], axis=1)


class Step2PointTabular:
    """The cached S2PT splits and their loaders."""

    name = "S2PT"

    def __init__(
        self,
        data_dir: str,
        convert_to_tensor: bool = False,
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
                "building the S2PT cache from raw HDF5 needs h5py and sklearn and is "
                "not ported yet (ROADMAP Queue 1 item 6); build it with the JAX "
                "package and point data_dir at it"
            )
        self.data_dir = data_dir
        self.convert_to_tensor = convert_to_tensor
        self.batch_size = batch_size
        self.datasets: Dict[str, Columns] = {}
        self._load_dataset()

    def _split_path(self, split: str) -> str:
        return os.path.join(self.data_dir, self.name, split, f"{self.name}_{split}.npz")

    def _load_dataset(self) -> None:
        for split in SPLITS:
            path = self._split_path(split)
            if not os.path.exists(path):
                raise FileNotFoundError(f"Required file is missing: {path}")
            print(f"Loading {split} dataset from {path}")
            with np.load(path) as data:
                self.datasets[split] = {k: data[k] for k in COLUMN_ORDER}
        print("Finished loading datasets")

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

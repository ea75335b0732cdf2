"""The S2PG lineage-graph dataset, read from its cached per-graph ``.npz`` files.

Counterpart of the cached half of ``point_cloud_classifier_tpu/data/graph.py``
(``Step2PointGraph`` reading ``{data_dir}/S2PG/{split}/graph_{i:05d}.npz``,
each with ``features``, ``edges``, ``weights``, ``label`` and ``event_id``).
It needs numpy only; the JAX package's reader sits on a base class that
imports pandas and sklearn.  Its loaders are the port's ``GraphLoader``, made
with the JAX reader's arguments (train shuffled and, with ``length_sorted``,
sorted by size).

Not ported yet: building the cache from the raw HDF5 showers
(``create_dataset=True`` needs h5py and sklearn; ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from point_cloud_classifier_tpu_torch.data.batching import GraphLoader

SPLITS = ("train", "val", "test")
GRAPH_KEYS = ("event_id", "features", "edges", "weights", "label")


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

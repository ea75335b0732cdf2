"""Raw-file inference: a shower file (a path or its bytes) in, a loader out.

Counterpart of ``point_cloud_classifier_tpu/data/inference.py``.
:func:`inference_loader` runs the representation's preprocessing on one raw
file, keeps the file's own event ids, applies the scaler persisted at dataset
creation (``{data_dir}/{NAME}/{NAME}_scaler.pkl``, read by
``data/module.load_scaler``) without refitting, and returns a label-free
loader with the trained config's wire options and the event ids in loader
order.  For ``s2pt`` with ``convert_to_tensor: false`` it returns the rows'
numpy columns (the features, then a dummy ``label``), which the port's
``LogRegression`` reads.

One difference from the JAX module: an S2PG loader takes the dataset options
``factory.get_dataloader`` gives the run's cached splits (the JAX factory's
gates: ``graph_layout`` ``auto`` unless the config names one, and the
checks for zero weights, multigraphs and in-row fits), so a run is served on
the wire it was trained and validated on, the dense in-row wire and its
kernels for the configs' GraphNet; the JAX module passes
``config["dataset"]`` as it stands, which serves such a config on the flat
wire.  Both compute the same probabilities, within f32 rounding.
"""

from __future__ import annotations

import os
from typing import Tuple, Union

import numpy as np

from point_cloud_classifier_tpu_torch.data.batching import GraphLoader, TabularLoader
from point_cloud_classifier_tpu_torch.data.graph import Step2PointGraph, scale_positions_inplace
from point_cloud_classifier_tpu_torch.data.hdf5 import load_shower_file
from point_cloud_classifier_tpu_torch.data.module import StandardScaler, feature_block, load_scaler, scaler_path
from point_cloud_classifier_tpu_torch.data.pointcloud import Step2PointPointCloud, frame_to_point_loader
from point_cloud_classifier_tpu_torch.data.tabular import FEATURE_ORDER, Step2PointTabular


def _load_scaler(data_dir: str, name: str) -> StandardScaler:
    path = scaler_path(data_dir, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Fitted scaler not found at {path}; run dataset creation first")
    return load_scaler(path)


def _without_creation(dataset: dict) -> dict:
    kwargs = dict(dataset)
    kwargs.pop("create_dataset", None)
    return kwargs


def inference_loader(dataset_name: str, config: dict, raw: Union[str, bytes]) -> Tuple[object, np.ndarray]:
    """(loader, or the rows' columns for a LogRegression; event ids in
    loader order) for one raw shower file, given as a path or as bytes.
    Labels are dummy zeros (every event preprocessed as a proton)."""
    raw = load_shower_file(raw)
    dataset_name = dataset_name.lower()

    if dataset_name == "s2pt":
        module = Step2PointTabular(load_cache=False, **_without_creation(config["dataset"]))
        module.remap_event_ids = False
        columns = module._preprocess_data(raw, particle="proton")
        if module.feature_scaling:
            scaled = _load_scaler(module.data_dir, module.name).transform(feature_block(columns, FEATURE_ORDER))
            for j, name in enumerate(FEATURE_ORDER):
                columns[name] = scaled[:, j]
        event_ids = columns.pop("event_id")
        if not module.convert_to_tensor:
            return columns, event_ids
        X = np.stack([columns[k] for k in FEATURE_ORDER], axis=1)
        return TabularLoader(X, np.zeros(len(X)), module.batch_size, shuffle=False), event_ids

    if dataset_name == "s2ppc":
        module = Step2PointPointCloud(load_cache=False, **_without_creation(config["dataset"]))
        module.remap_event_ids = False
        columns = module._preprocess_data(raw, particle="proton")
        if module.feature_scaling:
            scaler = _load_scaler(module.data_dir, module.name)
            columns["energy"] = scaler.transform(feature_block(columns, ["energy"]))[:, 0]
        return frame_to_point_loader(columns, module.batch_size, shuffle=False, **module.loader_kwargs)

    if dataset_name == "s2pg":
        from point_cloud_classifier_tpu_torch.factory import _graph_dataset_config

        module = Step2PointGraph(**_without_creation(_graph_dataset_config(config)))
        module.remap_event_ids = False
        graphs = module._preprocess_data(raw, particle="proton")
        if module.feature_scaling:
            scaler = _load_scaler(module.data_dir, module.name)
            for g in graphs:
                g["features"] = scale_positions_inplace(np.asarray(g["features"], dtype=np.float64))
                g["features"][:, 0:1] = scaler.transform(g["features"][:, 0:1])
        loader = GraphLoader(graphs, batch_size=module.batch_size, shuffle=False, **module.loader_kwargs)
        return loader, np.asarray([g["event_id"] for g in graphs])

    raise ValueError(f"Unknown dataset: {dataset_name}")

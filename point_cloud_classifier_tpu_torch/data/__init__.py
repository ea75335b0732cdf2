"""numpy batch loaders and the S2PT, S2PPC and S2PG datasets, built from raw HDF5 showers or read from their caches (no jax, pandas, sklearn or h5py)."""

from point_cloud_classifier_tpu_torch.data.batching import (
    GraphLoader,
    PointCloudLoader,
    TabularLoader,
    pow2_bucket,
)
from point_cloud_classifier_tpu_torch.data.graph import Step2PointGraph
from point_cloud_classifier_tpu_torch.data.pointcloud import Step2PointPointCloud
from point_cloud_classifier_tpu_torch.data.tabular import Step2PointTabular

__all__ = [
    "GraphLoader",
    "PointCloudLoader",
    "Step2PointGraph",
    "Step2PointPointCloud",
    "Step2PointTabular",
    "TabularLoader",
    "pow2_bucket",
]

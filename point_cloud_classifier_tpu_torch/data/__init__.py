"""numpy batch loaders and the cached S2PPC dataset (no jax, pandas or h5py)."""

from point_cloud_classifier_tpu_torch.data.batching import PointCloudLoader, pow2_bucket
from point_cloud_classifier_tpu_torch.data.pointcloud import Step2PointPointCloud

__all__ = ["PointCloudLoader", "Step2PointPointCloud", "pow2_bucket"]

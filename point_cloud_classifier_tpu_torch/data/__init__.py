"""numpy batch loaders (no jax, pandas or h5py)."""

from point_cloud_classifier_tpu_torch.data.batching import PointCloudLoader, pow2_bucket

__all__ = ["PointCloudLoader", "pow2_bucket"]

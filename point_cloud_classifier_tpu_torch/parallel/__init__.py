"""Meshes and training several sweep arms at once.

Counterpart of ``point_cloud_classifier_tpu/parallel/``: the ``(data,
model)`` mesh over ``torch.distributed`` ranks (``mesh.py``: data
parallelism, the model axis, each rank's share of a batch) and the vmapped
sweep arms (:func:`train_configs_vmapped`, whose arm axis a mesh splits over
the data ranks).  ``vmap_sweep`` is imported at first use: it imports the
trainer, which imports ``mesh``.
"""

from point_cloud_classifier_tpu_torch.parallel.mesh import (
    Mesh,
    RankShares,
    default_mesh,
    make_mesh,
    param_is_sharded,
    share_of_batch,
    share_slices,
)

__all__ = [
    "Mesh", "RankShares", "VmappedArms", "default_mesh", "make_mesh", "param_is_sharded",
    "share_of_batch", "share_slices", "train_configs_vmapped",
]


def __getattr__(name):
    if name in ("VmappedArms", "train_configs_vmapped"):
        from point_cloud_classifier_tpu_torch.parallel import vmap_sweep

        return getattr(vmap_sweep, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

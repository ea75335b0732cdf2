"""Training several sweep arms at once on one card.

Counterpart of ``point_cloud_classifier_tpu/parallel/``: the vmapped sweep
arms (:func:`train_configs_vmapped`).  Meshes (``parallel/mesh.py``: data
parallelism, the sharded arm axis) are not ported (ROADMAP Queue 1 item 13).
"""

from point_cloud_classifier_tpu_torch.parallel.vmap_sweep import VmappedArms, train_configs_vmapped

__all__ = ["VmappedArms", "train_configs_vmapped"]

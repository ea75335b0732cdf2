"""PyTorch + CUDA port of ``point_cloud_classifier_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; each module here mirrors
its counterpart's path and names (``ops/fused_phi.py`` ↔ ``ops/fused_phi.py``)
and is checked against it by ``tests/test_torch_*.py``.  The package imports
torch and numpy only, never jax or the JAX package, and builds nothing at
import: the CUDA kernels under ``csrc/`` are compiled on first use
(``native/``).

Ported so far: the DeepSets serving path on the flat point wire —
``data.batching.PointCloudLoader`` → ``factory.get_model("deep_sets", …)`` →
``ModelWrapper.predict`` — with the fused φ-pool kernel K1 in CUDA.
"""

__version__ = "0.1.0"

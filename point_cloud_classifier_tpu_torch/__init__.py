"""PyTorch + CUDA port of ``point_cloud_classifier_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; each module here mirrors
its counterpart's path and names (``ops/fused_phi.py`` ↔ ``ops/fused_phi.py``)
and is checked against it by ``tests/test_torch_*.py``.  The package imports
torch and numpy only, never jax or the JAX package, and builds nothing at
import: the CUDA kernels under ``csrc/`` are compiled on first use
(``native/``).

Ported so far, on the flat point wire: the DeepSets serving path —
``data.batching.PointCloudLoader`` → ``factory.get_model("deep_sets", …)`` →
``ModelWrapper.predict`` — and its training path — ``train.train_model``:
``factory.get_dataloader("s2ppc", …)`` → ``get_model`` →
``ModelWrapper.fit`` → ``save`` → ``predict`` — with the fused φ-pool kernel
K1 and its backward K2 in CUDA.  On the dense in-row graph wire: the
GraphNet serving path (GAT and GraphConv add/mean) —
``factory.get_dataloader("s2pg", …)`` → ``factory.get_model("graph_net",
…)`` → ``ModelWrapper.predict`` — with the GAT attention kernel K3 in CUDA,
and its training (K4, K6) and kNN graphs (K5).  The tabular models
(``FullyConnectedNet``, ``LogRegression``) on S2PT, and the command line over
all four families: ``python -m point_cloud_classifier_tpu_torch <command>``
(``cli.py``).
"""

__version__ = "0.1.0"

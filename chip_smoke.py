#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve, train, time.

Run from the repository root, with no arguments, on a machine with a CUDA
card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code is
not 0 (there is no CPU run: without CUDA the script stops before printing a
result):

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernels from ``point_cloud_classifier_tpu_torch/csrc``,
   and the host library (the loaders' C++ packers and the S2PG edge builder,
   ``csrc/host``, by ``g++``) with its build seconds;
3. kernel against plain: ``phi_pool`` (kernel K1) against ``phi_pool_plain``
   on the card, f32 and bf16, at the DeepSets config widths (6→256→256,
   residual, quick gelu), with a ragged point count, an empty event, padding
   rows, the flagship ``B=256, P=65,536`` shape, fewer points than one
   64-row tile and one tile plus one, and chains of width 64 and 384; each
   line names the kernel variant the case ran (sliced for the DeepSets chain
   in bf16, general for it in f32 and for every other chain);
4. backward kernel against plain: the backward of ``phi_pool`` (kernel K2)
   against ``phi_pool_bwd_plain`` at the same cases, f32 and bf16, with
   ``d_points`` asked for and not (sliced for the DeepSets chain in both
   types), and K2 run twice on the same inputs for bit-equal gradients;
5. serving slice: the DeepSets serving path through its entry points —
   ``factory.get_model("deep_sets", cfg, run_dir)`` on a JAX-format
   ``best_model.pt`` with seeded random weights, then ``predict`` over
   seeded clouds batched by ``PointCloudLoader`` — checked against the same
   model on its plain path, with the kernel's launch count;
6. training slice: ``train.train_model("deep_sets", "s2ppc", cfg)`` at the
   full width of ``configs/deep_sets.yaml`` for 3 epochs on a seeded
   synthetic S2PPC cache, with K1's and K2's launch counts, the losses, the
   val accuracy and the checkpoints checked; then five steps of the kernel
   route against the plain route from the same weights;
7. times: CUDA-event times of both kernels and their plain versions at both
   shapes and dtypes; ``predict`` and the train step per batch on the kernel
   and plain routes at batch sizes 32 and 256, in f32 and bf16 compute; and
   a ``torch.profiler`` trace of the B=256 f32 train step;
8. GAT kernel against plain: ``gat_attention`` (kernel K3) against
   ``gat_attention_plain`` on the card, f32 and bf16, at ragged M, in-row
   widths D = 4, 8 and 32, duplicate sources, self-edges, zero weights and
   isolated nodes, the fp16/int16 wire, the config batch (32 lineage graphs
   of 160-288 nodes) and the flagship B=256 graphs of 256 nodes, H=4, C=128,
   and at H=4, C=100 and H=3, C=96: every form of K3 (the piece form with a
   node or two nodes a warp, the channel form), each line naming its form,
   each case run twice for equal bits;
9. graph serving slice: for GAT and for GraphConv add at the full width of
   ``configs/graph_net.yaml``, ``factory.get_model("graph_net", cfg,
   run_dir)`` on a JAX-format ``best_model.pt`` with seeded random weights,
   then ``predict`` over ``factory.get_dataloader("s2pg", cfg)``'s test
   loader on a seeded synthetic S2PG cache at batch 32, held against the
   plain route (``force_plain()``), with K3's launch count (2 per GAT batch);
10. graph times: K3 against its plain version at B=32 and B=256, f32 and
   bf16, by CUDA events and by the profiler's device rows; ``predict`` per
   batch on both routes; and a ``torch.profiler`` trace of the B=256 GAT
   predict (the device's idle share);
11. GAT backward kernel against plain: the backward of ``gat_attention``
   (kernel K4) against ``gat_attention_bwd_plain`` at K3's seven cases, f32
   and bf16, each of ``ds_dst``, ``ds_src`` and ``dxw``; at every case the
   mirror of the in-row lists (``gat_out_rows``) against its plain version,
   exactly, and K4 with a mirror handed in against K4 building its own, bit
   for bit; then K4 twice on the flagship inputs: all three gradients
   ``torch.equal`` (every sum is a gather in a fixed order);
12. in-row aggregation kernel against plain: ``inrow_aggregate`` (kernel K6)
   against ``inrow_aggregate_plain``, forward and backward (the Function
   over the out-row lists), add and mean, f32 and bf16, at the config batch
   (B=32, M=288, D=8, H=128), B=256, the fp16/int16 wire, D=32 lists,
   isolated nodes, an M that is no power of two, and duplicate sources, at
   width 128 and at conv1's width 4 (and width 5): every layout of K6, each
   line naming its own, each case run twice for equal bits both ways;
13. graph training slice: ``train.train_model("graph_net", "s2pg", cfg)`` at
   the full width of ``configs/graph_net.yaml`` on a seeded synthetic S2PG
   cache at batch 32, 3 epochs for GAT (K3 forward, K4 backward) and for
   GraphConv add with ``fused_inrow`` (K6 both ways) and 1 epoch for
   GraphConv add as configured (no kernel), with the launch counts, the
   losses, the val accuracy and the checkpoints checked; then five steps of
   each kernel route against its plain route from the same weights, and the
   fused model on batches without out-rows (K6 serves, a train step raises);
14. graph training times: K4 and K6 (widths 128 and 4, by events and by the
   profiler's device rows) against their plain versions at B=32 and B=256,
   f32 and bf16; the train step per batch on the kernel and plain routes;
   packing with and without the out-rows; and ``torch.profiler`` traces of
   the B=256 f32 GAT and fused GraphConv train steps;
15. kNN aggregation kernel against plain: ``knn_aggregate`` (kernel K5)
   against ``knn_aggregate_plain`` and, through ``torch.autograd.grad``,
   ``knn_aggregate_bwd_plain``; f32 and bf16, add and mean, k = 1 and 8; at
   the config batch (32 graphs, N=8,192, widths 128 and 4), a ragged N that
   is no power of two, graphs of fewer than k + 1 nodes, positions on a
   coarse grid (exact ties, degrees over k), a long padding tail, and the
   flagship N=65,536 against the row-blocked plain version; at every case
   the selection (``knn_select``: ranges, points, thresholds, degrees)
   against ``knn_select_plain``, exactly, and
   ``knn_aggregate`` with a plan against without, bit for bit;
16. kNN serving slice: ``GraphNet(knn_k=8)``, GraphConv add and mean, through
   ``factory.get_model("graph_net", cfg, run_dir)`` on a JAX-format
   ``best_model.pt`` with ``DenseGraphConv_*`` keys, then ``predict`` over
   the flat-wire test loader of ``factory.get_dataloader("s2pg", cfg)``, held
   against the plain route, with K5's launch counts (1 selection and 2
   aggregations per batch);
17. kNN training slice: ``train.train_model("graph_net", "s2pg", cfg)`` with
   ``model.knn_k: 8`` for 3 epochs, add and mean, with K5's launch counts
   (per forward 1 selection and 2 aggregations, per backward 1 aggregation),
   the losses, the val accuracy and the checkpoints
   checked; five steps of the kernel route against the plain route; and
   ``resume_training(log_dir)`` for one more epoch, from the run's
   ``config.yaml`` alone;
18. kNN times: K5's selection, its aggregation given a
   plan forward and backward (also at width 4, conv1's input), and both in one
   call against the plain versions at N=8,192 and N=65,536; ``predict`` and
   the train step per batch on the K5 route,
   the plain route and the lineage-graph GraphConv routes; packing a flat
   batch; and a ``torch.profiler`` trace of the B=256 f32 kNN train step;
19. flagship wire (``bench.py``'s DeepSets wire: ``layout: auto``,
   ``length_sorted``, the fp16 wire, ``energy_total`` factored as
   ``event_feats``): (a) ``train.train_model`` at the config widths with
   B=256 for 3 epochs on a seeded synthetic S2PPC cache, in bf16 on
   ``trainer.device_resident`` batches and in f32 through
   ``PCC_PREFETCH=1`` and ``PCC_BG_LOADER=1``, counting DeepSets' forwards
   by wire and K1's and K2's launches on each (both wires must run, K1 and
   K2 on every dense batch, the sliced variants in bf16, val accuracy over
   the DeepSets floor); (c) ``factory.get_model`` + ``predict`` from each
   run's ``best_model.pt`` on the dense test batches against the plain
   route; (b) K1 and K2 on dense flagship batches (B=256, M=256 and M=320
   with 25% in-row padding, f32 and bf16) against the plain dense path
   (the masked row sum, and in f32 its autograd), with CUDA-event times and
   bounds; (d) packing per batch, the resident cache's first pass, and the
   train step per batch on the flat and dense wires, streaming, resident
   and prefetched, by CUDA events;
20. command line: ``cli.main([...])`` in this process on the card (so that the
   launch counts can be read, each set to 0 just before a command and read
   just after), over seeded S2PPC and S2PT caches of 1,024 / 256 / 256 events
   at the widths of ``configs/`` (``--config-dir``): ``train deep_sets`` for 2
   epochs (the run directory's files, K1 once per forward and K2 once per train
   step, val accuracy over the floor), ``evaluate`` (``metrics.json``'s three
   accuracies equal to ``predict``'s on each split, the report's supports those
   of the test split), ``infer --split test`` (a row per test event,
   probabilities within 1e-6 of ``predict``'s, ``prediction`` = probability ≥
   0.5), ``resume`` for a third epoch from the run's ``config.yaml`` alone,
   ``convert`` of ``best_model.pt`` to a reference ``state_dict``, to the JAX
   pickle and back, exactly equal; ``train fully_connected_net`` (5 epochs) and
   ``train logistic_regression`` on S2PT, each over its val floor and then
   ``evaluate``d, the logistic regression's coefficients within 2e-4 of the
   same fit on the CPU and its solve timed on both; each command's seconds;
21. GraphNet slice 2: ``train.train_model("graph_net", "s2pg", cfg)`` for 3
   epochs at B=32 on the graph training cache, at the widths of
   ``configs/graph_net.yaml``, for each arm: flat GraphConv add, mean and max
   and flat GAT (``graph_layout: flat``), in-row GraphConv and GAT with SAG,
   in-row max with and without SAG (``require_inrow``), and ``knn_k: 8``
   with GAT, SAG (mean) and max (the kNN edge-list arm), each with its launch
   counts (only in-row GAT with SAG reaches a kernel: K3 twice per forward,
   K4 twice per train step over two mirrors, the second of the keep-masked
   lists), its losses and checkpoints and its val accuracy floor; in-row GAT
   with SAG also five steps against its plain route; then ``layout: auto``
   over a cache whose first graph of each split holds a duplicate edge, an
   exact-zero weight and a node of 40 incoming edges: weighted GAT (the
   loader warns and demotes itself to the flat wire) and max (the batch of
   that node ships flat, with the loader's one warning), each trained; then
   the train step and ``predict`` per batch of every arm at B=256 (the kNN
   arms at B=32), in-row GAT with SAG also on its plain route and slice 1's
   in-row GAT beside flat GAT, and a trace of the B=256 flat GAT step;
22. host packers: every wire at B=256 packed by the C++ packers and by the
   numpy branch (``PCC_NATIVE=0``), byte for byte equal (point clouds flat
   and dense, f32 and fp16, segment ids and counts, ``energy_total``
   factored, the flagship wire length-sorted with a partial final batch;
   graphs in-row with and without the out-row mirror, f32 and fp16, flat,
   a merged multigraph demoted to flat, the host adjacency, a batch of
   edge-slot triples), with each packer's ms per batch (host clock, median
   of passes taken in turns); one event's S2PG edges by the C++ builder and
   by numpy, equal, over seeded events, ms per event both ways; and the
   train step per batch with the packing inline, C++ and numpy, beside
   pre-packed batches: the flagship DeepSets wire at B=256, flat and dense,
   f32 (K1 and K2, CUDA events), and the in-row GAT (K3, K4) and fused
   GraphConv (K6, with out-rows) at B=256 (host clock), each with its
   launch counts;
23. the hyperparameter sweep, over the caches of phases 20 and 13 at the
   configs' widths, 2 epochs: (a) ``sweep.main`` for DeepSets, 3 runs one at
   a time (``--seed 0``), the leaderboard and run directories checked, K1
   and K2 counted against each run's loaders and route, the winner through
   the command line's ``evaluate``; (b) ``sweep.main --vmap`` for GraphNet,
   4 runs, every group trained; ``train_configs_vmapped`` for (c) DeepSets,
   K = 4 arms at B=32 (K1 and K2 once an arm a step), (d) GAT, K = 4 (K3
   and K4 twice an arm, one mirror a step) and (e) GAT + SAG, K = 2 (a
   mirror for conv1 and one an arm for conv2): each arm against a
   sequential ``ModelWrapper`` run with its seed and learning rate (final
   train loss within 1e-4 relative, val accuracy within one example), the
   vmapped step against itself under ``force_plain()`` (loss and gradients
   within 1e-4), the kernels a vmapped step launches, and ms per arm-step
   vmapped against K sequential steps by CUDA events, in turns; the phase's
   seconds.

24. fused step windows, the tail route, remat and tracing: (a) a window
   of 16 same-shape resident batches (``fuse_steps=16``, one CUDA graph)
   against the same 16 steps run eagerly by the unfused trainer from the
   same weights, three times (warm-up, capture, replay), then a fused
   ``predict`` against an unfused one three times, on bench.py's flagship
   wire (B=256 clouds of 256 points, dense fp16 rows, ``energy_total``
   factored, f32) and on the configs' DeepSets, in-row GAT, fused GraphConv
   and kNN routes at B=32: per-step losses within 1e-5 relative, the
   parameters after within 1e-4, probabilities within 1e-4; each fused
   pass's launches, counted from 0 around it alone, equal to its eager
   steps' and naming the route's kernels; one train and one eval graph,
   each captured once and replayed; a profiled replay running each
   kernel, by name, as often as the replay counts its launches; ms a micro-step
   fused, eager, and eager with torch's default (non-capturable) Adam by
   CUDA events, in turns, an optimizer step alone of each form, each
   pass's idle share by the profiler, capture seconds; (b) ``fused_phi="tail"``: K1 and
   K2 over one bare linear [256, 256] at the flagship shape against their
   plain versions, timed against their bounds, and ``train_model`` for 3
   epochs over phase 6's cache with K1 and K2 counted and the val accuracy
   over its floor; (c) ``PCC_PHI_REMAT=0`` against ``1`` on the plain route
   (layer norm) at φ widths 256, 512 and 1024, B=256: ms a train step by
   CUDA events, in turns, and peak memory; (d) ``train_model`` with
   ``PCC_TRACE=1``: its trace names K1 and K2;
25. int8 evaluation and the serving export, over phase 20's trained DeepSets
   run and phase 13's in-row GAT run: (a) the int8 chain at the configs'
   widths, B=256, on the flat and dense fp16 wires, f32 and bf16, against the
   same chain on the CPU (the first layer's codes and scales equal, logits
   within 1e-4; bf16 3e-2), against the float ``predict`` (probabilities
   within 0.05, decisions equal wherever the float probability lies 0.01 or
   more from 0.5), with no K1 launch in the int8 ``predict`` and one a batch
   in the float one; a fused eval window of 16 batches (``fuse_steps=16``)
   with int8 captured and replayed, within 1e-6 of the eager int8
   ``predict``; (b) ``evaluate --quant int8`` through ``cli.main``
   (``eval_int8/metrics.json`` with ``"quant": "int8"``, no kernel launch);
   (c) the eval step's ms a resident B=256 batch (P=65,536, CUDA events, in
   turns) on the float K1 route, the float plain route and the int8 chain
   at φ widths 256, 512, 1024 and 2048 (``bench.py --eval-device
   --phi-width``), and each int8 layer's quantize pass and ``torch._int_mm``
   alone against their bounds (bytes over 3.35 TB/s, s8 operations over
   1,979 TOPS), with ``torch._int_mm`` on the weight codes row-major beside
   the column-major order the chain hands it; over 36 shapes
   ``int8_matmul`` exact and the row-major order's refusals; (d) ``export``
   through ``cli.main`` of the DeepSets run (float and int8) and the in-row
   GAT run for the card and the CPU,
   ``ExportedModel`` on each device within 1e-5 of ``predict`` of the same
   route there, no kernel launch while a program runs, a ``KeyError`` on a
   shape not exported, and an exported ``predict`` a batch beside
   ``predict``'s (host clock);
26. raw showers: (a) the JAX generator's showers, proton and piM, 2 files of
   2,000 events each (~80k steps), written by the port's HDF5 writer
   (``data/h5lite.py``) and read back equal, with the reader's MB/s; (b)
   ``train deep_sets --create-dataset`` through ``cli.main`` at the
   configs' widths for 3 epochs (K1 once a forward, K2 once a train step,
   the val accuracy over a floor set on the CPU); (c) ``create-datasets``
   of S2PT, S2PPC and S2PG with ``--workers 1`` and ``--workers 4``
   (forked from this process after CUDA is up), equal arrays and, for the
   ``save_npz`` caches, equal bytes, with seconds per representation; (d) a
   GAT (the configs' widths) trained 2 epochs on the created S2PG (K3
   twice a forward, K4 twice a train step over one mirror); (e) ``infer-raw``
   of one raw file for each run (K1 once a batch, K3 twice), each event of
   the file in the cached test split within 1e-5 of ``infer --split
   test``'s probability; (f) each run served by ``make_server(port=0)`` in
   a thread: ``/health``, ``/predict`` of the file's bytes within 1e-6 of
   ``infer-raw``'s, the kernel launches of that request, garbage a 400, a
   run whose scaler is missing a 500, and ms a request against events a
   request.

Beside each kernel's time the script works out the least time the card could
take for the same work (``bound_ms``: the bytes the function must move over
3.35 TB/s, or its operations over 67 TFLOP/s of f32 outside the tensor
cores, whichever is longer; for K1 and K2 in bf16 the operations over 989
TFLOP/s of dense bf16 in the tensor cores) and, where one PyTorch call
computes the same function, that call's time (``library_ms``).

The line before the last is one JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import filecmp
import glob
import io
import itertools
import json
import operator
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import torch

from point_cloud_classifier_tpu_torch import cli, convert, factory, serving
from point_cloud_classifier_tpu_torch import sweep as port_sweep
from point_cloud_classifier_tpu_torch import train as port_train
from point_cloud_classifier_tpu_torch.data import GraphLoader, PointCloudLoader
from point_cloud_classifier_tpu_torch.data.prefetch import prefetch_to_device
from point_cloud_classifier_tpu_torch.data.resident import ResidentCache
from point_cloud_classifier_tpu_torch.data.h5lite import read_h5
from point_cloud_classifier_tpu_torch.data.hdf5 import find_shower_files
from point_cloud_classifier_tpu_torch.data.pointcloud import frame_to_point_loader
from point_cloud_classifier_tpu_torch.data.synthetic import (
    lineage_graphs,
    write_s2pg_cache,
    write_s2ppc_cache,
    write_s2pt_cache,
    write_shower_file,
)
from point_cloud_classifier_tpu_torch.graph_kernel_times import device_ms
from point_cloud_classifier_tpu_torch.models import DeepSets, GraphNet, LogRegression, ModelWrapper
from point_cloud_classifier_tpu_torch.models.wrapper import _make_optimizer, put_batch
from point_cloud_classifier_tpu_torch.models.deep_sets import dense_segment_ids
from point_cloud_classifier_tpu_torch.data.graph import build_event_edges
from point_cloud_classifier_tpu_torch.native import kernel_library
from point_cloud_classifier_tpu_torch.native.host import build_event_edges_native, host_library
from point_cloud_classifier_tpu_torch.ops.dispatch import force_plain
from point_cloud_classifier_tpu_torch.ops.fused_phi import (
    _phi_pool_bwd_cuda,
    phi_forward,
    phi_pool,
    phi_pool_bwd_plain,
    phi_pool_plain,
)
from point_cloud_classifier_tpu_torch.ops.gat import (
    _gat_attention_bwd_cuda,
    _gat_out_rows_cuda,
    adjacency_mask,
    attention_form,
    gat_attention,
    gat_attention_bwd_plain,
    gat_attention_plain,
    gat_out_rows,
    gat_out_rows_plain,
)
from point_cloud_classifier_tpu_torch.ops.inrow_graph import (
    _inrow_aggregate_cuda,
    aggregate_form,
    inrow_aggregate,
    inrow_aggregate_plain,
)
from point_cloud_classifier_tpu_torch.ops.knn import (
    _knn_aggregate_bwd_cuda,
    _knn_aggregate_cuda,
    knn_aggregate,
    knn_aggregate_bwd_plain,
    knn_aggregate_plain,
    knn_select,
    knn_select_plain,
)
from point_cloud_classifier_tpu_torch.ops.activations import resolve_activation
from point_cloud_classifier_tpu_torch.ops.quant import (
    int8_matmul,
    int_mm_operands,
    quantize_cols,
    quantize_rows,
)
from point_cloud_classifier_tpu_torch.parallel import VmappedArms, train_configs_vmapped
from point_cloud_classifier_tpu_torch.server import make_server
from point_cloud_classifier_tpu_torch.utils.config import load_config, save_config

SEED = 0
# configs/deep_sets.yaml (model, dataset and trainer sections)
CONFIG = {
    "model": {
        "input_dim": 6,
        "phi_layers": [256, 256],
        "rho_layers": [256],
        "output_dim": 1,
        "sparse_batching": True,
        "pooling": "mean",
        "layer_norm": False,
        "activation": "gelu",
        "residual_block": True,
    },
    "dataset": {"batch_size": 32, "sparse_batching": True, "energy_cutoff": 0.015},
    "trainer": {"epochs": 15, "learning_rate": 0.001, "optimizer": "adamw"},
}
SPEC = (("plain", False), ("residual", False))  # φ [256, 256] with residual_block
# Bounds on max |kernel − plain| / max(1, max |plain|).  f32: both sides sum
# in f32 but in other orders (the kernel's sequential FMAs and run-length
# atomics, cuBLAS's blocked GEMM and index_add's atomics).  bf16: a
# reordered f32 dot can round to the neighbouring bf16 value (2^-8
# relative) before the chain and the pool carry it on.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K2 against phi_pool_bwd_plain, per gradient tensor.  f32: max |Δ| /
# max(1, max |plain|) and relative Frobenius, sums in other orders (the
# kernel's FMAs and per-block slabs against cuBLAS).  bf16: relative
# Frobenius; a reordered f32 dot can round dz or dz Wᵀ to the neighbouring
# bf16 value (2^-8 relative) before the next layer carries it.  The largest
# readings at these cases on an H100 (80GB HBM3, 700 W): max relative 7.5e-7
# and relative Frobenius 4.3e-7 in f32, relative Frobenius 7.8e-5 in bf16.
BWD_F32_REL, BWD_F32_FRO, BWD_BF16_FRO = 1e-4, 1e-5, 1e-3
# predict: probabilities of the kernel path against the plain path (f32).
PROB_TOL = 1e-4
# the training slice: per-step f32 loss of the kernel route against the plain
# route from the same weights; logits on a held batch after those steps (Adam
# moves each weight by about lr·sign(g), so a gradient near 0 that the two
# routes' sum orders give opposite signs moves that weight 2·lr apart); and
# the val accuracy floor, calibrated on the CPU with the same data and
# config (0.8125 after 3 epochs there; chance is 0.5).
STEP_LOSS_RTOL = 1e-4
# the same weights reloaded: K1's atomics sum each event in another order on
# every run, so the probabilities agree to f32 rounding, not bit for bit
RELOAD_TOL = 1e-6
LOGIT_TOL = 1e-2
VAL_ACC_FLOOR = 0.70
TRACK_STEPS = 5
CONFIG_B, CONFIG_P = 32, 8192  # a batch of 32 clouds of ~224 points
FLAGSHIP_B, FLAGSHIP_P = 256, 65536  # bench.py's flagship shape
KERNELS = {
    "phi_pool": ("point_cloud_classifier_tpu_torch/csrc/phi_pool.cu",
                 "point_cloud_classifier_tpu/ops/fused_phi.py:322"),
    "phi_pool_bwd": ("point_cloud_classifier_tpu_torch/csrc/phi_pool_bwd.cu",
                     "point_cloud_classifier_tpu/ops/fused_phi.py:552"),
    "gat_attention": ("point_cloud_classifier_tpu_torch/csrc/gat_attention.cu",
                      "point_cloud_classifier_tpu/ops/gat_pallas.py:862"),
    "gat_attention_bwd": ("point_cloud_classifier_tpu_torch/csrc/gat_attention_bwd.cu",
                          "point_cloud_classifier_tpu/ops/gat_pallas.py:903"),
    "inrow_aggregate": ("point_cloud_classifier_tpu_torch/csrc/inrow_aggregate.cu",
                        "point_cloud_classifier_tpu/ops/inrow_graph.py:133"),
    "knn_aggregate": ("point_cloud_classifier_tpu_torch/csrc/knn_aggregate.cu",
                      "point_cloud_classifier_tpu/ops/knn_pallas.py:129"),
}
# The H100's published peaks (NVIDIA's data sheet, SXM part): device memory
# rate, and f32 operations outside the tensor cores (every kernel here
# accumulates in f32 on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense bf16 in the tensor cores
# configs/graph_net.yaml (model, dataset and trainer sections); the GAT arm
# sets use_gat
GRAPH_CONFIG = {
    "model": {
        "input_dim": 4,
        "output_dim": 1,
        "hidden_dim": 128,
        "activation": "tanh",
        "use_gat": False,
        "gat_heads": 4,
        "sag_pool": False,
        "pool_ratio": 0.5,
        "local_pooling": "add",
        "global_pooling": "mean",
        "deepchem_style": True,
    },
    "dataset": {"batch_size": 32, "use_weights": False, "n_features": 4},
    "trainer": {"epochs": 15, "learning_rate": 0.001},
}
GRAPH_B, FLAGSHIP_GRAPHS = 32, 256  # the config batch; bench.py's flagship GAT batch
GAT_HEADS, GAT_C = 4, 128
# K3 against gat_attention_plain: max |Δ| / max(1, max |plain|), and in bf16
# also the relative Frobenius distance.  f32: the same f32 math, the
# softmax and the α-weighted sum in other orders.  bf16: both sides round α
# to bf16 before an f32 product and sum and round the output once, but an α
# or an output computed in another order can land on the neighbouring bf16
# value (2^-8 relative; the bound allows two such steps).  The largest
# readings at these cases on an H100 (80GB HBM3, 700 W): max relative
# 2.5e-7 in f32; in bf16 max relative 2.5e-3 and relative Frobenius 1.4e-4
# (one case; the others bit-equal).
GAT_F32_REL, GAT_BF16_REL, GAT_BF16_FRO = 1e-6, 8e-3, 1e-3
# K4 against gat_attention_bwd_plain, per gradient (ds_dst, ds_src, dxw): max
# |Δ| / max(1, max |plain|) and the relative Frobenius distance.  f32: the
# same f32 math; the dots, the softmax sums and K4's sums over a source's
# destinations run in other orders than a matrix product's (K4's own order is
# fixed: two runs give the same bits).  bf16: dα and α are
# rounded to bf16 on both sides, so a dot summed in another order can land on
# the neighbouring bf16 value (2^-8 relative), which the softmax backward
# carries into the score gradients; the bf16 bounds allow two such steps.  The
# largest readings at these cases on an H100 (80GB HBM3, 700 W): f32 max
# relative 7.7e-7 and relative Frobenius 4.1e-7; bf16 max relative 7.5e-4
# (dxw, one case; six of seven bit-equal) and relative Frobenius 7.0e-5.
GAT_BWD_F32_REL, GAT_BWD_F32_FRO, GAT_BWD_BF16_REL, GAT_BWD_BF16_FRO = 1e-5, 1e-5, 8e-3, 1e-3
# K6 against inrow_aggregate_plain, forward and backward: max |Δ| / max(1,
# max |plain|).  f32: the same products, summed over the D slots in slot
# order against a matrix product's order.  bf16: exact f32 products of bf16
# values and one rounding of the output on both sides, so at most one bf16
# value apart (2^-8 relative) where the f32 sums round apart.  The largest
# readings at these cases on an H100 (80GB HBM3, 700 W) are beside the
# bounds in PERF.md.
INROW_F32_REL, INROW_BF16_REL = 1e-6, 8e-3
# bf16 "mean" backward against the autograd of the plain version, which
# divides the cotangent by the degree in f32 where the Function (as the JAX
# custom_vjp) rounds that quotient to bf16 first: one more bf16 rounding per
# addend
INROW_BF16_AUTOGRAD_REL = 3e-2
# the graph training slice: val accuracy floors (chance 0.5), set from the
# same config, data and seed on the CPU (x86, plain versions), which read
# 0.78125 for GAT and 0.761719 for the fused GraphConv after 3 epochs, and
# 0.632812 for GraphConv add after its 1 epoch
GRAPH_VAL_ACC_FLOOR = {"GAT": 0.70, "GraphConv add fused_inrow": 0.68, "GraphConv add": 0.55}
# K5 against knn_aggregate_plain and knn_aggregate_bwd_plain: max |Δ| /
# max(1, max |plain|).  Both sides form the distance in one order of
# operations, so each row's threshold and degree are equal exactly (asserted)
# and the same rows are summed.  f32: those sums in index order against a
# matrix product's order.  bf16: exact f32 sums of bf16 values and one
# rounding of the output on both sides, so at most one bf16 value apart (2^-8
# relative) where the f32 sums round apart.  The largest readings at these
# cases on an H100 (80GB HBM3, 700 W) are beside the bounds in PERF.md.
KNN_F32_REL, KNN_BF16_REL = 1e-6, 8e-3
KNN_K = 8  # model.knn_k of the kNN slices
# the kNN training slice: val accuracy floors (chance 0.5), set from the same
# config, data and seed on the CPU (x86, plain versions), which read 0.558594
# for add (eight summed neighbours drive tanh towards saturation, and three
# epochs move it little) and 0.761719 for mean after 3 epochs
KNN_VAL_ACC_FLOOR = {"add": 0.53, "mean": 0.70}
# phase 21, GraphNet slice 2: each arm's model and dataset overrides of
# configs/graph_net.yaml, trained for 3 epochs on the graph training cache
SLICE2_ARMS = (
    ("flat GraphConv add", dict(local_pooling="add"), {"graph_layout": "flat"}),
    ("flat GraphConv mean", dict(local_pooling="mean"), {"graph_layout": "flat"}),
    ("flat GraphConv max", dict(local_pooling="max"), {"graph_layout": "flat"}),
    ("flat GAT", dict(use_gat=True), {"graph_layout": "flat"}),
    ("in-row GraphConv SAG", dict(sag_pool=True), {}),
    ("in-row GAT SAG", dict(use_gat=True, sag_pool=True), {}),
    ("in-row max", dict(local_pooling="max"), {}),
    ("in-row max SAG", dict(local_pooling="max", sag_pool=True), {}),
    ("kNN GAT", dict(knn_k=KNN_K, use_gat=True), {}),
    ("kNN SAG", dict(knn_k=KNN_K, sag_pool=True, local_pooling="mean"), {}),
    ("kNN max", dict(knn_k=KNN_K, local_pooling="max"), {}),
)
# the demoted loaders, over a cache whose first graph of each split holds a
# duplicate edge, an exact-zero weight and a node of 40 incoming edges:
# weighted GAT (the zero demotes the whole loader to the flat wire) and max
# (the batch of that node ships flat, the others in-row), with the warning
# each loader gives (the JAX loader's words)
SLICE2_DEMOTED = (
    ("demoted GAT", dict(use_gat=True), "exact-zero edge weight", {"src"}),
    ("demoted max", dict(local_pooling="max"), "in/out-degree overflows", {"src", "in_src"}),
)
# val accuracy floors (chance 0.5), set below the first reading on an H100
# (80GB HBM3, 700 W): flat add 0.761719, mean 0.730469, max 0.886719, GAT
# 0.78125; in-row GraphConv SAG 0.769531, GAT SAG 0.6875, max 0.886719, max
# SAG 0.851562; kNN GAT 0.789062, SAG 0.769531 (with mean aggregation: with
# add, which learns slowly over eight neighbours as the kNN add arm does, it
# read 0.511719-0.535156 over three runs, too near chance for a floor), max
# 0.871094; demoted GAT 0.71875, max 0.808594
SLICE2_VAL_ACC_FLOOR = {
    "flat GraphConv add": 0.70, "flat GraphConv mean": 0.68, "flat GraphConv max": 0.80, "flat GAT": 0.70,
    "in-row GraphConv SAG": 0.70, "in-row GAT SAG": 0.62, "in-row max": 0.80, "in-row max SAG": 0.78,
    "kNN GAT": 0.72, "kNN SAG": 0.70, "kNN max": 0.80, "demoted GAT": 0.65, "demoted max": 0.74,
}
# phase 20, the command line: seeded caches of 1,024 / 256 / 256 events
# (S2PPC and S2PT) read at the widths of configs/; val accuracy floors
# (chance 0.5), set from the same caches, configs and seeds on the CPU (x86,
# plain versions), which read 0.773438 for DeepSets after 2 epochs, 0.800781
# for the FCN after 5 and 0.828125 for the logistic regression
CLI_EVENTS = (1024, 256, 256)
CLI_VAL_ACC_FLOOR = {"deep_sets": 0.70, "fully_connected_net": 0.75, "logistic_regression": 0.78}
# the logistic regression solved on the card against the same solve on the
# CPU: both stop at max |grad| < 1e-4 of the summed loss in f32, and sum in
# other orders
LOGREG_COEF_TOL = 2e-4
LOGREG_REPS = 5
# infer's CSV against predict: its 6 decimals (5e-7) and K1's atomics
CSV_PROB_TOL = 1e-6


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count to 0, just before a path runs."""
    phi_pool.launches = phi_pool.bwd_launches = 0
    gat_attention.launches = gat_attention.bwd_launches = gat_out_rows.launches = 0
    inrow_aggregate.launches = inrow_aggregate.bwd_launches = 0
    knn_aggregate.launches = knn_aggregate.bwd_launches = knn_select.launches = 0


def launch_counts() -> dict:
    return {"phi_pool": phi_pool.launches, "phi_pool_bwd": phi_pool.bwd_launches,
            "gat_attention": gat_attention.launches, "gat_attention_bwd": gat_attention.bwd_launches,
            "gat_out_rows": gat_out_rows.launches,
            "inrow_aggregate": inrow_aggregate.launches,
            "inrow_aggregate backward": inrow_aggregate.bwd_launches,
            "knn_select": knn_select.launches,
            "knn_aggregate": knn_aggregate.launches,
            "knn_aggregate backward": knn_aggregate.bwd_launches}


def bound_ms(n_bytes: float, n_flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """(least ms the card could take, what bounds it): the bytes over the
    memory rate or the operations over their peak (f32 outside the tensor
    cores unless said), whichever is longer."""
    by_bytes, by_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * n_flops / flops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_phase() -> None:
    built = kernel_library()
    print(f"build: {built.path.name} in {built.build_seconds:.2f} s")
    host = host_library()
    print(f"build: host library {host.path.name} in {host.build_seconds:.2f} s (g++)")


def _uniform(rng, bound, shape):
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def phi_inputs(b, p, dtype, seed, empty_event=True, final=False, widths=None):
    """Flat-wire points for ``b`` events in ``p`` rows: events contiguous,
    event 1 empty, the rest of the rows padding (segment ``b``); the φ chain
    of ``widths`` (the config's [256, 256] unless given)."""
    rng = np.random.default_rng(seed)
    sizes = rng.multinomial(int(p * 0.9), np.ones(b) / b)
    if empty_event:
        sizes[0] += sizes[1]
        sizes[1] = 0
    seg = np.full(p, b, dtype=np.int32)
    seg[: sizes.sum()] = np.repeat(np.arange(b, dtype=np.int32), sizes)
    points = rng.normal(size=(p, 6)).astype(np.float32)
    params, last = [], 6
    for width in widths or CONFIG["model"]["phi_layers"]:
        params.append((_uniform(rng, last**-0.5, (last, width)), _uniform(rng, last**-0.5, (width,))))
        last = width
    if final:
        params.append((_uniform(rng, last**-0.5, (last, last)), _uniform(rng, last**-0.5, (last,))))
    dev = torch.device("cuda")
    params = tuple(tuple(torch.from_numpy(a).to(dev) for a in layer) for layer in params)
    return torch.from_numpy(points).to(dev, dtype), torch.from_numpy(seg).to(dev), params


# (name, events, point rows, a bare final linear, the φ widths): the DeepSets
# chain takes the sliced variant of K2 and of bf16 K1 (64-row tiles, four
# blocks a tile), so P below one tile and one over it; f32 K1 and every other
# chain the general one
PHI_CASES = [
    ("config B=32 P=8192", CONFIG_B, CONFIG_P, False, None),
    ("ragged B=7 P=1001", 7, 1001, False, None),
    ("ragged B=7 P=1001 +final linear", 7, 1001, True, None),
    ("flagship B=256 P=65536", FLAGSHIP_B, FLAGSHIP_P, False, None),
    ("under one tile B=3 P=37", 3, 37, False, None),
    ("one tile + 1 B=3 P=65", 3, 65, False, None),
    ("width 64 B=7 P=1001", 7, 1001, False, [64, 64]),
    ("width 384 B=7 P=1001", 7, 1001, False, [384, 384]),
]


def expected_variant(final: bool, widths, dtype, backward: bool) -> str:
    """Which variant the C entry must choose for a case: by its shape, its
    element type and the kernel (K2 when ``backward``) alone."""
    sliced = widths is None and not final and (backward or dtype == torch.bfloat16)
    return "sliced" if sliced else "general"


def kernel_phase():
    """K1 against plain at every case; returns the config-shape f32 error."""
    config_err = None
    for name, b, p, final, widths in PHI_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            points, seg, params = phi_inputs(b, p, dtype, SEED, final=final, widths=widths)
            out = phi_pool(points, seg, SPEC, params, "gelu", b + 1)
            torch.cuda.synchronize()
            ref = phi_pool_plain(points, seg, SPEC, params, "gelu", b + 1)
            torch.cuda.synchronize()
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"{name} {dtype}: bad output {tuple(out.shape)}")
            err = (out - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            rel = err / scale
            print(f"kernel {name} {str(dtype)[6:]} [{phi_pool.variant} variant]: max_abs_err {err:.3e}, "
                  f"max_rel_err {rel:.3e} (bound {TOL[dtype]:.0e}), |ref| max {scale:.3e}")
            if not rel <= TOL[dtype]:
                raise AssertionError(f"K1 disagrees with plain: {name} {dtype} rel {rel:.3e}")
            if phi_pool.variant != expected_variant(final, widths, dtype, False):
                raise AssertionError(f"K1 {name}: the {phi_pool.variant} variant ran")
            if (b, p, dtype) == (CONFIG_B, CONFIG_P, torch.float32):
                config_err = err
    return config_err


def _errors(out, ref):
    """(max |Δ|, max |Δ| / max(1, max |ref|), relative Frobenius)."""
    diff = (out.double() - ref.double())
    err = diff.abs().max().item()
    return err, err / max(1.0, ref.abs().max().item()), (diff.norm() / ref.double().norm()).item()


def bwd_kernel_phase():
    """K2 (the Function's backward on CUDA) against phi_pool_bwd_plain at
    K1's cases, and K2 twice for bit-equal gradients; returns the
    config-shape f32 max |Δ|."""
    config_err = None
    for name, b, p, final, widths in PHI_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for with_points in (True, False):
                points, seg, params = phi_inputs(b, p, dtype, SEED, final=final, widths=widths)
                width = params[-1][0].shape[1]
                g = torch.from_numpy(
                    np.random.default_rng(SEED + 3).normal(size=(b + 1, width)).astype(np.float32)
                ).cuda()
                points.requires_grad_(with_points)
                flat = [t.requires_grad_() for layer in params for t in layer]
                out = phi_pool(points, seg, SPEC, params, "gelu", b + 1)
                wrt = ([points] if with_points else []) + flat
                grads = torch.autograd.grad(out, wrt, g)
                torch.cuda.synchronize()
                d_points, ref = phi_pool_bwd_plain(
                    points.detach(), seg, g, SPEC, params, "gelu", b + 1, with_points=with_points
                )
                torch.cuda.synchronize()
                refs = ([d_points] if with_points else []) + ref
                worst = None
                for got, want in zip(grads, refs, strict=True):
                    if got.shape != want.shape or not torch.isfinite(got).all():
                        raise AssertionError(f"K2 {name} {dtype}: bad gradient {tuple(got.shape)}")
                    e = _errors(got, want)
                    worst = e if worst is None else tuple(max(a, c) for a, c in zip(worst, e))
                if dtype == torch.float32:
                    bounds = f"max_rel bound {BWD_F32_REL:.0e}, rel_fro bound {BWD_F32_FRO:.0e}"
                    ok = worst[1] <= BWD_F32_REL and worst[2] <= BWD_F32_FRO
                else:
                    bounds = f"rel_fro bound {BWD_BF16_FRO:.0e}"
                    ok = worst[2] <= BWD_BF16_FRO
                # the same launch again: every sum of K2 runs in a fixed order
                again = _phi_pool_bwd_cuda(points.detach(), seg, g, SPEC, params, "gelu", b + 1,
                                           with_points=with_points)
                again = ([again[0]] if with_points else []) + again[1]
                same = all(torch.equal(a, c) for a, c in zip(grads, again, strict=True))
                print(f"kernel K2 {name} {str(dtype)[6:]} d_points {'on' if with_points else 'off'} "
                      f"[{phi_pool.bwd_variant} variant]: max_abs_err {worst[0]:.3e}, max_rel_err "
                      f"{worst[1]:.3e}, rel_fro {worst[2]:.3e} ({bounds}); a second run is "
                      f"{'bit-equal' if same else 'NOT bit-equal'}")
                if not ok:
                    raise AssertionError(f"K2 disagrees with plain: {name} {dtype} {worst}")
                if not same:
                    raise AssertionError(f"K2 {name} {dtype}: two runs on the same inputs differ")
                if phi_pool.bwd_variant != expected_variant(final, widths, dtype, True):
                    raise AssertionError(f"K2 {name}: the {phi_pool.bwd_variant} variant ran")
                if (b, p, dtype, with_points) == (CONFIG_B, CONFIG_P, torch.float32, False):
                    config_err = worst[0]
    return config_err


def write_jax_checkpoint(run_dir: str, rng) -> None:
    """``best_model.pt`` in the JAX package's format: a pickle of
    ``{"params", "batch_stats"}`` numpy trees under its DeepSets names."""
    m = CONFIG["model"]
    params, last = {}, m["input_dim"]
    for i, width in enumerate(m["phi_layers"]):
        params[f"phi_{i}_kernel"] = _uniform(rng, last**-0.5, (last, width))
        params[f"phi_{i}_bias"] = _uniform(rng, last**-0.5, (width,))
        last = width
    params["phi_final_kernel"] = _uniform(rng, last**-0.5, (last, last))
    params["phi_final_bias"] = _uniform(rng, last**-0.5, (last,))
    stack = {}
    for j, width in enumerate(m["rho_layers"]):
        stack[f"TorchLinear_{j}"] = {
            "kernel": _uniform(rng, last**-0.5, (last, width)),
            "bias": _uniform(rng, last**-0.5, (width,)),
        }
        last = width
    params["_MLPStack_0"] = stack
    params["TorchLinear_0"] = {
        "kernel": _uniform(rng, last**-0.5, (last, m["output_dim"])),
        "bias": _uniform(rng, last**-0.5, (m["output_dim"],)),
    }
    with open(os.path.join(run_dir, "best_model.pt"), "wb") as f:
        pickle.dump({"params": params, "batch_stats": {}}, f)


def make_clouds(rng, n_events):
    """Seeded clouds of 160-288 points (mean 224, so a batch of 32 packs into
    the P=8,192 bucket and one of 256 into P=65,536), 6 features, labels 0/1;
    cloud 7 is empty."""
    sizes = rng.integers(160, 289, size=n_events)
    sizes[7] = 0
    clouds = [rng.normal(size=(int(n), 6)).astype(np.float32) for n in sizes]
    return clouds, rng.integers(0, 2, size=n_events).astype(np.float32)


def get_model(run_dir: str, **model_overrides):
    cfg = copy.deepcopy(CONFIG)
    cfg["model"].update(model_overrides)
    return factory.get_model("deep_sets", cfg, run_dir)


def slice_phase(run_dir: str) -> int:
    """get_model + predict through the kernel, checked against the plain path;
    returns the kernel's launch count during the kernel path's predict."""
    batch_size = CONFIG["dataset"]["batch_size"]
    n_events = 5 * batch_size - 3  # 5 batches, the last partial
    clouds, labels = make_clouds(np.random.default_rng(SEED + 1), n_events)
    loader = PointCloudLoader(clouds, labels, batch_size, shuffle=False)

    model = get_model(run_dir)
    reset_launch_counts()
    y_true, probs = model.predict(loader, return_prob=True)
    launches = phi_pool.launches
    _, probs_plain = get_model(run_dir, fused_phi="off").predict(loader, return_prob=True)

    n_batches = len(loader)
    err = float(np.abs(probs - probs_plain).max())
    print(f"slice: predict over {n_batches} batches, {n_events} clouds, "
          f"{sum(len(c) for c in clouds)} points; K1 launches {launches}; "
          f"probs in [{probs.min():.4f}, {probs.max():.4f}]; "
          f"max |kernel − plain| {err:.3e} (bound {PROB_TOL:.0e})")
    if probs.shape != (n_events, 1) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities: shape {probs.shape}")
    if probs.min() < 0.0 or probs.max() > 1.0:
        raise AssertionError("probabilities outside [0, 1]")
    if not np.array_equal(y_true[:, 0], labels):
        raise AssertionError("y_true does not follow the loader's labels")
    if not err <= PROB_TOL:
        raise AssertionError(f"kernel path disagrees with plain path: {err:.3e}")
    if n_batches < 4 or launches != n_batches:
        raise AssertionError(f"K1 launched {launches} times for {n_batches} batches")
    return launches


def training_config(data_dir: str, log_dir: str, epochs: int = 3) -> dict:
    """configs/base.yaml overlaid with configs/deep_sets.yaml, at 3 epochs."""
    cfg = copy.deepcopy(CONFIG)
    cfg["meta"] = {"model_name": "", "dataset_name": ""}
    cfg["dataset"]["data_dir"] = data_dir
    cfg["logging"] = {"log_dir": log_dir}
    cfg["trainer"]["epochs"] = epochs
    return cfg


def read_metrics(log_dir: str) -> dict:
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append(row["value"])
    return out


def train_phase(work_dir: str) -> dict:
    """train_model at full width through K1 and K2, checked; then the kernel
    route against the plain route.  Returns each kernel's launch count
    during train_model."""
    data_dir = os.path.join(work_dir, "data")
    write_s2ppc_cache(data_dir, n_events=(1024, 256, 256), seed=SEED)
    cfg = training_config(data_dir, os.path.join(work_dir, "log"))
    reset_launch_counts()
    t0 = time.perf_counter()
    log_dir = port_train.train_model("deep_sets", "s2ppc", cfg, return_log_dir=True)
    seconds = time.perf_counter() - t0
    launches = {"phi_pool": phi_pool.launches, "phi_pool_bwd": phi_pool.bwd_launches}

    data = factory.get_dataloader("s2ppc", cfg)
    n_train, n_val = len(data.get_train_loader()), len(data.get_val_loader())
    metrics = read_metrics(log_dir)
    with open(os.path.join(log_dir, "meta.json")) as f:
        meta = json.load(f)["metrics"]
    losses, val_losses = metrics["Loss/train"], metrics["Loss/val"]
    epochs = len(losses)
    steps = epochs * n_train
    eval_batches = epochs * n_val + n_train + n_val  # per-epoch val, then predict on both
    print(f"train: train_model deep_sets s2ppc, {epochs} epochs of {n_train} steps (B=32), "
          f"{seconds:.1f} s; K1 launches {launches['phi_pool']} (expected {steps} steps + "
          f"{eval_batches} eval batches), K2 launches {launches['phi_pool_bwd']} (expected {steps})")
    print(f"train: Loss/train {losses}, Loss/val {val_losses}, Accuracy/val {metrics['Accuracy/val']}, "
          f"meta {meta}; StepTime/wall_ms_per_step {metrics['StepTime/wall_ms_per_step']}")
    if launches["phi_pool_bwd"] != steps:
        raise AssertionError(f"K2 launched {launches['phi_pool_bwd']} times for {steps} train steps")
    if launches["phi_pool"] != steps + eval_batches:
        raise AssertionError(f"K1 launched {launches['phi_pool']} times, not {steps + eval_batches}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not learn: epoch losses {losses}")
    if not meta["accuracy/val"] >= VAL_ACC_FLOOR:
        raise AssertionError(f"accuracy/val {meta['accuracy/val']} below {VAL_ACC_FLOOR}")
    fresh = factory.get_model("deep_sets", cfg)
    if meta["parameters"] != sum(p.numel() for p in fresh.model.parameters()):
        raise AssertionError(f"parameters {meta['parameters']} is not the model's count")

    # model.pt holds the trained wrapper's final weights, the ones whose
    # predictions gave meta's accuracy/val; best_model.pt (through get_model)
    # holds them too when the last epoch had the lowest val loss
    val_loader = data.get_val_loader()
    fresh.load(os.path.join(log_dir, "model.pt"))
    y_val, p_final = fresh.predict(val_loader, return_prob=True)
    acc = round(port_train.accuracy(y_val, (p_final >= 0.5).astype(np.float32)), 6)
    best = factory.get_model("deep_sets", cfg, log_dir)
    _, p_best = best.predict(val_loader, return_prob=True)
    best_is_final = int(np.argmin(val_losses)) == epochs - 1
    err = float(np.abs(p_best - p_final).max())
    print(f"train: model.pt reloaded: accuracy/val {acc} (meta {meta['accuracy/val']}); "
          f"best_model.pt through get_model, from epoch {int(np.argmin(val_losses)) + 1} of "
          f"{epochs}: max |Δprob| against model.pt {err:.3e}"
          + (f" (bound {RELOAD_TOL:.0e})" if best_is_final else ""))
    if acc != meta["accuracy/val"]:
        raise AssertionError("model.pt does not predict as the trained wrapper did")
    if not np.isfinite(p_best).all() or (best_is_final and not err <= RELOAD_TOL):
        raise AssertionError("best_model.pt does not hold the best epoch's weights")
    track_phase(cfg, data)
    return launches


def track_phase(cfg: dict, data) -> None:
    """TRACK_STEPS train steps of the kernel route and of a fused_phi="off"
    model from the same initial weights, on the same batches."""
    kernel = factory.get_model("deep_sets", cfg)
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["model"]["fused_phi"] = "off"
    plain = factory.get_model("deep_sets", plain_cfg)
    batches = list(data.get_train_loader())[:TRACK_STEPS]
    rel = []
    for batch in batches:
        a, b = kernel.train_step(batch).item(), plain.train_step(batch).item()
        rel.append(abs(a - b) / abs(b))
    held = kernel._put(next(iter(data.get_val_loader())))
    with torch.inference_mode():
        logits, ref = kernel.model(held, train=False), plain.model(held, train=False)
    logit_err = (logits - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    print(f"train: kernel route against plain route over {TRACK_STEPS} steps: per-step loss rel "
          f"{[f'{r:.2e}' for r in rel]} (bound {STEP_LOSS_RTOL:.0e}); held-batch logits "
          f"max_rel_err {logit_err:.3e} (bound {LOGIT_TOL:.0e})")
    if not max(rel) <= STEP_LOSS_RTOL or not logit_err <= LOGIT_TOL:
        raise AssertionError("the kernel route does not track the plain route")


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _per_model(batches, n_models):
    """One list of batches per model: ``batches`` itself when it already is
    such a list of lists, else the same list for every model."""
    return batches if isinstance(batches[0], list) else [batches] * n_models


# runs of each route timing (predict and train step per batch, host clock)
ROUTE_REPS = 6


def predict_ms_per_batch(models, batches, reps=ROUTE_REPS):
    """Per model, (median, q1, q3) of ``predict``'s ms per batch over the
    pre-packed ``batches`` (one list, or one list per model), timed in turns
    (A B B A …) ``reps`` times after a warm-up."""
    batches = _per_model(batches, len(models))
    for model, own in zip(models, batches):
        model.predict(own, return_prob=True)
    samples = [[] for _ in models]
    for rep in range(reps):
        order = range(len(models)) if rep % 2 == 0 else reversed(range(len(models)))
        for i in order:
            t0 = time.perf_counter()
            models[i].predict(batches[i], return_prob=True)  # ends in a device→host copy
            samples[i].append((time.perf_counter() - t0) * 1e3 / len(batches[i]))
    return [tuple(float(q) for q in np.percentile(s, [50, 25, 75])) for s in samples]


def train_ms_per_batch(wrappers, batches, reps=ROUTE_REPS):
    """Per wrapper, (median, q1, q3) of the train step's ms per batch (forward,
    loss, backward, AdamW step) over the pre-packed ``batches`` (one list, or
    one list per wrapper), host clock to a synchronise, timed in turns (A B B
    A …) after a warm-up pass."""
    batches = _per_model(batches, len(wrappers))
    for wrapper, own in zip(wrappers, batches):
        for batch in own:
            wrapper.train_step(batch)
    torch.cuda.synchronize()
    samples = [[] for _ in wrappers]
    for rep in range(reps):
        order = range(len(wrappers)) if rep % 2 == 0 else reversed(range(len(wrappers)))
        for i in order:
            t0 = time.perf_counter()
            for batch in batches[i]:
                wrappers[i].train_step(batch)
            torch.cuda.synchronize()
            samples[i].append((time.perf_counter() - t0) * 1e3 / len(batches[i]))
    return [tuple(float(q) for q in np.percentile(s, [50, 25, 75])) for s in samples]


def route_models(dtype: str, **overrides):
    """(plain route, kernel route) wrappers from the same seeded weights."""
    cfg = copy.deepcopy(CONFIG)
    cfg["model"]["compute_dtype"] = dtype
    plain = copy.deepcopy(cfg)
    plain["model"]["fused_phi"] = "off"
    return factory.get_model("deep_sets", plain), factory.get_model("deep_sets", cfg)


def times_phase(smi: str, run_dir: str):
    """Both kernels against their plain versions (CUDA events, plain first),
    then predict and the train step per batch (host clock) on both routes.
    Returns, per kernel, the config shape's f32 times and bound."""
    config_times = {}
    for name, b, p in (("config", CONFIG_B, CONFIG_P), ("flagship", FLAGSHIP_B, FLAGSHIP_P)):
        for dtype in (torch.float32, torch.bfloat16):
            points, seg, params = phi_inputs(b, p, dtype, SEED)
            g = torch.ones((b + 1, 256), device="cuda")
            plain_ms = cuda_ms(lambda: phi_pool_plain(points, seg, SPEC, params, "gelu", b + 1))
            kernel_ms = cuda_ms(lambda: phi_pool(points, seg, SPEC, params, "gelu", b + 1))
            bwd_plain_ms = cuda_ms(lambda: phi_pool_bwd_plain(
                points, seg, g, SPEC, params, "gelu", b + 1, with_points=False))
            bwd_ms = cuda_ms(lambda: _phi_pool_bwd_cuda(
                points, seg, g, SPEC, params, "gelu", b + 1, with_points=False))
            print(f"time phi_pool {name} B={b} P={p} {str(dtype)[6:]}: K1 [{phi_pool.variant} variant] "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; backward without d_points: K2 "
                  f"[{phi_pool.bwd_variant} variant] {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms [{smi}]")
            # every row goes through every layer (2 operations per weight);
            # the backward recomputes the chain, forms every d_W (as many
            # again) and dz·Wᵀ for every layer but the first.  The bound is of
            # the work, not of the implementation: f32 on the CUDA cores' 67
            # TFLOP/s (whatever the kernel uses), bf16 on the tensor cores'
            # 989 TFLOP/s.
            flat = [t for layer in params for t in layer]
            per_row = [2 * w.shape[0] * w.shape[1] for w, _ in params]
            out_bytes = (b + 1) * params[-1][0].shape[1] * 4
            f32 = dtype == torch.float32
            peak = F32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S
            # bf16: points and weights are read as bf16; g, the sums and the
            # weight gradients stay f32
            scale = 1 if f32 else 0.5
            fwd = bound_ms(_nbytes(points, seg) + scale * _nbytes(*flat) + out_bytes,
                           p * sum(per_row), peak)
            bwd = bound_ms(_nbytes(points, seg, g) + scale * _nbytes(*flat) + _nbytes(*flat),
                           p * (2 * sum(per_row) + sum(per_row[1:])), peak)
            print(f"bound phi_pool {name} {str(dtype)[6:]}: K1 {fwd[0]:.4f} ms by {fwd[1]}, K2 {bwd[0]:.4f} "
                  f"ms by {bwd[1]} (3.35 TB/s, "
                  f"{'67 TFLOP/s f32 outside the tensor cores' if f32 else '989 TFLOP/s dense bf16'}); "
                  f"K1 at {kernel_ms / fwd[0]:.1f}x its bound, K2 at {bwd_ms / bwd[0]:.1f}x; no single "
                  f"PyTorch call computes either")
            if name == "config" and f32:
                config_times = {
                    "phi_pool": dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=fwd[0],
                                     bound_by=fwd[1], library_ms=None),
                    "phi_pool_bwd": dict(ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bwd[0],
                                         bound_by=bwd[1], library_ms=None),
                }
    for b in (CONFIG_B, FLAGSHIP_B):
        clouds, labels = make_clouds(np.random.default_rng(SEED + 2), 4 * b)
        t0 = time.perf_counter()
        batches = list(PointCloudLoader(clouds, labels, b, shuffle=False))
        pack_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        p_pad = sorted({batch["points"].shape[0] for batch in batches})
        for dtype in ("float32", "bfloat16"):
            plain, kernel = predict_ms_per_batch(
                [get_model(run_dir, compute_dtype=dtype, fused_phi="off"),
                 get_model(run_dir, compute_dtype=dtype)],
                batches,
            )
            print(f"time predict per batch B={b} P={p_pad} {dtype}, median (q1-q3) of {ROUTE_REPS} "
                  f"runs over {len(batches)} pre-packed batches, host clock: "
                  f"K1 path {kernel[0]:.4f} ({kernel[1]:.4f}-{kernel[2]:.4f}) ms, "
                  f"plain path {plain[0]:.4f} ({plain[1]:.4f}-{plain[2]:.4f}) ms; "
                  f"packing {pack_ms:.4f} ms/batch on the host [{smi}]")
            plain, kernel = train_ms_per_batch(list(route_models(dtype)), batches)
            print(f"time train step per batch B={b} P={p_pad} {dtype} adamw, median (q1-q3) "
                  f"of {ROUTE_REPS} runs over {len(batches)} pre-packed batches, host clock to a "
                  f"synchronise: K1+K2 route {kernel[0]:.4f} ({kernel[1]:.4f}-{kernel[2]:.4f}) ms, "
                  f"plain route {plain[0]:.4f} ({plain[1]:.4f}-{plain[2]:.4f}) ms [{smi}]")
    return config_times


def _shown(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def profile_train_steps(smi: str, label: str, wrapper, batches) -> None:
    """A torch.profiler trace of one train step per batch of ``batches``:
    device busy time, idle share of the window, top device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for batch in batches:
        wrapper.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            wrapper.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    items = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=_device_us, reverse=True,
    )
    busy_ms = sum(_device_us(e) for e in items) / 1e3
    if busy_ms <= 0:
        print(f"profile train step {label}: the profiler recorded no device time; "
              f"device busy and idle share not measured [{smi}]")
        return
    n = len(batches)
    top = "; ".join(f"{e.key[:64]} {_device_us(e) / 1e3 / n:.4f} ms x{e.count / n:g}" for e in items[:8])
    # the package's own kernels (csrc/ keeps them in anonymous namespaces),
    # whatever their rank
    marker = "(anonymous namespace)::"
    own = "; ".join(f"{e.key.split(marker, 1)[1].split('(')[0]} {_device_us(e) / 1e3 / n:.4f} ms x{e.count / n:g}"
                    for e in items if e.key.startswith(f"void {marker}"))
    print(f"profile train step {label}, {n} steps under torch.profiler: device busy "
          f"{busy_ms / n:.4f} ms/step of {wall_ms / n:.4f} ms/step wall, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; top device items per step: {top}; the package's kernels per "
          f"step: {own or 'none'} [{smi}]")


def profile_phase(smi: str) -> None:
    """The B=256 f32 DeepSets train step on the kernel route."""
    clouds, labels = make_clouds(np.random.default_rng(SEED + 2), 4 * FLAGSHIP_B)
    batches = list(PointCloudLoader(clouds, labels, FLAGSHIP_B, shuffle=False))
    _, kernel = route_models("float32")
    profile_train_steps(smi, "B=256 f32 K1+K2 route", kernel, batches)


# bench.py's flagship wire (bench.py:161-207): auto layout over length-sorted
# batches, the fp16 wire, energy_total (column 1) once per event
FLAGSHIP_WIRE = {"layout": "auto", "length_sorted": True, "transfer_dtype": "float16",
                 "factor_event_cols": [1]}
# (arm, model overrides, trainer overrides, environment): bf16 on resident
# batches; f32 through the background packer and the prefetch
FLAGSHIP_ARMS = (
    ("bf16 resident", {"compute_dtype": "bfloat16"}, {"device_resident": True}, {}),
    ("f32 prefetch+background", {}, {}, {"PCC_PREFETCH": "1", "PCC_BG_LOADER": "1"}),
)
FLAGSHIP_EVENTS = (4096, 512, 512)  # 16 train steps of B=256 an epoch
# predict through K1 against the plain route on the dense test batches:
# probabilities, f32 (PROB_TOL) and bf16 (the logits' bf16 bound)
FLAGSHIP_PROB_TOL = {"f32": PROB_TOL, "bf16": TOL[torch.bfloat16]}


class WireCounter:
    """Counts DeepSets forwards by wire (a global forward pre-hook, so that
    the run goes through the entry points untouched) and K1's and K2's
    launches from each forward to the next, with the variants they took."""

    def __enter__(self):
        from torch.nn.modules.module import (
            register_module_forward_hook,
            register_module_forward_pre_hook,
        )

        self.forwards = {"dense": 0, "flat": 0}
        self.k1 = {"dense": 0, "flat": 0}
        self.k2 = {"dense": 0, "flat": 0}
        self.variants = {"dense": set(), "flat": set()}
        self._open = None  # (wire, K1 count, K2 count) at the last forward
        self._hooks = [register_module_forward_pre_hook(self._pre),
                       register_module_forward_hook(self._post)]
        return self

    def _close(self):
        if self._open is not None:
            wire, k1, k2 = self._open
            self.k1[wire] += phi_pool.launches - k1
            self.k2[wire] += phi_pool.bwd_launches - k2
            if phi_pool.bwd_launches > k2:
                self.variants[wire].add(f"K2 {phi_pool.bwd_variant}")
        self._open = None

    def _pre(self, module, args):
        if isinstance(module, DeepSets):
            self._close()
            wire = "dense" if args[0]["points"].ndim == 3 else "flat"
            self.forwards[wire] += 1
            self._open = (wire, phi_pool.launches, phi_pool.bwd_launches)

    def _post(self, module, args, output):
        if isinstance(module, DeepSets) and phi_pool.launches > self._open[1]:
            self.variants[self._open[0]].add(f"K1 {phi_pool.variant}")

    def __exit__(self, *exc):
        self._close()
        for hook in self._hooks:
            hook.remove()


def flagship_config(data_dir: str, log_dir: str, model: dict, trainer: dict) -> dict:
    cfg = training_config(data_dir, log_dir)
    cfg["dataset"].update(batch_size=FLAGSHIP_B, **FLAGSHIP_WIRE)
    cfg["model"].update(factored_cols=[1], **model)
    cfg["trainer"].update(trainer)
    return cfg


def flagship_train_phase(work_dir: str) -> dict:
    """(a) train_model on bench.py's wire at B=256, both arms, with the wires
    and K1's and K2's launches counted; (c) get_model + predict on the dense
    test batches from each run's best_model.pt, against the plain route.
    Returns the launches on dense batches over both runs."""
    data_dir = os.path.join(work_dir, "flagship_data")
    write_s2ppc_cache(data_dir, n_events=FLAGSHIP_EVENTS, seed=SEED + 5)
    dense_launches = {"phi_pool": 0, "phi_pool_bwd": 0}
    for arm, model, trainer, env in FLAGSHIP_ARMS:
        cfg = flagship_config(data_dir, os.path.join(work_dir, "flagship_log"), model, trainer)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            reset_launch_counts()
            with WireCounter() as wires:
                t0 = time.perf_counter()
                log_dir = port_train.train_model("deep_sets", "s2ppc", cfg, return_log_dir=True)
                seconds = time.perf_counter() - t0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        metrics = read_metrics(log_dir)
        with open(os.path.join(log_dir, "meta.json")) as f:
            meta = json.load(f)["metrics"]
        losses = metrics["Loss/train"]
        print(f"flagship {arm}: train_model deep_sets s2ppc B={FLAGSHIP_B} {FLAGSHIP_WIRE}, "
              f"{len(losses)} epochs, {seconds:.1f} s; DeepSets forwards by wire {wires.forwards}; "
              f"K1 launches by wire {wires.k1}, K2 {wires.k2}; variants {wires.variants}; Loss/train "
              f"{losses}, Loss/val {metrics['Loss/val']}, meta {meta} (val floor {VAL_ACC_FLOOR}); "
              f"batch shapes {metrics['compile/distinct_batch_shapes']}")
        if (phi_pool.launches, phi_pool.bwd_launches) != (sum(wires.k1.values()), sum(wires.k2.values())):
            raise AssertionError(f"flagship {arm}: launches outside DeepSets' forwards and backwards")
        if not (wires.forwards["dense"] and wires.forwards["flat"]):
            raise AssertionError(f"flagship {arm}: not both wires ran: {wires.forwards}")
        if not (wires.k1["dense"] >= wires.forwards["dense"] and wires.k2["dense"] > 0):
            raise AssertionError(f"flagship {arm}: K1/K2 did not launch on every dense batch")
        if arm.startswith("bf16") and wires.variants["dense"] != {"K1 sliced", "K2 sliced"}:
            raise AssertionError(f"flagship {arm}: dense variants {wires.variants['dense']}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError(f"flagship {arm}: training did not learn: {losses}")
        if not meta["accuracy/val"] >= VAL_ACC_FLOOR:
            raise AssertionError(f"flagship {arm}: accuracy/val {meta['accuracy/val']} below {VAL_ACC_FLOOR}")
        dense_launches["phi_pool"] += wires.k1["dense"]
        dense_launches["phi_pool_bwd"] += wires.k2["dense"]
        flagship_predict_phase(arm, cfg, log_dir)
    return dense_launches


def flagship_predict_phase(arm: str, cfg: dict, log_dir: str) -> None:
    """(c) the run's best_model.pt through get_model + predict over the test
    split on the dense wire, K1 route against the plain route."""
    cfg = copy.deepcopy(cfg)
    cfg["dataset"]["layout"] = "dense"
    loader = factory.get_dataloader("s2ppc", cfg).get_test_loader()
    reset_launch_counts()
    y, probs = factory.get_model("deep_sets", cfg, log_dir).predict(loader, return_prob=True)
    launches = phi_pool.launches
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["model"]["fused_phi"] = "off"
    y_plain, probs_plain = factory.get_model("deep_sets", plain_cfg, log_dir).predict(loader, return_prob=True)
    err = float(np.abs(probs - probs_plain).max())
    tol = FLAGSHIP_PROB_TOL[arm.split()[0]]
    print(f"flagship {arm}: predict from best_model.pt on {len(loader)} dense test batches, "
          f"{len(probs)} clouds; K1 launches {launches}; max |Δprob| kernel − plain {err:.3e} "
          f"(bound {tol:.0e})")
    if probs.shape != (FLAGSHIP_EVENTS[2], 1) or not np.isfinite(probs).all():
        raise AssertionError(f"flagship {arm}: bad probabilities {probs.shape}")
    if launches != len(loader) or not np.array_equal(y, y_plain) or not err <= tol:
        raise AssertionError(f"flagship {arm}: predict disagrees or missed K1 ({launches}, {err:.3e})")


def dense_phi_inputs(m: int, dtype, seed: int):
    """A dense flagship batch, B=256 rows of M, flattened: M=256 rows hold
    240-256 points, M=320 rows 160-320 (25% in-row padding on average); the
    ids as DeepSets makes them; the config chain's weights."""
    rng = np.random.default_rng(seed)
    lo = 240 if m == 256 else 160
    counts = torch.from_numpy(rng.integers(lo, m + 1, size=FLAGSHIP_B).astype(np.int32)).cuda()
    points, _, params = phi_inputs(FLAGSHIP_B, FLAGSHIP_B * m, dtype, seed)
    return points, counts, dense_segment_ids(counts, m), params


def plain_dense_pool(points, counts, params, m: int):
    """The plain dense path: φ on every row, then the masked row sum in f32."""
    h = phi_forward(points, SPEC, params, "gelu").float().reshape(FLAGSHIP_B, m, -1)
    mask = (torch.arange(m, device=points.device)[None, :] < counts[:, None]).float()
    return torch.einsum("bm,bmh->bh", mask, h)


def flagship_kernel_phase(smi: str) -> dict:
    """(b) K1 and K2 on dense flagship batches (M=256 and 320, f32 and bf16)
    against the plain dense path, with CUDA-event times and bounds.  Returns
    the M=256 f32 times and errors."""
    out = {}
    for m in (256, 320):
        for dtype in (torch.float32, torch.bfloat16):
            points, counts, ids, params = dense_phi_inputs(m, dtype, SEED + 6)
            b1 = FLAGSHIP_B + 1
            total = phi_pool(points, ids, SPEC, params, "gelu", b1)
            ref = plain_dense_pool(points, counts, params, m)
            torch.cuda.synchronize()
            err = (total[:FLAGSHIP_B] - ref).abs().max().item()
            rel = err / max(1.0, ref.abs().max().item())
            # backward: K2 against the autograd of the plain dense path (f32)
            # and against its plain version on the same ids
            g = torch.from_numpy(np.random.default_rng(SEED + 7).normal(
                size=(b1, 256)).astype(np.float32)).cuda()
            g[FLAGSHIP_B] = 0  # the padding row's cotangent: the model slices it off
            d_points, grads = _phi_pool_bwd_cuda(points, ids, g, SPEC, params, "gelu", b1)
            got = [d_points, *grads]
            want_plain = phi_pool_bwd_plain(points, ids, g, SPEC, params, "gelu", b1)
            wants = [("phi_pool_bwd_plain", [want_plain[0], *want_plain[1]])]
            if dtype == torch.float32:
                leaves = [points.detach().requires_grad_()] + [
                    t.detach().requires_grad_() for layer in params for t in layer]
                ref_total = plain_dense_pool(leaves[0], counts, tuple(zip(leaves[1::2], leaves[2::2])), m)
                wants.append(("autograd of the plain dense path",
                              list(torch.autograd.grad(ref_total, leaves, g[:FLAGSHIP_B]))))
            lines = []
            for what, want in wants:
                worst = None
                for a, c in zip(got, want, strict=True):
                    e = _errors(a, c)
                    worst = e if worst is None else tuple(max(x, y) for x, y in zip(worst, e))
                ok = (worst[1] <= BWD_F32_REL and worst[2] <= BWD_F32_FRO) if dtype == torch.float32 \
                    else worst[2] <= BWD_BF16_FRO
                lines.append(f"against {what} max_abs_err {worst[0]:.3e}, max_rel_err {worst[1]:.3e}, "
                             f"rel_fro {worst[2]:.3e}")
                if not ok:
                    raise AssertionError(f"K2 on the dense wire M={m} {dtype}: {what} {worst}")
            name = f"dense B={FLAGSHIP_B} M={m} {str(dtype)[6:]}"
            n_points = int(counts.sum())
            kernel_ms = cuda_ms(lambda: phi_pool(points, ids, SPEC, params, "gelu", b1))
            plain_ms = cuda_ms(lambda: plain_dense_pool(points, counts, params, m))
            bwd_ms = cuda_ms(lambda: _phi_pool_bwd_cuda(points, ids, g, SPEC, params, "gelu", b1,
                                                        with_points=False))
            bwd_plain_ms = cuda_ms(lambda: phi_pool_bwd_plain(points, ids, g, SPEC, params, "gelu", b1,
                                                              with_points=False))
            # the bound counts the real points' work (the padding rows are
            # read, as the input holds them, but need no operations)
            flat = [t for layer in params for t in layer]
            per_row = [2 * w.shape[0] * w.shape[1] for w, _ in params]
            f32 = dtype == torch.float32
            peak, scale = (F32_FLOPS_PER_S, 1) if f32 else (BF16_FLOPS_PER_S, 0.5)
            fwd = bound_ms(_nbytes(points, ids) + scale * _nbytes(*flat) + b1 * 256 * 4,
                           n_points * sum(per_row), peak)
            bwd = bound_ms(_nbytes(points, ids, g) + scale * _nbytes(*flat) + _nbytes(*flat),
                           n_points * (2 * sum(per_row) + sum(per_row[1:])), peak)
            print(f"flagship kernel K1 {name} ({n_points} points, {1 - n_points / (FLAGSHIP_B * m):.3f} "
                  f"in-row padding) [{phi_pool.variant} variant]: max_abs_err {err:.3e}, max_rel_err "
                  f"{rel:.3e} (bound {TOL[dtype]:.0e}) against the masked row sum; K2 "
                  f"[{phi_pool.bwd_variant} variant] {'; '.join(lines)}")
            print(f"time flagship {name}: K1 {kernel_ms:.4f} ms (bound {fwd[0]:.4f} by {fwd[1]}), "
                  f"plain dense forward {plain_ms:.4f} ms; K2 without d_points {bwd_ms:.4f} ms (bound "
                  f"{bwd[0]:.4f} by {bwd[1]}), plain {bwd_plain_ms:.4f} ms [{smi}]")
            if not rel <= TOL[dtype]:
                raise AssertionError(f"K1 on the dense wire disagrees: {name} rel {rel:.3e}")
            if (m, f32) == (256, True):
                out = {"dense_ms": {"phi_pool": kernel_ms, "phi_pool_bwd": bwd_ms},
                       "dense_plain_ms": {"phi_pool": plain_ms, "phi_pool_bwd": bwd_plain_ms},
                       "dense_bound_ms": {"phi_pool": fwd[0], "phi_pool_bwd": bwd[0]},
                       "dense_max_abs_err": {"phi_pool": err}}
    return out


def events_ms_per_batch(wrappers, makers, rounds: int = 2):
    """Per (wrapper, batch maker), the train step's ms per batch by CUDA
    events over one pass of ``make()`` (the device timeline from the first
    step's start to the last one's end, host gaps included), after a
    warm-up pass; the arms taken in turns (A B C C B A …) ``rounds`` times.
    Returns each arm's readings."""
    for wrapper, make in zip(wrappers, makers):
        for batch in make():
            wrapper.train_step(batch)
    torch.cuda.synchronize()
    samples = [[] for _ in wrappers]
    arms = list(range(len(wrappers)))
    for turn in range(2 * rounds):
        for i in arms if turn % 2 == 0 else arms[::-1]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            n = 0
            start.record()
            for batch in makers[i]():
                wrappers[i].train_step(batch)
                n += 1
            end.record()
            torch.cuda.synchronize()
            samples[i].append(start.elapsed_time(end) / n)
    return samples


def flagship_times_phase(smi: str, work_dir: str) -> None:
    """(d) packing per batch; the resident cache's first pass per batch, one
    upload a batch against 64 stacked; and the train step per batch at B=256
    on the flagship wire, flat and dense, streaming, resident and prefetched,
    f32 and bf16, by CUDA events."""
    data_dir = os.path.join(work_dir, "flagship_data")
    wires = {}
    for layout in ("flat", "dense"):
        for transfer in ("float32", "float16"):
            cfg = flagship_config(data_dir, os.path.join(work_dir, "unused"), {}, {})
            cfg["dataset"].update(layout=layout, transfer_dtype=transfer)
            loader = factory.get_dataloader("s2ppc", cfg).get_train_loader()
            t0 = time.perf_counter()
            batches = list(loader)
            pack_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
            shapes = sorted({b["points"].shape for b in batches})
            print(f"flagship packing {layout} {transfer} B={FLAGSHIP_B}: {pack_ms:.4f} ms/batch on the "
                  f"host over {len(batches)} batches, points shapes {shapes}")
            if transfer == "float16":
                wires[layout] = batches
    for layout, batches in wires.items():
        for chunk in (1, 64):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            list(ResidentCache(batches, upload_chunk=chunk))
            torch.cuda.synchronize()
            print(f"flagship resident first pass {layout} fp16, upload_chunk {chunk}: "
                  f"{(time.perf_counter() - t0) * 1e3 / len(batches):.4f} ms/batch, host clock "
                  f"to a synchronise [{smi}]")
    for dtype in ("float32", "bfloat16"):
        cfg = flagship_config(data_dir, os.path.join(work_dir, "unused"), {"compute_dtype": dtype}, {})
        for layout, batches in wires.items():
            cache = ResidentCache(batches, shuffle_seed=SEED)
            list(cache)  # the first pass uploads
            pipelines = {"streaming": lambda: batches, "resident": lambda: cache,
                         "prefetch": lambda: prefetch_to_device(batches, size=2)}
            samples = events_ms_per_batch([factory.get_model("deep_sets", cfg) for _ in pipelines],
                                          list(pipelines.values()))
            row = ", ".join(f"{name} {np.median(ms):.4f} ({min(ms):.4f}-{max(ms):.4f})"
                            for name, ms in zip(pipelines, samples))
            print(f"time flagship train step per batch B={FLAGSHIP_B} {layout} fp16 wire, {dtype}, "
                  f"K1+K2 route, median (range) of {len(samples[0])} passes over {len(batches)} "
                  f"batches taken in turns, CUDA events: {row} ms [{smi}]")


def _graph_batch(graphs, batch_size, transfer_dtype="float32"):
    """The first dense in-row batch of ``graphs``, as numpy arrays."""
    loader = GraphLoader(graphs, batch_size, shuffle=False, layout="dense",
                         use_weights=False, transfer_dtype=transfer_dtype)
    return next(iter(loader))


def gat_inputs(case: str, dtype, seed: int = SEED):
    """(s_dst, s_src, in_src, in_w, xw) on the card for one K3 case: H=4 heads
    over C=128 channels unless the case names others."""
    rng = np.random.default_rng(seed)
    heads, channels = GAT_SHAPES.get(case, (GAT_HEADS, GAT_C))
    wire = {"config B=32": (GRAPH_B, 160, 288, "float32"),
            "config B=32 fp16/int16 wire": (GRAPH_B, 160, 288, "float16"),
            "flagship B=256 M=256": (FLAGSHIP_GRAPHS, 256, 256, "float32")}
    if case in wire:
        b, lo, hi, transfer = wire[case]
        batch = _graph_batch(lineage_graphs(rng, b, lo, hi), b, transfer)
        in_src, in_w = batch["in_src"], batch["in_w"]
        b, m, _ = in_src.shape
    else:
        # ragged random in-row lists; "tiny id pool" draws sources from 6 ids,
        # so most rows hold duplicates and self-edges; "isolated" empties
        # every slot of the first 9 nodes
        b, m, d = {"ragged M=37 D=4": (5, 37, 4), "ragged M=61 D=8": (3, 61, 8),
                   "D=32 tiny id pool": (3, 45, 32), "isolated D=8": (2, 40, 8),
                   "H=4 C=100 M=53 D=8": (3, 53, 8), "H=3 C=96 M=45 D=8": (3, 45, 8)}[case]
        in_src = rng.integers(0, 6 if "tiny" in case else m, size=(b, m, d)).astype(np.int32)
        in_w = (rng.random((b, m, d)) * (rng.random((b, m, d)) < 0.6)).astype(np.float32)
        if "isolated" in case:
            in_w[:, :9] = 0.0
    dev = torch.device("cuda")
    s_dst, s_src = (torch.from_numpy(rng.normal(size=(b, m, heads)).astype(np.float32)).to(dev)
                    for _ in range(2))
    xw = torch.from_numpy(rng.normal(size=(b, m, channels)).astype(np.float32)).to(dev, dtype)
    return s_dst, s_src, torch.from_numpy(in_src).to(dev), torch.from_numpy(in_w).to(dev), xw


# the cases reach every form of K3 (ops/gat.py:attention_form): the piece
# form with two pieces a lane (f32) and one (bf16) at the configs' shape and
# with three heads, and the channel form at D=32 with four heads and at a
# head of 25 channels
GAT_CASES = ("config B=32", "config B=32 fp16/int16 wire", "ragged M=37 D=4", "ragged M=61 D=8",
             "D=32 tiny id pool", "isolated D=8", "H=4 C=100 M=53 D=8", "H=3 C=96 M=45 D=8",
             "flagship B=256 M=256")
GAT_SHAPES = {"H=4 C=100 M=53 D=8": (4, 100), "H=3 C=96 M=45 D=8": (3, 96)}


def gat_form(args) -> str:
    """The form K3 takes for these inputs, as ops/gat.py chooses it."""
    s_dst, _, in_src, _, xw = args
    per = attention_form(s_dst.shape[-1], xw.shape[-1], in_src.shape[-1], xw.dtype)
    return f"piece form, two nodes a warp, {per} piece{'s' if per > 1 else ''} a lane" if per else "channel form"


def gat_kernel_phase():
    """K3 against gat_attention_plain at every case; returns the config-shape
    f32 max |Δ|."""
    config_err = None
    for case in GAT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = gat_inputs(case, dtype)
            out = gat_attention(*args)
            again = gat_attention(*args)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"K3 {case} {dtype}: two runs on the same inputs differ")
            ref = gat_attention_plain(*args)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype or not torch.isfinite(out).all():
                raise AssertionError(f"K3 {case} {dtype}: bad output {tuple(out.shape)} {out.dtype}")
            err, rel, fro = _errors(out, ref)
            if "isolated" in case:
                alone = (out[:, :9] - args[-1][:, :9]).abs().max().item()
                if not alone <= GAT_F32_REL * max(1.0, args[-1].abs().max().item()):
                    raise AssertionError(f"K3 {case}: isolated nodes are not their own row ({alone:.3e})")
            if dtype == torch.float32:
                bounds, ok = f"max_rel bound {GAT_F32_REL:.0e}", rel <= GAT_F32_REL
            else:
                bounds = f"max_rel bound {GAT_BF16_REL:.0e}, rel_fro bound {GAT_BF16_FRO:.0e}"
                ok = rel <= GAT_BF16_REL and fro <= GAT_BF16_FRO
            print(f"kernel K3 {case} B,M,D={tuple(args[2].shape)} in_w {str(args[3].dtype)[6:]}, "
                  f"in_src {str(args[2].dtype)[6:]}, xw {str(dtype)[6:]} [{gat_form(args)}]: max_abs_err "
                  f"{err:.3e}, max_rel_err {rel:.3e}, rel_fro {fro:.3e} ({bounds}); two runs torch.equal")
            if not ok:
                raise AssertionError(f"K3 disagrees with plain: {case} {dtype} {(err, rel, fro)}")
            if (case, dtype) == ("config B=32", torch.float32):
                config_err = err
    return config_err


def gat_bound(args, backward: bool):
    """K3's or K4's bound for these inputs: every operand read once and every
    result written once; per attended pair (a kept slot or the self-loop, as
    this run's lists have them) 2·C operations for the weighted sum and a few
    per head for the logit and the softmax, and for the backward the dα dots
    and the dxw products on top."""
    s_dst, s_src, in_src, in_w, xw = args
    pairs = int(adjacency_mask(in_src, in_w, s_dst.shape[1]).sum())
    h, c = s_dst.shape[-1], xw.shape[-1]
    if backward:  # reads the five operands and g; writes ds_dst, ds_src, dxw
        return bound_ms(_nbytes(*args, xw) + _nbytes(s_dst, s_src, xw), pairs * (4 * c + 16 * h))
    return bound_ms(_nbytes(*args) + _nbytes(xw), pairs * (2 * c + 8 * h))


def graph_config(data_dir: str, use_gat: bool, **model) -> dict:
    cfg = copy.deepcopy(GRAPH_CONFIG)
    cfg["model"].update(use_gat=use_gat, **model)
    cfg["dataset"]["data_dir"] = data_dir
    return cfg


def write_graph_checkpoint(run_dir: str, cfg: dict, seed: int) -> None:
    """``best_model.pt`` in the JAX package's format (a pickle of
    ``{"params", "batch_stats"}`` numpy trees under its GraphNet names): the
    port's seeded initial weights with every bias and running statistic
    moved off its initial value, and the head scaled up."""
    net = GraphNet(**cfg["model"], generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    state = {k: v.numpy() + (rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
                             if k.endswith(("bias", "running_mean", "running_var")) else 0)
             for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}
    state["fc2.weight"] *= 16.0  # logits spread, so probabilities span (0, 1)
    params, stats = convert.convert_torch_state_dict("graph_net", cfg, state)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "best_model.pt"), "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats}, f)


def graph_slice_phase(work_dir: str) -> int:
    """get_model("graph_net") + predict over the s2pg test loader, GAT and
    GraphConv add, each held against its plain route; returns K3's launch
    count during the GAT predict."""
    data_dir = os.path.join(work_dir, "s2pg")
    write_s2pg_cache(data_dir, n_graphs=(64, 64, 5 * GRAPH_B - 3), seed=SEED)
    gat_launches = None
    for name, use_gat in (("GAT", True), ("GraphConv add", False)):
        cfg = graph_config(data_dir, use_gat)
        run_dir = os.path.join(work_dir, f"graph_run_{int(use_gat)}")
        write_graph_checkpoint(run_dir, cfg, SEED + 7)
        model = factory.get_model("graph_net", cfg, run_dir)
        loader = factory.get_dataloader("s2pg", cfg).get_test_loader()
        reset_launch_counts()
        y_true, probs = model.predict(loader, return_prob=True)
        launches = gat_attention.launches
        if phi_pool.launches or phi_pool.bwd_launches:
            raise AssertionError(f"{name}: a DeepSets kernel launched on the graph path")
        with force_plain():
            _, probs_plain = model.predict(loader, return_prob=True)
        n_batches = len(loader)
        err = float(np.abs(probs - probs_plain).max())
        rungs = sorted({b["nodes"].shape[1] for b in loader})
        slots = sorted({b["in_src"].shape[2] for b in loader})
        print(f"graph slice {name}: predict over {n_batches} batches of {GRAPH_B}, {loader.n_examples} "
              f"graphs, M {rungs}, D {slots}; K3 launches {launches}; probs in "
              f"[{probs.min():.4f}, {probs.max():.4f}]; max |kernel − plain| {err:.3e} "
              f"(bound {PROB_TOL:.0e})")
        if probs.shape != (loader.n_examples, 1) or not np.isfinite(probs).all():
            raise AssertionError(f"{name}: bad probabilities, shape {probs.shape}")
        if probs.min() < 0.0 or probs.max() > 1.0 or probs.std() == 0.0:
            raise AssertionError(f"{name}: probabilities outside [0, 1] or all equal")
        if not np.array_equal(y_true[:, 0], loader.labels):
            raise AssertionError(f"{name}: y_true does not follow the loader's labels")
        if not err <= PROB_TOL:
            raise AssertionError(f"{name}: kernel route disagrees with plain route: {err:.3e}")
        if n_batches < 4 or launches != (2 * n_batches if use_gat else 0):
            raise AssertionError(f"{name}: K3 launched {launches} times for {n_batches} batches")
        if use_gat:
            gat_launches = launches
    return gat_launches


class PlainRoute:
    """A wrapper whose ``predict`` and ``train_step`` run inside
    ``force_plain()``."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    def train_step(self, batch):
        with force_plain():
            return self.wrapper.train_step(batch)

    def predict(self, batches, return_prob=False):
        with force_plain():
            return self.wrapper.predict(batches, return_prob)


def graph_times_phase(smi: str, run_dir: str):
    """K3 against its plain version (CUDA events, plain first), then predict
    per batch (host clock) on both routes, and a profile of the B=256 GAT
    predict.  Returns the config shape's f32 times and bound."""
    config_times = None
    for case in ("config B=32", "flagship B=256 M=256"):
        for dtype in (torch.float32, torch.bfloat16):
            args = gat_inputs(case, dtype)
            with torch.no_grad():
                plain_ms = cuda_ms(lambda: gat_attention_plain(*args))
                kernel_ms = cuda_ms(lambda: gat_attention(*args))
                device = device_ms(lambda: gat_attention(*args))[0]
            print(f"time gat_attention {case} B,M,D={tuple(args[2].shape)} H={GAT_HEADS} C={GAT_C} "
                  f"{str(dtype)[6:]} [{gat_form(args)}]: K3 {kernel_ms:.4f} ms by events, "
                  f"{_shown(device)} a launch on the profiler's device rows; plain {plain_ms:.4f} ms [{smi}]")
            if dtype == torch.float32:
                bound = gat_bound(args, backward=False)
                print(f"bound gat_attention {case} f32: K3 {bound[0]:.4f} ms by {bound[1]}; no single "
                      f"PyTorch call computes it")
                if case == "config B=32":
                    config_times = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound[0],
                                        bound_by=bound[1], library_ms=None)
    for b in (GRAPH_B, FLAGSHIP_GRAPHS):
        graphs = lineage_graphs(np.random.default_rng(SEED + 2), 4 * b)
        t0 = time.perf_counter()
        batches = list(GraphLoader(graphs, b, shuffle=False, layout="dense", use_weights=False))
        pack_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        shape = sorted({tuple(batch["in_src"].shape[1:]) for batch in batches})
        for dtype in ("float32", "bfloat16"):
            gat = factory.get_model("graph_net", graph_config("", True, compute_dtype=dtype), run_dir)
            conv = factory.get_model("graph_net", graph_config("", False, compute_dtype=dtype))
            kernel, plain, graphconv = predict_ms_per_batch([gat, PlainRoute(gat), conv], batches)
            print(f"time predict per batch B={b} (M, D)={shape} {dtype}, median (q1-q3) of {ROUTE_REPS} runs "
                  f"over {len(batches)} pre-packed batches, host clock: GAT K3 route {kernel[0]:.4f} "
                  f"({kernel[1]:.4f}-{kernel[2]:.4f}) ms, GAT plain route {plain[0]:.4f} "
                  f"({plain[1]:.4f}-{plain[2]:.4f}) ms, GraphConv add {graphconv[0]:.4f} "
                  f"({graphconv[1]:.4f}-{graphconv[2]:.4f}) ms; packing {pack_ms:.4f} ms/batch on "
                  f"the host [{smi}]")
            if b == FLAGSHIP_GRAPHS and dtype == "float32":
                profile_predict(smi, gat, batches)
    return config_times


def profile_predict(smi: str, model, batches) -> None:
    """A torch.profiler trace of predict over ``batches`` on the K3 route:
    device busy time, idle share of the window, top device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.predict(batches, return_prob=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict(batches, return_prob=True)  # ends in a device→host copy
        wall_ms = (time.perf_counter() - t0) * 1e3
    items = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                   key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in items) / 1e3
    n = len(batches)
    if busy_ms <= 0:
        print(f"profile GAT predict B={FLAGSHIP_GRAPHS} f32: the profiler recorded no device "
              f"time; device busy and idle share not measured [{smi}]")
        return
    top = "; ".join(f"{e.key[:96]} {_device_us(e) / 1e3 / n:.4f} ms x{e.count / n:g}" for e in items[:8])
    print(f"profile GAT predict B={FLAGSHIP_GRAPHS} f32 K3 route, {n} batches under torch.profiler: "
          f"device busy {busy_ms / n:.4f} ms/batch of {wall_ms / n:.4f} ms/batch wall, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; top device items per batch: {top} [{smi}]")


def gat_bwd_kernel_phase():
    """K4, reached through ``gat_attention``'s autograd Function, against
    gat_attention_bwd_plain at K3's cases; returns the config-shape f32
    max |Δ| over the three gradients."""
    config_err = None
    for case in GAT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = gat_inputs(case, dtype)
            g = torch.from_numpy(
                np.random.default_rng(SEED + 5).normal(size=tuple(args[-1].shape)).astype(np.float32)
            ).to(args[-1].device, dtype)
            # the mirror of the lists against its plain version, exactly
            s_dst, s_src, in_src, in_w, xw = args
            before = (gat_attention.bwd_launches, gat_out_rows.launches)
            mirror = gat_out_rows(in_src, in_w)
            torch.cuda.synchronize()
            if gat_out_rows.launches != before[1] + 1:
                raise AssertionError(f"K4 {case} {dtype}: gat_out_rows did not launch the mirror kernel")
            for name, got, want in zip(("out_off", "out_dst"), mirror, gat_out_rows_plain(in_src, in_w)):
                if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"K4 {case} {dtype}: the mirror's {name} differs from the plain version's")
            # through the autograd Function, as the main path reaches K4: with
            # the mirror handed in, as GraphNet does
            leaves = [t.clone().requires_grad_() for t in (s_dst, s_src, xw)]
            out = gat_attention(leaves[0], leaves[1], in_src, in_w, leaves[2], mirror=mirror)
            got = torch.autograd.grad(out, leaves, g)
            if (gat_attention.bwd_launches, gat_out_rows.launches) != (before[0] + 1, before[1] + 1):
                raise AssertionError(f"K4 {case} {dtype}: the Function's backward did not launch K4 once "
                                     f"and read the mirror it was given")
            # and building its own: one more mirror, the same bits
            own = torch.autograd.grad(gat_attention(leaves[0], leaves[1], in_src, in_w, leaves[2]), leaves, g)
            if (gat_attention.bwd_launches, gat_out_rows.launches) != (before[0] + 2, before[1] + 2):
                raise AssertionError(f"K4 {case} {dtype}: the Function's backward built no mirror of its own")
            if not all(torch.equal(a, b) for a, b in zip(got, own)):
                raise AssertionError(f"K4 {case} {dtype}: a mirror handed in changes the gradients")
            # one gradient asked for alone comes back in its own place
            (only_src,) = torch.autograd.grad(
                gat_attention(s_dst, leaves[1], in_src, in_w, xw), leaves[1], g)
            torch.cuda.synchronize()
            want = gat_attention_bwd_plain(*args, g)
            got, want = (*got, only_src), (*want, want[1])
            torch.cuda.synchronize()
            f32 = dtype == torch.float32
            rel_bound, fro_bound = ((GAT_BWD_F32_REL, GAT_BWD_F32_FRO) if f32
                                    else (GAT_BWD_BF16_REL, GAT_BWD_BF16_FRO))
            readings, worst = [], 0.0
            for name, out, ref in zip(("ds_dst", "ds_src", "dxw", "ds_src alone"), got, want, strict=True):
                if out.shape != ref.shape or out.dtype != ref.dtype or not torch.isfinite(out).all():
                    raise AssertionError(f"K4 {case} {dtype}: bad {name} {tuple(out.shape)} {out.dtype}")
                err, rel, fro = _errors(out, ref)
                readings.append(f"{name} max_abs {err:.3e} max_rel {rel:.3e} rel_fro {fro:.3e}")
                worst = max(worst, err)
                if not (rel <= rel_bound and fro <= fro_bound):
                    raise AssertionError(f"K4 disagrees with plain: {case} {dtype} {name} {(err, rel, fro)}")
            if "isolated" in case and got[0][:, :9].abs().max().item() != 0.0:
                raise AssertionError(f"K4 {case}: a node that attends to itself only has a ds_dst")
            print(f"kernel K4 {case} B,M,D={tuple(args[2].shape)} xw {str(dtype)[6:]}: "
                  f"{'; '.join(readings)} (max_rel bound {rel_bound:.0e}, rel_fro bound {fro_bound:.0e}); "
                  f"mirror equal to its plain version, {int(mirror.out_off[:, -1].sum())} edges")
            if (case, dtype) == ("config B=32", torch.float32):
                config_err = worst
    gat_bwd_repeat_phase()
    return config_err


def gat_bwd_repeat_phase() -> None:
    """K4 twice on the same flagship inputs, f32 and bf16, each run building
    its own mirror: every gradient is a gather summed in a fixed order, so
    all three must be equal bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        args = gat_inputs("flagship B=256 M=256", dtype)
        g = torch.from_numpy(
            np.random.default_rng(SEED + 5).normal(size=tuple(args[-1].shape)).astype(np.float32)
        ).to("cuda", dtype)
        first = _gat_attention_bwd_cuda(*args, g)
        second = _gat_attention_bwd_cuda(*args, g)
        torch.cuda.synchronize()
        same = {name: torch.equal(a, b) for name, a, b in zip(("ds_dst", "ds_src", "dxw"), first, second)}
        print(f"kernel K4 run to run, flagship B=256 M=256 {str(dtype)[6:]}, two runs on the same inputs: "
              f"torch.equal {same}")
        if not all(same.values()):
            raise AssertionError(f"K4 is not bit-equal from run to run: {same}")


def _out_rows(in_src, in_w):
    """The out-row mirror of hand-built in-row lists (numpy): each node's
    outgoing edges in destination order, as the loader ships them."""
    b, m, _ = in_src.shape
    adj = np.zeros((b, m, m), np.float64)
    np.add.at(adj, (np.arange(b)[:, None, None], np.arange(m)[None, :, None], in_src.astype(np.int64)),
              in_w.astype(np.float64))
    adj_t = np.swapaxes(adj, 1, 2)
    d_out = max(4, int((adj_t != 0).sum(axis=2).max()))
    if d_out > 32:
        raise AssertionError(f"out-degree {d_out} exceeds the wire's 32 slots")
    out_dst = np.zeros((b, m, d_out), in_src.dtype)
    out_w = np.zeros((b, m, d_out), in_w.dtype)
    for g in range(b):
        for row in range(m):
            cols = np.flatnonzero(adj_t[g, row])
            out_dst[g, row, : len(cols)] = cols
            out_w[g, row, : len(cols)] = adj_t[g, row, cols]
    return out_dst, out_w


INROW_WIDTH = GRAPH_CONFIG["model"]["hidden_dim"]
CONV1_WIDTH = GRAPH_CONFIG["model"]["input_dim"]  # conv1 aggregates the input features
# K6's cases: name -> (lists, width).  They reach every layout
# (ops/inrow_graph.py:aggregate_form): 16-byte pieces with two nodes a warp
# (width 128 f32) and four (128 bf16); a channel a piece with 16 nodes a
# warp (width 4) and 8 (width 5).
INROW_CASES = {
    "config B=32": ("config B=32", INROW_WIDTH),
    "config B=32 fp16/int16 wire": ("config B=32 fp16/int16 wire", INROW_WIDTH),
    "flagship B=256": ("flagship B=256", INROW_WIDTH),
    "D=32 int16/fp16 lists": ("D=32 int16/fp16 lists", INROW_WIDTH),
    "isolated D=8": ("isolated D=8", INROW_WIDTH),
    "ragged M=37 D=4": ("ragged M=37 D=4", INROW_WIDTH),
    "config B=32 width 4": ("config B=32", CONV1_WIDTH),
    "flagship B=256 width 4": ("flagship B=256", CONV1_WIDTH),
    "D=32 int16/fp16 lists width 4": ("D=32 int16/fp16 lists", CONV1_WIDTH),
    "isolated D=8 width 4": ("isolated D=8", CONV1_WIDTH),
    "ragged M=37 D=4 width 4": ("ragged M=37 D=4", CONV1_WIDTH),
    "config B=32 width 5": ("config B=32", 5),
}


def inrow_layout(h) -> str:
    """K6's layout for these features, as ops/inrow_graph.py chooses it."""
    vec, lanes = aggregate_form(h.shape[-1], h.dtype)
    return f"{vec} channel{'s' if vec > 1 else ''} a piece, two pieces a lane, {lanes} lane{'s' if lanes > 1 else ''} a node"


def inrow_inputs(case: str, dtype, seed: int = SEED, width: int = INROW_WIDTH):
    """(h, in_src, in_w, out_dst, out_w) on the card for one K6 list case at
    ``width``: the loader's weighted batches with their out-rows, or
    hand-built lists in which no source repeats within a row (as in the
    loader's merged batches) with their mirror."""
    rng = np.random.default_rng(seed)
    wire = {"config B=32": (GRAPH_B, "float32"), "config B=32 fp16/int16 wire": (GRAPH_B, "float16"),
            "flagship B=256": (FLAGSHIP_GRAPHS, "float32")}
    if case in wire:
        b, transfer = wire[case]
        loader = GraphLoader(lineage_graphs(rng, b), b, shuffle=False, layout="dense", use_weights=True,
                             transfer_dtype=transfer, emit_out_rows=True)
        batch = next(iter(loader))
        lists = [batch[k] for k in ("in_src", "in_w", "out_dst", "out_w")]
    else:
        b, m, d, frac = {"D=32 int16/fp16 lists": (3, 96, 32, 0.4), "isolated D=8": (2, 40, 8, 0.6),
                         "ragged M=37 D=4": (5, 37, 4, 0.6)}[case]
        in_src = np.stack([np.stack([rng.permutation(m)[:d] for _ in range(m)]) for _ in range(b)])
        in_src = in_src.astype(np.int32)
        in_w = (rng.random((b, m, d)) * (rng.random((b, m, d)) < frac)).astype(np.float32)
        if "isolated" in case:
            in_w[:, :9] = 0.0
        if "int16" in case:
            in_src, in_w = in_src.astype(np.int16), in_w.astype(np.float16)
        lists = [in_src, in_w, *_out_rows(in_src, in_w)]
    dev = torch.device("cuda")
    b, m, _ = lists[0].shape
    h = torch.from_numpy(rng.normal(size=(b, m, width)).astype(np.float32)).to(dev, dtype)
    return (h, *(torch.from_numpy(a).to(dev) for a in lists))


def _max_rel(out, ref) -> float:
    return _errors(out, ref)[1]


def inrow_kernel_phase():
    """K6 against inrow_aggregate_plain, forward and backward, at every case;
    returns the config-shape f32 "add" max |Δ| (forward and backward)."""
    config_err = None
    for case, (lists, width) in INROW_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for aggr in ("add", "mean"):
                h, in_src, in_w, out_dst, out_w = inrow_inputs(lists, dtype, width=width)
                g = torch.from_numpy(
                    np.random.default_rng(SEED + 6).normal(size=tuple(h.shape)).astype(np.float32)
                ).to(h.device, dtype)
                h.requires_grad_()
                out = inrow_aggregate(h, in_src, in_w, out_dst, out_w, aggr)
                (dh,) = torch.autograd.grad(out, h, g)
                # again: a sum in slot order, no atomics, the same bits both ways
                out_again = inrow_aggregate(h, in_src, in_w, out_dst, out_w, aggr)
                (dh_again,) = torch.autograd.grad(out_again, h, g)
                torch.cuda.synchronize()
                if not (torch.equal(out, out_again) and torch.equal(dh, dh_again)):
                    raise AssertionError(f"K6 {case} {dtype} {aggr}: two runs on the same inputs differ")
                # plain forward; plain backward = the Function inside
                # force_plain() (inrow_aggregate_plain over the out-rows, with
                # the Function's rounding), itself held to the autograd of
                # the plain forward
                ref = inrow_aggregate_plain(h.detach(), in_src, in_w, aggr)
                ref_h, auto_h = (h.detach().clone().requires_grad_() for _ in range(2))
                with force_plain():
                    (ref_dh,) = torch.autograd.grad(
                        inrow_aggregate(ref_h, in_src, in_w, out_dst, out_w, aggr), ref_h, g)
                (auto_dh,) = torch.autograd.grad(inrow_aggregate_plain(auto_h, in_src, in_w, aggr), auto_h, g)
                torch.cuda.synchronize()
                f32 = dtype == torch.float32
                bound = INROW_F32_REL if f32 else INROW_BF16_REL
                auto_bound = 1e-5 if f32 else INROW_BF16_AUTOGRAD_REL
                if out.shape != ref.shape or out.dtype != dtype or dh.dtype != dtype:
                    raise AssertionError(f"K6 {case} {dtype} {aggr}: bad output {tuple(out.shape)} {out.dtype}")
                fwd, bwd = _errors(out.detach(), ref), _errors(dh, ref_dh)
                auto = _max_rel(ref_dh, auto_dh)
                print(f"kernel K6 {case} {aggr} B,M,D={tuple(in_src.shape)} Do={out_dst.shape[-1]} width {width} "
                      f"in_w {str(in_w.dtype)[6:]}, h {str(dtype)[6:]} [{inrow_layout(h)}]: forward max_abs_err "
                      f"{fwd[0]:.3e} max_rel_err {fwd[1]:.3e}; backward max_abs_err {bwd[0]:.3e} max_rel_err "
                      f"{bwd[1]:.3e} (bound {bound:.0e}); plain backward against the plain forward's autograd "
                      f"max_rel_err {auto:.3e} (bound {auto_bound:.0e}); two runs torch.equal both ways")
                if not (fwd[1] <= bound and bwd[1] <= bound and auto <= auto_bound):
                    raise AssertionError(f"K6 disagrees with plain: {case} {dtype} {aggr}")
                if "isolated" in case and out[:, :9].abs().max().item() != 0.0:
                    raise AssertionError(f"K6 {case}: a node with no incoming edge has a sum")
                if (case, dtype, aggr) == ("config B=32", torch.float32, "add"):
                    config_err = max(fwd[0], bwd[0])
    # duplicate sources within a row sum in f32 in the kernel and in h's
    # dtype in the plain version: the same number in f32
    rng = np.random.default_rng(SEED + 7)
    in_src = torch.from_numpy(rng.integers(0, 6, size=(3, 45, 8)).astype(np.int32)).cuda()
    in_w = torch.from_numpy((rng.random((3, 45, 8)) * (rng.random((3, 45, 8)) < 0.7)).astype(np.float32)).cuda()
    for width in (INROW_WIDTH, CONV1_WIDTH):
        h = torch.from_numpy(rng.normal(size=(3, 45, width)).astype(np.float32)).cuda()
        for aggr in ("add", "mean"):
            with torch.no_grad():
                err = _errors(inrow_aggregate(h, in_src, in_w, aggr=aggr), inrow_aggregate_plain(h, in_src, in_w, aggr))
            print(f"kernel K6 duplicate sources (6-id pool, D=8) width {width} {aggr} f32 [{inrow_layout(h)}]: "
                  f"forward max_abs_err {err[0]:.3e} max_rel_err {err[1]:.3e} (bound 1e-05)")
            if not err[1] <= 1e-5:
                raise AssertionError(f"K6 disagrees with plain on duplicate sources: width {width} {aggr} {err}")
    return config_err


GRAPH_ARMS = (("GAT", dict(use_gat=True), 3), ("GraphConv add fused_inrow", dict(fused_inrow=True), 3),
              ("GraphConv add", {}, 1))


def graph_training_config(data_dir: str, log_dir: str, epochs: int, **model) -> dict:
    """configs/base.yaml overlaid with configs/graph_net.yaml (adam, lr
    1e-3, batch 32, multiplicity weights), at ``epochs`` epochs."""
    cfg = graph_config(data_dir, model.pop("use_gat", False), **model)
    cfg["meta"] = {"model_name": "", "dataset_name": ""}
    cfg["logging"] = {"log_dir": log_dir}
    cfg["trainer"]["epochs"] = epochs
    return cfg


def train_graph_arm(name: str, cfg: dict):
    """train_model("graph_net", "s2pg") for one arm, with what holds on any
    device checked: finite losses that fall over a run of several epochs,
    meta.json's parameter count, and model.pt reloading to meta's val
    accuracy.  The launch counts are set to 0 just before train_model and
    read just after.  Returns (train steps, eval batches, meta, counts)."""
    reset_launch_counts()
    t0 = time.perf_counter()
    log_dir = port_train.train_model("graph_net", "s2pg", cfg, return_log_dir=True)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    data = factory.get_dataloader("s2pg", cfg)
    n_train, n_val = len(data.get_train_loader()), len(data.get_val_loader())
    metrics = read_metrics(log_dir)
    with open(os.path.join(log_dir, "meta.json")) as f:
        meta = json.load(f)["metrics"]
    losses = metrics["Loss/train"]
    epochs = len(losses)
    print(f"graph train {name}: train_model graph_net s2pg, {epochs} epochs of {n_train} steps "
          f"(B={cfg['dataset']['batch_size']}), {seconds:.1f} s; Loss/train {losses}, Loss/val "
          f"{metrics['Loss/val']}, Accuracy/val {metrics['Accuracy/val']}, meta {meta}; "
          f"StepTime/wall_ms_per_step {metrics['StepTime/wall_ms_per_step']}")
    if not np.isfinite(losses).all() or (epochs > 1 and not losses[-1] < losses[0]):
        raise AssertionError(f"{name}: training did not learn: epoch losses {losses}")
    fresh = factory.get_model("graph_net", cfg)
    if meta["parameters"] != sum(p.numel() for p in fresh.model.parameters()):
        raise AssertionError(f"{name}: parameters {meta['parameters']} is not the model's count")
    for artifact in ("config.yaml", "meta.json", "metrics.jsonl", "best_model.pt", "model.pt"):
        if not os.path.exists(os.path.join(log_dir, artifact)):
            raise AssertionError(f"{name}: {artifact} was not written")
    # model.pt holds the final weights and running statistics, the ones whose
    # predictions gave meta's accuracy/val
    fresh.load(os.path.join(log_dir, "model.pt"))
    y_val, pred = fresh.predict(data.get_val_loader())
    acc = round(port_train.accuracy(y_val, pred), 6)
    print(f"graph train {name}: model.pt reloaded: accuracy/val {acc} (meta {meta['accuracy/val']})")
    if acc != meta["accuracy/val"]:
        raise AssertionError(f"{name}: model.pt does not predict as the trained wrapper did")
    # per-epoch validation, then train_model's predict over both loaders
    return epochs * n_train, epochs * n_val + n_train + n_val, meta, counts


def graph_train_phase(work_dir: str) -> dict:
    """The GraphNet training slice: each arm through train_model with its
    launch counts, then each kernel route against its plain route.  Returns
    the launch counts of the GAT arm (K3, K4) and the fused arm (K6)."""
    data_dir = os.path.join(work_dir, "s2pg_train")
    write_s2pg_cache(data_dir, n_graphs=(1024, 256, 256), seed=SEED)
    launches = {}
    for name, model, epochs in GRAPH_ARMS:
        cfg = graph_training_config(data_dir, os.path.join(work_dir, "graph_log"), epochs, **model)
        steps, evals, meta, counts = train_graph_arm(name, cfg)
        # per forward two convolutions; K4 once per K3 of a train step (both
        # xw depend on weights), both over one mirror of the batch's lists;
        # K6's backward once per train step (conv1's input is the batch's
        # features, which need no gradient)
        want = dict.fromkeys(counts, 0)
        if model.get("use_gat"):
            want.update({"gat_attention": 2 * (steps + evals), "gat_attention_bwd": 2 * steps,
                         "gat_out_rows": steps})
        elif model.get("fused_inrow"):
            want.update({"inrow_aggregate": 2 * (steps + evals), "inrow_aggregate backward": steps})
        print(f"graph train {name}: {steps} train steps, {evals} eval batches; launches {counts} "
              f"(expected {want}); accuracy/val {meta['accuracy/val']} (floor {GRAPH_VAL_ACC_FLOOR[name]})")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected {want}")
        if not meta["accuracy/val"] >= GRAPH_VAL_ACC_FLOOR[name]:
            raise AssertionError(f"{name}: accuracy/val {meta['accuracy/val']} below {GRAPH_VAL_ACC_FLOOR[name]}")
        launches.update({k: v for k, v in counts.items() if v})
        if model:
            graph_track_phase(name, cfg)
        if model.get("fused_inrow"):
            fused_without_out_rows_phase(cfg)
    return launches


def fused_without_out_rows_phase(cfg: dict) -> None:
    """The fused GraphConv on batches that carry no out-row lists (a loader
    built without ``emit_out_rows``): ``predict`` still aggregates through K6,
    two launches a batch and nothing else, and a train step raises instead of
    aggregating some other way."""
    wrapper = factory.get_model("graph_net", cfg)
    loader = GraphLoader(lineage_graphs(np.random.default_rng(SEED + 8), 3 * GRAPH_B), GRAPH_B,
                         shuffle=False, layout="dense", use_weights=True)
    batches = list(loader)
    if any("out_dst" in batch for batch in batches):
        raise AssertionError("the loader shipped out-rows it was not asked for")
    reset_launch_counts()
    _, probs = wrapper.predict(batches, return_prob=True)
    counts = launch_counts()
    want = {**dict.fromkeys(counts, 0), "inrow_aggregate": 2 * len(batches)}
    if counts != want or not np.isfinite(probs).all():
        raise AssertionError(f"fused predict without out-rows: launches {counts}, expected {want}")
    try:
        wrapper.train_step(batches[0])
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("a fused train step without out-rows did not raise")
    print(f"graph train fused_inrow without out-rows: predict over {len(batches)} batches launched "
          f"{counts}; train_step raises: {refusal[:72]}...")


def graph_track_phase(name: str, cfg: dict) -> None:
    """TRACK_STEPS train steps on the kernel route and, from the same initial
    weights and on the same batches, inside ``force_plain()``."""
    kernel, plain = factory.get_model("graph_net", cfg), PlainRoute(factory.get_model("graph_net", cfg))
    data = factory.get_dataloader("s2pg", cfg)
    batches = list(data.get_train_loader())[:TRACK_STEPS]
    rel = []
    for batch in batches:
        a, b = kernel.train_step(batch).item(), plain.train_step(batch).item()
        rel.append(abs(a - b) / abs(b))
    held = kernel._put(next(iter(data.get_val_loader())))
    with torch.inference_mode():
        logits = kernel.model(held, train=False)
        with force_plain():
            ref = plain.wrapper.model(held, train=False)
    logit_err = (logits - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    print(f"graph train {name}: kernel route against plain route over {TRACK_STEPS} steps: per-step loss "
          f"rel {[f'{r:.2e}' for r in rel]} (bound {STEP_LOSS_RTOL:.0e}); held-batch logits max_rel_err "
          f"{logit_err:.3e} (bound {LOGIT_TOL:.0e})")
    if not max(rel) <= STEP_LOSS_RTOL or not logit_err <= LOGIT_TOL:
        raise AssertionError(f"{name}: the kernel route does not track the plain route")


def inrow_library_ms(h, in_src, in_w, out) -> float:
    """The time of ``torch.sparse.mm`` over the block-diagonal CSR adjacency
    of the same lists (built ahead, outside the timing) times the same
    features: one PyTorch call that computes K6's "add".  Timed here and used
    nowhere in the package."""
    b, m, width = h.shape
    keep = (in_w != 0).reshape(-1)
    base = (torch.arange(b, device=h.device) * m)[:, None, None]
    rows = (base + torch.arange(m, device=h.device)[None, :, None]).expand_as(in_src).reshape(-1)[keep]
    cols = (base + in_src.long()).reshape(-1)[keep]
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), in_w.float().reshape(-1)[keep], (b * m, b * m)
    ).coalesce().to_sparse_csr()
    flat = h.reshape(b * m, width).contiguous()
    got = torch.sparse.mm(csr, flat).reshape(b, m, width)
    err = _max_rel(got, out)
    if not err <= 1e-5:
        raise AssertionError(f"the sparse product is not K6's function here: max_rel_err {err:.3e}")
    return cuda_ms(lambda: torch.sparse.mm(csr, flat))


def graph_train_times_phase(smi: str):
    """K4 and K6 against their plain versions (CUDA events, plain first), the
    train step per batch on the kernel and plain routes (host clock), packing
    with and without out-rows, and a profile of the B=256 f32 GAT train step.
    Returns, per kernel, the config shape's f32 times and bound."""
    config_times = {}
    for case in ("config B=32", "flagship B=256 M=256"):
        for dtype in (torch.float32, torch.bfloat16):
            args = gat_inputs(case, dtype)
            g = torch.randn(args[-1].shape, device="cuda").to(dtype)
            plain_ms = cuda_ms(lambda: gat_attention_bwd_plain(*args, g))
            # the mirror, once per batch; K4's wrapper alone over it (its two
            # stages); as the Function's backward over it (the forward's graph
            # is kept), which adds the autograd engine's host time; and K4
            # building a mirror of its own, as a caller without one pays
            mirror_ms = cuda_ms(lambda: _gat_out_rows_cuda(args[2], args[3]))
            mirror = gat_out_rows(args[2], args[3])
            leaves = [t.clone().requires_grad_() for t in (args[0], args[1], args[4])]
            out = gat_attention(leaves[0], leaves[1], args[2], args[3], leaves[2], mirror=mirror)
            function_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
            kernel_ms = cuda_ms(lambda: _gat_attention_bwd_cuda(*args, g, mirror=mirror))
            own_ms = cuda_ms(lambda: _gat_attention_bwd_cuda(*args, g))
            print(f"time gat_attention backward {case} B,M,D={tuple(args[2].shape)} H={GAT_HEADS} "
                  f"C={GAT_C} {str(dtype)[6:]}: K4 over a given mirror {kernel_ms:.4f} ms ({function_ms:.4f} ms "
                  f"as the backward of gat_attention under autograd), the mirror {mirror_ms:.4f} ms, K4 "
                  f"building its own {own_ms:.4f} ms, plain {plain_ms:.4f} ms [{smi}]")
            if dtype == torch.float32:
                bound = gat_bound(args, backward=True)
                print(f"bound gat_attention backward {case} f32: K4 {bound[0]:.4f} ms by {bound[1]}; "
                      f"no single PyTorch call computes it")
                if case == "config B=32":
                    config_times["gat_attention_bwd"] = dict(
                        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                        mirror_ms=mirror_ms)
    # K6 at conv2's width (hidden) and at conv1's (the input features); on
    # the main path the backward runs at the hidden width only
    for case, width in (("config B=32", INROW_WIDTH), ("config B=32", CONV1_WIDTH),
                        ("flagship B=256", INROW_WIDTH), ("flagship B=256", CONV1_WIDTH)):
        for dtype in (torch.float32, torch.bfloat16):
            h, in_src, in_w, out_dst, out_w = inrow_inputs(case, dtype, width=width)
            g = torch.randn(h.shape, device="cuda").to(dtype)
            with torch.no_grad():
                plain_ms = cuda_ms(lambda: inrow_aggregate_plain(h, in_src, in_w, "add"))
                kernel_ms = cuda_ms(lambda: _inrow_aggregate_cuda(h, in_src, in_w, "add"))
                device = device_ms(lambda: _inrow_aggregate_cuda(h, in_src, in_w, "add"))[0]
                bwd_plain_ms = cuda_ms(lambda: inrow_aggregate_plain(g, out_dst, out_w, "add"))
                bwd_ms = cuda_ms(lambda: _inrow_aggregate_cuda(g, out_dst, out_w, "add", backward=True))
                bwd_device = device_ms(lambda: _inrow_aggregate_cuda(g, out_dst, out_w, "add", backward=True))[0]
            print(f"time inrow_aggregate add {case} B,M,D={tuple(in_src.shape)} Do={out_dst.shape[-1]} "
                  f"H={width} {str(dtype)[6:]} [{inrow_layout(h)}]: forward K6 {kernel_ms:.4f} ms by events, "
                  f"{_shown(device)} a launch on the profiler's device rows, plain {plain_ms:.4f} ms; backward "
                  f"(over the out-rows) K6 {bwd_ms:.4f} ms by events, {_shown(bwd_device)} on the device rows, "
                  f"plain {bwd_plain_ms:.4f} ms [{smi}]")
            if dtype == torch.float32:
                # h and the lists read once, the output written once; two
                # operations per nonzero weight and channel
                edges = int((in_w != 0).sum())
                bound = bound_ms(_nbytes(h, in_src, in_w, h), 2 * edges * h.shape[-1])
                bwd_bound = bound_ms(_nbytes(g, out_dst, out_w, g), 2 * edges * h.shape[-1])
                with torch.no_grad():
                    library_ms = inrow_library_ms(h, in_src, in_w, _inrow_aggregate_cuda(h, in_src, in_w, "add"))
                    bwd_library_ms = inrow_library_ms(
                        g, out_dst, out_w, _inrow_aggregate_cuda(g, out_dst, out_w, "add", backward=True))
                print(f"bound inrow_aggregate add {case} H={width} f32: K6 forward {bound[0]:.4f} ms by "
                      f"{bound[1]}, backward {bwd_bound[0]:.4f} ms by {bwd_bound[1]} ({edges} edges); "
                      f"torch.sparse.mm over the prebuilt block-diagonal CSR: of the in-rows (forward) "
                      f"{library_ms:.4f} ms, of the out-rows (backward) {bwd_library_ms:.4f} ms [{smi}]")
                if (case, width) == ("config B=32", INROW_WIDTH):
                    config_times["inrow_aggregate"] = dict(
                        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                        library_ms=library_ms)
    for b in (GRAPH_B, FLAGSHIP_GRAPHS):
        graphs = lineage_graphs(np.random.default_rng(SEED + 2), 4 * b)
        build_ms, pack_ms = {}, {}
        for out_rows in (False, True):
            t0 = time.perf_counter()
            loader = GraphLoader(graphs, b, shuffle=False, layout="dense", use_weights=False,
                                 emit_out_rows=out_rows)
            t1 = time.perf_counter()
            batches = list(loader)
            build_ms[out_rows] = (t1 - t0) * 1e3
            pack_ms[out_rows] = (time.perf_counter() - t1) * 1e3 / len(batches)
        shape = sorted({(*batch["in_src"].shape[1:], batch["out_dst"].shape[2]) for batch in batches})
        print(f"time packing per batch B={b} (M, D, Do)={shape} on the host: {pack_ms[False]:.4f} ms "
              f"without out-rows, {pack_ms[True]:.4f} ms with; constructing the loader over "
              f"{len(graphs)} graphs, once: {build_ms[False]:.4f} ms without, {build_ms[True]:.4f} ms "
              f"with [{smi}]")
        for dtype in ("float32", "bfloat16"):
            gat = factory.get_model("graph_net", graph_config("", True, compute_dtype=dtype))
            gat_plain = factory.get_model("graph_net", graph_config("", True, compute_dtype=dtype))
            fused = factory.get_model("graph_net", graph_config("", False, compute_dtype=dtype, fused_inrow=True))
            conv = factory.get_model("graph_net", graph_config("", False, compute_dtype=dtype))
            rows = train_ms_per_batch([gat, PlainRoute(gat_plain), fused, conv], batches)
            names = ("GAT K3+K4 route", "GAT plain route", "GraphConv add K6 route",
                     "GraphConv add adjacency route")
            print(f"time train step per batch B={b} {dtype} adam, median (q1-q3) of {ROUTE_REPS} runs over "
                  f"{len(batches)} pre-packed batches, host clock to a synchronise: "
                  + ", ".join(f"{n} {r[0]:.4f} ({r[1]:.4f}-{r[2]:.4f}) ms" for n, r in zip(names, rows))
                  + f" [{smi}]")
            if b == FLAGSHIP_GRAPHS and dtype == "float32":
                profile_train_steps(smi, "B=256 f32 GAT K3+K4 route", gat, batches)
                profile_train_steps(smi, "B=256 f32 GraphConv add K6 route", fused, batches)
    return config_times


KNN_CASES = ("config B=32", "config B=32 H=4", "ragged N=1001", "graphs under k+1 nodes", "coarse grid ties",
             "long padding tail", "flagship B=256")
KNN_WIDTH = GRAPH_CONFIG["model"]["hidden_dim"]


def knn_inputs(case: str, dtype, seed: int = SEED):
    """(x, positions, node_seg, num_graphs) on the card for one K5 case: the
    flat loader's batches of lineage-like graphs (their standardized
    positions, not on any grid), or hand-built segments."""
    rng = np.random.default_rng(seed)
    wire = {"config B=32": GRAPH_B, "config B=32 H=4": GRAPH_B, "flagship B=256": FLAGSHIP_GRAPHS,
            "flagship B=256 H=4": FLAGSHIP_GRAPHS}
    if case in wire:
        graphs = wire[case]
        batch = next(iter(GraphLoader(lineage_graphs(rng, graphs), graphs, shuffle=False, layout="flat",
                                      use_weights=False)))
        pos, seg = batch["nodes"][:, 1:4], batch["node_seg"]
    else:
        # (nodes per graph low, high; graphs; padding rows; grid step)
        lo, hi, graphs, padding, grid = {
            "ragged N=1001": (20, 60, 24, None, None), "graphs under k+1 nodes": (1, 8, 60, 11, None),
            "coarse grid ties": (60, 120, 6, 9, 0.5), "long padding tail": (40, 80, 5, 3000, None)}[case]
        sizes = rng.integers(lo, hi + 1, size=graphs)
        if padding is None:  # 961 nodes and 40 padding rows: N = 1,001, no power of two
            sizes, padding = rng.multinomial(961, np.ones(graphs) / graphs), 40
        n = int(sizes.sum()) + padding
        seg = np.full(n, graphs, dtype=np.int32)
        seg[: sizes.sum()] = np.repeat(np.arange(graphs, dtype=np.int32), sizes)
        pos = rng.normal(size=(n, 3)).astype(np.float32)
        if grid:
            pos = (np.round(pos / grid) * grid).astype(np.float32)
    width = 4 if case.endswith("H=4") else KNN_WIDTH
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.normal(size=(len(seg), width)).astype(np.float32)).to(dev, dtype)
    return x, torch.from_numpy(np.ascontiguousarray(pos)).to(dev), torch.from_numpy(seg).to(dev), graphs


def knn_kernel_phase():
    """K5 against the plain versions, forward and (through the autograd
    Function) backward, at every case; returns the config-shape f32 "add" k=8
    max |Δ| (forward and backward)."""
    config_err = None
    for case in KNN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, pos, seg, graphs = knn_inputs(case, dtype)
            g = torch.from_numpy(
                np.random.default_rng(SEED + 9).normal(size=tuple(x.shape)).astype(np.float32)
            ).to(x.device, dtype)
            # the flagship's plain version takes a second a call: k = 8 only
            for k in ((KNN_K,) if case.startswith("flagship") else (1, KNN_K)):
                # the selection against its plain version, exactly: ranges,
                # points, thresholds and degrees
                before = knn_select.launches
                plan, ref_plan = knn_select(pos, seg, k, graphs), knn_select_plain(pos, seg, k, graphs)
                torch.cuda.synchronize()
                if knn_select.launches != before + 1:
                    raise AssertionError(f"K5 {case} {dtype}: knn_select did not launch the selection kernel")
                differ = [name for name, a, b in zip(("positions", "node_seg", "lo", "hi", "points", "kth", "deg"),
                                                     plan.tensors(), ref_plan.tensors(), strict=True)
                          if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b)]
                if differ:
                    raise AssertionError(
                        f"K5 {case} {dtype} k={k}: the selection's {differ} differ from the plain version's "
                        f"({int((plan.deg != ref_plan.deg).sum())} degrees, "
                        f"{int((plan.kth != ref_plan.kth).sum())} thresholds)")
                deg = plan.deg
                for aggr in ("add", "mean"):
                    # without a plan the Function selects for itself
                    leaf = x.clone().requires_grad_()
                    before = (knn_select.launches, knn_aggregate.launches, knn_aggregate.bwd_launches)
                    out = knn_aggregate(leaf, pos, seg, k, graphs, aggr)
                    (dx,) = torch.autograd.grad(out, leaf, g)
                    torch.cuda.synchronize()
                    after = (knn_select.launches, knn_aggregate.launches, knn_aggregate.bwd_launches)
                    if after != tuple(n + 1 for n in before):
                        raise AssertionError(f"K5 {case} {dtype}: the Function did not select once and launch K5 both ways")
                    # with the plan it only gathers, and gives the same bits
                    out_plan = knn_aggregate(leaf, pos, seg, k, graphs, aggr, plan=plan)
                    (dx_plan,) = torch.autograd.grad(out_plan, leaf, g)
                    torch.cuda.synchronize()
                    if (knn_select.launches, knn_aggregate.launches, knn_aggregate.bwd_launches) != (
                            after[0], after[1] + 1, after[2] + 1):
                        raise AssertionError(f"K5 {case} {dtype}: with a plan the Function selected again")
                    if not (torch.equal(out_plan, out) and torch.equal(dx_plan, dx)):
                        raise AssertionError(f"K5 {case} {dtype} {aggr} k={k}: a plan handed in changes the result")
                    ref = knn_aggregate_plain(x, pos, seg, k, graphs, aggr, kth=ref_plan.kth)
                    ref_dx = knn_aggregate_bwd_plain(g, pos, seg, k, graphs, aggr, kth=ref_plan.kth)
                    torch.cuda.synchronize()
                    if out.shape != ref.shape or out.dtype != dtype or dx.dtype != dtype:
                        raise AssertionError(f"K5 {case} {dtype} {aggr}: bad output {tuple(out.shape)} {out.dtype}")
                    fwd, bwd = _errors(out.detach(), ref), _errors(dx, ref_dx)
                    bound = KNN_F32_REL if dtype == torch.float32 else KNN_BF16_REL
                    print(f"kernel K5 {case} {aggr} k={k} N={x.shape[0]} H={x.shape[1]} graphs={graphs} "
                          f"x {str(dtype)[6:]}: forward max_abs_err {fwd[0]:.3e} max_rel_err {fwd[1]:.3e}; "
                          f"backward max_abs_err {bwd[0]:.3e} max_rel_err {bwd[1]:.3e} (bound {bound:.0e}); "
                          f"ranges, points, degrees and thresholds equal exactly, the same bits with a plan, max degree "
                          f"{int(deg.max())}, edges {int(deg.sum())}")
                    if not (fwd[1] <= bound and bwd[1] <= bound):
                        raise AssertionError(f"K5 disagrees with plain: {case} {dtype} {aggr} k={k}")
                    padding = seg >= graphs
                    if out[padding].abs().sum().item() != 0.0 or dx[padding].abs().sum().item() != 0.0:
                        raise AssertionError(f"K5 {case}: a padding node has a sum")
                    if case == "coarse grid ties" and not int(deg.max()) > k:
                        raise AssertionError(f"K5 {case}: no degree over k, so no tie was tested")
                    if case == "graphs under k+1 nodes" and k == KNN_K and not int(deg.max()) < k:
                        raise AssertionError(f"K5 {case}: a row found k neighbours")
                    if (case, dtype, aggr, k) == ("config B=32", torch.float32, "add", KNN_K):
                        config_err = max(fwd[0], bwd[0])
    return config_err


def knn_config(data_dir: str, local_pooling: str, **model) -> dict:
    """configs/graph_net.yaml with ``model.knn_k: 8``: no ``graph_layout``,
    so the factory chooses the flat wire."""
    return graph_config(data_dir, False, knn_k=KNN_K, local_pooling=local_pooling, **model)


def knn_slice_phase(work_dir: str) -> int:
    """get_model("graph_net") on a checkpoint with ``DenseGraphConv_*`` keys +
    predict over the flat s2pg test loader, add and mean, each held against
    its plain route; returns K5's launch count during the "add" predict."""
    data_dir = os.path.join(work_dir, "s2pg")  # the cache graph_slice_phase wrote
    add_launches = None
    for pooling in ("add", "mean"):
        cfg = knn_config(data_dir, pooling)
        run_dir = os.path.join(work_dir, f"knn_run_{pooling}")
        write_graph_checkpoint(run_dir, cfg, SEED + 11)
        with open(os.path.join(run_dir, "best_model.pt"), "rb") as f:
            names = sorted(pickle.load(f)["params"])
        if names[:2] != ["DenseGraphConv_0", "DenseGraphConv_1"]:
            raise AssertionError(f"kNN {pooling}: the checkpoint's convolutions are named {names[:2]}")
        model = factory.get_model("graph_net", cfg, run_dir)
        loader = factory.get_dataloader("s2pg", cfg).get_test_loader()
        if loader.layout != "flat" or "src" not in next(iter(loader)):
            raise AssertionError(f"kNN {pooling}: the factory did not choose the flat wire")
        reset_launch_counts()
        y_true, probs = model.predict(loader, return_prob=True)
        counts = launch_counts()
        with force_plain():
            _, probs_plain = model.predict(loader, return_prob=True)
        n_batches = len(loader)
        err = float(np.abs(probs - probs_plain).max())
        buckets = sorted({b["nodes"].shape[0] for b in loader})
        print(f"knn slice GraphConv {pooling} k={KNN_K}: predict over {n_batches} batches of {GRAPH_B}, "
              f"{loader.n_examples} graphs, N {buckets}; K5 launches: selection {counts['knn_select']}, "
              f"aggregation {counts['knn_aggregate']}; probs in "
              f"[{probs.min():.4f}, {probs.max():.4f}]; max |kernel − plain| {err:.3e} (bound {PROB_TOL:.0e})")
        if probs.shape != (loader.n_examples, 1) or not np.isfinite(probs).all():
            raise AssertionError(f"kNN {pooling}: bad probabilities, shape {probs.shape}")
        if probs.min() < 0.0 or probs.max() > 1.0 or probs.std() == 0.0:
            raise AssertionError(f"kNN {pooling}: probabilities outside [0, 1] or all equal")
        if not np.array_equal(y_true[:, 0], loader.labels):
            raise AssertionError(f"kNN {pooling}: y_true does not follow the loader's labels")
        if not err <= PROB_TOL:
            raise AssertionError(f"kNN {pooling}: kernel route disagrees with plain route: {err:.3e}")
        # per forward one selection, and one aggregation per convolution
        want = {**dict.fromkeys(counts, 0), "knn_select": n_batches, "knn_aggregate": 2 * n_batches}
        if n_batches < 4 or counts != want:
            raise AssertionError(f"kNN {pooling}: launches {counts}, expected {want}")
        if pooling == "add":
            add_launches = counts["knn_aggregate"]
    return add_launches


def knn_train_phase(work_dir: str) -> dict:
    """The kNN GraphNet training slice: train_model with K5's launch counts,
    add and mean; the kernel route against the plain route; resume_training.
    Returns the "add" arm's launch counts (forward, backward)."""
    data_dir = os.path.join(work_dir, "s2pg_train")  # the cache graph_train_phase wrote
    launches = {}
    for pooling in ("add", "mean"):
        name = f"kNN GraphConv {pooling}"
        cfg = graph_training_config(data_dir, os.path.join(work_dir, "knn_log"), 3, knn_k=KNN_K,
                                    local_pooling=pooling)
        steps, evals, meta, counts = train_graph_arm(name, cfg)
        # per forward one selection and two convolutions; backward once per
        # train step (conv1's input is the batch's features, which need no
        # gradient)
        want = {**dict.fromkeys(counts, 0), "knn_select": steps + evals,
                "knn_aggregate": 2 * (steps + evals), "knn_aggregate backward": steps}
        print(f"graph train {name}: {steps} train steps, {evals} eval batches; launches {counts} "
              f"(expected {want}); accuracy/val {meta['accuracy/val']} (floor {KNN_VAL_ACC_FLOOR[pooling]})")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected {want}")
        if not meta["accuracy/val"] >= KNN_VAL_ACC_FLOOR[pooling]:
            raise AssertionError(f"{name}: accuracy/val {meta['accuracy/val']} below {KNN_VAL_ACC_FLOOR[pooling]}")
        graph_track_phase(name, cfg)
        if pooling == "add":
            launches = {k: v for k, v in counts.items() if v}
            knn_resume_phase(name, cfg)
    return launches


def knn_resume_phase(name: str, cfg: dict) -> None:
    """resume_training on the finished run for one more epoch: the restored
    state trains on through K5 and the run's metrics grow by that epoch."""
    log_dir = cfg["logging"]["log_dir"]  # train_model wrote the run's directory here
    trained = len(read_metrics(log_dir)["Loss/train"])
    cfg = copy.deepcopy(cfg)
    cfg["trainer"]["epochs"] = trained + 1
    # one more epoch, asked for in the run's own config.yaml: resume_training
    # gets the directory and nothing else, and reads the file itself
    config_path = os.path.join(log_dir, "config.yaml")
    with open(config_path) as f:
        text = f.read()
    if text.count(f"epochs: {trained}\n") != 1:
        raise AssertionError(f"{name}: config.yaml does not hold 'epochs: {trained}' once")
    with open(config_path, "w") as f:
        f.write(text.replace(f"epochs: {trained}\n", f"epochs: {trained + 1}\n"))
    reset_launch_counts()
    resumed = port_train.resume_training(log_dir)
    if resumed.epochs != trained + 1:
        raise AssertionError(f"{name}: resume_training read epochs {resumed.epochs} from config.yaml")
    counts = launch_counts()
    data = factory.get_dataloader("s2pg", cfg)
    n_train, n_val = len(data.get_train_loader()), len(data.get_val_loader())
    want = {**dict.fromkeys(counts, 0), "knn_select": n_train + n_val,
            "knn_aggregate": 2 * (n_train + n_val), "knn_aggregate backward": n_train}
    losses = read_metrics(log_dir)["Loss/train"]
    print(f"graph train {name}: resume_training(log_dir), config.yaml read without PyYAML, for epoch {trained + 1}: Loss/train {losses}; "
          f"launches {counts} (expected {want})")
    if len(losses) != trained + 1 or not np.isfinite(losses).all():
        raise AssertionError(f"{name}: the resumed run logged {len(losses)} epochs, not {trained + 1}")
    if counts != want:
        raise AssertionError(f"{name}: resume launches {counts}, expected {want}")
    with open(os.path.join(log_dir, "state", "trainer_state.json")) as f:
        if json.load(f)["epoch"] != trained:
            raise AssertionError(f"{name}: the resumed state is not at epoch index {trained}")
    reloaded = factory.get_model("graph_net", cfg)
    reloaded.load(os.path.join(log_dir, "model.pt"))
    for key, value in resumed.model.state_dict().items():
        if not torch.equal(reloaded.model.state_dict()[key].to(value.device), value):
            raise AssertionError(f"{name}: model.pt does not hold the resumed weights ({key})")


def knn_bound(x, pos, seg, graphs: int, deg):
    """K5's bound for these inputs, forward or backward: x (or g), the
    positions and the ids read once, the output written once (the thresholds
    and degrees, 8 bytes a node, written by the forward and read by the
    backward, are left out); per allowed pair of this batch 8 operations for
    the distance, and per neighbour found one addition a channel."""
    sizes = torch.bincount(seg[seg < graphs].long(), minlength=graphs).double()
    pairs = float((sizes * (sizes - 1)).sum())
    return bound_ms(_nbytes(x, pos, seg, x), 8 * pairs + float(deg.sum()) * x.shape[1]), pairs


def knn_times_phase(smi: str):
    """K5 forward and backward against the plain versions (CUDA events, plain
    first), predict and the train step per batch on the K5 route, the plain
    route and the lineage-graph GraphConv routes (host clock), packing a flat
    batch, and a profile of the B=256 f32 kNN train step.  Returns the config
    shape's f32 times and bound."""
    config_times = None
    # width 4 is conv1's input: there the aggregation is all candidate tests
    for case in ("config B=32", "config B=32 H=4", "flagship B=256", "flagship B=256 H=4"):
        narrow_flagship = case == "flagship B=256 H=4"  # f32 and the kernels only
        for dtype in (torch.float32,) if narrow_flagship else (torch.float32, torch.bfloat16):
            x, pos, seg, graphs = knn_inputs(case, dtype)
            g = torch.randn(x.shape, device="cuda").to(dtype)
            # the row-blocked plain version at N=65,536 takes about a second a call
            iters, warmup = (2, 1) if case.startswith("flagship") else (20, 3)
            with torch.no_grad():
                # the selection alone (its entry: ranges and points, then kth
                # and deg), then the aggregation given a plan, as the model
                # calls it, and a call without a plan: both, one after the other
                select_ms = cuda_ms(lambda: knn_select(pos, seg, KNN_K, graphs))
                plan = knn_select(pos, seg, KNN_K, graphs)
                gather_ms = cuda_ms(lambda: _knn_aggregate_cuda(x, plan, "add"))
                bwd_ms = cuda_ms(lambda: _knn_aggregate_bwd_cuda(g, plan, "add"))
                unplanned_ms = cuda_ms(lambda: knn_aggregate(x, pos, seg, KNN_K, graphs, "add"))
                plain = "not timed at this shape"
                if not narrow_flagship:
                    # the plain versions of the same function: given the thresholds
                    plain_ms = cuda_ms(lambda: knn_aggregate_plain(
                        x, pos, seg, KNN_K, graphs, "add", kth=plan.kth), iters, warmup)
                    bwd_plain_ms = cuda_ms(lambda: knn_aggregate_bwd_plain(
                        g, pos, seg, KNN_K, graphs, "add", kth=plan.kth), iters, warmup)
                    plain = (f"given the thresholds forward {plain_ms:.4f} ms, backward {bwd_plain_ms:.4f} ms "
                             f"(mean of {iters})")
            print(f"time knn_aggregate add k={KNN_K} {case} N={x.shape[0]} H={x.shape[1]} {str(dtype)[6:]}: "
                  f"selection {select_ms:.4f} ms; aggregation given a plan forward {gather_ms:.4f} ms, "
                  f"backward {bwd_ms:.4f} ms; a call without a plan (one selection, one aggregation) "
                  f"{unplanned_ms:.4f} ms; plain {plain} [{smi}]")
            if dtype == torch.float32:
                bound, pairs = knn_bound(x, pos, seg, graphs, plan.deg)
                # the selection's own bound: positions and ids read once, the
                # points, thresholds and degrees written; 8 operations a pair
                select_bound = bound_ms(_nbytes(pos, seg, plan.points, plan.kth, plan.deg), 8 * pairs)
                print(f"bound knn_aggregate {case} f32: K5 {bound[0]:.4f} ms by {bound[1]}, each way "
                      f"({pairs:.0f} allowed pairs, {int(plan.deg.sum())} neighbours); the selection "
                      f"{select_bound[0]:.4f} ms by {select_bound[1]}; no single PyTorch call computes either")
                if case == "config B=32":
                    # ms: the aggregation given a plan, which is what the paths
                    # launch and what bound_ms counts; the selection beside it
                    config_times = dict(ms=gather_ms, plain_ms=plain_ms, bound_ms=bound[0],
                                        bound_by=bound[1], library_ms=None, select_ms=select_ms,
                                        select_bound_ms=select_bound[0])
    for b in (GRAPH_B, FLAGSHIP_GRAPHS):
        graphs = lineage_graphs(np.random.default_rng(SEED + 2), 4 * b)
        t0 = time.perf_counter()
        loader = GraphLoader(graphs, b, shuffle=False, layout="flat", use_weights=False)
        t1 = time.perf_counter()
        flat = list(loader)
        t2 = time.perf_counter()
        dense = list(GraphLoader(graphs, b, shuffle=False, layout="dense", use_weights=False, emit_out_rows=True))
        print(f"time packing per flat batch B={b} N={sorted({x['nodes'].shape[0] for x in flat})} "
              f"E={sorted({x['src'].shape[0] for x in flat})} on the host: {(t2 - t1) * 1e3 / len(flat):.4f} ms; "
              f"constructing the flat loader over {len(graphs)} graphs, once: {(t1 - t0) * 1e3:.4f} ms [{smi}]")
        slow_plain = b == FLAGSHIP_GRAPHS  # a second and more a step: timed apart, a few runs
        for dtype in ("float32", "bfloat16"):
            def knn_model():
                return factory.get_model("graph_net", knn_config("", "add", compute_dtype=dtype))
            knn, plain = knn_model(), PlainRoute(knn_model())
            fused = factory.get_model("graph_net", graph_config("", False, compute_dtype=dtype, fused_inrow=True))
            conv = factory.get_model("graph_net", graph_config("", False, compute_dtype=dtype))
            names = ["kNN K5 route", "lineage GraphConv add K6 route", "lineage GraphConv add adjacency route"]
            models, batches = [knn, fused, conv], [flat, dense, dense]
            if not slow_plain:
                names, models, batches = names + ["kNN plain route"], models + [plain], batches + [flat]
            for what, timer in (("predict", predict_ms_per_batch), ("train step", train_ms_per_batch)):
                rows = timer(models, batches)
                line = ", ".join(f"{n} {r[0]:.4f} ({r[1]:.4f}-{r[2]:.4f}) ms" for n, r in zip(names, rows))
                if slow_plain and dtype == "float32":
                    r = timer([plain], flat[:1], reps=2)[0]
                    line += f", kNN plain route {r[0]:.4f} ({r[1]:.4f}-{r[2]:.4f}) ms (2 runs over 1 batch)"
                print(f"time {what} per batch B={b} {dtype} adam, kNN k={KNN_K} on the flat wire beside the "
                      f"lineage graphs on the in-row wire, median (q1-q3) of {ROUTE_REPS} runs over {len(flat)} pre-packed "
                      f"batches, host clock{' to a synchronise' if what == 'train step' else ''}: {line} [{smi}]")
            if b == FLAGSHIP_GRAPHS and dtype == "float32":
                profile_train_steps(smi, "B=256 f32 kNN K5 route", knn, flat)
    return config_times


def slice2_arm_config(data_dir: str, log_dir: str, model: dict, dataset: dict) -> dict:
    cfg = graph_training_config(data_dir, log_dir, 3, **copy.deepcopy(model))
    cfg["dataset"].update(dataset)
    return cfg


def slice2_expected(counts: dict, model: dict, wires: list, steps: int, evals: int) -> dict:
    """The launches of one arm's train_model: only GAT on the in-row wire
    reaches a kernel (here with SAG), K3 twice per forward and K4 twice per
    train step over two mirrors (conv1's lists, then conv2's keep-masked
    ones)."""
    want = dict.fromkeys(counts, 0)
    if model.get("use_gat") and set(wires) == {"in_src"}:
        want.update({"gat_attention": 2 * (steps + evals), "gat_attention_bwd": 2 * steps,
                     "gat_out_rows": 2 * steps})
    return want


def slice2_wires(cfg: dict) -> list:
    """The wire of each train batch: flat, in-row or edge-slot triples."""
    wires = []
    for batch in factory.get_dataloader("s2pg", cfg).get_train_loader():
        wires.append("src" if "src" in batch else "in_src" if "in_src" in batch else "edge_slot")
    return wires


def slice2_train_arm(name: str, cfg: dict, model: dict) -> tuple:
    """train_model for one arm with its launch counts and floor; returns
    (counts, wires of the train batches)."""
    wires = slice2_wires(cfg)
    steps, evals, meta, counts = train_graph_arm(name, cfg)
    want = slice2_expected(counts, model, wires, steps, evals)
    floor = SLICE2_VAL_ACC_FLOOR[name]
    print(f"graph slice 2 {name}: {steps} train steps ({sorted(set(wires))} wire), {evals} eval batches; "
          f"launches {counts} (expected {want}); accuracy/val {meta['accuracy/val']} (floor {floor})")
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    if not meta["accuracy/val"] >= floor:
        raise AssertionError(f"{name}: accuracy/val {meta['accuracy/val']} below {floor}")
    return counts, wires


def slice2_demoted_phase(work_dir: str) -> None:
    """``layout: auto`` over the outlier cache: each loader warns as the JAX
    loader does and ships its wires, and the arm trains."""
    data_dir = os.path.join(work_dir, "s2pg_outliers")
    write_s2pg_cache(data_dir, n_graphs=(1024, 256, 256), seed=SEED + 21, outliers=True)
    for name, model, warned, wires in SLICE2_DEMOTED:
        cfg = slice2_arm_config(data_dir, os.path.join(work_dir, "slice2_log"), model,
                                {"graph_layout": "auto", "use_weights": True})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            seen = slice2_wires(cfg)
        messages = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
        print(f"graph slice 2 {name}: the train loader warned {messages}; wires {sorted(set(seen))}")
        if len(messages) != 1 or warned not in messages[0] or set(seen) != wires:
            raise AssertionError(f"{name}: warnings {messages}, wires {sorted(set(seen))}; expected "
                                 f"one warning naming {warned!r} and wires {sorted(wires)}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the same warnings, once per loader
            slice2_train_arm(name, cfg, model)


def slice2_phase(smi: str, work_dir: str) -> dict:
    """Phase 21, GraphNet slice 2: each arm through train_model on the graph
    training cache (3 epochs, B=32) with its launch counts and floor; the
    kernel route of in-row GAT with SAG against its plain route; the demoted
    loaders; then the train step and predict per batch at B=256 (the kNN
    arms at B=32) and a trace of the B=256 flat GAT step.  Returns the
    launch counts of in-row GAT with SAG."""
    data_dir = os.path.join(work_dir, "s2pg_train")  # the cache graph_train_phase wrote
    launches = {}
    marks = [time.perf_counter()]
    for name, model, dataset in SLICE2_ARMS:
        cfg = slice2_arm_config(data_dir, os.path.join(work_dir, "slice2_log"), model, dataset)
        counts, _ = slice2_train_arm(name, cfg, model)
        if any(counts.values()):
            launches = {k: v for k, v in counts.items() if v}
            graph_track_phase(name, cfg)
    marks.append(time.perf_counter())
    slice2_demoted_phase(work_dir)
    marks.append(time.perf_counter())
    slice2_times_phase(smi)
    marks.append(time.perf_counter())
    print("seconds: graph slice 2, "
          + ", ".join(f"{what} {b - a:.1f}" for what, a, b in
                      zip(("arms", "demoted loaders", "times"), marks, marks[1:])))
    return launches


def slice2_times_phase(smi: str) -> None:
    """The train step and predict per batch, host clock, each arm at B=256
    (kNN at B=32: the edge-list arm sorts an [N, N] distance matrix, 16 GiB
    in f32 at N = 65,536), in-row GAT with SAG also on its plain route and
    slice 1's in-row GAT beside flat GAT; then a trace of the B=256 f32 flat
    GAT step."""
    graphs = lineage_graphs(np.random.default_rng(SEED + 2), 4 * FLAGSHIP_GRAPHS)
    knn_graphs = lineage_graphs(np.random.default_rng(SEED + 2), 4 * GRAPH_B)
    loaders = {"flat": GraphLoader(graphs, FLAGSHIP_GRAPHS, shuffle=False, layout="flat", use_weights=False),
               "in-row": GraphLoader(graphs, FLAGSHIP_GRAPHS, shuffle=False, layout="dense", use_weights=False),
               "kNN": GraphLoader(knn_graphs, GRAPH_B, shuffle=False, layout="flat", use_weights=False)}
    batches = {wire: list(loader) for wire, loader in loaders.items()}
    rows = []
    for name, model, _ in SLICE2_ARMS + (("in-row GAT", dict(use_gat=True), {}),):
        wire = name.split(" ", 1)[0]
        cfg = slice2_arm_config("", None, model, {})
        wrapper = factory.get_model("graph_net", cfg)
        routes = [(name, wrapper)]
        if model.get("use_gat") and model.get("sag_pool") and wire == "in-row":
            plain = factory.get_model("graph_net", cfg)  # the same seeded weights
            routes.append((f"{name} plain route", PlainRoute(plain)))
        own = batches[wire]
        step = train_ms_per_batch([w for _, w in routes], own, reps=4)
        serve = predict_ms_per_batch([w for _, w in routes], own, reps=4)
        b = own[0]["y"].shape[0]
        for (label, _), t, p in zip(routes, step, serve):
            rows.append(f"{label} B={b}: train step {t[0]:.4f} ({t[1]:.4f}-{t[2]:.4f}) ms, predict "
                        f"{p[0]:.4f} ({p[1]:.4f}-{p[2]:.4f}) ms")
        if name == "flat GAT":
            profile_train_steps(smi, "B=256 f32 flat GAT (segment softmax and scatters)", wrapper, own)
    print(f"time graph slice 2, f32 adam, per batch, median (q1-q3) of 4 runs over {len(batches['flat'])} "
          f"pre-packed batches, host clock to a synchronise: " + "; ".join(rows) + f" [{smi}]")


def _cli(seconds: dict, label: str, *argv) -> dict:
    """One command through ``cli.main`` in this process, on the card, with
    every launch count set to 0 just before it; returns the counts read just
    after."""
    reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(list(argv))
    seconds[label] = time.perf_counter() - t0
    counts = launch_counts()
    print(f"cli {label}: {seconds[label]:.2f} s, launches {({k: v for k, v in counts.items() if v})}")
    return counts


def _expect_launches(label: str, counts: dict, **want) -> None:
    want = {**dict.fromkeys(counts, 0), **want}
    if counts != want:
        raise AssertionError(f"cli {label}: launches {counts}, expected {want}")


def _cli_train(seconds: dict, work_dir: str, data: str, model: str, *extra):
    """``train <model>`` at the widths of configs/; returns the run directory,
    the launch counts and the run's config.yaml."""
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    log = os.path.join(work_dir, "cli_log", model)
    counts = _cli(seconds, f"train {model}", "train", model, "--config-dir", configs,
                  "--data-dir", data, "--log-dir", log, *extra)
    run_dir = os.path.join(log, "version_0")
    with open(os.path.join(run_dir, "meta.json")) as f:
        meta = json.load(f)["metrics"]
    print(f"cli train {model}: meta.json {meta}")
    if not meta["accuracy/val"] >= CLI_VAL_ACC_FLOOR[model]:
        raise AssertionError(f"cli train {model}: accuracy/val {meta['accuracy/val']} below "
                             f"{CLI_VAL_ACC_FLOOR[model]}")
    return run_dir, counts, load_config(os.path.join(run_dir, "config.yaml"))


def cli_deep_sets_phase(seconds: dict, work_dir: str, data: str) -> dict:
    """``train``, ``evaluate``, ``infer``, ``resume`` and ``convert`` of a
    DeepSets run; returns K1's and K2's launches during ``train``."""
    run_dir, counts, cfg = _cli_train(seconds, work_dir, data, "deep_sets", "--epochs", "2")
    missing = {"config.yaml", "meta.json", "metrics.jsonl", "best_model.pt", "model.pt"} - set(os.listdir(run_dir))
    if missing:
        raise AssertionError(f"cli train deep_sets: the run directory lacks {sorted(missing)}")
    module = factory.get_dataloader("s2ppc", cfg)
    loaders = {"train": module.get_train_loader(), "val": module.get_val_loader(), "test": module.get_test_loader()}
    n = {split: len(loader) for split, loader in loaders.items()}
    steps = 2 * n["train"]
    # per epoch the train steps and a validation; then predict on train and val
    _expect_launches("train deep_sets", counts, phi_pool=steps + 2 * n["val"] + n["train"] + n["val"],
                     phi_pool_bwd=steps)
    train_launches = {"phi_pool": counts["phi_pool"], "phi_pool_bwd": counts["phi_pool_bwd"]}

    counts = _cli(seconds, "evaluate deep_sets", "evaluate", run_dir)
    _expect_launches("evaluate deep_sets", counts, phi_pool=n["test"] + n["train"] + n["val"])
    with open(os.path.join(run_dir, "eval", "metrics.json")) as f:
        metrics = json.load(f)
    model = factory.get_model("deep_sets", cfg, run_dir)
    for split, loader in loaders.items():
        y, pred = model.predict(loader)
        if metrics[f"accuracy_{split}"] != port_train.accuracy(y, pred):
            raise AssertionError(f"cli evaluate: accuracy_{split} {metrics[f'accuracy_{split}']} is not "
                                 f"predict's {port_train.accuracy(y, pred)}")
    y_test, p_test = (a.reshape(-1) for a in model.predict(loaders["test"], return_prob=True))
    with open(os.path.join(run_dir, "eval", "classification_report.txt")) as f:
        report = f.read().splitlines()
    supports = [int(report[i].split()[-1]) for i in (2, 3)] + [int(report[-1].split()[-1])]
    want = [int((y_test == 0).sum()), int((y_test == 1).sum()), len(y_test)]
    print(f"cli evaluate deep_sets: {metrics}; report supports {supports} (test split {want})")
    if supports != want or len(y_test) != CLI_EVENTS[2]:
        raise AssertionError("cli evaluate: classification_report.txt does not hold the test split's support")

    csv = os.path.join(work_dir, "cli_predictions_test.csv")
    counts = _cli(seconds, "infer deep_sets", "infer", run_dir, "--split", "test", "--output", csv)
    _expect_launches("infer deep_sets", counts, phi_pool=n["test"])
    rows = np.loadtxt(csv, delimiter=",", skiprows=1)
    err = float(np.abs(rows[:, 2] - p_test).max())
    away = np.abs(rows[:, 2] - 0.5) > CSV_PROB_TOL
    print(f"cli infer deep_sets: {len(rows)} rows, max |probability − predict's| {err:.3e} (bound {CSV_PROB_TOL:.0e})")
    if (len(rows) != len(y_test) or not np.array_equal(rows[:, 0], np.arange(len(rows)))
            or not np.array_equal(rows[:, 1], y_test) or not err <= CSV_PROB_TOL
            or not np.array_equal(rows[away, 3], (rows[away, 2] >= 0.5).astype(np.float64))):
        raise AssertionError("cli infer: the CSV does not hold predict's test split")

    # one more epoch, asked for in the run's own config.yaml alone
    config_path = os.path.join(run_dir, "config.yaml")
    with open(config_path) as f:
        text = f.read()
    if text.count("epochs: 2\n") != 1:
        raise AssertionError("cli resume: config.yaml does not hold 'epochs: 2' once")
    with open(config_path, "w") as f:
        f.write(text.replace("epochs: 2\n", "epochs: 3\n"))
    counts = _cli(seconds, "resume deep_sets", "resume", run_dir)
    # one epoch: its train steps and its validation (resume predicts nothing after)
    _expect_launches("resume deep_sets", counts, phi_pool=n["train"] + n["val"], phi_pool_bwd=n["train"])
    losses = read_metrics(run_dir)["Loss/train"]
    print(f"cli resume deep_sets: Loss/train {losses}")
    if len(losses) != 3 or not np.isfinite(losses).all():
        raise AssertionError(f"cli resume: {len(losses)} epochs logged, not 3")

    best = os.path.join(run_dir, "best_model.pt")
    out = {name: os.path.join(work_dir, f"cli_{name}") for name in ("reference.pt", "jax.pt", "back.pt")}
    _cli(seconds, "convert deep_sets --to-torch", "convert", "deep_sets", best, out["reference.pt"],
         "--to-torch", "--config", config_path)
    _cli(seconds, "convert deep_sets", "convert", "deep_sets", out["reference.pt"], out["jax.pt"],
         "--config", config_path)
    _cli(seconds, "convert deep_sets --to-torch (back)", "convert", "deep_sets", out["jax.pt"], out["back.pt"],
         "--to-torch", "--config", config_path)
    want = torch.load(best, map_location="cpu", weights_only=True)
    for name in ("reference.pt", "back.pt"):
        got = torch.load(out[name], map_location="cpu", weights_only=True)
        if list(got) != list(want) or not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"cli convert: {name} is not best_model.pt exactly")
    print("cli convert deep_sets: best_model.pt → reference state_dict → JAX pickle → state_dict, exactly equal")
    return train_launches


def cli_tabular_phase(smi: str, seconds: dict, work_dir: str, data: str) -> None:
    """``train`` and ``evaluate`` of the FCN and the logistic regression on
    S2PT, the latter's coefficients against the same fit on the CPU, and its
    solve timed on the card and the CPU."""
    run_dir, counts, cfg = _cli_train(seconds, work_dir, data, "fully_connected_net", "--epochs", "5")
    _expect_launches("train fully_connected_net", counts)  # no kernel on its path
    _cli(seconds, "evaluate fully_connected_net", "evaluate", run_dir)
    model = factory.get_model("fully_connected_net", cfg, run_dir)
    with open(os.path.join(run_dir, "eval", "metrics.json")) as f:
        print(f"cli evaluate fully_connected_net: {json.load(f)} (best_model.pt on {model.device})")

    run_dir, counts, cfg = _cli_train(seconds, work_dir, data, "logistic_regression")
    _expect_launches("train logistic_regression", counts)
    card = LogRegression(device="cpu").load(os.path.join(run_dir, "model.pkl"))
    train = factory.get_dataloader("s2pt", cfg).get_train_loader()
    solves = {device: [] for device in ("cpu", "cuda")}
    fitted = {device: LogRegression(device=device).fit(train) for device in solves}  # warm-up
    for device in ("cpu", "cuda", "cuda", "cpu"):  # in turns
        for _ in range(LOGREG_REPS):
            t0 = time.perf_counter()
            fitted[device] = LogRegression(device=device).fit(train)
            solves[device].append(time.perf_counter() - t0)
    cpu = fitted["cpu"]
    err = max(float(np.abs(card.coef_ - cpu.coef_).max()), float(np.abs(card.intercept_ - cpu.intercept_).max()))
    print(f"cli train logistic_regression: coefficients from the card's model.pkl against the CPU's fit "
          f"max |Δ| {err:.3e} (bound {LOGREG_COEF_TOL:.0e}); L-BFGS iterations card "
          f"{fitted['cuda'].n_iter_}, CPU {fitted['cpu'].n_iter_}; the solve on {len(train['label'])} rows, "
          f"median of {2 * LOGREG_REPS}: card {1e3 * np.median(solves['cuda']):.3f} ms, CPU "
          f"{1e3 * np.median(solves['cpu']):.3f} ms (host clock, ends in the copy of the result) [{smi}]")
    if not err <= LOGREG_COEF_TOL:
        raise AssertionError(f"cli train logistic_regression: the card's coefficients are {err} from the CPU's")
    _cli(seconds, "evaluate logistic_regression", "evaluate", run_dir)
    with open(os.path.join(run_dir, "eval", "metrics.json")) as f:
        print(f"cli evaluate logistic_regression: {json.load(f)}")


def cli_phase(smi: str, work_dir: str) -> dict:
    """Phase 20, the command line: ``cli.main`` in this process on the card,
    over seeded S2PPC and S2PT caches at the widths of configs/.  Returns K1's
    and K2's launches during ``train deep_sets``."""
    data = os.path.join(work_dir, "cli_data")
    write_s2ppc_cache(data, n_events=CLI_EVENTS, seed=SEED)
    write_s2pt_cache(data, n_events=CLI_EVENTS, seed=SEED)
    seconds = {}
    launches = cli_deep_sets_phase(seconds, work_dir, data)
    cli_tabular_phase(smi, seconds, work_dir, data)
    print(f"cli seconds: {({k: round(v, 2) for k, v in seconds.items()})} [{smi}]")
    return launches


# phase 23: the hyperparameter sweep
SWEEP_EPOCHS = 2
SWEEP_LRS = (1e-3, 5e-4, 2e-3, 3e-4)  # the arms' learning rates (K = 4)
# an arm against its sequential run: the final weights' mean train loss
# (eval mode, the train split unshuffled) within 1e-4 relative; the
# vmapped step against itself under force_plain(): loss and every gradient
# within 1e-4 of the largest plain entry (max(1, ·)); the same f32 math,
# matrix products batched over the arms and the kernels' sums in their
# own orders
SWEEP_LOSS_RTOL, SWEEP_STEP_TOL = 1e-4, 1e-4
SWEEP_TURNS = 5  # timed turns of a vmapped step against K sequential steps


def _sweep_loaders(dataset: str, cfg: dict):
    module = factory.get_dataloader(dataset, cfg)
    return module.get_train_loader(), module.get_val_loader()


def _rewound(*loaders):
    """The loaders at their first shuffle epoch, as a fresh data module's."""
    for loader in loaders:
        loader._epoch = 0
    return loaders


def _sweep_main(label: str, *argv) -> dict:
    """``sweep.main`` in this process, with every launch count set to 0 just
    before it; returns the counts read just after and the seconds."""
    reset_launch_counts()
    t0 = time.perf_counter()
    port_sweep.main(list(argv))
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    print(f"sweep {label}: {seconds:.1f} s, launches {({k: v for k, v in counts.items() if v})}")
    return counts, seconds


def _leaderboard(search: str, runs: int) -> list:
    status = os.path.join(search, "status_log.txt")
    if os.path.exists(status):
        with open(status) as f:
            raise AssertionError(f"sweep: runs failed:\n{f.read()[:2000]}")
    with open(os.path.join(search, "search_results.json")) as f:
        top = json.load(f)
    if len(top) != runs or [r["val_acc"] for r in top] != sorted((r["val_acc"] for r in top), reverse=True):
        raise AssertionError(f"sweep: the leaderboard is not {runs} runs sorted by val_acc: {top}")
    for r in top:
        run = os.path.join(search, f"version_{r['version']}")
        missing = {"config.yaml", "meta.json", "model.pt", "best_model.pt"} - set(os.listdir(run))
        if missing:
            raise AssertionError(f"sweep: {run} lacks {sorted(missing)}")
    return top


def sweep_sequential_phase(work_dir: str, data: str) -> dict:
    """(a) ``sweep.main`` for DeepSets, one run at a time at the sampled
    widths, with K1's and K2's launches as each run's loaders and route say;
    the winner through the command line's ``evaluate``."""
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    search = os.path.join(work_dir, "sweep_deep_sets")
    argv = ["deep_sets", "--seed", "0", "--max-runs", "3", "--epochs", str(SWEEP_EPOCHS), "--force",
            "--config-dir", configs, "--data-dir", data, "--search-dir", search]
    counts, seconds = _sweep_main("deep_sets (sequential, 3 runs)", *argv)
    top = _leaderboard(search, 3)
    want = dict.fromkeys(counts, 0)
    for version in range(3):
        hp = load_config(os.path.join(search, f"version_{version}", "config.yaml"))
        train, val = _sweep_loaders("s2ppc", hp)
        kernel = DeepSets(**hp["model"])._use_kernel()
        n_tr, n_va = len(train), len(val)
        print(f"sweep deep_sets version_{version}: phi {hp['model']['phi_layers']}, rho "
              f"{hp['model']['rho_layers']}, B={hp['dataset']['batch_size']}, lr "
              f"{hp['trainer']['learning_rate']:.3e}; {'K1 and K2' if kernel else 'the plain path'}")
        if kernel:  # per epoch the steps and a validation; then predict on train and val
            want["phi_pool"] += SWEEP_EPOCHS * (n_tr + n_va) + n_tr + n_va
            want["phi_pool_bwd"] += SWEEP_EPOCHS * n_tr
    if counts != want or not counts["phi_pool_bwd"]:
        raise AssertionError(f"sweep deep_sets: launches {counts}, expected {want}")
    win = os.path.join(search, f"version_{top[0]['version']}")
    cli.main(["evaluate", win])
    with open(os.path.join(win, "eval", "metrics.json")) as f:
        metrics = json.load(f)
    print(f"sweep deep_sets: leaderboard {top}; the winner evaluates: {metrics}")
    if set(metrics) != {"accuracy_train", "accuracy_val", "accuracy_test"}:
        raise AssertionError("sweep deep_sets: evaluate did not score the winner")
    return {k: v for k, v in counts.items() if v}


def sweep_vmapped_phase(work_dir: str, data: str) -> dict:
    """(b) ``sweep.main --vmap`` for GraphNet: every sampled group trains."""
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    search = os.path.join(work_dir, "sweep_graph_net")
    counts, seconds = _sweep_main(
        "graph_net --vmap (4 runs)", "graph_net", "--vmap", "--seed", "0", "--max-runs", "4", "--epochs",
        str(SWEEP_EPOCHS), "--force", "--config-dir", configs, "--data-dir", data, "--search-dir", search)
    top = _leaderboard(search, 4)
    for r in sorted(top, key=lambda r: r["version"]):
        hp = load_config(os.path.join(search, f"version_{r['version']}", "config.yaml"))
        print(f"sweep graph_net version_{r['version']}: {hp['model']}, B={hp['dataset']['batch_size']}, "
              f"{hp['trainer']['optimizer']} lr {hp['trainer']['learning_rate']:.3e}; val_acc {r['val_acc']}")
    return {k: v for k, v in counts.items() if v}


def sweep_arms_phase(smi: str, name: str, model_name: str, dataset: str, cfg: dict, lrs, per_step: dict) -> dict:
    """(c)-(e) ``train_configs_vmapped`` at the config's widths: each arm
    against a sequential ``ModelWrapper`` run with its seed and learning rate,
    the vmapped step against itself under ``force_plain()``, the kernels a
    vmapped step launches (``per_step``), and ms per arm-step vmapped against
    K sequential steps.  Returns the launches of the vmapped training."""
    k = len(lrs)
    optimizer = cfg["trainer"].get("optimizer", "adam")
    model_cls = {"deep_sets": DeepSets, "graph_net": GraphNet}[model_name]
    train, val = _sweep_loaders(dataset, cfg)  # rewound for every run
    n_tr, n_va = len(train), len(val)
    reset_launch_counts()
    t0 = time.perf_counter()
    result = train_configs_vmapped(model_cls(**cfg["model"]), list(lrs), optimizer, SWEEP_EPOCHS,
                                   *_rewound(train, val), seeds=[SEED] * k)
    seconds = time.perf_counter() - t0
    counts = {key: v for key, v in launch_counts().items() if v}
    # per epoch the steps and a validation, then one pass over the train split
    forwards, steps = SWEEP_EPOCHS * (n_tr + n_va) + n_tr, SWEEP_EPOCHS * n_tr
    want = {key: v * (steps if key in per_step["backward"] else forwards if key in per_step["forward"] else steps)
            for key, v in per_step["counts"].items()}
    print(f"sweep arms {name}: K={k}, {SWEEP_EPOCHS} epochs of {n_tr} steps (B={cfg['dataset']['batch_size']}), "
          f"{seconds:.1f} s; launches {counts} (expected {want}); val_accs {result['val_accs']}")
    if counts != want:
        raise AssertionError(f"sweep arms {name}: launches {counts}, expected {want}")

    unshuffled = copy.copy(train)
    unshuffled.shuffle = False
    wrappers = []
    for arm, lr in enumerate(lrs):
        arm_cfg = copy.deepcopy(cfg)
        arm_cfg["trainer"].update(learning_rate=lr, seed=SEED, epochs=SWEEP_EPOCHS, state_every=0)
        arm_cfg.pop("logging", None)
        wrapper = factory.get_model(model_name, arm_cfg)
        wrapper.fit(*_rewound(train, val))
        y, pred = wrapper.predict(val)
        seq_acc = port_train.accuracy(y, pred)
        seq_loss = wrapper._evaluate(unshuffled)[0]
        wrapper.model.load_state_dict(result["final_state"][arm])
        arm_loss = wrapper._evaluate(unshuffled)[0]
        rel = abs(arm_loss - seq_loss) / max(abs(seq_loss), 1e-12)
        apart = abs(result["val_accs"][arm] - seq_acc) * len(y)
        print(f"sweep arms {name} arm {arm} (lr {lr:.1e}): final train loss vmapped {arm_loss:.6f}, sequential "
              f"{seq_loss:.6f}, rel {rel:.2e} (bound {SWEEP_LOSS_RTOL:.0e}); val accuracy {result['val_accs'][arm]:.6f} "
              f"against {seq_acc:.6f} ({apart:.0f} of {len(y)} examples apart, bound 1)")
        if not rel <= SWEEP_LOSS_RTOL or not apart <= 1.0 + 1e-9:
            raise AssertionError(f"sweep arms {name} arm {arm}: the vmapped arm does not follow its sequential run")
        wrappers.append(factory.get_model(model_name, arm_cfg))

    arms = VmappedArms(model_cls(**cfg["model"]), list(lrs), optimizer, seeds=[SEED] * k)
    batch = arms.put(next(iter(unshuffled)))
    grads, loss, _ = arms.grads(batch)
    with force_plain():
        plain_grads, plain_loss, _ = arms.grads(batch)
    errs = [_max_rel(loss, plain_loss)] + [_max_rel(grads[n], plain_grads[n]) for n in grads]
    print(f"sweep arms {name}: vmapped step against force_plain(): loss and {len(grads)} gradients, max rel "
          f"{max(errs):.2e} (bound {SWEEP_STEP_TOL:.0e})")
    if not max(errs) <= SWEEP_STEP_TOL:
        raise AssertionError(f"sweep arms {name}: the kernel route does not follow the plain route")
    reset_launch_counts()
    arms.step(batch)
    torch.cuda.synchronize()
    step_counts = {key: v for key, v in launch_counts().items() if v}
    print(f"sweep arms {name}: kernels a vmapped step of K={k} launches: {step_counts}")
    if step_counts != per_step["counts"]:
        raise AssertionError(f"sweep arms {name}: a step launched {step_counts}, expected {per_step['counts']}")

    # ms per arm-step: one vmapped step over K arms against K sequential
    # steps (each wrapper its own step), CUDA events, in turns
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fn):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / k

    def sequential():
        for w in wrappers:
            w.train_step(batch)

    for _ in range(2):  # warm-up
        arms.step(batch)
        sequential()
    vm, seq = [], []
    for _ in range(SWEEP_TURNS):
        vm.append(timed(lambda: arms.step(batch)))
        seq.append(timed(sequential))
    print(f"time sweep arms {name}: ms per arm-step at K={k}, B={cfg['dataset']['batch_size']}, median of "
          f"{SWEEP_TURNS} turns (CUDA events): vmapped {np.median(vm):.4f} ({min(vm):.4f}-{max(vm):.4f}), "
          f"sequential {np.median(seq):.4f} ({min(seq):.4f}-{max(seq):.4f}) [{smi}]")
    return counts


def sweep_phase(smi: str, work_dir: str) -> dict:
    """Phase 23, the hyperparameter sweep on the card (the caches of phases
    20 and 13): (a) and (b) through ``sweep.main``, (c)-(e) through
    ``train_configs_vmapped`` against sequential runs.  Returns the launches
    of all five, summed."""
    t0 = time.perf_counter()
    clouds, graphs = os.path.join(work_dir, "cli_data"), os.path.join(work_dir, "s2pg_train")
    parts = [sweep_sequential_phase(work_dir, clouds), sweep_vmapped_phase(work_dir, graphs)]
    ds_cfg = load_config(os.path.join("configs", "base.yaml"), os.path.join("configs", "deep_sets.yaml"))
    ds_cfg["dataset"]["data_dir"] = clouds
    k = len(SWEEP_LRS)
    parts.append(sweep_arms_phase(
        smi, "DeepSets", "deep_sets", "s2ppc", ds_cfg, SWEEP_LRS,
        {"counts": {"phi_pool": k, "phi_pool_bwd": k}, "forward": {"phi_pool"}, "backward": {"phi_pool_bwd"}}))
    gat_cfg = graph_training_config(graphs, os.path.join(work_dir, "sweep_log"), SWEEP_EPOCHS, use_gat=True)
    parts.append(sweep_arms_phase(
        smi, "GAT", "graph_net", "s2pg", gat_cfg, SWEEP_LRS,
        {"counts": {"gat_attention": 2 * k, "gat_attention_bwd": 2 * k, "gat_out_rows": 1},
         "forward": {"gat_attention"}, "backward": {"gat_attention_bwd"}}))
    sag_cfg = graph_training_config(graphs, os.path.join(work_dir, "sweep_log"), SWEEP_EPOCHS, use_gat=True,
                                    sag_pool=True)
    parts.append(sweep_arms_phase(
        smi, "GAT + SAG", "graph_net", "s2pg", sag_cfg, SWEEP_LRS[:2],
        {"counts": {"gat_attention": 4, "gat_attention_bwd": 4, "gat_out_rows": 3},
         "forward": {"gat_attention"}, "backward": {"gat_attention_bwd"}}))
    total = {}
    for part in parts:
        for key, v in part.items():
            total[key] = total.get(key, 0) + v
    print(f"seconds: sweep phase {time.perf_counter() - t0:.1f} [{smi}]")
    return total


# phase 22: the C++ host packers and the edge builder
PACK_B = 256
PACK_PASSES = 5  # host-clock passes over each wire's batches, per packer, in turns
EDGE_EVENTS = 200


@contextlib.contextmanager
def numpy_packing():
    """``PCC_NATIVE=0`` for the block: the loaders pack with numpy."""
    previous = os.environ.get("PCC_NATIVE")
    os.environ["PCC_NATIVE"] = "0"
    try:
        yield
    finally:
        if previous is None:
            del os.environ["PCC_NATIVE"]
        else:
            os.environ["PCC_NATIVE"] = previous


class NumpyPacking:
    """A loader whose batches the numpy branch packs, one at a time as it is
    iterated (inline, as the C++ packer packs the loader's own)."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        batches = iter(self.loader)
        while True:
            with numpy_packing():
                batch = next(batches, None)
            if batch is None:
                return
            yield batch


def packer_wires() -> dict:
    """Every wire at B=256: (name, loader) over seeded clouds of 160-288
    points (one empty, ``energy_total`` in column 1 constant in an event,
    four full batches and a partial one) and lineage graphs of 160-288 nodes
    (a second set with the outlier graph: a duplicate edge, an exact-zero
    weight, a node of 40 more incoming edges)."""
    rng = np.random.default_rng(SEED + 22)
    clouds, labels = make_clouds(rng, 4 * PACK_B + 100)
    for cloud in clouds:
        cloud[:, 1] = cloud[0, 1] if len(cloud) else 0.0
    graphs = lineage_graphs(rng, 4 * PACK_B)
    outliers = lineage_graphs(rng, 4 * PACK_B, outliers=True)

    def clouds_of(**kw):
        return PointCloudLoader(clouds, labels, PACK_B, shuffle=False, **kw)

    def graphs_of(gs, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the demoted loader warns
            return GraphLoader(gs, PACK_B, shuffle=False, **kw)

    return {
        "clouds flat f32 ids": clouds_of(),
        "clouds flat fp16 counts, energy_total factored": clouds_of(
            transfer_dtype="float16", seg_encoding="counts", factor_event_cols=(1,)),
        "clouds dense f32": clouds_of(layout="dense"),
        "clouds flagship wire (auto, fp16, factored, length-sorted)": clouds_of(**FLAGSHIP_WIRE),
        "graphs in-row f32": graphs_of(graphs, layout="dense", use_weights=False),
        "graphs in-row + out-rows f32": graphs_of(graphs, layout="dense", use_weights=False, emit_out_rows=True),
        "graphs in-row + out-rows fp16 weighted": graphs_of(graphs, layout="dense", emit_out_rows=True,
                                                            transfer_dtype="float16"),
        "graphs flat f32": graphs_of(graphs, layout="flat"),
        "graphs flat fp16 counts": graphs_of(graphs, layout="flat", transfer_dtype="float16",
                                             seg_encoding="counts"),
        "graphs merged multigraph demoted to flat": graphs_of(outliers, layout="auto", flat_if_multigraph=True),
        "graphs host adjacency fp16": graphs_of(graphs, layout="dense", adj_wire="host",
                                                transfer_dtype="float16"),
        "graphs in-row, the outlier's batch edge-slot triples": graphs_of(outliers, layout="dense"),
    }


def _pack_pass(loader, numpy_branch: bool):
    """One pass over ``loader``: its batches and the ms a batch took."""
    with numpy_packing() if numpy_branch else contextlib.nullcontext():
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # a demoted batch warns
            batches = list(loader)
        return batches, (time.perf_counter() - t0) * 1e3 / len(batches)


def _same_bytes(name: str, ours: list, plain: list) -> None:
    if len(ours) != len(plain):
        raise AssertionError(f"packer {name}: {len(ours)} batches, numpy {len(plain)}")
    for i, (a, b) in enumerate(zip(ours, plain)):
        if sorted(a) != sorted(b):
            raise AssertionError(f"packer {name} batch {i}: keys {sorted(a)}, numpy {sorted(b)}")
        for key in a:
            if a[key].dtype != b[key].dtype or a[key].shape != b[key].shape or a[key].tobytes() != b[key].tobytes():
                raise AssertionError(f"packer {name} batch {i}: {key} differs from the numpy branch's")


def _fresh_pass(batches) -> float:
    """ms a batch to allocate zeroed arrays of ``batches``' shapes and dtypes
    and write one byte of each page, keeping them as a pass keeps its
    batches: the first-touch page faults that every packer pays before it
    copies a byte."""
    kept = []
    t0 = time.perf_counter()
    for batch in batches:
        arrays = [np.zeros(a.shape, a.dtype) for a in batch.values()]
        for a in arrays:
            a.reshape(-1).view(np.uint8)[::4096] = 1
        kept.append(arrays)
    return (time.perf_counter() - t0) * 1e3 / len(batches)


def packer_phase(smi: str) -> None:
    """Every wire packed both ways, equal bytes, and each packer's ms per
    batch beside the fresh buffers' alone: the median (range) of passes
    taken in turns (C++, numpy, buffers, then the other way round, ...); the
    first pass of each packer is compared."""
    for name, loader in packer_wires().items():
        samples = {"C++": [], "numpy": [], "buffers": []}
        for turn in range(PACK_PASSES):
            for arm in ("C++", "numpy", "buffers")[:: 1 if turn % 2 == 0 else -1]:
                if arm == "buffers":
                    samples[arm].append(_fresh_pass(ours))
                    continue
                batches, ms = _pack_pass(loader, arm == "numpy")
                samples[arm].append(ms)
                if turn == 0 and arm == "C++":
                    ours = batches
                elif turn == 0:
                    _same_bytes(name, ours, batches)
        rows = "points" if "points" in ours[0] else "nodes"
        shapes = " ".join(sorted({str(tuple(batch[rows].shape)) for batch in ours}))
        wires = sorted({k for batch in ours for k in batch if k in ("in_src", "out_pos", "adj", "edge_slot", "src")})
        mb = sum(a.nbytes for a in ours[0].values()) / 2**20
        times = ", ".join(f"{arm} {np.median(ms):.4f} ({min(ms):.4f}-{max(ms):.4f})" for arm, ms in samples.items())
        print(f"packer {name} B={PACK_B}: C++ = numpy byte for byte over {len(ours)} batches ({rows} "
              f"{shapes}; {', '.join(wires) or 'no edges'}; {mb:.2f} MiB a batch); ms per batch, median "
              f"(range) of {PACK_PASSES} passes in turns, host clock: {times} (buffers: allocating and "
              f"touching the batch's arrays alone) [{smi}]")


def synthetic_event(rng, n_particles: int = 120, unrecorded: float = 0.4, max_steps: int = 6):
    """One seeded event for the edge builders: a lineage tree (a second
    parent now and then) whose recorded particles leave 1 to ``max_steps -
    1`` steps, then the incident node (pid 0, time 0)."""
    parents = {0: []}
    for p in range(1, n_particles):
        parents[p] = [int(rng.integers(0, p))]
        if rng.random() < 0.2:
            parents[p].append(int(rng.integers(0, p)))
    recorded = [0] + [p for p in range(1, n_particles) if rng.random() > unrecorded]
    steps = rng.integers(1, max_steps, size=len(recorded))
    pids = np.append(np.repeat(recorded, steps), 0).astype(np.int64)
    times = np.append(rng.exponential(1.0, size=int(steps.sum())), 0.0)
    return pids, times, np.arange(len(pids), dtype=np.int64), parents


def edge_builder_phase(smi: str) -> None:
    """Seeded events' edges by the C++ builder and by numpy, equal, and the
    ms per event of each (host clock)."""
    rng = np.random.default_rng(SEED + 23)
    events = [synthetic_event(rng) for _ in range(EDGE_EVENTS)]
    t0 = time.perf_counter()
    native = [build_event_edges_native(*event) for event in events]
    t1 = time.perf_counter()
    plain = [build_event_edges(*event) for event in events]
    t2 = time.perf_counter()
    for i, (a, b) in enumerate(zip(native, plain)):
        if a is None or a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"edge builder: event {i}'s C++ edges differ from numpy's")
    steps = sum(len(event[0]) for event in events)
    edges = sum(e.shape[1] for e in plain)
    print(f"edge builder: C++ = numpy over {EDGE_EVENTS} seeded events ({steps} steps, {edges} directed "
          f"edges); ms per event, host clock: C++ {(t1 - t0) * 1e3 / EDGE_EVENTS:.4f}, numpy "
          f"{(t2 - t1) * 1e3 / EDGE_EVENTS:.4f} [{smi}]")


def inline_packing_phase(smi: str, work_dir: str) -> None:
    """The train step per batch with the packing inline, by the C++ packer and
    by numpy, beside pre-packed batches (taken in turns): the flagship
    DeepSets wire at B=256, f32 compute (CUDA events over a pass), and the
    in-row GAT and fused GraphConv at B=256 (host clock), with the launch
    counts of each."""
    data_dir = os.path.join(work_dir, "flagship_data")
    for layout in ("flat", "dense"):
        cfg = flagship_config(data_dir, os.path.join(work_dir, "unused"), {}, {})
        cfg["dataset"].update(layout=layout)
        loader = factory.get_dataloader("s2ppc", cfg).get_train_loader()
        prepacked = list(loader)
        arms = {"pre-packed": lambda: prepacked, "C++ packing inline": lambda: loader,
                "numpy packing inline": lambda: NumpyPacking(loader)}
        reset_launch_counts()
        samples = events_ms_per_batch([factory.get_model("deep_sets", cfg) for _ in arms], list(arms.values()))
        counts = {k: v for k, v in launch_counts().items() if v}
        if layout == "dense" and not (counts.get("phi_pool") and counts.get("phi_pool_bwd")):
            raise AssertionError(f"inline packing, flagship dense: K1 and K2 did not run ({counts})")
        row = ", ".join(f"{name} {np.median(ms):.4f} ({min(ms):.4f}-{max(ms):.4f})"
                        for name, ms in zip(arms, samples))
        print(f"time flagship train step per batch B={FLAGSHIP_B} {layout} fp16 wire, float32, streaming, "
              f"median (range) of {len(samples[0])} passes over {len(prepacked)} batches taken in turns, "
              f"CUDA events: {row} ms; launches {counts} [{smi}]")
    graphs = lineage_graphs(np.random.default_rng(SEED + 2), 4 * FLAGSHIP_GRAPHS)
    for name, use_gat, model, wire, kernels in (
            ("GAT K3+K4 route", True, {}, {}, ("gat_attention", "gat_attention_bwd")),
            ("GraphConv add K6 route", False, {"fused_inrow": True}, {"emit_out_rows": True},
             ("inrow_aggregate", "inrow_aggregate backward"))):
        loader = GraphLoader(graphs, FLAGSHIP_GRAPHS, shuffle=False, layout="dense", use_weights=False, **wire)
        prepacked = list(loader)
        wrappers = [factory.get_model("graph_net", graph_config("", use_gat, **model)) for _ in range(3)]
        reset_launch_counts()
        rows = train_ms_per_batch(wrappers, [prepacked, loader, NumpyPacking(loader)])
        counts = {k: v for k, v in launch_counts().items() if v}
        if not all(counts.get(k) for k in kernels):
            raise AssertionError(f"inline packing, {name}: {kernels} did not all run ({counts})")
        print(f"time train step per batch B={FLAGSHIP_GRAPHS} in-row {name} float32 adam, median (q1-q3) of "
              f"{ROUTE_REPS} runs over {len(prepacked)} batches, host clock to a synchronise: "
              + ", ".join(f"{n} {r[0]:.4f} ({r[1]:.4f}-{r[2]:.4f}) ms" for n, r in
                          zip(("pre-packed", "C++ packing inline", "numpy packing inline"), rows))
              + f"; launches {counts} [{smi}]")


def host_phase(smi: str, work_dir: str) -> None:
    """Phase 22: the host packers and the edge builder."""
    packer_phase(smi)
    edge_builder_phase(smi)
    inline_packing_phase(smi, work_dir)


# phase 24: fused step windows (fuse_steps) as CUDA graphs, fused_phi="tail",
# the remat measurements, PCC_TRACE
FUSE_K = 16  # bench.py's flagship --fuse 16
FUSE_PASSES = 3  # a window's warm-up, its capture and first replay, a replay
FUSE_LOSS_RTOL = 1e-5  # per-step f32 loss, fused window against the same steps run eagerly
FUSE_TURNS = 3  # timed rounds of a fused pass against an eager one, in turns
# the parameters after the windows against the eager steps', max |Δ| over
# max(max |p|, 1), as tests/test_torch_gpu.py holds them (ten times the
# loss bound: Adam carries the losses' rounding into every weight)
FUSE_PARAM_TOL = 1e-4
OPT_STEPS = 50  # optimizer steps a timed turn, capturable Adam against the default
# GPU cycles of the marker kernel (torch.cuda._sleep's spin_kernel) that
# splits a profile's two runs: a trace has lost its first device records
# (12 of a GAT replay's, its first step's mirror among them, late in the
# smoke), so a profile runs twice and reads the records after the marker
PROFILE_MARK_CYCLES = 1000
# each launch counter's kernels by name (csrc/): a counted launch runs one
# of them once (K4's launch also runs gat_bwd_sources_kernel, K2's may run
# reduce_slabs_kernel, K5's selection its two range kernels)
REPLAY_KERNELS = (
    (("phi_pool",), ("phi_pool_kernel", "phi_pool_sliced_kernel")),
    (("phi_pool_bwd",), ("phi_pool_bwd_kernel", "phi_pool_bwd_sliced_kernel")),
    (("gat_attention",), ("gat_attention_pieces_kernel", "gat_attention_channels_kernel")),
    (("gat_attention_bwd",), ("gat_bwd_rows_kernel",)),
    (("gat_out_rows",), ("gat_out_rows_kernel",)),
    (("inrow_aggregate", "inrow_aggregate backward"), ("inrow_aggregate_kernel",)),
    (("knn_select",), ("knn_select_kernel",)),
    (("knn_aggregate", "knn_aggregate backward"), ("knn_gather_kernel",)),
)
# remat: the plain route's φ widths at B=256, and the train steps timed a turn
REMAT_WIDTHS = (256, 512, 1024)
REMAT_STEPS = 8


def _spread(samples) -> str:
    return f"{min(samples):.4f}–{max(samples):.4f}"


def _one_shape(batches, k: int = FUSE_K):
    """``k`` batches of the most frequent shape, cycled from the distinct
    ones as bench.py cycles its four; and how many were distinct."""
    groups = {}
    for b in batches:
        groups.setdefault(tuple(sorted((n, v.shape) for n, v in b.items())), []).append(b)
    best = max(groups.values(), key=len)
    return [best[i % len(best)] for i in range(k)], len(best)


def _own_kernels(events) -> dict:
    """{kernel: executions} of the package's own kernels among a profile's
    device records (csrc/ keeps them in anonymous namespaces)."""
    marker = "void (anonymous namespace)::"
    out = {}
    for e in events:
        if e.name.startswith(marker):
            name = e.name[len(marker):].split("(")[0].split("<")[0]
            out[name] = out.get(name, 0) + 1
    return out


def _window_profile(run) -> tuple:
    """(device busy ms, wall ms, the package's kernels by name) of the
    second of two ``run()`` under torch.profiler: the first takes any
    records the trace loses at its start, and a marker kernel between them
    says where the second begins (busy None where the profiler saw no
    device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
        torch.cuda._sleep(PROFILE_MARK_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(device) if "spin_kernel" in e.name]
    if len(marks) != 1:
        raise AssertionError(f"a profile holds {len(marks)} marker kernels, not 1")
    second = device[marks[0] + 1:]
    busy = sum(e.time_range.elapsed_us() for e in second) / 1e3
    return (busy if busy > 0 else None), wall, _own_kernels(second)


def _counted(run) -> tuple:
    """``(run(), the kernels' launches in it alone)``: the counts are set to
    0 just before and read just after."""
    reset_launch_counts()
    out = run()
    return out, launch_counts()


def fused_route_phase(smi: str, label: str, make_model, host_batches, optimizer: str, kernels) -> dict:
    """A window of FUSE_K same-shape resident batches through a fused
    wrapper (one CUDA graph) against the same steps run eagerly from the
    same weights by the unfused trainer, FUSE_PASSES times (warm-up,
    capture and first replay, replay), then a fused ``predict`` against an
    unfused one as many times.  Fails unless every pass's losses and
    probabilities agree, the parameters after agree, each fused pass
    launches what its eager steps launch (the kernels named in ``kernels``
    and no other), the wrapper holds one train and one eval graph captured
    once each and replayed, and a profiled replay runs each kernel, by name,
    as often as a replay counts its launches.  Times ms per micro-step fused,
    eager, and eager with the non-capturable Adam, by CUDA events in turns,
    and an optimizer step alone of each form; each pass's idle share by the
    profiler.  Returns the kernels' launches in the fused passes."""
    window, distinct = _one_shape(host_batches)
    dev = [{k: torch.as_tensor(v).cuda() for k, v in b.items()} for b in window]
    fused = ModelWrapper(make_model(0), 1e-3, 1, optimizer=optimizer, fuse_steps=FUSE_K)
    # the same steps eagerly with the optimizer the window captures
    # (capturable: the step count and bias corrections on the device), and
    # by the unfused trainer as it is (torch's default Adam): what the
    # capturable form costs and how far the two round apart
    eager = ModelWrapper(make_model(1), 1e-3, 1, optimizer=optimizer)
    eager.optimizer = _make_optimizer(optimizer, eager.model.parameters(), 1e-3, capturable=True)
    host_adam = ModelWrapper(make_model(2), 1e-3, 1, optimizer=optimizer)
    eager.model.load_state_dict(fused.model.state_dict())
    host_adam.model.load_state_dict(fused.model.state_dict())
    fused_counts = dict.fromkeys(launch_counts(), 0)

    def add(counts):
        for name, n in counts.items():
            fused_counts[name] += n

    worst = prob_err = 0.0
    for p in range(FUSE_PASSES):
        got, counts = _counted(lambda: fused.train_window(dev))  # the last pass a replay
        want, want_counts = _counted(lambda: torch.stack([eager.train_step(b) for b in dev]))
        if counts != want_counts:
            raise AssertionError(f"fuse {label}: train pass {p} launched {counts}, its eager steps {want_counts}")
        add(counts)
        worst = max(worst, ((got - want).abs() / want.abs()).max().item())
    for _ in range(FUSE_PASSES):
        other = torch.stack([host_adam.train_step(b) for b in dev])
    drift = ((other - want).abs() / want.abs()).max().item()
    param_err = max(((p - q).abs().max() / q.abs().max().clamp(min=1.0)).item()
                    for p, q in zip(fused.model.parameters(), eager.model.parameters()))
    launched = sorted(name for name, n in fused_counts.items() if n)
    train_graphs = (len(fused.windows), fused.windows.captures, fused.windows.replays)
    fused.model.load_state_dict(eager.model.state_dict())
    p_eager, eval_counts = _counted(lambda: eager.predict(dev, return_prob=True)[1])
    for p in range(FUSE_PASSES):
        p_fused, pred_counts = _counted(lambda: fused.predict(dev, return_prob=True)[1])
        if pred_counts != eval_counts:
            raise AssertionError(f"fuse {label}: predict pass {p} launched {pred_counts}, unfused {eval_counts}")
        add(pred_counts)
        prob_err = max(prob_err, float(np.abs(p_fused - p_eager).max()))
    graphs = (len(fused.windows), fused.windows.captures, fused.windows.replays)
    if not worst <= FUSE_LOSS_RTOL:
        raise AssertionError(f"fuse {label}: per-step losses {worst:.3e} relative from the eager steps")
    if not param_err <= FUSE_PARAM_TOL:
        raise AssertionError(f"fuse {label}: parameters after the windows {param_err:.3e} from the eager steps'")
    if not prob_err <= PROB_TOL:
        raise AssertionError(f"fuse {label}: fused predict {prob_err:.3e} from unfused")
    if launched != sorted(kernels):
        raise AssertionError(f"fuse {label}: the fused passes launched {launched}, not {sorted(kernels)}")
    want_graphs = ((1, 1, FUSE_PASSES - 1), (2, 2, 2 * (FUSE_PASSES - 1)))
    if (train_graphs, graphs) != want_graphs:
        raise AssertionError(f"fuse {label}: (graphs, captures, replays) {train_graphs} after training and "
                             f"{graphs} after predict, not {want_graphs}")

    def fused_pass():
        fused.train_window(dev)

    def eager_pass(wrapper=eager):
        for b in dev:
            wrapper.train_step(b)

    arms = {"fused": fused_pass, "eager": eager_pass, "host Adam": lambda: eager_pass(host_adam)}
    samples = {arm: [] for arm in arms}
    for turn in range(2 * FUSE_TURNS):
        names = list(arms)
        for arm in names[turn % 3:] + names[:turn % 3]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            arms[arm]()
            end.record()
            torch.cuda.synchronize()
            samples[arm].append(start.elapsed_time(end) / FUSE_K)
    ms = {arm: float(np.median(v)) for arm, v in samples.items()}
    # an optimizer step alone, capturable against not, over the gradients
    # the last steps left
    opt_samples = {"capturable": [], "host": []}
    for turn in range(2 * FUSE_TURNS):
        for form in ("capturable", "host") if turn % 2 == 0 else ("host", "capturable"):
            opt = (eager if form == "capturable" else host_adam).optimizer
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(OPT_STEPS):
                opt.step()
            end.record()
            torch.cuda.synchronize()
            opt_samples[form].append(start.elapsed_time(end) / OPT_STEPS)
    opt_ms = {form: float(np.median(v)) for form, v in opt_samples.items()}
    idle, own = {}, {}
    for arm, run in (("fused", fused_pass), ("eager", eager_pass)):
        busy, wall, own[arm] = _window_profile(run)
        idle[arm] = "not measured (no device time)" if busy is None else (
            f"busy {busy / FUSE_K:.4f} of {wall / FUSE_K:.4f} ms a step, idle share {1 - busy / wall:.3f}")
    # the profiled replay, read by kernel name against the launches a
    # replay counts (the last train pass was one)
    for counters, names in REPLAY_KERNELS:
        want_n = sum(counts[c] for c in counters)
        seen = sum(own["fused"].get(n, 0) for n in names)
        if seen != want_n:
            raise AssertionError(f"fuse {label}: the profiled replay ran {names} {seen} times, where a "
                                 f"replay counts {want_n} launches of {counters} ({own['fused']})")
    print(f"fuse {label}: K={FUSE_K} window of one shape ({distinct} distinct batches cycled), "
          f"{FUSE_PASSES} passes (warm-up, capture, replay): per-step loss max relative "
          f"{worst:.3e} (bound {FUSE_LOSS_RTOL:.0e}), parameters max relative {param_err:.3e} (bound "
          f"{FUSE_PARAM_TOL:.0e}); fused predict max |Δprob| {prob_err:.3e} (bound {PROB_TOL:.0e}); "
          f"(graphs, captures, replays) {train_graphs} after training, {graphs} after predict; capture "
          f"{fused.windows.capture_seconds:.3f} s; kernels in the fused passes (each equal to its eager "
          f"steps') {({k: v for k, v in fused_counts.items() if v})}; the profiled replay's kernels "
          f"{own['fused']}; torch's default Adam against the capturable one, last pass's losses "
          f"{drift:.3e}; ms a micro-step fused {ms['fused']:.4f} ({_spread(samples['fused'])}), eager "
          f"{ms['eager']:.4f} ({_spread(samples['eager'])}), ×{ms['eager'] / ms['fused']:.2f}, eager with "
          f"the default Adam {ms['host Adam']:.4f} ({_spread(samples['host Adam'])}); an optimizer step "
          f"alone, capturable {opt_ms['capturable']:.4f} ms ({_spread(opt_samples['capturable'])}), default "
          f"{opt_ms['host']:.4f} ({_spread(opt_samples['host'])}); fused pass {idle['fused']}; eager pass "
          f"{idle['eager']} [{smi}]")
    return fused_counts


def fused_routes_phase(smi: str) -> dict:
    """(a) the fused routes: the flagship wire, then the configs' DeepSets,
    in-row GAT, fused GraphConv and kNN routes."""
    rng = np.random.default_rng(SEED + 24)
    # bench.py's flagship: B=256 clouds of 256 points on the dense fp16 wire
    # with energy_total factored (the length-sorted steady state, M = 256)
    clouds = [rng.normal(size=(256, 6)).astype(np.float32) for _ in range(4 * FLAGSHIP_B)]
    for c in clouds:
        c[:, 1] = rng.normal()
    flagship = PointCloudLoader(clouds, rng.integers(0, 2, size=len(clouds)), FLAGSHIP_B, False,
                                layout="dense", transfer_dtype="float16", factor_event_cols=[1])
    ds = copy.deepcopy(CONFIG["model"])

    def deep_sets(**extra):
        return lambda seed: DeepSets(**{**ds, **extra}, generator=torch.Generator().manual_seed(seed))

    clouds32, labels32 = make_clouds(np.random.default_rng(SEED + 25), 24 * CONFIG_B)
    graphs = lineage_graphs(np.random.default_rng(SEED + 26), 24 * GRAPH_B, 160, 288)

    def graph_net(**extra):
        model = {**GRAPH_CONFIG["model"], **extra}
        return lambda seed: GraphNet(**model, generator=torch.Generator().manual_seed(seed))

    phi = ("phi_pool", "phi_pool_bwd")
    routes = [
        ("flagship B=256 dense fp16 f32", deep_sets(factored_cols=[1]), list(flagship), "adamw", phi),
        ("DeepSets B=32", deep_sets(), list(PointCloudLoader(clouds32, labels32, CONFIG_B, False)), "adamw",
         phi),
        ("in-row GAT B=32", graph_net(use_gat=True),
         list(GraphLoader(graphs, GRAPH_B, shuffle=False, layout="dense", use_weights=False)), "adam",
         ("gat_attention", "gat_attention_bwd", "gat_out_rows")),
        ("GraphConv add fused_inrow B=32", graph_net(fused_inrow=True),
         list(GraphLoader(graphs, GRAPH_B, shuffle=False, layout="dense", use_weights=True,
                          emit_out_rows=True)), "adam", ("inrow_aggregate", "inrow_aggregate backward")),
        ("kNN GraphConv add B=32", graph_net(knn_k=KNN_K),
         list(GraphLoader(graphs, GRAPH_B, shuffle=False, layout="flat", use_weights=False)), "adam",
         ("knn_select", "knn_aggregate", "knn_aggregate backward")),
    ]
    total = {}
    for label, make, batches, optimizer, kernels in routes:
        for name, n in fused_route_phase(smi, label, make, batches, optimizer, kernels).items():
            total[name] = total.get(name, 0) + n
    return total


def tail_phase(smi: str, work_dir: str) -> dict:
    """(b) fused_phi="tail": K1 and K2 over the one bare linear layer
    against their plain versions at the flagship shape, then train_model
    for 3 epochs over phase 6's cache, with launches counted and the val
    accuracy over its floor.  Returns the run's launches."""
    rng = np.random.default_rng(SEED + 27)
    h = torch.from_numpy(rng.normal(size=(FLAGSHIP_P, 256)).astype(np.float32)).cuda()
    seg = torch.from_numpy(np.sort(rng.integers(0, FLAGSHIP_B + 1, size=FLAGSHIP_P)).astype(np.int32)).cuda()
    bound = 256 ** -0.5
    w = torch.from_numpy(_uniform(rng, bound, (256, 256))).cuda()
    b = torch.from_numpy(_uniform(rng, bound, (256,))).cuda()
    g = torch.from_numpy(rng.normal(size=(FLAGSHIP_B + 1, 256)).astype(np.float32)).cuda()
    params = ((w, b),)
    out = phi_pool(h, seg, (), params, "gelu", FLAGSHIP_B + 1)
    ref = phi_pool_plain(h, seg, (), params, "gelu", FLAGSHIP_B + 1)
    fwd_err = _max_rel(out, ref)
    d_h, grads = _phi_pool_bwd_cuda(h, seg, g, (), params, "gelu", FLAGSHIP_B + 1)
    d_ref, grads_ref = phi_pool_bwd_plain(h, seg, g, (), params, "gelu", FLAGSHIP_B + 1)
    bwd_err = max(_max_rel(a, r) for a, r in zip([d_h, *grads], [d_ref, *grads_ref]))
    k1_ms = cuda_ms(lambda: phi_pool(h, seg, (), params, "gelu", FLAGSHIP_B + 1))
    k2_ms = cuda_ms(lambda: _phi_pool_bwd_cuda(h, seg, g, (), params, "gelu", FLAGSHIP_B + 1))
    # the least time: h read once and the sums written once, or the
    # products (forward 2·P·H·H; backward dz Wᵀ and hᵀ dz, 4·P·H·H)
    k1_bound, _ = bound_ms(_nbytes(h, seg, w, b, out), 2 * FLAGSHIP_P * 256 * 256)
    k2_bound, _ = bound_ms(_nbytes(h, seg, g, w, b, d_h, *grads), 4 * FLAGSHIP_P * 256 * 256)
    print(f"tail: K1 over one bare linear [256, 256] at P={FLAGSHIP_P}, B={FLAGSHIP_B}, f32: max "
          f"relative {fwd_err:.3e} (bound {TOL[torch.float32]:.0e}), {k1_ms:.4f} ms (least {k1_bound:.4f}); "
          f"K2 with d_points {bwd_err:.3e} (bound {BWD_F32_REL:.0e}), {k2_ms:.4f} ms (least "
          f"{k2_bound:.4f}); variants {phi_pool.variant}, {phi_pool.bwd_variant} [{smi}]")
    if not (fwd_err <= TOL[torch.float32] and bwd_err <= BWD_F32_REL):
        raise AssertionError("tail: K1 or K2 over the one-layer chain disagrees with its plain version")

    cfg = training_config(os.path.join(work_dir, "data"), os.path.join(work_dir, "tail_log"))
    cfg["model"]["fused_phi"] = "tail"
    reset_launch_counts()
    t0 = time.perf_counter()
    log_dir = port_train.train_model("deep_sets", "s2ppc", cfg, return_log_dir=True)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    metrics = read_metrics(log_dir)
    with open(os.path.join(log_dir, "meta.json")) as f:
        meta = json.load(f)["metrics"]
    data = factory.get_dataloader("s2ppc", cfg)
    n_train = len(data.get_train_loader())
    steps = len(metrics["Loss/train"]) * n_train
    print(f"tail: train_model deep_sets fused_phi=tail, 3 epochs, {seconds:.1f} s; K1 "
          f"{counts['phi_pool']}, K2 {counts['phi_pool_bwd']} (train steps {steps}); Loss/train "
          f"{metrics['Loss/train']}, meta {meta} (val floor {VAL_ACC_FLOOR}) [{smi}]")
    if counts["phi_pool_bwd"] != steps or counts["phi_pool"] < steps:
        raise AssertionError("tail: K1 and K2 did not launch on every train step")
    if not meta["accuracy/val"] >= VAL_ACC_FLOOR:
        raise AssertionError(f"tail: accuracy/val {meta['accuracy/val']} below {VAL_ACC_FLOOR}")
    return {"phi_pool": {"tail_launches": counts["phi_pool"], "tail_ms": k1_ms, "tail_bound_ms": k1_bound,
                         "tail_max_rel_err": fwd_err},
            "phi_pool_bwd": {"tail_launches": counts["phi_pool_bwd"], "tail_ms": k2_ms,
                             "tail_bound_ms": k2_bound, "tail_max_rel_err": bwd_err}}


def remat_phase(smi: str) -> None:
    """(c) PCC_PHI_REMAT=0 against 1 on the plain route (layer norm) at φ
    widths REMAT_WIDTHS, B=256: ms a train step by CUDA events, in turns,
    and peak device memory."""
    clouds, labels = make_clouds(np.random.default_rng(SEED + 28), 2 * FLAGSHIP_B)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()}
               for b in PointCloudLoader(clouds, labels, FLAGSHIP_B, shuffle=False)]
    saved = os.environ.get("PCC_PHI_REMAT")
    try:
        for width in REMAT_WIDTHS:
            model = {**CONFIG["model"], "phi_layers": [width, width], "layer_norm": True}
            wrapper = ModelWrapper(DeepSets(**model, generator=torch.Generator().manual_seed(0)), 1e-3, 1,
                                   optimizer="adamw")
            samples, peak = {"0": [], "1": []}, {}
            for turn in range(4):
                for mode in ("0", "1") if turn % 2 == 0 else ("1", "0"):
                    os.environ["PCC_PHI_REMAT"] = mode
                    wrapper.train_step(batches[0])  # warm
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    for i in range(REMAT_STEPS):
                        wrapper.train_step(batches[i % len(batches)])
                    end.record()
                    torch.cuda.synchronize()
                    samples[mode].append(start.elapsed_time(end) / REMAT_STEPS)
                    peak[mode] = (torch.cuda.max_memory_allocated() - base) / 2**20
            ms = {m: float(np.median(v)) for m, v in samples.items()}
            print(f"remat φ [{width}, {width}] layer_norm B={FLAGSHIP_B} adamw: ms a train step "
                  f"PCC_PHI_REMAT=0 {ms['0']:.4f} ({_spread(samples['0'])}), =1 {ms['1']:.4f} "
                  f"({_spread(samples['1'])}), ×{ms['0'] / ms['1']:.3f}; peak above the weights "
                  f"{peak['0']:.1f} / {peak['1']:.1f} MiB [{smi}]")
    finally:
        if saved is None:
            os.environ.pop("PCC_PHI_REMAT", None)
        else:
            os.environ["PCC_PHI_REMAT"] = saved


def trace_phase(smi: str, work_dir: str) -> None:
    """(d) train_model with PCC_TRACE=1 for one epoch: a Chrome trace under
    {log_dir}/trace/ per epoch that names K1 and K2."""
    cfg = training_config(os.path.join(work_dir, "data"), os.path.join(work_dir, "trace_log"), epochs=1)
    os.environ["PCC_TRACE"] = "1"
    try:
        log_dir = port_train.train_model("deep_sets", "s2ppc", cfg, return_log_dir=True)
    finally:
        os.environ.pop("PCC_TRACE")
    traces = sorted(os.listdir(os.path.join(log_dir, "trace")))
    with open(os.path.join(log_dir, "trace", traces[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernels = {m.group(1) for n in names for m in [re.search(r"\b(phi_pool\w*_kernel)\b", n)] if m}
    k1 = sorted(k for k in kernels if "bwd" not in k)
    k2 = sorted(k for k in kernels if "bwd" in k)
    print(f"trace: PCC_TRACE=1 train_model, 1 epoch: {len(traces)} trace file(s) under "
          f"{os.path.basename(log_dir)}/trace/, {len(names)} event names; K1 {k1}, K2 {k2} [{smi}]")
    if not (k1 and k2):
        raise AssertionError("trace: the trace does not name K1 and K2")


def fuse_phase(smi: str, work_dir: str) -> tuple:
    """Phase 24.  Returns (the fused routes' launches, the tail's launches,
    times and errors for K1 and K2)."""
    fused = fused_routes_phase(smi)
    tail = tail_phase(smi, work_dir)
    remat_phase(smi)
    trace_phase(smi, work_dir)
    return fused, tail


# phase 25: int8 evaluation and the serving export
INT8_B = 256
INT8_WIDTHS = (256, 512, 1024, 2048)  # bench.py --eval-device --phi-width
S8_OPS_PER_S = 1979e12  # dense int8 in the tensor cores (NVIDIA's data sheet, SXM part)
# the int8 chain on the card against the same chain on the CPU, logits max
# |Δ| / max(1, max |CPU|).  The codes and the s32 sums are exact on both, so
# what is left is the activations' rounding: an activation an ulp apart can
# move a later layer's code by one at a rounding tie (f32); in bf16 a value
# at a rounding boundary lands on its neighbour (2^-8 relative)
INT8_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# int8 against float probabilities: JAX tests/test_quant.py's band; the
# decisions agree for every event whose float probability lies at least
# DECISION_MARGIN from 0.5
INT8_FLOAT_BAND, DECISION_MARGIN = 0.05, 0.01
# the fused int8 eval window against the eager int8 predict (the flat wire
# pools by index_add's atomics, in another order each run)
INT8_WINDOW_TOL = 1e-6
# ExportedModel against wrapper.predict of the same route on the same device
EXPORT_TOL = 1e-5
INT8_TIME_ITERS = 5
INT8_MM_ROWS = (17, 24, 33, 1001, 1008, 65536)


def _deep_sets_wrappers(run_dir: str, cfg: dict, dtype: str, device=None, **trainer) -> dict:
    """{quant: wrapper} of the run's best_model.pt at ``dtype``, int8 and
    float."""
    out = {}
    for quant in ("int8", "none"):
        c = copy.deepcopy(cfg)
        c["model"]["compute_dtype"] = dtype
        c["trainer"].update(trainer)
        factory.apply_quant(c, "deep_sets", quant)
        out[quant] = factory.get_model("deep_sets", c, run_dir, device=device)
    return out


def int8_card_phase(smi: str, run_dir: str, cfg: dict) -> None:
    """(a) the int8 chain of the command line's trained DeepSets (phase 20)
    at B=256, flat and dense fp16 wires, f32 and bf16: against the same
    chain on the CPU (first layer's codes equal, logits within
    INT8_LOGIT_TOL), against the float predict, with K1 counted; then a
    fused eval window of FUSE_K batches against the eager int8 predict."""
    clouds, labels = make_clouds(np.random.default_rng(SEED + 250), 4 * INT8_B)
    for layout in ("flat", "dense"):
        batches = list(PointCloudLoader(clouds, labels, INT8_B, False, layout=layout, transfer_dtype="float16"))
        for dtype in ("float32", "bfloat16"):
            card = _deep_sets_wrappers(run_dir, cfg, dtype)
            host = _deep_sets_wrappers(run_dir, cfg, dtype, device="cpu")["int8"]
            codes_apart, logit_err = 0, 0.0
            with torch.inference_mode():
                for b in batches:
                    x = torch.from_numpy(b["points"]).to(getattr(torch, dtype)).reshape(-1, b["points"].shape[-1])
                    (q_card, s_card), (q_host, s_host) = quantize_rows(x.cuda()), quantize_rows(x)
                    codes_apart += int((q_card.cpu() != q_host).sum()) + int((s_card.cpu() != s_host).sum())
                    got = card["int8"].model(put_batch(b, card["int8"].model, card["int8"].device)).cpu()
                    want = host.model(put_batch(b, host.model, host.device))
                    logit_err = max(logit_err, _max_rel(got, want))
            counts = {}
            probs = {}
            for quant in ("int8", "none"):
                reset_launch_counts()
                probs[quant] = card[quant].predict(batches, return_prob=True)[1]
                counts[quant] = phi_pool.launches
            apart = float(np.abs(probs["int8"] - probs["none"]).max())
            flips = (probs["int8"] >= 0.5) != (probs["none"] >= 0.5)
            clear = np.abs(probs["none"] - 0.5) >= DECISION_MARGIN
            print(f"int8 {layout} fp16 wire {dtype} B={INT8_B}, {len(batches)} batches: first layer's codes "
                  f"and scales apart from the CPU's {codes_apart}; logits max relative {logit_err:.3e} (bound "
                  f"{INT8_LOGIT_TOL[dtype]:.0e}); max |p_int8 − p_float| {apart:.3e} (band "
                  f"{INT8_FLOAT_BAND}); decisions apart {int(flips.sum())} of {flips.size}, "
                  f"{int((flips & clear).sum())} of them {DECISION_MARGIN} or more from 0.5; K1 launches "
                  f"int8 {counts['int8']}, float {counts['none']} [{smi}]")
            if codes_apart or not logit_err <= INT8_LOGIT_TOL[dtype]:
                raise AssertionError(f"int8 {layout} {dtype}: the card's int8 chain is not the CPU's")
            if not apart <= INT8_FLOAT_BAND or (flips & clear).any():
                raise AssertionError(f"int8 {layout} {dtype}: int8 strays from the float predict")
            if counts["int8"] != 0 or counts["none"] != len(batches):
                raise AssertionError(f"int8 {layout} {dtype}: K1 launches {counts}, expected 0 and {len(batches)}")

    # the fused eval window: clouds of 256 points, one shape a wire
    rng = np.random.default_rng(SEED + 251)
    clouds = [rng.normal(size=(256, 6)).astype(np.float32) for _ in range(4 * INT8_B)]
    for layout in ("flat", "dense"):
        loader = PointCloudLoader(clouds, rng.integers(0, 2, size=len(clouds)), INT8_B, False, layout=layout,
                                  transfer_dtype="float16")
        window, distinct = _one_shape(list(loader), FUSE_K)
        eager = _deep_sets_wrappers(run_dir, cfg, "float32")["int8"]
        fused = _deep_sets_wrappers(run_dir, cfg, "float32", fuse_steps=FUSE_K)["int8"]
        want = eager.predict(window * FUSE_PASSES, return_prob=True)[1]
        reset_launch_counts()
        got = fused.predict(window * FUSE_PASSES, return_prob=True)[1]
        k1 = phi_pool.launches
        err = float(np.abs(got - want).max())
        graphs = (len(fused.windows), fused.windows.captures, fused.windows.replays)
        print(f"int8 fused eval window {layout} B={INT8_B} K={FUSE_K} ({distinct} distinct batches cycled), "
              f"{FUSE_PASSES} passes: (graphs, captures, replays) {graphs}, capture "
              f"{fused.windows.capture_seconds:.2f} s; max |Δprob| against the eager int8 predict {err:.3e} "
              f"(bound {INT8_WINDOW_TOL:.0e}); K1 launches {k1} [{smi}]")
        if graphs != (1, 1, FUSE_PASSES - 1) or not err <= INT8_WINDOW_TOL or k1:
            raise AssertionError(f"int8 fused eval window {layout}: not captured, or not the eager predict")


def int8_evaluate_phase(smi: str, run_dir: str) -> None:
    """(b) ``evaluate --quant int8`` through ``cli.main`` on the command
    line's trained DeepSets: ``eval_int8/metrics.json`` with ``"quant":
    "int8"``, no K1 launch, its accuracies beside a float ``evaluate`` of
    the same weights (phase 20's ``resume`` moved them since its own)."""
    seconds = {}
    _cli(seconds, "evaluate deep_sets", "evaluate", run_dir)
    counts = _cli(seconds, "evaluate deep_sets --quant int8", "evaluate", run_dir, "--quant", "int8")
    _expect_launches("evaluate deep_sets --quant int8", counts)
    with open(os.path.join(run_dir, "eval_int8", "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(run_dir, "eval", "metrics.json")) as f:
        floats = json.load(f)
    print(f"cli evaluate deep_sets --quant int8: {metrics} (float: {floats}), "
          f"{seconds['evaluate deep_sets --quant int8']:.2f} s [{smi}]")
    if metrics.get("quant") != "int8" or list(metrics)[:3] != list(floats):
        raise AssertionError("cli evaluate --quant int8: eval_int8/metrics.json lacks its accuracies or its quant")


def int8_times_phase(smi: str) -> None:
    """(c) ms a resident B=256 batch of the eval step (forward and sigmoid,
    CUDA events, in turns) on the float K1 route, the float plain route and
    the int8 chain at φ widths INT8_WIDTHS (bench.py --eval-device
    --phi-width: φ [w, w], the rest of configs/deep_sets.yaml, f32, clouds
    of 256 points on the flat wire, P=65,536); and each int8 layer's
    quantize pass and ``torch._int_mm`` alone against their bounds."""
    rng = np.random.default_rng(SEED + 252)
    clouds = [rng.normal(size=(256, 6)).astype(np.float32) for _ in range(4 * INT8_B)]
    batches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()}
               for b in PointCloudLoader(clouds, rng.integers(0, 2, size=len(clouds)), INT8_B, False)]
    crossover = {}
    for width in INT8_WIDTHS:
        model = {**CONFIG["model"], "phi_layers": [width, width]}
        base = DeepSets(**model, generator=torch.Generator().manual_seed(SEED)).cuda().eval()
        routes = {"int8": DeepSets(**model, quant="int8"), "plain": DeepSets(**model, fused_phi="off")}
        if base._use_kernel():
            routes["K1"] = DeepSets(**model)
        for net in routes.values():
            net.load_state_dict(base.state_dict())
            net.cuda().eval()

        def step(net):
            with torch.inference_mode():
                for b in batches:
                    torch.sigmoid(net(b))

        samples = {name: [] for name in routes}
        for turn in range(2):
            for name in routes if turn == 0 else reversed(list(routes)):
                samples[name].append(cuda_ms(lambda: step(routes[name]), iters=INT8_TIME_ITERS, warmup=2)
                                     / len(batches))
        ms = {name: float(np.median(s)) for name, s in samples.items()}
        best_float = min(v for k, v in ms.items() if k != "int8")
        crossover[width] = ms["int8"] < best_float
        shown = ", ".join(f"{name} {ms[name]:.4f} ({_spread(samples[name])})" for name in ("K1", "plain", "int8")
                          if name in ms)
        print(f"int8 time φ [{width}, {width}] B={INT8_B} P={batches[0]['points'].shape[0]} f32: eval step ms "
              f"a batch {shown}{'' if 'K1' in ms else ', K1 n/a (the chain exceeds its tiles: plain route)'}; "
              f"int8 / best float ×{ms['int8'] / best_float:.3f} [{smi}]")
        # each int8 layer alone: its activation quantize pass and its s8 product
        spec, params = routes["int8"]._phi_spec_params()
        act = resolve_activation(model["activation"])
        h = batches[0]["points"].float()
        with torch.inference_mode():
            for i, ((kind, _), (w, b, *_)) in enumerate(zip(spec, params)):
                xq, sx = quantize_rows(h)
                wq, sw = quantize_cols(w)
                p, k = xq.shape
                xp, wp = int_mm_operands(xq, wq)
                q_ms = cuda_ms(lambda: quantize_rows(h))
                mm_ms = cuda_ms(lambda: torch._int_mm(xp, wp))
                acc = torch._int_mm(xp, wp)
                # the weight codes row-major, where cuBLASLt takes them
                rows = wp.contiguous()
                try:
                    row_ms = f"{cuda_ms(lambda: torch._int_mm(xp, rows)):.4f} ms"
                except RuntimeError as e:
                    row_ms = f"refused ({str(e).split(' when ')[0]})"
                q_bound, q_by = bound_ms(_nbytes(h, xq, sx), 0)
                mm_bound, mm_by = bound_ms(_nbytes(xp, wp, acc), 2 * p * xp.shape[1] * wp.shape[1], S8_OPS_PER_S)
                print(f"int8 time φ [{width}, {width}] layer {i + 1} ({kind}, [{p}, {k}] × [{k}, {w.shape[1]}]): "
                      f"quantize pass {q_ms:.4f} ms (bound {q_bound:.4f}, {q_by}); _int_mm {mm_ms:.4f} ms "
                      f"(bound {mm_bound:.4f}, {mm_by}; the weight codes row-major: {row_ms}) [{smi}]")
                out = act(acc[:p, : w.shape[1]].float() * sx * sw + b.float())
                h = h + out if kind == "residual" else out
        del routes, base
        torch.cuda.empty_cache()
    print(f"int8 crossover on the card (int8 faster than the best float route) {crossover} [{smi}]")
    # the operand order over shapes the chain meets: rows past 16, K and N
    # padded to multiples of 8
    refused, shapes = [], list(itertools.product(INT8_MM_ROWS, (8, 16, 256), (8, 256)))
    for m, k, n in shapes:
        gen = torch.Generator().manual_seed(m + k + n)
        xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen).cuda()
        wq = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen).cuda()
        # f64 products and sums of int8 codes are exact
        if not torch.equal(int8_matmul(xq, wq).double(), xq.double() @ wq.double()):
            raise AssertionError(f"int8: int8_matmul at {(m, k, n)} is not the exact product")
        try:
            torch._int_mm(xq, wq.contiguous())
        except RuntimeError:
            refused.append((m, k, n))
    print(f"int8 _int_mm over {len(shapes)} shapes (rows {INT8_MM_ROWS}, K 8, 16, 256, N 8, 256): the "
          f"column-major weight codes exact at every one; row-major refused at {len(refused)}: {refused} "
          f"[{smi}]")


def _aten_only(served) -> None:
    """Raise unless every call in the loaded programs is an ATen operation."""
    for key, program in served._loaded.items():
        for node in program.module.graph.nodes:
            target = node.target
            if node.op == "call_function" and not (target is operator.getitem or (
                    isinstance(target, torch._ops.OpOverload) and target.namespace == "aten")):
                raise AssertionError(f"export: the program for {key} calls {target}")


def export_phase(smi: str, run_dir: str) -> None:
    """(d) ``export`` through ``cli.main`` of the command line's DeepSets run
    (float and int8) and of phase 13's in-row GAT run, for the card and the
    CPU; ``ExportedModel`` on each against ``predict`` of the same route on
    that device; no kernel launch while a program runs; a shape not exported
    raises KeyError; an exported predict a batch beside ``predict``'s."""
    seconds = {}
    runs = (("deep_sets", os.path.join(run_dir, "cli_log", "deep_sets", "version_0"), "none"),
            ("deep_sets int8", os.path.join(run_dir, "cli_log", "deep_sets", "version_0"), "int8"),
            ("in-row GAT", os.path.join(run_dir, "graph_log", "version_0"), "none"))
    for label, run, quant in runs:
        out = os.path.join(run_dir, "exported_" + label.replace(" ", "_"))
        counts = _cli(seconds, f"export {label}", "export", run, "--out-dir", out, "--quant", quant,
                      "--platforms", "cuda", "cpu")
        _expect_launches(f"export {label}", counts)
        config = load_config(os.path.join(run, "config.yaml"))
        model_name = config["meta"]["model_name"]
        factory.apply_quant(config, model_name, quant)
        batches = list(factory.get_dataloader(config["meta"]["dataset_name"], config).get_test_loader())
        with open(os.path.join(out, "manifest.json")) as f:
            manifest = json.load(f)
        shapes = {serving._shape_key(b) for b in batches}
        if set(manifest["artifacts"]) != shapes or manifest["quant"] != quant:
            raise AssertionError(f"export {label}: the manifest does not hold the test loader's shapes")
        errs, served = {}, {}
        for device in ("cuda", "cpu"):
            wrapper = factory.get_model(model_name, config, run, device=device)
            with force_plain():
                _, want = wrapper.predict(batches, return_prob=True)
            served[device] = serving.ExportedModel(out, device=device)
            reset_launch_counts()
            _, got = served[device].predict(batches, return_prob=True)
            counts = launch_counts()
            _aten_only(served[device])
            errs[device] = float(np.abs(got - want).max())
            if any(counts.values()):
                raise AssertionError(f"export {label}: an exported program launched {counts}")
        bad = {k: np.asarray(v)[:1] if np.ndim(v) else v for k, v in batches[0].items()}
        try:
            served["cuda"](bad)
            raise AssertionError(f"export {label}: a shape not exported did not raise KeyError")
        except KeyError:
            pass
        wrapper = factory.get_model(model_name, config, run)
        (w_ms, w_q1, w_q3), (e_ms, e_q1, e_q3) = predict_ms_per_batch([wrapper, served["cuda"]], batches)
        print(f"export {label}: {len(manifest['artifacts'])} programs for {len(batches)} test batches, "
              f"{seconds[f'export {label}']:.2f} s; ExportedModel against predict of the same route, max "
              f"|Δprob| card {errs['cuda']:.3e}, CPU {errs['cpu']:.3e} (bound {EXPORT_TOL:.0e}); no kernel "
              f"launch; KeyError on a shape not exported; ms a batch (host clock, median and quartiles): "
              f"predict {w_ms:.4f} ({w_q1:.4f}–{w_q3:.4f}), exported {e_ms:.4f} ({e_q1:.4f}–{e_q3:.4f}) [{smi}]")
        if not max(errs.values()) <= EXPORT_TOL:
            raise AssertionError(f"export {label}: the exported program strays from predict")


def int8_export_phase(smi: str, run_dir: str) -> None:
    """Phase 25: int8 evaluation and the serving export."""
    cli_run = os.path.join(run_dir, "cli_log", "deep_sets", "version_0")
    cfg = load_config(os.path.join(cli_run, "config.yaml"))
    int8_card_phase(smi, cli_run, cfg)
    int8_evaluate_phase(smi, cli_run)
    int8_times_phase(smi)
    export_phase(smi, run_dir)


# phase 26: raw showers.  The JAX generator's showers (proton and piM, 2
# files of 2,000 events each, ~80k steps), written by the port's HDF5
# writer; the val accuracy floors (chance 0.5) are set from the same files,
# configs and seeds on the CPU (x86, plain versions), which read
# RAW_CPU_VAL_ACC: DeepSets after its 3 epochs, GAT after its 2
RAW_EVENTS, RAW_FILES = 2000, 2
RAW_CPU_VAL_ACC = {"deep_sets": 0.96875, "GAT": 0.836875}
RAW_VAL_ACC_FLOOR = {"deep_sets": 0.90, "GAT": 0.78}
# infer-raw against infer --split test on the same events: both CSVs' 6
# decimals, the batches' other neighbours (K1's sums are per event), and for
# S2PG the features standardized in float64 at inference where dataset
# creation rounds them to float32 first
RAW_PROB_TOL = 1e-5
# a served request's probabilities against infer-raw's CSV (6 decimals)
SERVE_PROB_TOL = 1e-6
SERVE_SIZES = (32, 256, 2000)  # events a request, for ms per request
SERVE_REPS = 3


def raw_write_phase(smi: str, raw: str) -> int:
    """(a) The raw files written by ``write_shower_file`` (the seeds of
    ``write_synthetic_dataset``) and read back by ``read_h5``, every array
    equal to what was written; the reader's MB/s.  Returns the step count."""
    written, t0 = {}, time.perf_counter()
    for p_i, particle in enumerate(("proton", "piM")):
        for n in range(RAW_FILES):
            name = f"{particle}_file{n}.h5"
            written[name] = write_shower_file(os.path.join(raw, name), particle, RAW_EVENTS, seed=SEED + 1000 * p_i + n)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(raw, name)) for name in written)
    reads, from_bytes = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        got = {name: read_h5(os.path.join(raw, name)) for name in written}
        reads.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for name in written:
            with open(os.path.join(raw, name), "rb") as f:
                read_h5(f.read())
        from_bytes.append(time.perf_counter() - t0)
    for name, arrays in written.items():
        if sorted(got[name]) != sorted(arrays) or not all(
                got[name][k].dtype == v.dtype and np.array_equal(got[name][k], v) for k, v in arrays.items()):
            raise AssertionError(f"raw showers: {name} does not read back as written")
    steps = sum(len(a["steps/energy"]) for a in written.values())
    print(f"raw write: {len(written)} files, {RAW_EVENTS} events each, {steps} steps, {nbytes} bytes, written in "
          f"{write_s:.2f} s; read back equal; reader {nbytes / 1e6 / min(reads):.1f} MB/s from the paths "
          f"(mapped; best of 3, {1e3 * min(reads):.1f} ms for the four files, page cache warm), "
          f"{nbytes / 1e6 / min(from_bytes):.1f} MB/s from each file's bytes (one read, then parsed) [{smi}]")
    return steps


def raw_train_phase(seconds: dict, work_dir: str, raw: str) -> tuple:
    """(b) ``train deep_sets --create-dataset`` at the configs' widths for 3
    epochs: K1 once a forward and K2 once a train step, the val accuracy over
    its floor.  Returns (the run, its launch counts)."""
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    log = os.path.join(work_dir, "raw_log", "deep_sets")
    counts = _cli(seconds, "train deep_sets --create-dataset", "train", "deep_sets", "--config-dir", configs,
                  "--data-dir", raw, "--log-dir", log, "--create-dataset", "--epochs", "3")
    run = os.path.join(log, "version_0")
    cfg = load_config(os.path.join(run, "config.yaml"))
    with open(os.path.join(run, "meta.json")) as f:
        meta = json.load(f)["metrics"]
    module = factory.get_dataloader("s2ppc", cfg)
    n_train, n_val = len(module.get_train_loader()), len(module.get_val_loader())
    _expect_launches("train deep_sets --create-dataset", counts, phi_pool=3 * (n_train + n_val) + n_train + n_val,
                     phi_pool_bwd=3 * n_train)
    print(f"raw train deep_sets: {n_train} train batches an epoch; meta.json {meta} (floor "
          f"{RAW_VAL_ACC_FLOOR['deep_sets']}; the CPU read {RAW_CPU_VAL_ACC['deep_sets']})")
    if cfg["dataset"]["create_dataset"] is not False:
        raise AssertionError("raw train: config.yaml does not say create_dataset: false")
    if not meta["accuracy/val"] >= RAW_VAL_ACC_FLOOR["deep_sets"]:
        raise AssertionError(f"raw train deep_sets: accuracy/val {meta['accuracy/val']} below the floor")
    return run, counts


def _npz_tree(root: str) -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*.npz"), recursive=True)):
        with np.load(path) as z:
            out[os.path.relpath(path, root)] = {k: z[k] for k in z.files}
    return out


def raw_create_phase(smi: str, seconds: dict, work_dir: str, raw: str) -> str:
    """(c) ``create-datasets`` of S2PT, S2PPC and S2PG with ``--workers 1``
    and ``--workers 4`` (forked from this process, whose CUDA is up: a worker
    that touched CUDA would fail): equal arrays, and equal bytes for every
    ``save_npz`` file (S2PT, S2PG).  Returns the workers-1 data directory."""
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    dirs = {}
    for workers in (1, 4):
        dirs[workers] = os.path.join(work_dir, f"raw_w{workers}")
        os.makedirs(dirs[workers])
        for name in glob.glob(os.path.join(raw, "*.h5")):
            shutil.copy(name, dirs[workers])
        for ds in ("s2pt", "s2ppc", "s2pg"):
            with contextlib.redirect_stdout(io.StringIO()):
                _cli(seconds, f"create-datasets {ds} --workers {workers}", "create-datasets", "--data-dir",
                     dirs[workers], "--config-dir", configs, "--datasets", ds, "--workers", str(workers))
    events = 2 * RAW_FILES * RAW_EVENTS
    for name in ("S2PT", "S2PPC", "S2PG"):
        files = [sorted(os.path.relpath(p, os.path.join(d, name)) for p in glob.glob(
            os.path.join(d, name, "**", "*.npz"), recursive=True)) for d in (dirs[1], dirs[4])]
        if name == "S2PPC":  # np.savez stamps the time into its zip: the arrays
            a, b = _npz_tree(os.path.join(dirs[1], name)), _npz_tree(os.path.join(dirs[4], name))
            same = list(a) == list(b) and all(list(a[f]) == list(b[f]) and all(
                a[f][k].dtype == b[f][k].dtype and np.array_equal(a[f][k], b[f][k]) for k in a[f]) for f in a)
        else:  # save_npz: the bytes, and so the arrays
            same = files[0] == files[1] and all(filecmp.cmp(
                os.path.join(dirs[1], name, f), os.path.join(dirs[4], name, f), shallow=False) for f in files[0])
        ds = name.lower()
        s1, s4 = seconds[f"create-datasets {ds} --workers 1"], seconds[f"create-datasets {ds} --workers 4"]
        print(f"raw create {name}: {len(files[0])} files; workers 1 {s1:.2f} s ({1e3 * s1 / events:.3f} s a 1,000 "
              f"events), workers 4 {s4:.2f} s ({1e3 * s4 / events:.3f}); "
              f"{'arrays' if name == 'S2PPC' else 'bytes'} equal {same} [{smi}]")
        if not (same and files[0]):
            raise AssertionError(f"raw create {name}: --workers 4 built another cache than --workers 1")
    return dirs[1]


def _file_offset(data_dir: str, path: str) -> int:
    """The event-id offset dataset creation gave a raw file: the events of the
    files before it in ``DataModule._file_jobs``'s order."""
    jobs = [fp for particle in ("proton", "piM") for fp in find_shower_files(data_dir, particle)]
    return jobs.index(path) * RAW_EVENTS


def _test_event_ids(dataset: str, cfg: dict) -> np.ndarray:
    """The global event ids of the cached test split, in its loader's order."""
    module = factory.get_dataloader(dataset, cfg)
    if dataset == "s2pg":
        return np.array([int(g["event_id"]) for g in module._load_split_graphs("test")])
    _, ids = frame_to_point_loader(module.datasets["test"], module.batch_size, shuffle=False, **module.loader_kwargs)
    return ids


def raw_infer_phase(seconds: dict, work_dir: str, label: str, run: str, data_dir: str) -> tuple:
    """(e) ``infer-raw`` of one raw file: K1 once a batch (DeepSets) or K3
    twice (GAT), and each event of the file that lies in the cached test split
    within RAW_PROB_TOL of ``infer --split test``'s probability, matched
    through the file's event-id offset.  Returns (the file, infer-raw's rows)."""
    cfg = load_config(os.path.join(run, "config.yaml"))
    dataset = cfg["meta"]["dataset_name"]
    path = os.path.join(data_dir, f"piM_file{RAW_FILES - 1}.h5")
    csv = os.path.join(work_dir, f"raw_{label}.csv")
    counts = _cli(seconds, f"infer-raw {label}", "infer-raw", run, "--input", path, "--output", csv)
    rows = np.loadtxt(csv, delimiter=",", skiprows=1, ndmin=2)
    batches = -(-len(rows) // cfg["dataset"]["batch_size"])
    if dataset == "s2pg":
        _expect_launches(f"infer-raw {label}", counts, gat_attention=2 * batches)
    else:
        _expect_launches(f"infer-raw {label}", counts, phi_pool=batches)
    test_csv = os.path.join(work_dir, f"raw_{label}_test.csv")
    _cli(seconds, f"infer {label} --split test", "infer", run, "--split", "test", "--output", test_csv)
    test = np.loadtxt(test_csv, delimiter=",", skiprows=1, ndmin=2)
    ids = _test_event_ids(dataset, cfg)
    local = rows[:, 0].astype(np.int64)
    # creation renumbers a file's events by first appearance (ascending here)
    global_ids = _file_offset(data_dir, path) + np.searchsorted(np.unique(local), local)
    prob = dict(zip(global_ids.tolist(), rows[:, 1]))
    pairs = [(prob[g], p) for g, p in zip(ids.tolist(), test[:, 2]) if g in prob]
    err = max(abs(a - b) for a, b in pairs) if pairs else float("inf")
    print(f"raw infer-raw {label}: {len(rows)} events in {batches} batches, launches "
          f"{({k: v for k, v in counts.items() if v})}; {len(pairs)} of them in the cached test split, "
          f"max |probability − infer --split test's| {err:.3e} (bound {RAW_PROB_TOL:.0e})")
    if len(rows) < 0.9 * RAW_EVENTS or len(pairs) < 0.15 * RAW_EVENTS or not err <= RAW_PROB_TOL:
        raise AssertionError(f"raw infer-raw {label}: the file's probabilities do not match the test split's")
    return path, rows


def _post(url: str, data: bytes) -> tuple:
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def raw_serve_phase(smi: str, work_dir: str, label: str, run: str, path: str, rows: np.ndarray) -> dict:
    """(f) ``make_server(port=0)`` in a thread over the run: ``/health``; the
    file's bytes POSTed to ``/predict`` within SERVE_PROB_TOL of infer-raw's
    CSV, with the launches of that one request; garbage a 400; a run whose
    scaler is missing a 500; ms per request against events per request.
    Returns the request's launch counts."""
    cfg = load_config(os.path.join(run, "config.yaml"))
    server = make_server(run, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        if health != {"status": "ok", "model": cfg["meta"]["model_name"], "dataset": cfg["meta"]["dataset_name"],
                      "quant": "none"}:
            raise AssertionError(f"serve {label}: /health answered {health}")
        with open(path, "rb") as f:
            data = f.read()
        reset_launch_counts()
        status, body = _post(url + "/predict", data)
        counts = launch_counts()
        served = {p["event_id"]: p["probability"] for p in body.get("predictions", [])}
        err = max(abs(served.get(int(e), np.inf) - p) for e, p in rows[:, :2])
        print(f"serve {label}: /health {health}; POST /predict of {len(data)} bytes: {status}, {len(served)} "
              f"events, max |probability − infer-raw's| {err:.3e} (bound {SERVE_PROB_TOL:.0e}); launches of the "
              f"request {({k: v for k, v in counts.items() if v})}")
        if status != 200 or len(served) != len(rows) or not err <= SERVE_PROB_TOL:
            raise AssertionError(f"serve {label}: /predict does not give infer-raw's probabilities")
        status, body = _post(url + "/predict", b"this is not an hdf5 file")
        print(f"serve {label}: garbage → {status} {body}")
        if status != 400:
            raise AssertionError(f"serve {label}: garbage answered {status}, not 400")
        timing = []
        for n_events in SERVE_SIZES:
            sized = os.path.join(work_dir, f"serve_{n_events}.h5")
            write_shower_file(sized, "piM", n_events, seed=SEED + 7)
            with open(sized, "rb") as f:
                blob = f.read()
            _post(url + "/predict", blob)  # warm-up
            times = []
            for _ in range(SERVE_REPS):
                t0 = time.perf_counter()
                status, _ = _post(url + "/predict", blob)
                times.append(time.perf_counter() - t0)
            timing.append(f"{n_events} events {1e3 * np.median(times):.2f} ms")
        print(f"serve {label}: ms a request (host clock, loopback HTTP, median of {SERVE_REPS}): "
              f"{'; '.join(timing)} [{smi}]")
    finally:
        server.shutdown()
        server.server_close()
    # the same run over a data directory without its scaler
    broken = os.path.join(work_dir, f"raw_{label}_no_scaler")
    shutil.copytree(run, broken)
    cfg["dataset"]["data_dir"] = os.path.join(broken, "empty_data")
    os.makedirs(cfg["dataset"]["data_dir"])
    save_config(cfg, broken)
    server = make_server(broken, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, body = _post(f"http://127.0.0.1:{server.server_address[1]}/predict", data)
    finally:
        server.shutdown()
        server.server_close()
    print(f"serve {label}: the scaler missing → {status} {body}")
    if status != 500 or not body["error"].startswith("FileNotFoundError"):
        raise AssertionError(f"serve {label}: a missing scaler answered {status}, not 500")
    return counts


def raw_showers_phase(smi: str, work_dir: str) -> dict:
    """Phase 26: raw showers to caches, training, raw inference and the HTTP
    scorer on the card.  Returns each kernel's launches in the phase."""
    t0 = time.perf_counter()
    raw = os.path.join(work_dir, "raw_showers")
    steps = raw_write_phase(smi, raw)
    seconds = {}
    ds_run, ds_counts = raw_train_phase(seconds, work_dir, raw)
    created = raw_create_phase(smi, seconds, work_dir, raw)
    cfg = graph_training_config(created, os.path.join(work_dir, "raw_log", "gat"), 2, use_gat=True)
    n_steps, evals, meta, gat_counts = train_graph_arm("GAT on the created S2PG", cfg)
    print(f"raw train GAT: launches {({k: v for k, v in gat_counts.items() if v})} over {n_steps} train steps "
          f"and {evals} eval batches; accuracy/val {meta['accuracy/val']} (floor {RAW_VAL_ACC_FLOOR['GAT']}; the CPU "
          f"read {RAW_CPU_VAL_ACC['GAT']})")
    _expect_launches("train GAT on the created S2PG", gat_counts, gat_attention=2 * (n_steps + evals),
                     gat_attention_bwd=2 * n_steps, gat_out_rows=n_steps)
    if not meta["accuracy/val"] >= RAW_VAL_ACC_FLOOR["GAT"]:
        raise AssertionError(f"raw train GAT: accuracy/val {meta['accuracy/val']} below the floor")
    gat_run = cfg["logging"]["log_dir"]
    launches = {k: ds_counts[k] + gat_counts[k] for k in ds_counts}
    for label, run, data_dir in (("deep_sets", ds_run, raw), ("GAT", gat_run, created)):
        path, rows = raw_infer_phase(seconds, work_dir, label, run, data_dir)
        counts = raw_serve_phase(smi, work_dir, label, run, path, rows)
        for k in launches:
            launches[k] += counts[k]
    shown = {k: round(v, 2) for k, v in seconds.items() if not k.startswith("create-datasets")}
    print(f"raw seconds: {shown}; {steps} steps; phase {time.perf_counter() - t0:.1f} s [{smi}]")
    return launches



# phase 27: meshes.  The flagship DeepSets (configs/deep_sets.yaml's widths)
# on phase 19's cache at B=256 on the dense fp16 wire, and phase 13's in-row
# GAT (hidden 128, 4 heads) on its S2PG cache at the config's B=32.  One card:
# NCCL runs a world of one rank here (it refuses two ranks on one device), and
# gloo ranks share the card for n = 2 and 4.
MESH_STEPS = 8  # (a) train steps of each model, mesh against meshless
MESH_LOSS_TOL = 1e-6  # (a) per-step loss, a world-1 NCCL mesh against no mesh
MESH_TURNS = 2  # (a) timed rounds: meshless, mesh, mesh, meshless
MESH_EPOCHS = 3  # (b), (d) epochs on gloo ranks
MESH_CURVE_TOL = 5e-4  # (b) Loss/train against n = 1: __graft_entry__.py's size-invariance bound
MESH_PROBS = dict(rtol=5e-4, atol=5e-5)  # (b), (d): tests/test_parallel.py's bound
# (b), (d): the trained runs' probabilities against n = 1's.  The in-row
# GAT on 4 ranks of an H100 agrees with one rank to ~1e-6 until step 37,
# where a score within rounding of LeakyReLU's kink takes the other slope
# and conv2's attention gradients part 4.4e-3; Adam then drifts att_dst
# (whose gradient only such straddling nodes give), ending 1.34e-3 apart
# in eval probabilities after 96 steps, past MESH_PROBS: printed as not
# met, and failed past this guard.  The mesh's predict itself is held to MESH_PROBS
# on n = 1's final weights.
MESH_TRAINED_GUARD = 5e-3
MESH_CLI_TOL = 1e-6  # (e) metrics of torchrun's run against the meshless command line's
MESH_PHASE_SECONDS = 120


def mesh_models(run_dir: str) -> list:
    """(label, model name, dataset, config) of phase 27's two models."""
    ds = flagship_config(os.path.join(run_dir, "flagship_data"), os.path.join(run_dir, "mesh_log", "deep_sets"),
                         {}, {"epochs": MESH_EPOCHS})
    ds["dataset"]["layout"] = "dense"
    gat = graph_training_config(os.path.join(run_dir, "s2pg_train"), os.path.join(run_dir, "mesh_log", "gat"),
                                MESH_EPOCHS, use_gat=True)
    return [("DeepSets", "deep_sets", "s2ppc", ds), ("in-row GAT", "graph_net", "s2pg", gat)]


def mesh_fit(models, rank: int, n: int, n_model: int, device=None, states=None) -> dict:
    """Each model through ``factory.get_model`` and ``fit`` for MESH_EPOCHS
    epochs, then ``predict`` over its test split: without a mesh where
    ``n == 1``, else on a mesh over the process group (data-parallel, or
    ``n_model`` wide).  Returns per model rank 0's Loss/train curve, the
    probabilities and this rank's kernel launches in ``fit``; with
    ``states`` (n = 1's final ``state_dict``s by model), also the
    probabilities of ``predict`` on those weights."""
    out = {}
    for label, model_name, dataset, cfg in models:
        cfg = copy.deepcopy(cfg)
        cfg["logging"]["log_dir"] = os.path.join(cfg["logging"]["log_dir"], f"n{n}_model{n_model}")
        if n > 1:
            cfg["trainer"].update(data_parallel=n_model == 1, n_model=n_model)
        data = factory.get_dataloader(dataset, cfg)
        wrapper = factory.get_model(model_name, cfg, device=device)
        reset_launch_counts()
        wrapper.fit(data.get_train_loader(), data.get_val_loader())
        counts = {k: v for k, v in launch_counts().items() if v}
        _, probs = wrapper.predict(data.get_test_loader(), return_prob=True)
        curve = read_metrics(cfg["logging"]["log_dir"])["Loss/train"] if rank == 0 else None
        out[label] = {"curve": curve, "probs": probs, "launches": counts,
                      "state": {k: v.cpu() for k, v in wrapper.model.state_dict().items()} if n == 1 else None}
        if states is not None:
            wrapper.model.load_state_dict(states[label])
            wrapper._reshard()
            out[label]["same_weights"] = wrapper.predict(data.get_test_loader(), return_prob=True)[1]
    return out


def mesh_rank_job(rank: int, n: int, models, n_model: int, states) -> dict:
    """One gloo rank of (b) or (d), on the card this process shares."""
    torch.cuda.set_device(0)
    return mesh_fit(models, rank, n, n_model, device="cuda:0", states=states)


def _steps_ms(wrapper, batches) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for b in batches:
        wrapper.train_step(b)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(batches)


def mesh_world1_phase(smi: str, models, mesh) -> dict:
    """(a) MESH_STEPS train steps of each model on a world-1 NCCL mesh
    against the same steps without one, from the same weights: per-step
    losses, the kernels' launches, then ms a step of each, in turns.
    Returns the mesh runs' launches."""
    totals = dict.fromkeys(launch_counts(), 0)
    for label, model_name, dataset, cfg in models:
        loader = factory.get_dataloader(dataset, cfg).get_train_loader()
        batches = list(itertools.islice(iter(loader), MESH_STEPS))
        wrappers = []
        for m in (None, mesh):
            model = factory.get_model(model_name, cfg).model  # drawn from trainer.seed: the same weights
            wrappers.append(ModelWrapper(model, cfg["trainer"]["learning_rate"], 1,
                                         optimizer=cfg["trainer"].get("optimizer", "adam"), mesh=m))
        dev = [put_batch(b, wrappers[0].model, wrappers[0].device) for b in batches]
        plain, plain_counts = _counted(lambda: torch.stack([wrappers[0].train_step(b) for b in dev]))
        meshed, mesh_counts = _counted(lambda: torch.stack([wrappers[1].train_step(b) for b in dev]))
        err = float((plain - meshed).abs().max())
        print(f"mesh (a) {label}: world-1 NCCL mesh {mesh}, {MESH_STEPS} steps at B={cfg['dataset']['batch_size']}: "
              f"losses {meshed.tolist()}, max |Δ| against no mesh {err:.3g} (tolerance {MESH_LOSS_TOL}); launches "
              f"{({k: v for k, v in mesh_counts.items() if v})}, without a mesh "
              f"{({k: v for k, v in plain_counts.items() if v})}")
        if not err <= MESH_LOSS_TOL:
            raise AssertionError(f"mesh (a) {label}: losses {err} apart")
        if mesh_counts != plain_counts or not any(mesh_counts.values()):
            raise AssertionError(f"mesh (a) {label}: launches {mesh_counts} against {plain_counts}")
        for k, v in mesh_counts.items():
            totals[k] += v
        times = {"meshless": [], "mesh": []}
        for _ in range(MESH_TURNS):
            for name, w in (("meshless", wrappers[0]), ("mesh", wrappers[1]), ("mesh", wrappers[1]),
                            ("meshless", wrappers[0])):
                times[name].append(_steps_ms(w, dev))
        print(f"mesh (a) {label}: ms a train step, CUDA events over {MESH_STEPS} steps, in turns: without a mesh "
              f"{_spread(times['meshless'])}, world-1 NCCL mesh {_spread(times['mesh'])} [{smi}]")
    return totals


def mesh_fused_phase(smi: str, models, mesh) -> dict:
    """(c) a window of FUSE_K same-shape flagship batches as one CUDA graph on
    the world-1 NCCL mesh, its all-reduces captured inside, against the same
    steps run eagerly on the mesh with the optimizer the window captures.
    Returns the fused passes' launches."""
    label, model_name, dataset, cfg = models[0]
    batches = list(factory.get_dataloader(dataset, cfg).get_train_loader())
    window, distinct = _one_shape(batches)
    opt = cfg["trainer"]["optimizer"]
    fused = ModelWrapper(factory.get_model(model_name, cfg).model, 1e-3, 1, optimizer=opt, fuse_steps=FUSE_K,
                         mesh=mesh)
    eager = ModelWrapper(factory.get_model(model_name, cfg).model, 1e-3, 1, optimizer=opt, mesh=mesh)
    eager.optimizer = _make_optimizer(opt, eager._trained_params(), 1e-3, capturable=True)
    dev = [put_batch(b, fused.model, fused.device) for b in window]
    totals = dict.fromkeys(launch_counts(), 0)
    worst = 0.0
    for p in range(FUSE_PASSES):
        got, counts = _counted(lambda: fused.train_window(dev))
        want = torch.stack([eager.train_step(b) for b in dev])
        worst = max(worst, float(((got - want).abs() / want.abs()).max()))
        for k, v in counts.items():
            totals[k] += v
    print(f"mesh (c) {label}: a fused window of {FUSE_K} batches ({distinct} distinct) on the world-1 NCCL mesh, "
          f"{FUSE_PASSES} passes: captures {fused.windows.captures}, replays {fused.windows.replays}, capture "
          f"{fused.windows.capture_seconds:.2f} s; max relative |Δ loss| against the eager steps {worst:.3g} "
          f"(tolerance {FUSE_LOSS_RTOL}); launches {({k: v for k, v in totals.items() if v})} [{smi}]")
    if fused.windows.captures != 1 or fused.windows.replays < 1:
        raise AssertionError("mesh (c): the window was not captured once and replayed")
    if not worst <= FUSE_LOSS_RTOL:
        raise AssertionError(f"mesh (c): fused losses {worst} from the eager steps")
    return totals


def mesh_cli_phase(smi: str, run_dir: str) -> None:
    """(e) ``torchrun --nproc-per-node 1 -m point_cloud_classifier_tpu_torch
    train deep_sets`` with PCC_DATA_PARALLEL=1 against the same command
    without a mesh in this process, over phase 20's cache."""
    data = os.path.join(run_dir, "cli_data")
    argv = ["train", "deep_sets", "--data-dir", data, "--epochs", "1"]
    runs = {"mesh": os.path.join(run_dir, "mesh_cli", "torchrun"), "meshless": os.path.join(run_dir, "mesh_cli", "plain")}
    launcher = [shutil.which("torchrun")] if shutil.which("torchrun") else [sys.executable, "-m", "torch.distributed.run"]
    t0 = time.perf_counter()
    proc = subprocess.run([*launcher, "--standalone", "--nproc-per-node", "1", "-m", "point_cloud_classifier_tpu_torch",
                           *argv, "--log-dir", runs["mesh"]], env={**os.environ, "PCC_DATA_PARALLEL": "1"},
                          capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"mesh (e): torchrun exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    cli.main([*argv, "--log-dir", runs["meshless"]])
    dirs = {k: os.path.join(v, "version_0") for k, v in runs.items()}
    texts = {}
    for k, d in dirs.items():
        with open(os.path.join(d, "config.yaml")) as f:
            texts[k] = f.read().replace(runs[k], "<log>")
    metas = {}
    for k, d in dirs.items():
        with open(os.path.join(d, "meta.json")) as f:
            metas[k] = json.load(f)
    metrics = {k: read_metrics(d) for k, d in dirs.items()}
    err = max(abs(a - b) for tag in ("Loss/train", "Loss/val", "Accuracy/val")
              for a, b in zip(metrics["mesh"][tag], metrics["meshless"][tag]))
    acc_err = max(abs(metas["mesh"]["metrics"][k] - metas["meshless"]["metrics"][k])
                  for k in ("accuracy/train", "accuracy/val"))
    print(f"mesh (e) torchrun --nproc-per-node 1 -m point_cloud_classifier_tpu_torch {' '.join(argv)} with "
          f"PCC_DATA_PARALLEL=1: {seconds:.1f} s; files {sorted(os.listdir(dirs['mesh']))}; meta {metas['mesh']}; "
          f"max |Δ| of Loss/train, Loss/val, Accuracy/val against the meshless command {err:.3g}, of meta's "
          f"accuracies {acc_err:.3g} (tolerance {MESH_CLI_TOL}) [{smi}]")
    if os.listdir(runs["mesh"]) != ["version_0"] or sorted(os.listdir(dirs["mesh"])) != sorted(os.listdir(dirs["meshless"])):
        raise AssertionError("mesh (e): the run's files differ from the meshless run's")
    if texts["mesh"] != texts["meshless"]:
        raise AssertionError("mesh (e): config.yaml differs from the meshless run's")
    if list(metas["mesh"]) != list(metas["meshless"]) or list(metas["mesh"]["metrics"]) != list(metas["meshless"]["metrics"]):
        raise AssertionError("mesh (e): meta.json's keys differ from the meshless run's")
    if not (err <= MESH_CLI_TOL and acc_err <= MESH_CLI_TOL):
        raise AssertionError(f"mesh (e): metrics {err}, accuracies {acc_err} from the meshless run's")


def _mesh_check(label: str, ref: dict, got: list) -> None:
    """(b), (d): rank 0's curve within MESH_CURVE_TOL of n = 1's; every
    rank's ``predict`` on n = 1's weights within MESH_PROBS of n = 1's; the
    trained probabilities against n = 1's, printed against MESH_PROBS and
    failed past MESH_TRAINED_GUARD."""
    for name in ref:
        curve = np.asarray(got[0][name]["curve"])
        np.testing.assert_allclose(curve, ref[name]["curve"], rtol=MESH_CURVE_TOL, atol=MESH_CURVE_TOL,
                                   err_msg=f"mesh {label} {name}: Loss/train")
        for rank, out in enumerate(got):
            np.testing.assert_allclose(out[name]["same_weights"], ref[name]["probs"], **MESH_PROBS,
                                       err_msg=f"mesh {label} {name}: predict on n = 1's weights, rank {rank}")
        same = max(float(np.abs(o[name]["same_weights"] - ref[name]["probs"]).max()) for o in got)
        err = max(float(np.abs(o[name]["probs"] - ref[name]["probs"]).max()) for o in got)
        within = all(np.allclose(o[name]["probs"], ref[name]["probs"], **MESH_PROBS) for o in got)
        print(f"mesh {label} {name}: Loss/train {curve.tolist()} (n = 1: {list(ref[name]['curve'])}); max |Δ| "
              f"probabilities on n = 1's weights {same:.3g}; trained {err:.3g} (within rtol 5e-4 / atol 5e-5: "
              f"{'met' if within else 'NOT MET'}); launches by rank {[o[name]['launches'] for o in got]}")
        if not err <= MESH_TRAINED_GUARD:
            raise AssertionError(f"mesh {label} {name}: trained probabilities {err} from n = 1")


def mesh_phase(smi: str, run_dir: str) -> dict:
    """Phase 27: meshes.  Returns the kernels' launches in the phase (every
    rank's)."""
    import torch.distributed as dist
    from concurrent.futures import ThreadPoolExecutor

    from point_cloud_classifier_tpu_torch.parallel import make_mesh
    from point_cloud_classifier_tpu_torch.parallel.ranks import run_ranks

    t0 = time.perf_counter()
    models = mesh_models(run_dir)
    mesh = make_mesh(device="cuda")
    try:
        launches = mesh_world1_phase(smi, models, mesh)
        for k, v in mesh_fused_phase(smi, models, mesh).items():
            launches[k] += v
    finally:
        dist.destroy_process_group()
    print(f"mesh: NCCL at n > 1 is not run: it needs two or more cards, and this machine has "
          f"{torch.cuda.device_count()}")
    ref = mesh_fit(models, 0, 1, 1)
    for name in ref:
        for k, v in ref[name]["launches"].items():
            launches[k] += v
    states = {name: ref[name]["state"] for name in ref}
    with ThreadPoolExecutor(3) as pool:
        # (b) gloo worlds of 2 and 4 ranks and (d) the model axis over 2,
        # every rank on this card, while this process runs (e)
        worlds = {f"(b) n={n}": pool.submit(run_ranks, mesh_rank_job, n, models, 1, states, timeout=600)
                  for n in (2, 4)}
        worlds["(d) n_model=2"] = pool.submit(run_ranks, mesh_rank_job, 2, models, 2, states, timeout=600)
        mesh_cli_phase(smi, run_dir)
        for label, f in worlds.items():
            got = f.result()
            _mesh_check(label, ref, got)
            for out in got:
                for name in out:
                    for k, v in out[name]["launches"].items():
                        launches[k] += v
    seconds = time.perf_counter() - t0
    print(f"mesh: phase 27 in {seconds:.1f} s (budget {MESH_PHASE_SECONDS} s) [{smi}]")
    if seconds > MESH_PHASE_SECONDS:
        raise AssertionError(f"mesh: phase 27 took {seconds:.1f} s")
    return launches


def main() -> None:
    t0 = time.perf_counter()
    marks = [t0]

    def lap(what: str) -> None:
        """The seconds the phases since the last mark took."""
        marks.append(time.perf_counter())
        print(f"seconds: {what} {marks[-1] - marks[-2]:.1f}")

    smi = device_phase()
    build_phase()
    lap("device and build")
    errors = {"phi_pool": kernel_phase(), "phi_pool_bwd": bwd_kernel_phase(),
              "gat_attention": gat_kernel_phase(), "gat_attention_bwd": gat_bwd_kernel_phase(),
              "inrow_aggregate": inrow_kernel_phase(), "knn_aggregate": knn_kernel_phase()}
    lap("kernels against plain")
    with tempfile.TemporaryDirectory() as run_dir:
        write_jax_checkpoint(run_dir, np.random.default_rng(SEED))
        serve_launches = slice_phase(run_dir)
        launches = train_phase(run_dir)
        lap("DeepSets serving and training")
        graph_serve_launches = graph_slice_phase(run_dir)
        graph_launches = graph_train_phase(run_dir)
        lap("GraphNet serving and training")
        knn_serve_launches = knn_slice_phase(run_dir)
        knn_launches = knn_train_phase(run_dir)
        lap("kNN serving and training")
        slice2_launches = slice2_phase(smi, run_dir)
        lap("graph slice 2")
        dense_launches = flagship_train_phase(run_dir)
        dense = flagship_kernel_phase(smi)
        lap("flagship wire")
        print(f"launches: DeepSets serving path K1 {serve_launches}; DeepSets training path "
              f"K1 {launches['phi_pool']}, K2 {launches['phi_pool_bwd']}; GAT serving path "
              f"K3 {graph_serve_launches}; GraphNet training path {graph_launches}; kNN serving path "
              f"K5 {knn_serve_launches}; kNN training path {knn_launches}; flagship wire, K1 and K2 "
              f"on dense batches {dense_launches}")
        print(f"launches: graph slice 2, in-row GAT with SAG training path {slice2_launches}")
        # K3's and K4's counts sum both GAT training paths, slice 1's and
        # slice 2's (SAG: two mirrors a step)
        for name in ("gat_attention", "gat_attention_bwd", "gat_out_rows"):
            graph_launches[name] += slice2_launches[name]
        # K6's and K5's counts are their forward and backward launches
        # together; K5's selections and K4's mirrors stand beside them
        graph_launches["inrow_aggregate"] += graph_launches.pop("inrow_aggregate backward")
        knn_launches["knn_aggregate"] += knn_launches.pop("knn_aggregate backward")
        beside = {"gat_attention_bwd": {"mirror_launches": graph_launches.pop("gat_out_rows")},
                  "knn_aggregate": {"select_launches": knn_launches.pop("knn_select")}}
        for name in ("phi_pool", "phi_pool_bwd"):
            # the flagship wire's dense batches: launches over both runs, and
            # the M=256 f32 times, bound and error
            beside[name] = {"dense_launches": dense_launches[name],
                            **{k: v[name] for k, v in dense.items() if name in v}}
        launches.update(graph_launches)
        launches.update(knn_launches)
        times = times_phase(smi, run_dir)
        lap("DeepSets times")
        times["gat_attention"] = graph_times_phase(smi, os.path.join(run_dir, "graph_run_1"))
        times.update(graph_train_times_phase(smi))
        times["knn_aggregate"] = knn_times_phase(smi)
        lap("graph times")
        flagship_times_phase(smi, run_dir)
        lap("flagship times")
        cli_launches = cli_phase(smi, run_dir)
        lap("command line")
        print(f"launches: command line, train deep_sets K1 {cli_launches['phi_pool']}, "
              f"K2 {cli_launches['phi_pool_bwd']}")
        host_phase(smi, run_dir)
        lap("host packers")
        sweep_launches = sweep_phase(smi, run_dir)
        lap("sweep")
        print(f"launches: sweep (sequential, vmapped search and the vmapped arms) {sweep_launches}")
        for name in launches:
            beside.setdefault(name, {})["sweep_launches"] = sweep_launches.get(name, 0)
            launches[name] += sweep_launches.get(name, 0)
        fuse_launches, tail_launches = fuse_phase(smi, run_dir)
        lap("fused windows, tail, remat, trace")
        print(f"launches: fused windows (replays counted) {fuse_launches}; fused_phi=tail {tail_launches}")
        fuse_launches["inrow_aggregate"] += fuse_launches.pop("inrow_aggregate backward")
        fuse_launches["knn_aggregate"] += fuse_launches.pop("knn_aggregate backward")
        beside["gat_attention_bwd"]["fused_window_mirror_launches"] = fuse_launches.pop("gat_out_rows")
        beside["knn_aggregate"]["fused_window_select_launches"] = fuse_launches.pop("knn_select")
        for name in launches:
            beside[name]["fused_window_launches"] = fuse_launches.get(name, 0)
            launches[name] += fuse_launches.get(name, 0)
        for name in ("phi_pool", "phi_pool_bwd"):
            beside[name].update(tail_launches[name])
            launches[name] += tail_launches[name]["tail_launches"]
        int8_export_phase(smi, run_dir)
        lap("int8 and export")
        raw_launches = raw_showers_phase(smi, run_dir)
        lap("raw showers")
        print(f"launches: raw showers (train, infer-raw and a request of DeepSets and GAT) {raw_launches}")
        beside["gat_attention_bwd"]["raw_showers_mirror_launches"] = raw_launches.pop("gat_out_rows")
        beside["knn_aggregate"]["raw_showers_select_launches"] = raw_launches.pop("knn_select")
        raw_launches["inrow_aggregate"] += raw_launches.pop("inrow_aggregate backward")
        raw_launches["knn_aggregate"] += raw_launches.pop("knn_aggregate backward")
        for name in launches:
            beside[name]["raw_showers_launches"] = raw_launches.get(name, 0)
            launches[name] += raw_launches.get(name, 0)
        mesh_launches = mesh_phase(smi, run_dir)
        lap("meshes")
        print(f"launches: meshes (every rank's) {mesh_launches}")
        beside["gat_attention_bwd"]["mesh_mirror_launches"] = mesh_launches.pop("gat_out_rows")
        beside["knn_aggregate"]["mesh_select_launches"] = mesh_launches.pop("knn_select")
        mesh_launches["inrow_aggregate"] += mesh_launches.pop("inrow_aggregate backward")
        mesh_launches["knn_aggregate"] += mesh_launches.pop("knn_aggregate backward")
        for name in launches:
            beside[name]["mesh_launches"] = mesh_launches.get(name, 0)
            launches[name] += mesh_launches.get(name, 0)
    profile_phase(smi)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errors[name],
        **times[name],
        **beside.get(name, {}),
    } for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

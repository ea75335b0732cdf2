#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve, train, time.

Run from the repository root, with no arguments, on a machine with a CUDA
card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code is
not 0 (there is no CPU run: without CUDA the script stops before printing a
result):

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernels from ``point_cloud_classifier_tpu_torch/csrc``;
3. kernel against plain: ``phi_pool`` (kernel K1) against ``phi_pool_plain``
   on the card, f32 and bf16, at the DeepSets config widths (6→256→256,
   residual, quick gelu), with a ragged point count, an empty event, padding
   rows, and the flagship ``B=256, P=65,536`` shape;
4. backward kernel against plain: the backward of ``phi_pool`` (kernel K2)
   against ``phi_pool_bwd_plain`` at the same cases, f32 and bf16, with
   ``d_points`` asked for and not;
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
   of 160-288 nodes) and the flagship B=256 graphs of 256 nodes, H=4, C=128;
9. graph serving slice: for GAT and for GraphConv add at the full width of
   ``configs/graph_net.yaml``, ``factory.get_model("graph_net", cfg,
   run_dir)`` on a JAX-format ``best_model.pt`` with seeded random weights,
   then ``predict`` over ``factory.get_dataloader("s2pg", cfg)``'s test
   loader on a seeded synthetic S2PG cache at batch 32, held against the
   plain route (``force_plain()``), with K3's launch count (2 per GAT batch);
10. graph times: K3 against its plain version at B=32 and B=256, f32 and
   bf16; ``predict`` per batch on both routes; and a ``torch.profiler``
   trace of the B=256 GAT predict (the device's idle share).

The line before the last is one JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
import subprocess
import tempfile
import time

import numpy as np
import torch

from point_cloud_classifier_tpu_torch import convert, factory
from point_cloud_classifier_tpu_torch import train as port_train
from point_cloud_classifier_tpu_torch.data import GraphLoader, PointCloudLoader
from point_cloud_classifier_tpu_torch.data.synthetic import (
    lineage_graphs,
    write_s2pg_cache,
    write_s2ppc_cache,
)
from point_cloud_classifier_tpu_torch.models import GraphNet
from point_cloud_classifier_tpu_torch.native import kernel_library
from point_cloud_classifier_tpu_torch.ops.dispatch import force_plain
from point_cloud_classifier_tpu_torch.ops.fused_phi import (
    _phi_pool_bwd_cuda,
    phi_pool,
    phi_pool_bwd_plain,
    phi_pool_plain,
)
from point_cloud_classifier_tpu_torch.ops.gat import gat_attention, gat_attention_plain

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
}
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


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count to 0, just before a path runs."""
    phi_pool.launches = phi_pool.bwd_launches = gat_attention.launches = 0


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


def _uniform(rng, bound, shape):
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def phi_inputs(b, p, dtype, seed, empty_event=True, final=False):
    """Flat-wire points for ``b`` events in ``p`` rows: events contiguous,
    event 1 empty, the rest of the rows padding (segment ``b``)."""
    rng = np.random.default_rng(seed)
    sizes = rng.multinomial(int(p * 0.9), np.ones(b) / b)
    if empty_event:
        sizes[0] += sizes[1]
        sizes[1] = 0
    seg = np.full(p, b, dtype=np.int32)
    seg[: sizes.sum()] = np.repeat(np.arange(b, dtype=np.int32), sizes)
    points = rng.normal(size=(p, 6)).astype(np.float32)
    params, last = [], 6
    for width in CONFIG["model"]["phi_layers"]:
        params.append((_uniform(rng, last**-0.5, (last, width)), _uniform(rng, last**-0.5, (width,))))
        last = width
    if final:
        params.append((_uniform(rng, last**-0.5, (last, last)), _uniform(rng, last**-0.5, (last,))))
    dev = torch.device("cuda")
    params = tuple(tuple(torch.from_numpy(a).to(dev) for a in layer) for layer in params)
    return torch.from_numpy(points).to(dev, dtype), torch.from_numpy(seg).to(dev), params


def kernel_phase():
    """K1 against plain at every case; returns the config-shape f32 error."""
    cases = [
        ("config B=32 P=8192", CONFIG_B, CONFIG_P, False),
        ("ragged B=7 P=1001", 7, 1001, False),
        ("ragged B=7 P=1001 +final linear", 7, 1001, True),
        ("flagship B=256 P=65536", FLAGSHIP_B, FLAGSHIP_P, False),
    ]
    config_err = None
    for name, b, p, final in cases:
        for dtype in (torch.float32, torch.bfloat16):
            points, seg, params = phi_inputs(b, p, dtype, SEED, final=final)
            out = phi_pool(points, seg, SPEC, params, "gelu", b + 1)
            torch.cuda.synchronize()
            ref = phi_pool_plain(points, seg, SPEC, params, "gelu", b + 1)
            torch.cuda.synchronize()
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"{name} {dtype}: bad output {tuple(out.shape)}")
            err = (out - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            rel = err / scale
            print(f"kernel {name} {str(dtype)[6:]}: max_abs_err {err:.3e}, "
                  f"max_rel_err {rel:.3e} (bound {TOL[dtype]:.0e}), |ref| max {scale:.3e}")
            if not rel <= TOL[dtype]:
                raise AssertionError(f"K1 disagrees with plain: {name} {dtype} rel {rel:.3e}")
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
    K1's cases; returns the config-shape f32 max |Δ|."""
    cases = [
        ("config B=32 P=8192", CONFIG_B, CONFIG_P, False),
        ("ragged B=7 P=1001", 7, 1001, False),
        ("ragged B=7 P=1001 +final linear", 7, 1001, True),
        ("flagship B=256 P=65536", FLAGSHIP_B, FLAGSHIP_P, False),
    ]
    config_err = None
    for name, b, p, final in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for with_points in (True, False):
                points, seg, params = phi_inputs(b, p, dtype, SEED, final=final)
                g = torch.from_numpy(
                    np.random.default_rng(SEED + 3).normal(size=(b + 1, 256)).astype(np.float32)
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
                print(f"kernel K2 {name} {str(dtype)[6:]} d_points {'on' if with_points else 'off'}: "
                      f"max_abs_err {worst[0]:.3e}, max_rel_err {worst[1]:.3e}, rel_fro {worst[2]:.3e} "
                      f"({bounds})")
                if not ok:
                    raise AssertionError(f"K2 disagrees with plain: {name} {dtype} {worst}")
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


def predict_ms_per_batch(models, batches, reps=10):
    """Per model, (median, q1, q3) of ``predict``'s ms per batch over the
    pre-packed ``batches``, timed in turns (A B B A …) after a warm-up."""
    for model in models:
        model.predict(batches, return_prob=True)
    samples = [[] for _ in models]
    for rep in range(reps):
        order = range(len(models)) if rep % 2 == 0 else reversed(range(len(models)))
        for i in order:
            t0 = time.perf_counter()
            models[i].predict(batches, return_prob=True)  # ends in a device→host copy
            samples[i].append((time.perf_counter() - t0) * 1e3 / len(batches))
    return [tuple(float(q) for q in np.percentile(s, [50, 25, 75])) for s in samples]


def train_ms_per_batch(wrappers, batches, reps=10):
    """Per wrapper, (median, q1, q3) of the train step's ms per batch (forward,
    loss, backward, AdamW step) over the pre-packed ``batches``, host clock
    to a synchronise, timed in turns (A B B A …) after a warm-up pass."""
    for wrapper in wrappers:
        for batch in batches:
            wrapper.train_step(batch)
    torch.cuda.synchronize()
    samples = [[] for _ in wrappers]
    for rep in range(reps):
        order = range(len(wrappers)) if rep % 2 == 0 else reversed(range(len(wrappers)))
        for i in order:
            t0 = time.perf_counter()
            for batch in batches:
                wrappers[i].train_step(batch)
            torch.cuda.synchronize()
            samples[i].append((time.perf_counter() - t0) * 1e3 / len(batches))
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
    Returns the config shape's f32 (kernel ms, plain ms) per kernel."""
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
            print(f"time phi_pool {name} B={b} P={p} {str(dtype)[6:]}: K1 {kernel_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms; backward without d_points: K2 {bwd_ms:.4f} ms, "
                  f"plain {bwd_plain_ms:.4f} ms [{smi}]")
            if (name, dtype) == ("config", torch.float32):
                config_times = {"phi_pool": (kernel_ms, plain_ms),
                                "phi_pool_bwd": (bwd_ms, bwd_plain_ms)}
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
            print(f"time predict per batch B={b} P={p_pad} {dtype}, median (q1-q3) of 10 "
                  f"runs over {len(batches)} pre-packed batches, host clock: "
                  f"K1 path {kernel[0]:.4f} ({kernel[1]:.4f}-{kernel[2]:.4f}) ms, "
                  f"plain path {plain[0]:.4f} ({plain[1]:.4f}-{plain[2]:.4f}) ms; "
                  f"packing {pack_ms:.4f} ms/batch on the host [{smi}]")
            plain, kernel = train_ms_per_batch(list(route_models(dtype)), batches)
            print(f"time train step per batch B={b} P={p_pad} {dtype} adamw, median (q1-q3) "
                  f"of 10 runs over {len(batches)} pre-packed batches, host clock to a "
                  f"synchronise: K1+K2 route {kernel[0]:.4f} ({kernel[1]:.4f}-{kernel[2]:.4f}) ms, "
                  f"plain route {plain[0]:.4f} ({plain[1]:.4f}-{plain[2]:.4f}) ms [{smi}]")
    return config_times


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def profile_phase(smi: str) -> None:
    """A torch.profiler trace of the B=256 f32 train step on the kernel
    route: device busy time, idle share of the window, top device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    clouds, labels = make_clouds(np.random.default_rng(SEED + 2), 4 * FLAGSHIP_B)
    batches = list(PointCloudLoader(clouds, labels, FLAGSHIP_B, shuffle=False))
    _, kernel = route_models("float32")
    for batch in batches:
        kernel.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            kernel.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    items = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=_device_us, reverse=True,
    )
    busy_ms = sum(_device_us(e) for e in items) / 1e3
    if busy_ms <= 0:
        print(f"profile train step B=256 f32: the profiler recorded no device time; "
              f"device busy and idle share not measured [{smi}]")
        return
    n = len(batches)
    top = "; ".join(f"{e.key[:48]} {_device_us(e) / 1e3 / n:.4f} ms x{e.count // n}" for e in items[:6])
    print(f"profile train step B=256 f32 K1+K2 route, {n} steps under torch.profiler: device busy "
          f"{busy_ms / n:.4f} ms/step of {wall_ms / n:.4f} ms/step wall, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; top device items per step: {top} [{smi}]")


def _graph_batch(graphs, batch_size, transfer_dtype="float32"):
    """The first dense in-row batch of ``graphs``, as numpy arrays."""
    loader = GraphLoader(graphs, batch_size, shuffle=False, layout="dense",
                         use_weights=False, transfer_dtype=transfer_dtype)
    return next(iter(loader))


def gat_inputs(case: str, dtype, seed: int = SEED):
    """(s_dst, s_src, in_src, in_w, xw) on the card for one K3 case."""
    rng = np.random.default_rng(seed)
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
                   "D=32 tiny id pool": (3, 45, 32), "isolated D=8": (2, 40, 8)}[case]
        in_src = rng.integers(0, 6 if "tiny" in case else m, size=(b, m, d)).astype(np.int32)
        in_w = (rng.random((b, m, d)) * (rng.random((b, m, d)) < 0.6)).astype(np.float32)
        if "isolated" in case:
            in_w[:, :9] = 0.0
    dev = torch.device("cuda")
    s_dst, s_src = (torch.from_numpy(rng.normal(size=(b, m, GAT_HEADS)).astype(np.float32)).to(dev)
                    for _ in range(2))
    xw = torch.from_numpy(rng.normal(size=(b, m, GAT_C)).astype(np.float32)).to(dev, dtype)
    return s_dst, s_src, torch.from_numpy(in_src).to(dev), torch.from_numpy(in_w).to(dev), xw


GAT_CASES = ("config B=32", "config B=32 fp16/int16 wire", "ragged M=37 D=4", "ragged M=61 D=8",
             "D=32 tiny id pool", "isolated D=8", "flagship B=256 M=256")


def gat_kernel_phase():
    """K3 against gat_attention_plain at every case; returns the config-shape
    f32 max |Δ|."""
    config_err = None
    for case in GAT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = gat_inputs(case, dtype)
            out = gat_attention(*args)
            torch.cuda.synchronize()
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
                  f"in_src {str(args[2].dtype)[6:]}, xw {str(dtype)[6:]}: max_abs_err {err:.3e}, "
                  f"max_rel_err {rel:.3e}, rel_fro {fro:.3e} ({bounds})")
            if not ok:
                raise AssertionError(f"K3 disagrees with plain: {case} {dtype} {(err, rel, fro)}")
            if (case, dtype) == ("config B=32", torch.float32):
                config_err = err
    return config_err


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
    """A wrapper whose ``predict`` runs inside ``force_plain()``."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    def predict(self, batches, return_prob=False):
        with force_plain():
            return self.wrapper.predict(batches, return_prob)


def graph_times_phase(smi: str, run_dir: str):
    """K3 against its plain version (CUDA events, plain first), then predict
    per batch (host clock) on both routes, and a profile of the B=256 GAT
    predict.  Returns the config shape's f32 (kernel ms, plain ms)."""
    config_times = None
    for case in ("config B=32", "flagship B=256 M=256"):
        for dtype in (torch.float32, torch.bfloat16):
            args = gat_inputs(case, dtype)
            with torch.no_grad():
                plain_ms = cuda_ms(lambda: gat_attention_plain(*args))
                kernel_ms = cuda_ms(lambda: gat_attention(*args))
            print(f"time gat_attention {case} B,M,D={tuple(args[2].shape)} H={GAT_HEADS} C={GAT_C} "
                  f"{str(dtype)[6:]}: K3 {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms [{smi}]")
            if (case, dtype) == ("config B=32", torch.float32):
                config_times = (kernel_ms, plain_ms)
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
            print(f"time predict per batch B={b} (M, D)={shape} {dtype}, median (q1-q3) of 10 runs "
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


def main() -> None:
    t0 = time.perf_counter()
    smi = device_phase()
    build_phase()
    errors = {"phi_pool": kernel_phase(), "phi_pool_bwd": bwd_kernel_phase(),
              "gat_attention": gat_kernel_phase()}
    with tempfile.TemporaryDirectory() as run_dir:
        write_jax_checkpoint(run_dir, np.random.default_rng(SEED))
        serve_launches = slice_phase(run_dir)
        launches = train_phase(run_dir)
        launches["gat_attention"] = graph_slice_phase(run_dir)
        print(f"launches: DeepSets serving path K1 {serve_launches}; DeepSets training path "
              f"K1 {launches['phi_pool']}, K2 {launches['phi_pool_bwd']}; GAT serving path "
              f"K3 {launches['gat_attention']}")
        times = times_phase(smi, run_dir)
        times["gat_attention"] = graph_times_phase(smi, os.path.join(run_dir, "graph_run_1"))
    profile_phase(smi)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errors[name],
        "ms": times[name][0],
        "plain_ms": times[name][1],
    } for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

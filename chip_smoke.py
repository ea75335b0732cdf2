#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve, time.

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
4. slice: the DeepSets serving path through its entry points —
   ``factory.get_model("deep_sets", cfg, run_dir)`` on a JAX-format
   ``best_model.pt`` with seeded random weights, then ``predict`` over
   seeded clouds batched by ``PointCloudLoader`` — checked against the same
   model on its plain path, with the kernel's launch count;
5. times: CUDA-event times of the kernel and the plain version at both
   shapes and dtypes, and ``predict`` per batch on the kernel and plain
   routes at batch sizes 32 and 256, in f32 and bf16 compute.

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

from point_cloud_classifier_tpu_torch import factory
from point_cloud_classifier_tpu_torch.data import PointCloudLoader
from point_cloud_classifier_tpu_torch.native import kernel_library
from point_cloud_classifier_tpu_torch.ops.fused_phi import phi_pool, phi_pool_plain

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
# predict: probabilities of the kernel path against the plain path (f32).
PROB_TOL = 1e-4
CONFIG_B, CONFIG_P = 32, 8192  # a batch of 32 clouds of ~224 points
FLAGSHIP_B, FLAGSHIP_P = 256, 65536  # bench.py's flagship shape
SOURCE = "point_cloud_classifier_tpu_torch/csrc/phi_pool.cu"
REPLACES = "point_cloud_classifier_tpu/ops/fused_phi.py:322"


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
    phi_pool.launches = 0
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


def times_phase(smi: str, run_dir: str):
    """Kernel against plain (CUDA events, plain first), then predict per
    batch (host clock) on both routes.  Returns the config shape's f32
    (kernel ms, plain ms)."""
    config_times = None
    for name, b, p in (("config", CONFIG_B, CONFIG_P), ("flagship", FLAGSHIP_B, FLAGSHIP_P)):
        for dtype in (torch.float32, torch.bfloat16):
            points, seg, params = phi_inputs(b, p, dtype, SEED)
            plain_ms = cuda_ms(lambda: phi_pool_plain(points, seg, SPEC, params, "gelu", b + 1))
            kernel_ms = cuda_ms(lambda: phi_pool(points, seg, SPEC, params, "gelu", b + 1))
            print(f"time phi_pool {name} B={b} P={p} {str(dtype)[6:]}: K1 {kernel_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms [{smi}]")
            if (name, dtype) == ("config", torch.float32):
                config_times = (kernel_ms, plain_ms)
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
    return config_times


def main() -> None:
    smi = device_phase()
    build_phase()
    config_err = kernel_phase()
    with tempfile.TemporaryDirectory() as run_dir:
        write_jax_checkpoint(run_dir, np.random.default_rng(SEED))
        launches = slice_phase(run_dir)
        kernel_ms, plain_ms = times_phase(smi, run_dir)
    print(json.dumps({"kernels": [{
        "name": "phi_pool",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": config_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

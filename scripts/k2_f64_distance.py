"""How far f32 K2 lands from an f64 backward at the sweep's deeper chains,
gradient by gradient, beside the other f32 backwards.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 scripts/k2_f64_distance.py

For φ [512] × 2 to × 4 and [1024] × 3 (the sweep's chains, plain and
residual square layers), gelu and silu, P = 63 and 1001 (the card tests'
inputs, ``tests/test_torch_gpu.py:_tf32x3_bwd_inputs``), it prints the
relative Frobenius distance, ‖a − f64‖ / ‖f64‖, of each gradient
(``d_points``, each layer's ``d_W`` and ``d_b``) of four backwards to
``phi_pool_bwd_plain`` in f64 on the same inputs: K2 on the path (its
tf32x3 variant), K2's general variant (the timing entry: f32 FMAs),
``phi_pool_bwd_plain`` in f32 (cuBLAS) and ``phi_pool_bwd_tf32x3_plain``
(K2's products in plain PyTorch), the worst of each and K2's by gradient.
K2's bound against the f32 plain version is 1e-5 relative Frobenius
(``chip_smoke.py:BWD_F32_FRO``).  It checks nothing.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))

from point_cloud_classifier_tpu_torch.models.wrapper import resolve_device  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi as fp  # noqa: E402

CHAINS = {"[512] × 2 plain": (6, [512] * 2, False), "[512] × 3 plain": (6, [512] * 3, False),
          "[512] × 4 plain": (6, [512] * 4, False), "[512] × 4 residual": (6, [512] * 4, True),
          "[1024] × 3 plain": (6, [1024] * 3, False), "[1024] × 3 residual": (6, [1024] * 3, True)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_f64_distance: torch.cuda.is_available() is false; this runs on a GPU")
    import test_torch_gpu as cases  # the card tests' seeded inputs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases.TF32X3_BWD_CHAINS.update(CHAINS)

    def fro(a, b):
        return ((a.double() - b.double()).norm() / max(b.double().norm().item(), 1e-30)).item()

    for chain in CHAINS:
        for act in ("gelu", "silu"):
            for p in (63, 1001):
                pts, seg, params, s, spec, g = cases._tf32x3_bwd_inputs(dev, chain, p)
                p64 = tuple(tuple(t.double() for t in layer) for layer in params)
                d64, g64 = fp.phi_pool_bwd_plain(pts.double(), seg, g.double(), spec, p64, act, s)
                ref = [d64, *g64]
                names = ["d_points"] + [f"{k}{i}" for i in range(len(params)) for k in ("d_W", "d_b")]
                runs = {"K2": fp._phi_pool_bwd_cuda(pts, seg, g, spec, params, act, s)}
                variant = fp.phi_pool.bwd_variant
                runs.update({
                    "K2 general": fp._phi_pool_bwd_cuda(pts, seg, g, spec, params, act, s, general=True),
                    "plain f32": fp.phi_pool_bwd_plain(pts, seg, g, spec, params, act, s),
                    "tf32x3 plain": fp.phi_pool_bwd_tf32x3_plain(pts, seg, g, spec, params, act, s),
                })
                dist = {k: [fro(a, b) for a, b in zip([d, *gr], ref)] for k, (d, gr) in runs.items()}
                worst = "; ".join(f"{k} {max(v):.2e}" for k, v in dist.items())
                each = " ".join(f"{n} {x:.1e}" for n, x in zip(names, dist["K2"]))
                print(f"φ {chain} {act} P={p}, to f64, the worst gradient: {worst}; K2 [{variant}] "
                      f"by gradient: {each} [{smi}]", flush=True)


if __name__ == "__main__":
    main()

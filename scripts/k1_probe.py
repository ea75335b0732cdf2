"""Probe f32 K1's variants on a CUDA card: ptxas's report, checks and times.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 scripts/k1_probe.py            # checks at every case, times at P >= 8,192
    python3 scripts/k1_probe.py --times    # times only (the cases at P >= 8,192)
    python3 scripts/k1_probe.py --clocks   # where a tf32x3 block's clocks go, per phase

It compiles ``csrc/phi_pool.cu`` once with ``-Xptxas -v`` and prints each
tf32x3 kernel's registers and spills, then runs K1 on seeded chains (the
DeepSets chain at φ 256, 512 and 1024, a bare final linear, widths 64 and
384, the tail's bare [256, 256] layer over 256-wide rows, one point an
event), gelu and relu, and prints per case: the variant, the distance to
``phi_pool_plain`` and to ``phi_pool_tf32x3_plain`` (of max(1, max |plain|)),
the general variant's distance (``_phi_pool_cuda(general=True)``), a one-pass
TF32 product's, and at P >= 8,192 the ms of the taken variant (twice), the
general variant and the plain version (CUDA events between eager calls)
beside the f32 and 3xTF32 bounds.  With ``--clocks`` it builds with
``PCC_PHASE_CLOCKS`` and prints block 0's clock sums per phase at the
large shapes.  ``nvidia-smi``'s name and power limit head the output.  It
checks nothing: ``chip_smoke.py`` does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from point_cloud_classifier_tpu_torch import native  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi  # noqa: E402
from point_cloud_classifier_tpu_torch.phase_clocks import K1_PHASES  # noqa: E402

RES = (("plain", False), ("residual", False))
# (name, events, point rows, layer widths, the points' width, spec, one point an event)
CASES = [
    ("ragged B=7 P=1001", 7, 1001, [256, 256], 6, RES, False),
    ("under one tile B=3 P=37", 3, 37, [256, 256], 6, RES, False),
    ("P=1", 1, 1, [256, 256], 6, RES, False),
    ("+final", 7, 1001, [256, 256, 256], 6, RES, False),
    ("w64", 7, 1001, [64, 64], 6, RES, False),
    ("w384", 7, 1001, [384, 384], 6, RES, False),
    ("w512", 7, 1001, [512, 512], 6, RES, False),
    ("w1024", 7, 1001, [1024, 1024], 6, RES, False),
    ("tail ragged", 7, 1001, [256], 256, (), False),
    ("singletons B=P=4096", 4096, 4096, [256, 256], 6, RES, True),
    ("singletons w1024", 4096, 4096, [1024, 1024], 6, RES, True),
    ("config B=32 P=8192", 32, 8192, [256, 256], 6, RES, False),
    ("flagship B=256 P=65536", 256, 65536, [256, 256], 6, RES, False),
    ("tail B=256 P=65536", 256, 65536, [256], 256, (), False),
    ("phi512 B=256 P=65536", 256, 65536, [512, 512], 6, RES, False),
    ("phi1024 B=256 P=65536", 256, 65536, [1024, 1024], 6, RES, False),
]


def inputs(b, p, widths, in_dim=6, singletons=False, seed=0):
    rng = np.random.default_rng(seed)
    if singletons:
        seg = np.arange(p, dtype=np.int32)
    else:
        sizes = rng.multinomial(int(p * 0.9), np.ones(b) / b)
        seg = np.full(p, b, dtype=np.int32)
        seg[: sizes.sum()] = np.repeat(np.arange(b, dtype=np.int32), sizes)
    pts = torch.from_numpy(rng.normal(size=(p, in_dim)).astype(np.float32)).cuda()
    params, last = [], in_dim
    for w in widths:
        bound = last**-0.5
        params.append((torch.from_numpy(rng.uniform(-bound, bound, (last, w)).astype(np.float32)).cuda(),
                       torch.from_numpy(rng.uniform(-bound, bound, (w,)).astype(np.float32)).cuda()))
        last = w
    return pts, torch.from_numpy(seg).cuda(), tuple(params)


def ms(fn, iters=20, warm=3):
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                            os.path.join(tmp, "phi_pool.o"), str(native.CSRC_DIR / "phi_pool.cu")],
                           capture_output=True, text=True)
    lines = r.stderr.splitlines()
    for i, line in enumerate(lines):
        near = "".join(lines[max(0, i - 3):i + 1])
        if "error" in line.lower() or ("tf32x3" in near and ("Used" in line or "spill" in line)):
            print(line)
    if r.returncode:
        raise SystemExit(r.stderr[-4000:])


def clocks(lib) -> None:
    names = K1_PHASES["tf32x3"]
    for name, b, p, widths, in_dim, spec, single in CASES[-5:]:
        for act in ("gelu", "relu"):
            pts, seg, params = inputs(b, p, widths, in_dim, singletons=single)
            fused_phi.phi_pool(pts, seg, spec, params, act, b + 1)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 16)()
            lib.pcc_phi_pool_phase_clocks(buf)
            total = sum(buf[: len(names)])
            print(f"clocks {name} {act} [{fused_phi.phi_pool.variant}]: " + "; ".join(
                f"{n} {buf[i]} ({buf[i] / total:.3f})" for i, n in enumerate(names)) + f"; total {total}",
                flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_probe: torch.cuda.is_available() is false; this runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    ptxas_report()
    if "--clocks" in sys.argv:
        native.enable_phase_clocks()
    t0 = time.perf_counter()
    built = native.kernel_library()
    print("build", built.build_seconds, flush=True)
    if "--clocks" in sys.argv:
        clocks(built.lib)
        return
    for name, b, p, widths, in_dim, spec, single in CASES:
        if "--times" in sys.argv and p < 8192:
            continue
        for act in ("gelu", "relu"):
            pts, seg, params = inputs(b, p, widths, in_dim, singletons=single)
            out = fused_phi.phi_pool(pts, seg, spec, params, act, b + 1)
            torch.cuda.synchronize()
            variant = fused_phi.phi_pool.variant
            ref = fused_phi.phi_pool_plain(pts, seg, spec, params, act, b + 1)
            tf = fused_phi.phi_pool_tf32x3_plain(pts, seg, spec, params, act, b + 1)
            one = fused_phi.segment_sum(fused_phi.phi_forward_tf32x3(pts, spec, params, act, passes=1),
                                        seg, b + 1)
            gen = fused_phi._phi_pool_cuda(pts, seg, spec, params, act, b + 1, general=True)
            scale = max(1.0, ref.abs().max().item())
            line = (f"{name} {act} [{variant}]: rel to plain {(out - ref).abs().max().item() / scale:.3e}, "
                    f"to tf32x3 plain {(out - tf).abs().max().item() / scale:.3e}; general "
                    f"{(gen - ref).abs().max().item() / scale:.3e}; one-pass plain "
                    f"{(one - ref).abs().max().item() / scale:.3e}; finite {bool(torch.isfinite(out).all())}")
            if p >= 8192:
                run = lambda: fused_phi.phi_pool(pts, seg, spec, params, act, b + 1)  # noqa: E731
                t_new = ms(run)
                t_gen = ms(lambda: fused_phi._phi_pool_cuda(pts, seg, spec, params, act, b + 1, general=True))
                t_plain = ms(lambda: fused_phi.phi_pool_plain(pts, seg, spec, params, act, b + 1))
                t_new2 = ms(run)
                flops = p * sum(2 * w.shape[0] * w.shape[1] for w, _ in params)
                line += (f"; ms {variant} {t_new:.4f} / {t_new2:.4f}, general {t_gen:.4f}, plain {t_plain:.4f}; "
                         f"bounds f32 {1e3 * flops / 67e12:.4f}, 3xTF32 {3e3 * flops / 495e12:.4f}")
            print(line, flush=True)
            del pts, seg, params, out, ref, tf, one, gen
            torch.cuda.empty_cache()
    print("seconds", time.perf_counter() - t0)


if __name__ == "__main__":
    main()

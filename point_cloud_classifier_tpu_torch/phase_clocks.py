"""Where a block of the sliced K1 and K2, of f32 K1's and K2's tf32x3
variants and of bf16 K1's and K2's wide variants spends its clocks, per
phase.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 -m point_cloud_classifier_tpu_torch.phase_clocks

It builds the kernels with their per-phase clocks
(``native.enable_phase_clocks()``: thread 0 of block 0 adds up ``clock64()``
between the marks of ``csrc/phi_pool.cu`` and ``csrc/phi_pool_bwd.cu``),
launches K1 and K2 once each at the DeepSets config batch (B=32, P=8,192)
and at the flagship shape (B=256, P=65,536), in f32 (K1's tf32x3 variant,
K2's one-block tf32x3 form) and bf16 (the one-block wide forms of both),
with K1's and K2's sliced variants there too in bf16 (the timing entries,
``general=True``), then at φ [512, 512] and [1024, 1024] at the flagship
shape in f32 (both tf32x3) and bf16 (both wide), K2's row pass and its d_W
pass apart, at φ [256] × 3 and [512] × 3 residual (two square layers, the
sweep's) in f32 (K2's row pass of two square layers, its products summed a
chunk at a time), and the tail's bare layer, [256, 256] in f32 and bf16 and
[1024, 1024] in bf16 (K1 tf32x3 or wide; K2 tf32x3 or wide, its row
product for d_points and its d_W pass), and prints the sums of each launch
per phase, with ``nvidia-smi``'s name and power limit of the card.  The
one-block bf16 forms keep W (K2: W2) in shared memory where it fits: their
"waits for a staged chunk" read 0.  It
checks nothing: ``chip_smoke.py`` holds the kernels against their plain
versions, on a build without the clocks.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from point_cloud_classifier_tpu_torch import native
from point_cloud_classifier_tpu_torch.ops.fused_phi import _phi_pool_bwd_cuda, _phi_pool_cuda, phi_pool

SPEC = (("plain", False), ("residual", False))  # φ [256, 256] with residual_block
# (name, events, point rows, φ width, element types, φ layers)
BOTH = (torch.float32, torch.bfloat16)
SHAPES = (("config", 32, 8192, 256, BOTH, 2),
          ("flagship", 256, 65536, 256, BOTH, 2),
          ("phi 512", 256, 65536, 512, BOTH, 2),
          ("phi 1024", 256, 65536, 1024, BOTH, 2),
          ("phi 256 × 3", 256, 65536, 256, (torch.float32,), 3),
          ("phi 512 × 3", 256, 65536, 512, (torch.float32,), 3),
          ("tail", 256, 65536, 256, BOTH, 1),
          ("tail 1024", 256, 65536, 1024, (torch.bfloat16,), 1))
# a consumer thread's (the producers stage W apart): per chunk of W the wait
# for its stage, the products; per layer the barrier after them, the
# epilogue and the barriers around it; per tile the wait for its points, the
# pool
STREAMED = ("set-up", "tile's points", "waits for a staged chunk", "products", "layer's barrier",
            "before the epilogue", "epilogue", "after the epilogue", "pool")
K1_PHASES = {
    "sliced": ("set-up", "inputs", "first layer", "barrier", "product and layer", "pool", "barrier"),
    "tf32x3": STREAMED,
    # the last layer's epilogue apart: it writes no neighbour's h
    "wide": STREAMED + ("last layer's epilogue",),
}
K2_PHASES = {
    "sliced": ("set-up", "inputs", "g and first layer", "barrier", "recompute", "dz", "d_W",
               "share of dz·Wᵀ", "barrier", "first layer's gradients", "d_points", "barrier", "slab"),
    # the row pass's consumer thread: per tile its points, h1 between its two
    # cluster barriers, the two products' waits for staged chunks, the
    # products and the barrier after each, dz2 between its barriers, d_b2, dz1,
    # d_W1 (and d_points); at the end the slab
    "wide": ("set-up", "tile's points", "before h1", "h1", "after h1", "waits for a staged chunk",
             "products", "products' barrier", "before dz2", "dz2", "after dz2", "d_b2", "dz1",
             "d_W1 and d_points", "slab"),
}
# f32 K2's tf32x3 variant marks its row pass as the wide one does, each
# square layer's epilogue (its output forward, the layer below's dz back)
# where the wide one marks dz2's, each layer's d_b where it marks d_b2; the
# tail's row product for d_points (per tile its rows of g, per chunk the wait
# and the products, the barrier after them, the epilogue's stores); the d_W
# pass of both variants (block 0, a thread of the first warp) marks from
# phase 16 on: per stage of 32 rows the wait for their copies, the products
# (and the adds into the block's sums in f32), the tail's column sums of d_b
# and the next copies issued; the partial's stores at the end
K2_PHASES["tf32x3"] = K2_PHASES["wide"][:8] + ("before an epilogue", "square layers' epilogues",
                                               "after an epilogue", "d_b") + K2_PHASES["wide"][12:]
K2_TAIL_ROWS = ("set-up", "tile's rows of g", "waits for a staged chunk", "products", "barrier",
                "epilogue")
DW_FIRST = 16
DW_VARIANTS = ("tf32x3", "wide")  # K2's variants with a d_W pass
DW_PHASES = ("set-up", "waits for staged rows", "products and sums", "d_b and next rows", "partial")


def _inputs(b: int, p: int, dtype, width: int = 256, seed: int = 0, tail: bool = False, layers: int = 2):
    """Flat-wire points for ``b`` contiguous events in ``p`` rows (a tenth of
    the rows padding, segment ``b``) and the seeded 6 -> width -> … -> width
    chain of ``layers`` layers, or with ``tail`` width-wide points and one
    bare width -> width layer."""
    rng = np.random.default_rng(seed)
    sizes = rng.multinomial(int(p * 0.9), np.ones(b) / b)
    seg = np.full(p, b, dtype=np.int32)
    seg[: sizes.sum()] = np.repeat(np.arange(b, dtype=np.int32), sizes)
    last = width if tail else 6
    points = rng.normal(size=(p, last)).astype(np.float32)
    params = []
    for _ in range(1 if tail else layers):
        bound = last**-0.5
        params.append(tuple(
            torch.from_numpy(rng.uniform(-bound, bound, size=shape).astype(np.float32)).cuda()
            for shape in ((last, width), (width,))
        ))
        last = width
    return torch.from_numpy(points).cuda().to(dtype), torch.from_numpy(seg).cuda(), tuple(params)


def _clocks(entry, n: int, first: int = 0):
    torch.cuda.synchronize()
    out = (ctypes.c_longlong * 24)()
    if entry(ctypes.addressof(out)) != 0:
        raise RuntimeError("reading the phase clocks failed")
    return list(out)[first:first + n]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("phase_clocks: torch.cuda.is_available() is false; this runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    native.enable_phase_clocks()
    built = native.kernel_library()
    print(f"build with {native.PHASE_CLOCKS_FLAG}: {built.path.name} in {built.build_seconds:.2f} s")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bwd_clocks = built.lib.pcc_phi_pool_bwd_phase_clocks
    for name, b, p, width, dtypes, layers in SHAPES:
        tail = name.startswith("tail")
        spec = () if tail else SPEC + SPEC[1:] * (layers - 2)
        for dtype in dtypes:
            points, seg, params = _inputs(b, p, dtype, width, tail=tail, layers=layers)
            g = torch.ones((b + 1, width), device="cuda")
            rows = []
            # at φ 256 in bf16 (the wide variant's one block a tile on the
            # path) also the sliced variant, through the timing entry
            sliced = width == 256 and layers == 2  # the chain the timing entries take on the sliced variant
            for general in (False, True) if sliced and dtype == torch.bfloat16 else (False,):
                _phi_pool_cuda(points, seg, spec, params, "gelu", b + 1, general=general)
                if phi_pool.variant in K1_PHASES:
                    phases = K1_PHASES[phi_pool.variant]
                    rows.append((f"K1 {phi_pool.variant}", phases,
                                 _clocks(built.lib.pcc_phi_pool_phase_clocks, len(phases))))
            # the tail's K2 as the train step calls it (d_points on: the
            # layer's input is the chain below), the DeepSets chain's without;
            # at φ 256 also the timing entry's sliced variant
            for general in (False, True) if sliced else (False,):
                _phi_pool_bwd_cuda(points, seg, g, spec, params, "gelu", b + 1, with_points=tail,
                                   general=general)
                variant = phi_pool.bwd_variant
                if variant in K2_PHASES:
                    phases = K2_TAIL_ROWS if tail else K2_PHASES[variant]
                    pass_name = " row product" if tail else " row pass" if variant in DW_VARIANTS else ""
                    rows.append((f"K2 {variant}{pass_name}", phases, _clocks(bwd_clocks, len(phases))))
                if variant in DW_VARIANTS:
                    rows.append((f"K2 {variant} d_W pass", DW_PHASES,
                                 _clocks(bwd_clocks, len(DW_PHASES), DW_FIRST)))
            for kernel, phases, sums in rows:
                print(f"phase clocks {kernel} {name} B={b} P={p} {str(dtype)[6:]}, block 0, one launch "
                      f"({(p + 63) // 64} tiles over the grid's clusters, {sms} SMs): "
                      + "; ".join(f"{ph} {c}" for ph, c in zip(phases, sums))
                      + f"; total {sum(sums)} [{smi}]")


if __name__ == "__main__":
    main()

"""Time K2's wide (bf16) and tf32x3 (f32) variants, and f32 K1 (whose
tf32x3 products K2's share), in two source trees on one CUDA card, in turns,
to hold a change to their shared code against its parent.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit, with the parent unpacked into a git-ignored directory:

    git archive <parent> | tar -x -C _archive/parent
    python3 scripts/k2_ab.py _archive/parent .

Each tree runs in a process of its own (both hold a package of the same
name), in the order parent, change, change, parent, and builds its own
kernels on its first run.  A run times K2 on the device alone (CUDA-graph
replay, as ``chip_smoke.py``'s ``graph_ms``) at B=256, P=65,536: bf16 and
f32 at φ [256, 256], [512, 512] and [1024, 1024] residual without
``d_points`` (the wide and the tf32x3 variants, the d_W pass of both; at φ
256 the one-block forms), and the f32 tail's bare [256, 256] layer with
``d_points``; f32 K1 at φ [256, 256], [512, 512] and [1024, 1024]
residual at B=256; and at φ [256, 256] also at B=32, P=8,192 (the DeepSets
config batch), and at both batches through the timing entry
(``_phi_pool_bwd_cuda(general=True)``: the sliced variant, a 4-block
cluster a tile, in either tree).  A tree whose K2 at φ 256 is the sliced variant (a parent
before the one-block forms) reads the sliced variant in both rows.  It
prints one line a run and, last, the median of each case over the runs of
each tree, beside ``nvidia-smi``'s name and power limit.  It checks
nothing: ``chip_smoke.py`` and the card tests do.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SEED = 0
FLAGSHIP, CONFIG = (256, 65_536), (32, 8_192)  # (events B, point rows P)
# (name, element type, φ width, (B, P), timing entry)
CASES = (("bf16 phi 256", "bfloat16", 256, FLAGSHIP, False),
         ("bf16 phi 256 timing entry", "bfloat16", 256, FLAGSHIP, True),
         ("bf16 phi 256 B=32", "bfloat16", 256, CONFIG, False),
         ("bf16 phi 256 B=32 timing entry", "bfloat16", 256, CONFIG, True),
         ("f32 phi 256", "float32", 256, FLAGSHIP, False),
         ("f32 phi 256 timing entry", "float32", 256, FLAGSHIP, True),
         ("f32 phi 256 B=32", "float32", 256, CONFIG, False),
         ("f32 phi 256 B=32 timing entry", "float32", 256, CONFIG, True),
         ("bf16 phi 512", "bfloat16", 512, FLAGSHIP, False), ("bf16 phi 1024", "bfloat16", 1024, FLAGSHIP, False),
         ("f32 phi 512", "float32", 512, FLAGSHIP, False), ("f32 phi 1024", "float32", 1024, FLAGSHIP, False),
         ("f32 tail", "float32", 256, FLAGSHIP, False),
         ("f32 K1 phi 256", "float32", 256, FLAGSHIP, False), ("f32 K1 phi 512", "float32", 512, FLAGSHIP, False),
         ("f32 K1 phi 1024", "float32", 1024, FLAGSHIP, False))


def graph_ms(torch, fn, iters=10, replays=3) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def run_tree() -> None:
    """One tree's times (the working directory is the tree), as JSON."""
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    from point_cloud_classifier_tpu_torch.ops import fused_phi

    rng = np.random.default_rng(SEED)
    segs = {(b, p): torch.from_numpy(np.sort(rng.integers(0, b + 1, size=p)).astype(np.int32)).cuda()
            for b, p in (FLAGSHIP, CONFIG)}
    out = {}
    for name, dtype_name, width, (B, P), general in CASES:
        seg = segs[B, P]
        dtype = getattr(torch, dtype_name)
        tail = "tail" in name
        last = width if tail else 6
        points = torch.from_numpy(rng.normal(size=(P, last)).astype(np.float32)).cuda().to(dtype)
        params = []
        for _ in range(1 if tail else 2):
            bound = last ** -0.5
            params.append(tuple(torch.from_numpy(rng.uniform(-bound, bound, size=s).astype(np.float32)).cuda()
                                .to(dtype) for s in ((last, width), (width,))))
            last = width
        spec = () if tail else (("plain", False), ("residual", False))
        g = torch.from_numpy(rng.normal(size=(B + 1, width)).astype(np.float32)).cuda()
        if "K1" in name:
            kernel = lambda: fused_phi.phi_pool(points, seg, spec, tuple(params), "gelu", B + 1)  # noqa: E731
        else:
            kernel = lambda: fused_phi._phi_pool_bwd_cuda(  # noqa: E731
                points, seg, g, spec, tuple(params), "gelu", B + 1, with_points=tail, general=general)
        kernel()
        variant = fused_phi.phi_pool.variant if "K1" in name else fused_phi.phi_pool.bwd_variant
        out[name] = {"variant": variant, "ms": graph_ms(torch, kernel)}
        del points, params, g
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main() -> None:
    if len(sys.argv) == 2 and sys.argv[1] == "--run":
        run_tree()
        return
    if len(sys.argv) != 3:
        raise SystemExit("usage: python3 scripts/k2_ab.py PARENT_TREE CHANGE_TREE")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k2_ab: torch.cuda.is_available() is false; this runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    trees = {"parent": os.path.abspath(sys.argv[1]), "change": os.path.abspath(sys.argv[2])}
    here = os.path.abspath(__file__)
    runs = {"parent": [], "change": []}
    for label in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, here, "--run"], cwd=trees[label], check=True,
                              capture_output=True, text=True)
        reading = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[label].append(reading)
        print(f"{label}: " + "; ".join(f"{k} [{v['variant']}] {v['ms']:.4f} ms" for k, v in reading.items())
              + f" [{smi}]", flush=True)
    for name, *_ in CASES:
        med = {label: statistics.median(r[name]["ms"] for r in rs) for label, rs in runs.items()}
        print(f"median {name}: change {med['change']:.4f} ms, parent {med['parent']:.4f} ms, "
              f"change / parent {med['change'] / med['parent']:.4f} [{smi}]")


if __name__ == "__main__":
    main()

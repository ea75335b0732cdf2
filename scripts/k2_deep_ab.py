"""Time f32 K1 and K2 at the hyperparameter sweep's deeper chains in two
source trees on one CUDA card, in turns, to hold a change to K2's row pass
of two or three square layers (and to the products K1 shares) against
another tree.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit, with the other tree unpacked into a git-ignored directory:

    git archive <commit> | tar -x -C _archive/other
    python3 scripts/k2_deep_ab.py _archive/other .

Each tree runs in a process of its own, in the order first, second, second,
first, and builds its own kernels on its first run.  A run times K2 without
``d_points`` and K1, f32, on the device alone (CUDA-graph replay, as
``chip_smoke.py``'s ``graph_ms``) at B=256, P=65,536, φ [d] × n residual
(gelu) for CHAINS, and prints one line a run and, last, the median of each
case over each tree's runs, with ``nvidia-smi``'s name and power limit.  The
trees must both take the tf32x3 variant at these chains (the general one
takes some 0.1–0.3 s a call at φ 1024).  It checks nothing:
``chip_smoke.py`` and the card tests do.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CHAINS = ((128, 3), (256, 2), (256, 3), (256, 4), (512, 2), (512, 3), (512, 4), (1024, 3))  # (d, n)
B, P = 256, 65_536


def graph_ms(torch, fn, iters=5, replays=2) -> float:
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

    rng = np.random.default_rng(0)
    seg = torch.from_numpy(np.sort(rng.integers(0, B + 1, size=P)).astype(np.int32)).cuda()
    points = torch.from_numpy(rng.normal(size=(P, 6)).astype(np.float32)).cuda()
    out = {}
    for width, n in CHAINS:
        dims = [6] + [width] * n
        params = tuple(tuple(torch.from_numpy(rng.uniform(-i**-0.5, i**-0.5, shape).astype(np.float32)).cuda()
                             for shape in ((i, o), (o,)))
                       for i, o in zip(dims[:-1], dims[1:]))
        spec = (("plain", False),) + (("residual", False),) * (n - 1)
        g = torch.ones(B + 1, width, device="cuda")
        k2 = lambda: fused_phi._phi_pool_bwd_cuda(  # noqa: E731
            points, seg, g, spec, params, "gelu", B + 1, with_points=False)
        k1 = lambda: fused_phi.phi_pool(points, seg, spec, params, "gelu", B + 1)  # noqa: E731
        out[f"K2 [{width}] × {n}"] = graph_ms(torch, k2)
        out[f"K1 [{width}] × {n}"] = graph_ms(torch, k1)
    print(json.dumps(out))


def main() -> None:
    if len(sys.argv) == 2 and sys.argv[1] == "--run":
        run_tree()
        return
    if len(sys.argv) != 3:
        raise SystemExit("usage: python3 scripts/k2_deep_ab.py FIRST_TREE SECOND_TREE")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k2_deep_ab: torch.cuda.is_available() is false; this runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    trees = {"first": os.path.abspath(sys.argv[1]), "second": os.path.abspath(sys.argv[2])}
    here = os.path.abspath(__file__)
    runs = {"first": [], "second": []}
    for label in ("first", "second", "second", "first"):
        proc = subprocess.run([sys.executable, here, "--run"], cwd=trees[label], check=True,
                              capture_output=True, text=True)
        runs[label].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{label}: " + "; ".join(f"{k} {v:.4f} ms" for k, v in runs[label][-1].items()) + f" [{smi}]",
              flush=True)
    for name in runs["first"][0]:
        med = {label: statistics.median(r[name] for r in rs) for label, rs in runs.items()}
        print(f"median {name}: first {med['first']:.4f} ms, second {med['second']:.4f} ms, "
              f"second / first {med['second'] / med['first']:.4f} [{smi}]")


if __name__ == "__main__":
    main()

"""Times of the in-row graph kernels K3 (GAT attention, ``ops/gat.py``) and
K6 (in-row aggregation, ``ops/inrow_graph.py``) on one CUDA card, by CUDA
events and by the profiler's device rows.

Run from a checkout's root, on a machine with a card and the CUDA toolkit:

    python3 -m point_cloud_classifier_tpu_torch.graph_kernel_times

It times the kernels of the package it is run from, at the shapes of
``configs/graph_net.yaml`` on lineage graphs (``data/synthetic.py``) from a
fixed seed, the inputs ``chip_smoke.py`` builds for the same cases: K3 at the
config batch (32 graphs of 160–288 nodes, M = 288) and the flagship (256
graphs of 256 nodes), C = 128 in 4 heads, D = 8; K6 forward (in-rows) and
backward (out-rows) at the config batch and the flagship (256 graphs, M =
288), widths 128 (``hidden_dim``) and 4 (``input_dim``, conv1's input), f32
and bf16.  It uses only entry points that the package has had since K3 and
K6 were first ported, so a copy of this file times an older checkout's
kernels too (copy it into that checkout's package and run it there): that
is how two versions are compared on one card, in turns.  Where the package
chooses between forms of K3 and layouts of K6 (``ops.gat.attention_form``,
``ops.inrow_graph.aggregate_form``), it also times the others at the same
inputs.

Events read the host below ~0.05 ms (the wrapper's own time); the device
rows are the kernels' time on the card.  Each line carries the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from point_cloud_classifier_tpu_torch.data import GraphLoader
from point_cloud_classifier_tpu_torch.data.synthetic import lineage_graphs
from point_cloud_classifier_tpu_torch.native import kernel_library
from point_cloud_classifier_tpu_torch.ops import gat, inrow_graph

SEED = 0
HEADS, CHANNELS = 4, 128  # GAT: 4 heads of 32 over hidden_dim 128
WIDTHS = (128, 4)  # K6: hidden_dim, and input_dim (conv1's input features)
GAT_SHAPES = {"config B=32": (32, 160, 288), "flagship B=256 M=256": (256, 256, 256)}
INROW_SHAPES = {"config B=32": 32, "flagship B=256": 256}
ITERS = 20


def events_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Mean ms a call by CUDA events around ``iters`` calls after a warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_ms(fn, iters: int = ITERS, warmup: int = 3):
    """(device ms a call, kernels a call) from torch.profiler's device rows
    over ``iters`` calls after a warm-up; (None, 0) where the profiler
    recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(_device_us(e) for e in rows)
    if busy <= 0:
        return None, 0
    return busy / 1e3 / iters, sum(e.count for e in rows) / iters


def gat_inputs(b: int, lo: int, hi: int, dtype, seed: int = SEED):
    """(s_dst, s_src, in_src, in_w, xw) on the card: one dense in-row batch
    of ``b`` lineage graphs of ``lo``–``hi`` nodes, random scores and xw."""
    rng = np.random.default_rng(seed)
    loader = GraphLoader(lineage_graphs(rng, b, lo, hi), b, shuffle=False, layout="dense",
                         use_weights=False, transfer_dtype="float32")
    batch = next(iter(loader))
    b, m, _ = batch["in_src"].shape
    dev = torch.device("cuda")
    s_dst, s_src = (torch.from_numpy(rng.normal(size=(b, m, HEADS)).astype(np.float32)).to(dev)
                    for _ in range(2))
    xw = torch.from_numpy(rng.normal(size=(b, m, CHANNELS)).astype(np.float32)).to(dev, dtype)
    return s_dst, s_src, torch.from_numpy(batch["in_src"]).to(dev), torch.from_numpy(batch["in_w"]).to(dev), xw


def inrow_inputs(b: int, width: int, dtype, seed: int = SEED):
    """(h, in_src, in_w, out_dst, out_w) on the card: one weighted dense
    in-row batch of ``b`` lineage graphs with its out-rows, random h."""
    rng = np.random.default_rng(seed)
    loader = GraphLoader(lineage_graphs(rng, b), b, shuffle=False, layout="dense", use_weights=True,
                         transfer_dtype="float32", emit_out_rows=True)
    batch = next(iter(loader))
    lists = [torch.from_numpy(batch[k]).cuda() for k in ("in_src", "in_w", "out_dst", "out_w")]
    b, m, _ = lists[0].shape
    h = torch.from_numpy(rng.normal(size=(b, m, width)).astype(np.float32)).to("cuda", dtype)
    return (h, *lists)


def _gat_forms(dtype):
    """(label, form) of each form of K3 to time: the package's own choice
    first, then the others it can take at C = 128."""
    if not hasattr(gat, "attention_form"):
        return [("the kernel", None)]
    chosen = gat.attention_form(HEADS, CHANNELS, 8, dtype)
    pieces = CHANNELS * dtype.itemsize // 16
    forms = [(f"chosen: piece form, {chosen} piece{'s' * (chosen > 1)} a lane", None), ("channel form", 0)]
    return forms + [(f"piece form, {per} piece{'s' * (per > 1)} a lane", per) for per in (1, 2)
                    if per != chosen and pieces <= 16 * per]


def _inrow_forms(width: int, dtype):
    """(label, form) of each layout of K6 to time: the package's own choice
    first, then half and twice its lanes a node, and a channel a piece where
    it takes 16-byte pieces."""
    if not hasattr(inrow_graph, "aggregate_form"):
        return [("", None)]
    vec, lanes = inrow_graph.aggregate_form(width, dtype)
    forms = [(f"chosen: {_layout(vec, lanes)}", None)]
    forms += [(_layout(vec, other), (vec, other)) for other in (lanes // 2, 2 * lanes) if 1 <= other <= 32]
    if vec > 1:
        channel_lanes = min(32, 1 << max(0, -(-width // 2) - 1).bit_length())
        forms.append((_layout(1, channel_lanes), (1, channel_lanes)))
    return forms


def _layout(vec: int, lanes: int) -> str:
    return f"{vec} channel{'s' * (vec > 1)} a piece, {lanes} lane{'s' * (lanes > 1)} a node"


def gat_times(smi: str) -> None:
    for name, (b, lo, hi) in GAT_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = gat_inputs(b, lo, hi, dtype)
            with torch.no_grad():
                ref = gat.gat_attention(*args)
                for label, form in _gat_forms(dtype):
                    if form is None:
                        fn = lambda: gat.gat_attention(*args)  # noqa: E731
                    else:
                        fn = lambda: gat._gat_attention_cuda(*args, form=form)  # noqa: E731
                    diff = (fn().float() - ref.float()).abs().max().item()
                    ev = events_ms(fn)
                    dev, launches = device_ms(fn)
                    shown = "not measured" if dev is None else f"{dev:.4f} ms ({launches:g} kernels a call)"
                    print(f"K3 {name} B,M,D={tuple(args[2].shape)} H={HEADS} C={CHANNELS} "
                          f"{str(dtype)[6:]} [{label}]: events {ev:.4f} ms, device {shown}; "
                          f"max |Δ| against the chosen form {diff:.3e} [{smi}]")


def inrow_times(smi: str) -> None:
    for name, b in INROW_SHAPES.items():
        for width in WIDTHS:
            for dtype in (torch.float32, torch.bfloat16):
                h, in_src, in_w, out_dst, out_w = inrow_inputs(b, width, dtype)
                with torch.no_grad():
                    for way, lists, backward in (("forward", (in_src, in_w), False),
                                                 ("backward", (out_dst, out_w), True)):
                        ref = inrow_graph._inrow_aggregate_cuda(h, *lists, "add", backward=backward)
                        for label, form in _inrow_forms(width, dtype):
                            kw = {} if form is None else {"form": form}
                            fn = lambda: inrow_graph._inrow_aggregate_cuda(  # noqa: E731
                                h, *lists, "add", backward=backward, **kw)
                            diff = (fn().float() - ref.float()).abs().max().item()
                            ev = events_ms(fn)
                            dev, launches = device_ms(fn)
                            shown = "not measured" if dev is None else f"{dev:.4f} ms ({launches:g} kernels a call)"
                            print(f"K6 {way} {name} B,M,D={tuple(lists[0].shape)} width {width} "
                                  f"{str(dtype)[6:]}{f' [{label}]' if label else ''}: events {ev:.4f} ms, device "
                                  f"{shown}; max |Δ| against the chosen layout {diff:.3e} [{smi}]")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("graph_kernel_times: torch.cuda.is_available() is false; this runs on a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    built = kernel_library()
    print(f"graph_kernel_times: {torch.cuda.get_device_name(0)}, {smi}; library {built.path.name} "
          f"built in {built.build_seconds:.2f} s")
    gat_times(smi)
    inrow_times(smi)


if __name__ == "__main__":
    main()

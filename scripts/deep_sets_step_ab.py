"""Time the DeepSets train step end to end in two source trees on one CUDA
card, in turns, to hold a change to K1 or K2 against its parent where a
user meets it.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit, with the parent unpacked into a git-ignored directory:

    git archive <parent> | tar -x -C _archive/parent
    python3 scripts/deep_sets_step_ab.py _archive/parent .

Each tree runs in a process of its own (both hold a package of the same
name), in the order parent, change, change, parent, builds its own kernels
on its first run and takes its own ``chip_smoke.py``'s measurements:

- ``fused_route_phase`` (phase 24) for bench.py's flagship (B=256 clouds
  of 256 points on the dense fp16 wire, ``energy_total`` factored, f32) and
  the DeepSets config batch (B=32): ms a micro-step of a fused window of 16
  steps (one CUDA-graph replay) and of the same steps eagerly, by CUDA
  events in turns, with the phase's own checks against the eager steps;
- the train step per batch at B=256 on the flagship wire's resident
  batches, dense and flat, f32 and bf16 (``events_ms_per_batch``, CUDA
  events over a pass, as ``flagship_times_phase``'s resident arm), and the
  device's busy ms a step and idle share over a pass under torch.profiler
  (``profile_train_steps``), with the ``cudaMalloc`` calls of the timed
  passes (``torch.cuda.memory_stats``).

It prints one line a run and, last, the median of each reading over the
runs of each tree, beside ``nvidia-smi``'s name and power limit.  With
``--pairs N`` a run takes the resident train steps' times alone, in N
pairs of runs, the parent first in every other pair, and the summary adds
the pairs the change reads lower in and the parent's quartiles:

    python3 scripts/deep_sets_step_ab.py _archive/parent . --pairs 10

With ``--k2-turns`` it times one tree (the working directory) alone: the
same resident train steps, f32 and bf16, flat and dense, with K2 through
its entry (at φ 256 the one-block forms) and through the timing entry
(``_phi_pool_bwd_cuda(general=True)``: the sliced variant), pass by pass
in turns in one process (A B B A, ``K2_TURNS`` rounds), so that two trees'
processes, their placement on the host's cores and the time between them
are out of the comparison.  Each arm reads the step's ms per batch by
CUDA events over a pass, the host's ms per step to the last step's return
(before the pass synchronises), K2's host call alone, and under
torch.profiler the device's busy ms a step and the idle share:

    python3 scripts/deep_sets_step_ab.py --k2-turns
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile


def run_tree(resident_only: bool = False) -> None:
    """One tree's readings (the working directory is the tree), as JSON;
    ``resident_only``: the resident train steps' times alone."""
    import copy

    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from point_cloud_classifier_tpu_torch import factory
    from point_cloud_classifier_tpu_torch.data.pointcloud import PointCloudLoader
    from point_cloud_classifier_tpu_torch.data.resident import ResidentCache
    from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache
    from point_cloud_classifier_tpu_torch.models import DeepSets

    with contextlib.redirect_stdout(io.StringIO()):
        smi = cs.device_phase()
    out = {}
    # phase 24's two DeepSets routes, as fused_routes_phase builds them
    rng = np.random.default_rng(cs.SEED + 24)
    clouds = [rng.normal(size=(256, 6)).astype(np.float32) for _ in range(4 * cs.FLAGSHIP_B)]
    for c in clouds:
        c[:, 1] = rng.normal()
    flagship = PointCloudLoader(clouds, rng.integers(0, 2, size=len(clouds)), cs.FLAGSHIP_B, False,
                                layout="dense", transfer_dtype="float16", factor_event_cols=[1])
    ds = copy.deepcopy(cs.CONFIG["model"])

    def deep_sets(**extra):
        return lambda seed: DeepSets(**{**ds, **extra}, generator=torch.Generator().manual_seed(seed))

    clouds32, labels32 = cs.make_clouds(np.random.default_rng(cs.SEED + 25), 24 * cs.CONFIG_B)
    phi = ("phi_pool", "phi_pool_bwd")
    for label, make, batches in () if resident_only else (
            ("flagship B=256 dense fp16 f32", deep_sets(factored_cols=[1]), list(flagship)),
            ("DeepSets B=32", deep_sets(), list(PointCloudLoader(clouds32, labels32, cs.CONFIG_B, False)))):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cs.fused_route_phase(smi, label, make, batches, "adamw", phi)
        text = printed.getvalue()
        fused = re.search(r"ms a micro-step fused ([0-9.]+)", text)
        eager = re.search(r", eager ([0-9.]+) \(", text)
        if not (fused and eager):
            raise SystemExit(f"deep_sets_step_ab: no micro-step reading in {text[-2000:]}")
        out[f"fused micro-step {label}"] = float(fused.group(1))
        out[f"eager step {label}"] = float(eager.group(1))
    # the resident train step on the flagship wire, as flagship_times_phase's
    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "flagship_data")
        write_s2ppc_cache(data_dir, n_events=cs.FLAGSHIP_EVENTS, seed=cs.SEED + 5)
        wires = {}
        for layout in ("flat", "dense"):
            cfg = cs.flagship_config(data_dir, os.path.join(work, "unused"), {}, {})
            cfg["dataset"].update(layout=layout, transfer_dtype="float16")
            wires[layout] = list(factory.get_dataloader("s2ppc", cfg).get_train_loader())
        for dtype in ("float32", "bfloat16"):
            cfg = cs.flagship_config(data_dir, os.path.join(work, "unused"), {"compute_dtype": dtype}, {})
            for layout, batches in wires.items():
                cache = ResidentCache(batches, shuffle_seed=cs.SEED)
                list(cache)  # the first pass uploads
                wrapper = factory.get_model("deep_sets", cfg)
                mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
                (samples,) = cs.events_ms_per_batch([wrapper], [lambda: cache])
                out[f"resident train step {dtype} {layout}"] = float(np.median(samples))
                out[f"resident cudaMalloc calls {dtype} {layout}"] = float(
                    torch.cuda.memory_stats().get("num_device_alloc", 0) - mallocs)
                if resident_only:
                    continue
                printed = io.StringIO()
                with contextlib.redirect_stdout(printed):
                    cs.profile_train_steps(smi, f"{dtype} {layout}", wrapper, list(cache))
                busy = re.search(r"device busy ([0-9.]+) ms/step of [0-9.]+ ms/step wall, idle share ([0-9.]+)",
                                 printed.getvalue())
                if busy:  # the profiler saw device time
                    out[f"resident device busy {dtype} {layout}"] = float(busy.group(1))
                    out[f"resident idle share {dtype} {layout}"] = float(busy.group(2))
    print(json.dumps(out))


K2_TURNS = 10  # rounds of A B B A passes in --k2-turns


def k2_turns() -> None:
    """The resident train steps with K2's two entries in turns, one process."""
    import functools
    import time

    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from point_cloud_classifier_tpu_torch import factory
    from point_cloud_classifier_tpu_torch.data.resident import ResidentCache
    from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache
    from point_cloud_classifier_tpu_torch.ops import fused_phi

    with contextlib.redirect_stdout(io.StringIO()):
        smi = cs.device_phase()
    entry = fused_phi._phi_pool_bwd_cuda
    host_calls = []

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host_calls.append(time.perf_counter() - t0)
            return out
        return call

    arms = {"entry": timed(entry), "timing entry": timed(functools.partial(entry, general=True))}
    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "flagship_data")
        write_s2ppc_cache(data_dir, n_events=cs.FLAGSHIP_EVENTS, seed=cs.SEED + 5)
        wires = {}
        for layout in ("flat", "dense"):
            cfg = cs.flagship_config(data_dir, os.path.join(work, "unused"), {}, {})
            cfg["dataset"].update(layout=layout, transfer_dtype="float16")
            wires[layout] = list(factory.get_dataloader("s2ppc", cfg).get_train_loader())
        try:
            for dtype in ("bfloat16", "float32"):
                cfg = cs.flagship_config(data_dir, os.path.join(work, "unused"), {"compute_dtype": dtype}, {})
                for layout, batches in wires.items():
                    cache = ResidentCache(batches, shuffle_seed=cs.SEED)
                    list(cache)  # the first pass uploads
                    wrapper = factory.get_model("deep_sets", cfg)
                    reads = {arm: {"step": [], "host": [], "k2 host": []} for arm in arms}
                    variants = {}
                    for turn in range(4 * K2_TURNS + 2):
                        arm = list(arms)[(turn + turn // 2) % 2]  # A B B A …
                        fused_phi._phi_pool_bwd_cuda = arms[arm]
                        del host_calls[:]
                        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        n = 0
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        start.record()
                        for batch in cache:
                            wrapper.train_step(batch)
                            n += 1
                        end.record()
                        host = time.perf_counter() - t0
                        torch.cuda.synchronize()
                        variants[arm] = fused_phi.phi_pool.bwd_variant
                        if turn < 2:
                            continue  # a warm-up pass an arm
                        reads[arm]["step"].append(start.elapsed_time(end) / n)
                        reads[arm]["host"].append(1e3 * host / n)
                        reads[arm]["k2 host"].append(1e3 * float(np.median(host_calls)))
                    for arm in arms:
                        fused_phi._phi_pool_bwd_cuda = arms[arm]
                        printed = io.StringIO()
                        with contextlib.redirect_stdout(printed):
                            cs.profile_train_steps(smi, arm, wrapper, list(cache))
                        busy = re.search(r"device busy ([0-9.]+) ms/step of [0-9.]+ ms/step wall, idle share "
                                         r"([0-9.]+)", printed.getvalue())
                        med = {k: statistics.median(v) for k, v in reads[arm].items()}
                        print(f"k2 turns {dtype} {layout}, K2 through the {arm} [{variants[arm]}]: step "
                              f"{med['step']:.4f} ms (events, {len(reads[arm]['step'])} passes, "
                              f"{min(reads[arm]['step']):.4f}–{max(reads[arm]['step']):.4f}), host to the last "
                              f"step's return {med['host']:.4f} ms, K2's host call {med['k2 host']:.4f} ms"
                              + (f", device busy {busy.group(1)} ms/step, idle share {busy.group(2)}" if busy
                                 else ", the profiler saw no device time") + f" [{smi}]", flush=True)
        finally:
            fused_phi._phi_pool_bwd_cuda = entry


def main() -> None:
    if len(sys.argv) == 2 and sys.argv[1] in ("--run", "--run-resident"):
        run_tree(resident_only=sys.argv[1] == "--run-resident")
        return
    if len(sys.argv) == 2 and sys.argv[1] == "--k2-turns":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("deep_sets_step_ab: torch.cuda.is_available() is false; this runs on a GPU")
        k2_turns()
        return
    pairs = int(sys.argv[4]) if len(sys.argv) == 5 and sys.argv[3] == "--pairs" else 0
    if len(sys.argv) != 3 and not pairs:
        raise SystemExit("usage: python3 scripts/deep_sets_step_ab.py PARENT_TREE CHANGE_TREE [--pairs N] "
                         "| --k2-turns")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("deep_sets_step_ab: torch.cuda.is_available() is false; this runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    trees = {"parent": os.path.abspath(sys.argv[1]), "change": os.path.abspath(sys.argv[2])}
    here = os.path.abspath(__file__)
    runs = {"parent": [], "change": []}
    order = [label for i in range(pairs) for label in (("parent", "change") if i % 2 == 0 else ("change", "parent"))]
    for label in order or ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, here, "--run-resident" if pairs else "--run"], cwd=trees[label],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"deep_sets_step_ab: the {label} tree failed:\n{proc.stderr[-4000:]}")
        reading = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[label].append(reading)
        print(f"{label}: " + "; ".join(f"{k} {v:.4f}" for k, v in reading.items()) + f" [{smi}]",
              flush=True)
    # a reading every run took (the profiler may see no device time)
    for name in [k for k in runs["change"][0] if all(k in r for rs in runs.values() for r in rs)]:
        med = {label: statistics.median(r[name] for r in rs) for label, rs in runs.items()}
        ratio = f", change / parent {med['change'] / med['parent']:.4f}" if med["parent"] else ""
        if pairs > 1:  # the pairs the change reads lower in, and the parent's own spread
            lower = sum(c[name] < p[name] for c, p in zip(runs["change"], runs["parent"]))
            q1, _, q3 = statistics.quantiles([r[name] for r in runs["parent"]], n=4)
            ratio += f"; change lower in {lower} of {pairs} pairs, the parent's quartiles {q1:.4f}–{q3:.4f}"
        print(f"median {name} (ms, but the counts and the idle share): change {med['change']:.4f}, parent "
              f"{med['parent']:.4f}{ratio} [{smi}]")


if __name__ == "__main__":
    main()

"""Accuracy parity of the PyTorch port against the JAX package, on the CPU.

The north star asks the port for trained val accuracy within ±0.5% of the
reference on the four configs of ``BASELINE.md``'s accuracy-parity table.
This script is the port's arm of ``scripts/measure_parity.py``: it builds the
synthetic caches with the JAX pipeline as that script does, then trains the
JAX package ("Ours" in ``BASELINE.md``) and the port (``device="cpu"``) from
the configs in ``configs/`` on the same caches with the same seeds, and
prints each config's val accuracy on both sides and the difference.  Each
side draws its initial weights from the seed with its own generator, so a
run's Δ holds seed noise as well; the means over seeds are what compare.

Setups (``BASELINE.md``'s): 200 events a file (400 + 400) and 3 seeds for
the logistic regression, the FCN and DeepSets; 400 events a file and 5 seeds
for GraphNet.

Usage (from the repository root):

    python scripts/measure_parity_torch.py [--models ...] [--events N]
        [--repeats N] [--epochs N] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from measure_parity import _prepare_data, _quiet, _val_acc, train_ours  # noqa: E402

# model: (events a file, seeds), BASELINE.md's accuracy-parity setups
SETUPS = {
    "logistic_regression": (200, 3),
    "fully_connected_net": (200, 3),
    "deep_sets": (200, 3),
    "graph_net": (400, 5),
}


def train_port(model_name: str, data_dir: str, run_root: str, seed: int, epochs=None) -> float:
    """The port's ``train_model`` on the CPU from the same config files and
    overrides as ``measure_parity.train_ours``; its val accuracy."""
    from point_cloud_classifier_tpu_torch.factory import MODEL_DATASETS
    from point_cloud_classifier_tpu_torch.train import train_model
    from point_cloud_classifier_tpu_torch.utils.config import load_config

    config = load_config(
        os.path.join(REPO, "configs", "base.yaml"),
        os.path.join(REPO, "configs", f"{model_name}.yaml"),
    )
    config["dataset"]["data_dir"] = data_dir
    config["logging"]["log_dir"] = os.path.join(run_root, f"port_{model_name}_{seed}")
    if epochs and "trainer" in config:
        config["trainer"]["epochs"] = epochs
    if "trainer" in config:
        config["trainer"]["seed"] = seed
    with _quiet():
        log_dir = train_model(model_name, MODEL_DATASETS[model_name], config, return_log_dir=True,
                              device="cpu")
    return _val_acc(log_dir)


def measure(models, events=None, repeats=None, epochs=None, work=None) -> dict:
    """Per model: both sides' val accuracies per seed, their means and Δ
    (port − JAX).  ``events`` and ``repeats`` override the setups."""
    own = work is None
    work = work or tempfile.mkdtemp(prefix="parity_torch_")
    results, prepared = {}, {}
    try:
        for model in models:
            n_events, seeds = SETUPS[model]
            n_events, seeds = events or n_events, repeats or seeds
            data_dir = os.path.join(work, f"data_{n_events}")
            if n_events not in prepared:
                _prepare_data(data_dir, n_events, seed=0)
                prepared[n_events] = data_dir
            run_root = os.path.join(work, "runs")
            jax_runs, port_runs = [], []
            for seed in range(seeds):
                jax_runs.append(train_ours(model, data_dir, run_root, seed=seed, epochs=epochs))
                port_runs.append(train_port(model, data_dir, run_root, seed=seed, epochs=epochs))
                print(f"  {model} seed {seed}: jax={jax_runs[-1]:.4f} port={port_runs[-1]:.4f}")
            results[model] = {
                "events_per_file": n_events,
                "seeds": seeds,
                "jax_val_acc": float(np.mean(jax_runs)),
                "port_val_acc": float(np.mean(port_runs)),
                "jax_std": float(np.std(jax_runs)),
                "port_std": float(np.std(port_runs)),
                "jax_runs": jax_runs,
                "port_runs": port_runs,
                "delta": float(np.mean(port_runs) - np.mean(jax_runs)),
            }
            r = results[model]
            print(f"{model}: JAX {r['jax_val_acc']:.4f} ± {r['jax_std']:.4f}  port "
                  f"{r['port_val_acc']:.4f} ± {r['port_std']:.4f}  Δ {r['delta']:+.4f}  (CPU)")
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", nargs="+", default=list(SETUPS), choices=list(SETUPS))
    parser.add_argument("--events", type=int, default=None, help="events a file (default: the setup's)")
    parser.add_argument("--repeats", type=int, default=None, help="seeds (default: the setup's)")
    parser.add_argument("--epochs", type=int, default=None, help="override the configs' epochs")
    parser.add_argument("--json", default=None, help="also write the results here")
    args = parser.parse_args(argv)
    results = measure(args.models, args.events, args.repeats, args.epochs)
    print(json.dumps(results, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()

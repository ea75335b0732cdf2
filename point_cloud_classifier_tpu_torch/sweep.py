"""Random hyperparameter search with a persistent leaderboard.

Counterpart of the repository's ``sweep.py``, with the same arguments,
choices and defaults::

    python -m point_cloud_classifier_tpu_torch.sweep <model> [--vmap] [--seed S] …

- the samplers (:func:`fully_connected_net_config`, :func:`deep_sets_config`,
  :func:`graph_net_config`) draw from the global ``np.random`` in the JAX
  sweep's order, so ``--seed s`` samples its configurations dict for dict;
- :func:`run_search` trains one sampled configuration at a time through the
  port's ``train.train_model`` (``trainer.epochs`` forced, ``state_every:
  0``), rewrites ``search_results.json`` after every run, and appends a
  failed run to ``status_log.txt`` and searches on; between runs it drops the
  run's memory with ``gc.collect()`` and ``torch.cuda.empty_cache()``, as the
  original torch reference's sweep did;
- :func:`run_search_vmapped` (``--vmap``) samples every configuration up
  front, groups them by model, dataset and optimizer, and trains each group's
  arms together (``parallel/vmap_sweep.train_configs_vmapped``), failures
  isolated per group and per arm; each arm gets its ``version_N`` directory
  with ``config.yaml``, ``meta.json``, ``model.pt`` and, where its val loss
  ever improved, ``best_model.pt``: torch ``state_dict``s under
  ``convert.py``'s keys, so ``python -m point_cloud_classifier_tpu_torch
  evaluate <version_dir>`` scores a sweep's winner.

Runs go to the card and raise where there is none; ``main(argv,
device="cpu")`` and the functions' ``device`` argument run them on the CPU.
``--mesh`` raises: meshes are not ported (ROADMAP Queue 1 item 13).  The JAX
sweep's persistent compile cache has no counterpart (PyTorch compiles
nothing here).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
from copy import deepcopy

import numpy as np
import torch

from point_cloud_classifier_tpu_torch.models.wrapper import resolve_device
from point_cloud_classifier_tpu_torch.train import train_model
from point_cloud_classifier_tpu_torch.utils.config import load_config

_MESH_REFUSAL = "not ported to PyTorch yet: --mesh, the arm axis over several cards (ROADMAP Queue 1 item 13)"


def fully_connected_net_config(config):
    hp_config = deepcopy(config)
    hp_config["trainer"]["learning_rate"] = 10 ** np.random.uniform(-4, -2)
    hidden_dim = int(np.random.choice([32, 64, 128, 256]))
    n_layers = int(np.random.choice([2, 3, 4]))
    hp_config["model"]["hidden_layers"] = [hidden_dim] * n_layers
    hp_config["model"]["batch_normalization"] = bool(np.random.choice([True, False]))
    hp_config["dataset"]["batch_size"] = int(np.random.choice([32, 64]))
    return hp_config


def deep_sets_config(config):
    hp_config = deepcopy(config)

    phi_dim = int(np.random.choice([128, 256, 512, 1024]))
    phi_n_layers = int(np.random.choice([1, 2, 3, 4]))
    hp_config["model"]["phi_layers"] = [phi_dim] * phi_n_layers

    rho_dim = int(np.random.choice([128, 256, 512, 1024]))
    rho_n_layers = int(np.random.choice([1, 2, 3]))
    hp_config["model"]["rho_layers"] = [rho_dim] * rho_n_layers

    hp_config["model"]["activation"] = str(np.random.choice(["gelu", "silu"]))
    hp_config["model"]["residual_block"] = bool(np.random.choice([True, False]))
    hp_config["trainer"]["learning_rate"] = 10 ** np.random.uniform(-4, -2)
    hp_config["dataset"]["batch_size"] = int(np.random.choice([16, 32, 64]))
    return hp_config


def graph_net_config(config):
    hp_config = deepcopy(config)

    hp_config["model"]["hidden_dim"] = int(np.random.choice([64, 128, 256]))
    hp_config["model"]["activation"] = str(np.random.choice(["gelu", "relu", "tanh"]))
    hp_config["model"]["use_gat"] = bool(np.random.choice([True, False]))
    hp_config["model"]["gat_heads"] = int(np.random.choice([4, 8]))
    hp_config["model"]["sag_pool"] = bool(np.random.choice([True, False]))
    hp_config["model"]["pool_ratio"] = float(np.random.choice([0.3, 0.4, 0.5]))
    hp_config["model"]["local_pooling"] = str(np.random.choice(["add", "mean", "max"]))
    hp_config["model"]["global_pooling"] = str(np.random.choice(["add", "mean", "max"]))
    hp_config["model"]["deepchem_style"] = bool(np.random.choice([True, False]))

    input_dim = int(np.random.choice([1, 4]))
    hp_config["model"]["input_dim"] = input_dim
    hp_config["dataset"]["n_features"] = input_dim

    hp_config["dataset"]["use_weights"] = bool(np.random.choice([True, False]))
    hp_config["dataset"]["batch_size"] = int(np.random.choice([16, 32, 64]))

    hp_config["trainer"]["learning_rate"] = 10 ** np.random.uniform(-4, -2)
    hp_config["trainer"]["optimizer"] = str(np.random.choice(["adam", "adamw"]))
    return hp_config


_SAMPLERS = {
    "fully_connected_net": fully_connected_net_config,
    "deep_sets": deep_sets_config,
    "graph_net": graph_net_config,
}


def update_leaderboard(top_runs, version_dir):
    """Append a finished run's val accuracy; keep sorted desc."""
    meta_path = os.path.join(version_dir, "meta.json")
    if not os.path.exists(meta_path):
        print(f"WARNING: meta.json not found at {version_dir}")
        return

    with open(meta_path, "r") as f:
        meta = json.load(f)

    val_acc = meta.get("metrics", {}).get("accuracy/val", None)
    n_params = meta.get("metrics", {}).get("parameters", None)
    if val_acc is None:
        print(f"WARNING: No val_accuracy for {version_dir}")
        return

    version = version_dir.split("_")[-1]
    top_runs.append({"version": version, "val_acc": val_acc, "parameters": n_params})
    top_runs.sort(key=lambda x: x["val_acc"], reverse=True)


def save_leaderboard(top_runs, save_dir):
    with open(os.path.join(save_dir, "search_results.json"), "w") as f:
        json.dump(top_runs, f, indent=4)


def create_search_dir(search_dir, force: bool = False):
    """Confirm-then-clear a non-empty search dir (``force`` skips the prompt)."""
    if os.path.exists(search_dir) and os.listdir(search_dir):
        if not force:
            reply = input(f"Directory '{search_dir}' is NOT empty. Delete it? [y/N]: ")
            if reply.lower() != "y":
                return
        print("Clearing existing search directory")
        shutil.rmtree(search_dir)
    os.makedirs(search_dir, exist_ok=True)


def _log_failure(status_log: str, header: str, error: Exception, hp: dict) -> None:
    with open(status_log, "a") as f:
        f.write(f"{header}\n")
        f.write(f"Error: {error}\n")
        f.write("Hyperparameters:\n")
        f.write(f"{hp}\n")
        f.write("-" * 80 + "\n\n")


def _release_run_memory() -> None:
    """Between runs, what the original torch reference's sweep did: drop the
    run's objects and hand the card's cached blocks back."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _search_config(model_name, config_dir, search_dir, epochs, force, data_dir):
    if model_name not in _SAMPLERS:
        raise ValueError(f"No hyperparameter sampler for model: {model_name}")
    config = load_config(
        os.path.join(config_dir, "base.yaml"),
        os.path.join(config_dir, f"{model_name}.yaml"),
    )
    create_search_dir(search_dir=search_dir, force=force)
    config["logging"]["log_dir"] = search_dir
    config["trainer"]["epochs"] = epochs
    if data_dir is not None:
        config["dataset"]["data_dir"] = data_dir
    return config


def run_search(
    model_name: str,
    dataset_name: str,
    search_dir: str,
    max_runs: int = 2000,
    config_dir: str = "configs",
    epochs: int = 10,
    force: bool = False,
    data_dir: str = None,
    device: str = None,
):
    """Random search, one run at a time, on the card unless ``device`` says
    otherwise (``"cpu"``)."""
    device = str(resolve_device(device))  # no card: raise now, not once a run
    search_dir = os.path.abspath(search_dir)
    status_log = os.path.join(search_dir, "status_log.txt")
    config = _search_config(model_name, config_dir, search_dir, epochs, force, data_dir)
    # sweep runs are leaderboard fodder: no per-epoch resume checkpoints
    config["trainer"]["state_every"] = 0

    top_runs = []
    print(f"Starting hyperparameter search ({max_runs} runs)...")

    for i in range(max_runs):
        hp_config = _SAMPLERS[model_name](config=config)
        print(hp_config)

        try:
            version_dir = train_model(
                model_name=model_name,
                dataset_name=dataset_name,
                config=hp_config,
                return_log_dir=True,
                device=device,
            )
            update_leaderboard(top_runs=top_runs, version_dir=version_dir)
        except Exception as e:
            print(f"[Run {i}/{max_runs}] Configuration failed: {e}")
            _log_failure(status_log, f"Run {i} FAILED", e, hp_config)

        _release_run_memory()
        save_leaderboard(top_runs=top_runs, save_dir=search_dir)

    return top_runs


def run_search_vmapped(
    model_name: str,
    dataset_name: str,
    search_dir: str,
    max_runs: int = 32,
    config_dir: str = "configs",
    epochs: int = 10,
    force: bool = False,
    data_dir: str = None,
    use_mesh: bool = False,
    device: str = None,
):
    """Same-architecture configurations trained together, one group at a
    time (``parallel/vmap_sweep.py``), with the sequential search's
    artifacts: one ``version_N`` directory per sampled configuration and
    the same ``search_results.json``."""
    from point_cloud_classifier_tpu_torch.factory import get_dataloader
    from point_cloud_classifier_tpu_torch.models import DeepSets, FullyConnectedNet, GraphNet
    from point_cloud_classifier_tpu_torch.parallel.vmap_sweep import train_configs_vmapped
    from point_cloud_classifier_tpu_torch.utils.config import save_config
    from point_cloud_classifier_tpu_torch.utils.log import TrainingLogger

    if use_mesh:
        raise NotImplementedError(_MESH_REFUSAL)
    device = str(resolve_device(device))
    model_classes = {
        "fully_connected_net": FullyConnectedNet,
        "deep_sets": DeepSets,
        "graph_net": GraphNet,
    }
    model_name = model_name.lower()
    dataset_name = dataset_name.lower()
    search_dir = os.path.abspath(search_dir)
    config = _search_config(model_name, config_dir, search_dir, epochs, force, data_dir)

    # sample everything up front, then group by architecture and optimizer
    sampled = [_SAMPLERS[model_name](config=config) for _ in range(max_runs)]
    groups = {}
    for hp in sampled:
        key = json.dumps(
            {
                "model": hp["model"],
                "dataset": hp["dataset"],
                "optimizer": hp["trainer"].get("optimizer", "adam"),
            },
            sort_keys=True,
        )
        groups.setdefault(key, []).append(hp)

    status_log = os.path.join(search_dir, "status_log.txt")
    top_runs = []
    print(
        f"Starting vmapped search: {max_runs} configs in {len(groups)} "
        f"architecture groups..."
    )
    for g_i, group in enumerate(groups.values()):
        hp0 = group[0]
        try:
            # the model section too: the graph loader's layout depends on it
            dataloader = get_dataloader(
                dataset_name,
                {"dataset": dict(hp0["dataset"]), "model": dict(hp0["model"])},
            )
            result = train_configs_vmapped(
                model_classes[model_name](**hp0["model"]),
                [hp["trainer"]["learning_rate"] for hp in group],
                hp0["trainer"].get("optimizer", "adam"),
                epochs,
                dataloader.get_train_loader(),
                dataloader.get_val_loader(),
                seeds=[int(hp["trainer"].get("seed", 0)) for hp in group],
                device=device,
            )
        except Exception as e:
            # the sequential search's contract: log and keep searching
            print(f"[Group {g_i}/{len(groups)}] Configuration group failed: {e}")
            _log_failure(status_log, f"Group {g_i} ({len(group)} configs) FAILED", e, hp0)
            save_leaderboard(top_runs=top_runs, save_dir=search_dir)
            continue

        for arm, hp in enumerate(group):
            try:
                logger = TrainingLogger(model_name, dataset_name, **hp["logging"])
                version_dir = os.path.join(search_dir, f"version_{logger.get_version()}")
                hp["logging"]["log_dir"] = version_dir
                hp["meta"]["model_name"] = model_name
                hp["meta"]["dataset_name"] = dataset_name
                save_config(config=hp, log_dir=version_dir)
                # ModelWrapper.save's format, so evaluate and infer read it
                torch.save(result["final_state"][arm], os.path.join(version_dir, "model.pt"))
                if result["best_improved"][arm]:
                    torch.save(result["best_state"][arm], os.path.join(version_dir, "best_model.pt"))
                # else the val loss never improved (e.g. NaN from the first
                # epoch): the best state is the initial one, and the
                # sequential trainer writes no best checkpoint either
                logger.log_metric("accuracy/train", round(result["train_accs"][arm], 6))
                logger.log_metric("accuracy/val", round(result["val_accs"][arm], 6))
                logger.log_metric("parameters", result["n_params"])
                update_leaderboard(top_runs=top_runs, version_dir=version_dir)
            except Exception as e:
                # one arm's artifacts failing leaves the other arms and groups be
                print(f"[Group {g_i} arm {arm}] artifact write failed: {e}")
                with open(status_log, "a") as f:
                    f.write(f"Group {g_i} arm {arm} ARTIFACTS FAILED\n")
                    f.write(f"Error: {e}\n")
                    f.write(f"{hp}\n")
                    f.write("-" * 80 + "\n\n")
        del result
        _release_run_memory()
        save_leaderboard(top_runs=top_runs, save_dir=search_dir)

    return top_runs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Random hyperparameter search")
    parser.add_argument("model", choices=sorted(_SAMPLERS))
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--search-dir", default="search_runs")
    parser.add_argument("--max-runs", type=int, default=2000)
    parser.add_argument("--config-dir", default="configs")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--data-dir", default=None, help="override dataset.data_dir")
    parser.add_argument("--force", action="store_true", help="clear search dir without prompting")
    parser.add_argument(
        "--vmap",
        action="store_true",
        help="train same-architecture configs simultaneously as one vmapped step",
    )
    parser.add_argument(
        "--mesh",
        action="store_true",
        help="not ported (ROADMAP Queue 1 item 13)",
    )
    parser.add_argument(
        "--seed", type=int, default=None,
        help="seed the hyperparameter sampler (reproducible searches)",
    )
    return parser


def main(argv=None, device: str = None) -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and search, on the card
    unless ``device`` names another (``"cpu"``)."""
    from point_cloud_classifier_tpu_torch.factory import MODEL_DATASETS

    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError(_MESH_REFUSAL)
    if args.seed is not None:
        np.random.seed(args.seed)

    kwargs = dict(
        model_name=args.model,
        dataset_name=args.dataset or MODEL_DATASETS[args.model],
        search_dir=args.search_dir,
        max_runs=args.max_runs,
        config_dir=args.config_dir,
        epochs=args.epochs,
        force=args.force,
        data_dir=args.data_dir,
        device=device,
    )
    if args.vmap:
        run_search_vmapped(**kwargs)
    else:
        run_search(**kwargs)


if __name__ == "__main__":
    main()

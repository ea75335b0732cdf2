"""The command line: ``python -m point_cloud_classifier_tpu_torch <command> …``.

Counterpart of ``_build_parser`` and ``main`` in the repository's
``train.py``: the same nine subcommands, with the same arguments, choices
and defaults, all of which run, on the card (``main(argv, device="cpu")``
runs them on the CPU; the command line always means the card):
``train`` (with ``--create-dataset``, the caches built first), ``evaluate``,
``resume``, ``infer``, ``infer-raw`` (a raw shower file scored),
``serve`` (the HTTP scorer, ``server.py``), ``export``,
``create-datasets`` (``--workers`` forked processes) and ``convert``;
``--quant int8`` takes DeepSets' int8 chain in ``evaluate``, ``infer``,
``infer-raw``, ``serve`` and ``export``.  ``train --plots`` raises (ROADMAP
Queue 1 item 16).  Dataset creation runs before anything touches the card,
so its forked workers start from a process without CUDA.

Data-parallel training runs one process a card under ``torchrun``, with the
mesh asked for by ``PCC_DATA_PARALLEL=1`` / ``PCC_N_MODEL`` or the config's
``trainer.data_parallel`` / ``trainer.n_model``::

    PCC_DATA_PARALLEL=1 torchrun --nproc-per-node 4 -m point_cloud_classifier_tpu_torch train deep_sets

Rank 0 builds the cache of ``--create-dataset`` while the others wait, and
writes the run directory; a plain ``python -m`` asking for a mesh trains on
a world of one rank, and raises where more cards are visible.
"""

from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from point_cloud_classifier_tpu_torch.factory import MODEL_DATASETS, get_dataloader
from point_cloud_classifier_tpu_torch.train import (
    evaluate_model,
    infer,
    infer_raw,
    resume_training,
    train_model,
)
from point_cloud_classifier_tpu_torch.utils.config import load_config, load_yaml

# the configs whose dataset section each cache is built from
_DATASET_MODELS = {"s2pt": "fully_connected_net", "s2ppc": "deep_sets", "s2pg": "graph_net"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m point_cloud_classifier_tpu_torch",
        description="Point-cloud classifier, PyTorch on the GPU: train / evaluate",
    )
    sub = parser.add_subparsers(dest="command")

    tp = sub.add_parser("train", help="train a model")
    tp.add_argument("model", choices=sorted(MODEL_DATASETS))
    tp.add_argument("--dataset", default=None, help="default: the model's dataset")
    tp.add_argument("--config-dir", default="configs")
    tp.add_argument("--data-dir", default=None, help="override dataset.data_dir")
    tp.add_argument("--log-dir", default=None, help="override logging.log_dir")
    tp.add_argument("--epochs", type=int, default=None, help="override trainer.epochs")
    tp.add_argument("--seed", type=int, default=None, help="override trainer.seed (init RNG)")
    tp.add_argument("--plots", action="store_true", help="not ported (ROADMAP Queue 1 item 16)")
    tp.add_argument(
        "--create-dataset", action="store_true",
        help="build the dataset's cache from the raw shower files before training",
    )

    quant_help = (
        "int8: DeepSets' φ chain through s8 products (eval only); auto: int8 from a widest "
        "φ layer of 1024, float at the configs' widths"
    )
    quant = dict(default="none", choices=["none", "int8", "auto"], help=quant_help)
    ep = sub.add_parser("evaluate", help="evaluate a finished run dir")
    ep.add_argument("model_dir")
    ep.add_argument("--save-dir", default=None, help="default: <model_dir>/eval")
    ep.add_argument("--quant", **quant)

    rp = sub.add_parser("resume", help="resume an interrupted run dir")
    rp.add_argument("model_dir")

    ip = sub.add_parser("infer", help="batch inference from a run dir → CSV")
    ip.add_argument("model_dir")
    ip.add_argument("--split", default="test", choices=["train", "val", "test"])
    ip.add_argument("--output", default=None)
    ip.add_argument("--quant", **quant)

    irp = sub.add_parser("infer-raw", help="predictions for a raw shower HDF5 file → CSV")
    irp.add_argument("model_dir")
    irp.add_argument("--input", required=True, help="raw .h5 shower file")
    irp.add_argument("--output", default=None)
    irp.add_argument("--quant", **quant)

    sv = sub.add_parser(
        "serve",
        help="HTTP scoring endpoint: POST raw shower HDF5 bytes to /predict, get per-event "
        "probabilities (GET /health)",
    )
    sv.add_argument("model_dir")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--quant", **quant)

    xp = sub.add_parser("export", help="export a run dir as torch.export programs for serving")
    xp.add_argument("model_dir")
    xp.add_argument("--out-dir", default=None, help="default: <model_dir>/exported")
    xp.add_argument("--quant", **quant)
    xp.add_argument("--platforms", nargs="+", default=None)

    cp = sub.add_parser("create-datasets", help="build the caches from the raw shower files")
    cp.add_argument("--data-dir", required=True)
    cp.add_argument("--config-dir", default="configs")
    cp.add_argument(
        "--datasets", nargs="+", default=["s2pt", "s2ppc", "s2pg"],
        choices=["s2pt", "s2ppc", "s2pg"],
    )
    cp.add_argument(
        "--workers", type=int, default=1,
        help="load and preprocess the files in N forked processes (the caches equal --workers 1's)",
    )

    cv = sub.add_parser(
        "convert",
        help="convert a torch state_dict checkpoint (the original reference's or "
        "this package's) into the JAX package's checkpoint format, or back",
    )
    cv.add_argument("model", choices=["fully_connected_net", "deep_sets", "graph_net"])
    cv.add_argument("torch_ckpt", help="the checkpoint to read")
    cv.add_argument("out", help="output path (e.g. <run_dir>/model.pt)")
    cv.add_argument("--config-dir", default="configs")
    cv.add_argument(
        "--config", default=None,
        help="the run's resolved config.yaml (default: the configs/ overlay for "
        "the model; its widths must match the checkpoint's)",
    )
    cv.add_argument(
        "--to-torch", action="store_true",
        help="reverse direction: read a JAX-package or port checkpoint and write "
        "a torch state_dict the original reference loads",
    )
    return parser


def _model_config(config_dir: str, model: str) -> dict:
    return load_config(
        os.path.join(config_dir, "base.yaml"), os.path.join(config_dir, f"{model}.yaml")
    )


def main(argv=None, device: str = None) -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run the command, on the
    card unless ``device`` names another (``"cpu"``); a process group the
    command started (a mesh's) is closed at the end."""
    started = dist.is_initialized()
    try:
        _run(build_parser(), argv, device)
    finally:
        if not started and dist.is_initialized():
            dist.destroy_process_group()


def _run(parser: argparse.ArgumentParser, argv, device) -> None:
    args = parser.parse_args(argv)

    if args.command == "evaluate":
        evaluate_model(args.model_dir, save_dir=args.save_dir, quant=args.quant, device=device)
        return
    if args.command == "resume":
        resume_training(args.model_dir, device=device)
        return
    if args.command == "infer":
        infer(args.model_dir, split=args.split, output=args.output, quant=args.quant, device=device)
        return
    if args.command == "infer-raw":
        infer_raw(args.model_dir, args.input, output=args.output, quant=args.quant, device=device)
        return
    if args.command == "serve":
        from point_cloud_classifier_tpu_torch.server import serve

        serve(args.model_dir, host=args.host, port=args.port, quant=args.quant, device=device)
        return
    if args.command == "create-datasets":
        for ds in args.datasets:
            config = _model_config(args.config_dir, _DATASET_MODELS[ds])
            config["dataset"]["data_dir"] = args.data_dir
            config["dataset"]["create_dataset"] = True
            if args.workers > 1:
                config["dataset"]["workers"] = args.workers
            get_dataloader(ds, config)
        return
    if args.command == "export":
        from point_cloud_classifier_tpu_torch.serving import export_run

        out = export_run(
            args.model_dir,
            out_dir=args.out_dir,
            quant=args.quant,
            platforms=tuple(args.platforms) if args.platforms else None,
            device=device,
        )
        print(f"Exported serving artifacts to {out}")
        return
    if args.command == "convert":
        from point_cloud_classifier_tpu_torch.convert import (
            convert_checkpoint,
            export_torch_checkpoint,
        )

        if args.config:
            with open(args.config) as f:
                config = load_yaml(f.read())
        else:
            config = _model_config(args.config_dir, args.model)
        fn = export_torch_checkpoint if args.to_torch else convert_checkpoint
        fn(args.model, config, args.torch_ckpt, args.out)
        print(f"Converted {args.torch_ckpt} -> {args.out}")
        return
    if args.command != "train":
        parser.print_help()
        return

    model = args.model
    dataset = (args.dataset or MODEL_DATASETS[model]).lower()
    config = _model_config(args.config_dir, model)
    if args.data_dir:
        config["dataset"]["data_dir"] = args.data_dir
    if args.log_dir:
        config["logging"]["log_dir"] = args.log_dir
    if args.epochs is not None:
        config.setdefault("trainer", {})["epochs"] = args.epochs
    if args.seed is not None:
        config.setdefault("trainer", {})["seed"] = args.seed
    if args.create_dataset and os.environ.get("RANK", "0") == "0":
        # under torchrun rank 0 builds the cache; the others wait for it in
        # train_model, where rank 0 hands them the run's version
        config["dataset"]["create_dataset"] = True
        get_dataloader(dataset, config)
        config["dataset"]["create_dataset"] = False
    train_model(model, dataset, config, plots=args.plots, device=device)

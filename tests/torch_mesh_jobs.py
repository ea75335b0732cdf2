"""The rank side of the mesh tests: what each rank of a spawned gloo world
runs (``parallel/ranks.run_ranks``).

It imports torch and the port only, never jax or the JAX package, so that
the spawned ranks start without them; ``tests/test_torch_no_jax.py`` holds
that.  Each job returns, from every rank, what the tests compare with the
JAX package's single-device and mesh runs in the pytest process.
"""

from __future__ import annotations

import json
import os

import torch

from point_cloud_classifier_tpu_torch.data import GraphLoader, PointCloudLoader
from point_cloud_classifier_tpu_torch.models import DeepSets, FullyConnectedNet, GraphNet, ModelWrapper  # noqa: F401
from point_cloud_classifier_tpu_torch.parallel import make_mesh, train_configs_vmapped

FAMILIES = {"fully_connected_net": FullyConnectedNet, "deep_sets": DeepSets, "graph_net": GraphNet}


def _loader(spec):
    """A list of packed batches as it is, or a loader built from its
    arguments (``("points" | "graphs", args, kwargs)``)."""
    if isinstance(spec, list):
        return spec
    kind, args, kwargs = spec
    return (PointCloudLoader if kind == "points" else GraphLoader)(*args, **kwargs)


def _metrics(log_dir):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append(row["value"])
    return out


def fit_cases(rank, n, cases, meshless):
    """Each case trained and then predicted on this world: without a mesh
    (``meshless``, the port's single-device run) or on a mesh of the case's
    ``n_model``.  Returns per case the probabilities, the BatchNorm running
    statistics, the state after ``fit`` and, from rank 0, its ``Loss/train``
    curve."""
    meshes = {}
    out = {}
    for name, case in cases.items():
        mesh = None
        if not meshless:
            n_model = case.get("n_model", 1)
            if n_model not in meshes:
                meshes[n_model] = make_mesh(n_model=n_model, device="cpu")
            mesh = meshes[n_model]
        model = FAMILIES[case["family"]](**case["kwargs"])
        model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()})
        log_dir = os.path.join(case["log_root"], f"{name}_{'single' if meshless else n}")
        def make(state_every):
            return ModelWrapper(model, learning_rate=case.get("lr", 1e-3), epochs=case["epochs"], seed=0,
                                mesh=mesh, fuse_steps=case.get("fuse_steps", 1), log_dir=log_dir,
                                state_every=state_every, device_resident=case.get("device_resident", False),
                                device="cpu")

        wrapper = make(1 if case.get("resume_check") else 0)
        wrapper.fit(_loader(case["train"]), _loader(case["val"]) if "val" in case else None)
        _, probs = wrapper.predict(_loader(case["predict"]), return_prob=True)
        state = wrapper._host_state_dict()
        resumed = None
        if case.get("resume_check"):
            # the resumable state rank 0 wrote, read back on every rank
            again = make(1)
            again.restore_state()
            mine, theirs = wrapper.optimizer.state_dict()["state"], again.optimizer.state_dict()["state"]
            resumed = all(torch.equal(a, b) for a, b in zip(wrapper._trained_params(), again._trained_params()))
            resumed = resumed and mine.keys() == theirs.keys() and all(
                torch.equal(mine[i][k], theirs[i][k]) for i in mine for k in mine[i])
        out[name] = {
            "resumed": resumed,
            "probs": probs,
            "stats": {k: v.numpy() for k, v in state.items() if "running" in k},
            "state": {k: v.numpy() for k, v in state.items()},
            "loss": _metrics(log_dir)["Loss/train"] if rank == 0 else None,
        }
    return out


def cli_train(rank, n, argv, env):
    """``cli.main(argv, device="cpu")`` on every rank, with ``env`` set."""
    from point_cloud_classifier_tpu_torch.cli import main

    os.environ.update(env)
    main(argv, device="cpu")
    return sorted(os.listdir(argv[argv.index("--log-dir") + 1]))


def world(rank, n, cases, cli=None):
    """One spawned world's share of the mesh tests: :func:`fit_cases` on a
    mesh, then, where given, :func:`cli_train` of ``cli = (argv, env)``."""
    out = {"cases": fit_cases(rank, n, cases, meshless=False)}
    if cli is not None:
        out["cli"] = cli_train(rank, n, *cli)
    if n == 4:
        out["grid"] = ranks_agree(rank, n)
    return out


def vmapped_arms(rank, n, cases):
    """``train_configs_vmapped`` of each case, with a mesh over the world
    (``meshless``: without one)."""
    mesh = make_mesh(device="cpu")
    out = {}
    for name, case in cases.items():
        model = FAMILIES[case["family"]](**case["kwargs"])
        result = train_configs_vmapped(
            model, case["lrs"], case["optimizer"], case["epochs"], case["train"], case["val"],
            seeds=case.get("seeds"), init_states=case.get("init_states"),
            mesh=None if case.get("meshless") else mesh, device="cpu",
        )
        result["final_state"] = [{k: v.numpy() for k, v in s.items()} for s in result["final_state"]]
        result["best_state"] = [{k: v.numpy() for k, v in s.items()} for s in result["best_state"]]
        out[name] = result
    return out


def sweep_world(rank, n, cases, argv=None):
    """:func:`vmapped_arms` of ``cases`` then, where given, the sweep's
    ``main(argv, device="cpu")`` on every rank."""
    from point_cloud_classifier_tpu_torch.sweep import main

    out = {"arms": vmapped_arms(rank, n, cases)}
    if argv is not None:
        main(argv, device="cpu")
    return out


def ranks_agree(rank, n):
    """This rank's mesh coordinates and groups on a data=2 × model=2 grid."""
    import torch.distributed as dist

    mesh = make_mesh(n_model=2, device="cpu")
    return {
        "shape": mesh.shape,
        "coords": (mesh.data_rank, mesh.model_rank),
        "data_group": dist.get_process_group_ranks(mesh.data_group),
        "model_group": dist.get_process_group_ranks(mesh.model_group),
        "writer": mesh.writer,
    }


def loaded_after_fit(rank, n, cases, packages):
    """:func:`fit_cases` on a mesh, then which of ``packages`` this rank's
    process has imported."""
    import sys

    fit_cases(rank, n, cases, meshless=False)
    return sorted({m.split(".")[0] for m, module in sys.modules.items() if module is not None} & set(packages))

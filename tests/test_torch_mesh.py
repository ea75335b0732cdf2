"""The port's data parallelism and model axis against the JAX package's
meshes, on the CPU.

Every case of ``tests/test_parallel.py`` (fcn, flat and dense-wire DeepSets,
GraphNet, the giant event, fused steps under a mesh, tensor parallel) runs
on the same seeded numpy batches from the same initial weights (the JAX
init moved by ``convert.py``): in the JAX package on one device and on its
``make_mesh()`` over the 8 host devices (``conftest.py``), here; in the port
without a mesh in this process, and on gloo worlds of 1, 2 and 4 CPU ranks
spawned once for the module (``parallel/ranks.run_ranks``; what a rank runs
lives in the jax-free ``tests/torch_mesh_jobs.py``).  Probabilities must
agree within rtol 5e-4 / atol 5e-5 (the JAX tests' bound), ``Loss/train``
curves within 5e-4 of the port's single-device run, and BatchNorm running
statistics within 1e-6 of it.  A Linear's bias ahead of a BatchNorm (the
FCN's) has a gradient of 0 in exact arithmetic; each run's rounding leaves
~1e-9 that Adam scales to steps near the learning rate, so those biases and
the running means that take them in drift apart between any two summation
orders (``tests/test_torch_vmap_sweep.py``'s ``FCN_FREE``).  Train-mode
losses do not see them; eval probabilities are compared with the
reference run's free tensors swapped in, and the free running means are
left out of the statistics check.  Beside them: a global batch whose shares
hold unequal numbers of real rows (a mean of per-rank means fails it),
loaders that pack each rank's share themselves, ``make_mesh``'s errors, and
a data-parallel ``train`` through the command line, whose files rank 0
alone writes.
"""

import json
import os
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_jobs  # noqa: E402
from test_parallel import (  # noqa: E402
    _giant_event_batch,
    _graph_batch,
    _pointcloud_batch,
    _pointcloud_dense_batch,
    _tabular_batch,
)

from point_cloud_classifier_tpu.models import DeepSets as JaxDeepSets  # noqa: E402
from point_cloud_classifier_tpu.models import FullyConnectedNet as JaxFCN  # noqa: E402
from point_cloud_classifier_tpu.models import GraphNet as JaxGraphNet  # noqa: E402
from point_cloud_classifier_tpu.models import ModelWrapper as JaxWrapper  # noqa: E402
from point_cloud_classifier_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from point_cloud_classifier_tpu_torch import convert  # noqa: E402
from point_cloud_classifier_tpu_torch.cli import main as cli_main  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.models import DeepSets, GraphNet  # noqa: E402
from point_cloud_classifier_tpu_torch.parallel import make_mesh, share_of_batch, share_slices  # noqa: E402
from point_cloud_classifier_tpu_torch.parallel.mesh import mesh_options  # noqa: E402
from point_cloud_classifier_tpu_torch.parallel.ranks import run_ranks  # noqa: E402

PROBS = dict(rtol=5e-4, atol=5e-5)  # tests/test_parallel.py's bound
LOSS = dict(rtol=5e-4, atol=5e-4)  # __graft_entry__.py's size-invariance bound
STATS = dict(rtol=1e-6, atol=1e-6)
WORLDS = (1, 2, 4)

_JAX = {"fully_connected_net": JaxFCN, "deep_sets": JaxDeepSets, "graph_net": JaxGraphNet}
_DEEP_SETS = dict(input_dim=6, phi_layers=[64, 64], rho_layers=[64], output_dim=1, activation="gelu",
                  residual_block=True, pooling="mean")


def _unequal_batch(seed, real):
    """A tabular batch of 32 slots whose first ``real`` rows are real: its
    shares over 2 or 4 ranks hold unequal numbers of real rows (none, for
    some), and the padding rows hold noise that only the mask keeps out."""
    batch = _tabular_batch(seed=seed)
    batch["y_mask"][real:] = 0.0
    return batch


# name: (family, kwargs, train batches, predict batches, epochs, extra)
JAX_CASES = {
    "fcn": ("fully_connected_net", dict(input_dim=9, hidden_layers=[32, 32], batch_normalization=True,
                                        output_dim=1),
            [_tabular_batch(seed=s) for s in range(3)], [_tabular_batch(seed=9)], 1, {}),
    "deep_sets": ("deep_sets", _DEEP_SETS, [_pointcloud_batch(seed=s) for s in range(3)],
                  [_pointcloud_batch(seed=9)], 1, {}),
    "deep_sets_dense_wire": ("deep_sets", _DEEP_SETS, [_pointcloud_dense_batch(seed=s) for s in range(3)],
                             [_pointcloud_dense_batch(seed=9)], 1, {}),
    "graph_net": ("graph_net", dict(input_dim=4, hidden_dim=32, output_dim=1, activation="tanh"),
                  [_graph_batch(seed=s) for s in range(3)], [_graph_batch(seed=9)], 1, {}),
    "giant_event": ("deep_sets", _DEEP_SETS, [_giant_event_batch(seed=s) for s in range(2)],
                    [_giant_event_batch(seed=9)], 1, {}),
    "fused_steps": ("fully_connected_net", dict(input_dim=9, hidden_layers=[8], batch_normalization=True,
                                                output_dim=1),
                    [_tabular_batch(seed=s) for s in range(5)], [_tabular_batch(seed=9), _tabular_batch(seed=10)],
                    2, {"fuse_steps": 4}),
    "tensor_parallel": ("deep_sets", dict(input_dim=6, phi_layers=[128, 128], rho_layers=[128], output_dim=1,
                                          activation="gelu", pooling="mean"),
                        [_pointcloud_batch(seed=s) for s in range(2)], [_pointcloud_batch(seed=9)], 1,
                        {"n_model": 2, "resume_check": True}),
    "unequal_rows": ("fully_connected_net", dict(input_dim=9, hidden_layers=[16], batch_normalization=True,
                                                 output_dim=1),
                     [_unequal_batch(0, 5), _unequal_batch(1, 17), _unequal_batch(2, 32), _unequal_batch(3, 9)],
                     [_unequal_batch(9, 21)], 2, {}),
}
BN_CASES = ("fcn", "graph_net", "fused_steps", "unequal_rows", "loader_graph_gat", "loader_graph_flat")


def _events(n=70, seed=3):
    rng = np.random.default_rng(seed)
    events = [rng.normal(size=(int(rng.integers(1, 40)), 6)).astype(np.float32) for _ in range(n)]
    return events, np.array([float(e[:, 0].mean() > 0) for e in events], np.float32)


def _graphs(n=36, seed=4):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n):
        size = int(rng.integers(3, 14))
        e = int(rng.integers(size, 3 * size))
        edges = np.stack([rng.integers(0, size, e), rng.integers(0, size, e)]).astype(np.int32)
        keep = edges[0] != edges[1]
        graphs.append({"features": rng.normal(size=(size, 4)).astype(np.float32), "edges": edges[:, keep],
                       "weights": rng.uniform(0.5, 1.5, int(keep.sum())).astype(np.float32),
                       "label": float(rng.integers(0, 2))})
    return graphs


def _loader_cases():
    """Loaders that pack each rank's share themselves (``iter_shard``),
    shuffled and length-sorted, against the port's single-device run."""
    events, labels = _events()
    points = dict(transfer_dtype="float16", factor_event_cols=[1], length_sorted=True, min_bucket=64)
    graphs = _graphs()
    gat = dict(input_dim=4, hidden_dim=16, output_dim=1, activation="tanh", use_gat=True, deepchem_style=True)
    conv = dict(input_dim=4, hidden_dim=16, output_dim=1, activation="tanh", deepchem_style=True)
    cases = {
        "loader_points": ("deep_sets", dict(input_dim=6, phi_layers=[16, 16], rho_layers=[16], output_dim=1,
                                            activation="gelu", layer_norm=False, residual_block=True,
                                            pooling="mean", factored_cols=[1]),
                          ("points", (events[:54], labels[:54], 12, True), dict(seed=2, layout="auto", **points)),
                          ("points", (events[54:], labels[54:], 12, False), dict(layout="dense", **points))),
        "loader_graph_gat": ("graph_net", gat,
                             ("graphs", (graphs[:28], 8, True), dict(seed=1, layout="auto", n_features=4)),
                             ("graphs", (graphs[28:], 8, False), dict(layout="dense", n_features=4))),
        "loader_graph_flat": ("graph_net", conv,
                              ("graphs", (graphs[:28], 8, True), dict(seed=1, layout="flat", n_features=4)),
                              ("graphs", (graphs[28:], 8, False), dict(layout="flat", n_features=4))),
    }
    out = {}
    for name, (family, kwargs, train, predict) in cases.items():
        model = (DeepSets if family == "deep_sets" else GraphNet)(
            **kwargs, generator=torch.Generator().manual_seed(7))
        out[name] = dict(family=family, kwargs=kwargs, state={k: v.numpy() for k, v in model.state_dict().items()},
                         train=train, val=predict, predict=predict, epochs=2)
    # the resident cache holds each rank's shares (replayed in an order
    # shuffled from the seed, the same on every rank)
    out["loader_points_resident"] = dict(out["loader_points"], device_resident=True, epochs=3)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in the JAX package (one device and its mesh) and in the
    port (no mesh here; meshes on gloo worlds of 1, 2 and 4 ranks)."""
    root = tmp_path_factory.mktemp("mesh")
    jax_single, jax_mesh, cases, jax_states, jax_runs = {}, {}, {}, {}, []
    for name, (family, kwargs, train, predict, epochs, extra) in JAX_CASES.items():
        model = _JAX[family](**kwargs)
        for label, mesh in (("single", None), ("mesh", jax_make_mesh(n_model=extra.get("n_model", 1)))):
            wrapper = JaxWrapper(model, learning_rate=1e-3, epochs=epochs, seed=0, mesh=mesh,
                                 fuse_steps=extra.get("fuse_steps", 1) if mesh is not None else 1)
            wrapper._ensure_initialized(train[0])
            jax_runs.append((name, label, family, kwargs, wrapper))
            if mesh is None:
                state = convert.to_torch_state_dict(family, {"model": kwargs}, jax.tree.map(np.asarray, wrapper.params),
                                                    jax.tree.map(np.asarray, wrapper.batch_stats))
        cases[name] = dict(family=family, kwargs=kwargs, state=state, train=train, predict=predict, epochs=epochs,
                           n_model=extra.get("n_model", 1), fuse_steps=extra.get("fuse_steps", 1),
                           resume_check=extra.get("resume_check", False))
    cases.update(_loader_cases())
    for case in cases.values():
        case["log_root"] = str(root)

    data, configs = str(root / "data"), str(root / "configs")
    write_s2ppc_cache(data, n_events=(64, 16, 16), min_points=3, max_points=20, seed=2)
    os.makedirs(configs)
    with open(os.path.join(configs, "base.yaml"), "w") as f:
        f.write('meta:\n  model_name: ""\n  dataset_name: ""\n\ndataset:\n  data_dir: "data"\nlogging:\n'
                '  log_dir: "log"\n')
    with open(os.path.join(configs, "deep_sets.yaml"), "w") as f:
        f.write("model:\n  input_dim: 6\n  phi_layers: [16, 16]\n  rho_layers: [16]\n  output_dim: 1\n"
                "  sparse_batching: true\n  pooling: \"mean\"\n  layer_norm: false\n  activation: \"gelu\"\n"
                "  residual_block: true\n\ndataset:\n  batch_size: 16\n  sparse_batching: true\n\n"
                "trainer:\n  epochs: 2\n  learning_rate: 0.001\n  optimizer: \"adamw\"\n")

    def argv(log):
        return ["train", "deep_sets", "--data-dir", data, "--config-dir", configs, "--log-dir", str(root / log)]

    # the spawned worlds train while this process runs the JAX side
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        pending = {
            n: pool.submit(run_ranks, torch_mesh_jobs.world, n,
                           {k: v for k, v in cases.items() if n % v.get("n_model", 1) == 0},
                           (argv(f"cli_{n}"), {"PCC_DATA_PARALLEL": "1"}) if n == 2 else None, timeout=600)
            for n in WORLDS
        }
        for name, label, family, kwargs, wrapper in jax_runs:
            wrapper.fit(JAX_CASES[name][2])
            (jax_single if label == "single" else jax_mesh)[name] = wrapper.predict(
                JAX_CASES[name][3], return_prob=True)[1]
            jax_states[name, label] = convert.to_torch_state_dict(
                family, {"model": kwargs}, jax.tree.map(np.asarray, wrapper.params),
                jax.tree.map(np.asarray, wrapper.batch_stats))
        single = torch_mesh_jobs.fit_cases(0, 1, cases, meshless=True)
        cli_main(argv("cli_single"), device="cpu")
        worlds = {n: f.result() for n, f in pending.items()}
    return dict(jax_single=jax_single, jax_mesh=jax_mesh, jax_states=jax_states, single=single, worlds=worlds,
                root=root, cases=cases)


def _free(state):
    """The free tensors of a state: each Linear bias ahead of a BatchNorm and
    that BatchNorm's running mean (the FCN's ``network.{j-1}.bias`` and
    ``network.{j}.running_mean``)."""
    free = []
    for key in state:
        m = re.fullmatch(r"network\.(\d+)\.running_mean", key)
        if m:
            free += [key, f"network.{int(m.group(1)) - 1}.bias"]
    return free


def _probs(runs, name, out, ref_state):
    """A mesh run's probabilities; with free tensors, those of its final
    state with the reference run's free tensors swapped in."""
    state = out["cases"][name]["state"]
    free = _free(state)
    if not free:
        return out["cases"][name]["probs"]
    case = runs["cases"][name]
    model = torch_mesh_jobs.FAMILIES[case["family"]](**case["kwargs"])
    model.load_state_dict({k: torch.as_tensor(np.array(ref_state[k] if k in free else v)) for k, v in state.items()})
    return torch_mesh_jobs.ModelWrapper(model, 1e-3, 1, device="cpu").predict(case["predict"], return_prob=True)[1]


def _case_ids(names, worlds=WORLDS):
    return [(name, n) for name in names for n in worlds
            if n % JAX_CASES.get(name, (None, None, None, None, None, {}))[5].get("n_model", 1) == 0]


@pytest.mark.parametrize("name, n", _case_ids(JAX_CASES))
def test_probabilities_match_the_jax_single_device_run(runs, name, n):
    for rank, out in enumerate(runs["worlds"][n]):
        np.testing.assert_allclose(_probs(runs, name, out, runs["jax_states"][name, "single"]),
                                   runs["jax_single"][name], **PROBS, err_msg=f"rank {rank} of {n}")


@pytest.mark.parametrize("name, n", _case_ids(JAX_CASES))
def test_probabilities_match_the_jax_mesh_run(runs, name, n):
    np.testing.assert_allclose(_probs(runs, name, runs["worlds"][n][0], runs["jax_states"][name, "mesh"]),
                               runs["jax_mesh"][name], **PROBS)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_single_device_port_matches_jax(runs, name):
    out = {"cases": runs["single"]}
    np.testing.assert_allclose(_probs(runs, name, out, runs["jax_states"][name, "single"]),
                               runs["jax_single"][name], **PROBS)


LOADER_CASES = ["loader_points", "loader_points_resident", "loader_graph_gat", "loader_graph_flat"]


@pytest.mark.parametrize("name, n", _case_ids(LOADER_CASES))
def test_loaders_pack_each_share_and_match_the_single_device_run(runs, name, n):
    np.testing.assert_allclose(runs["worlds"][n][0]["cases"][name]["probs"], runs["single"][name]["probs"], **PROBS)


@pytest.mark.parametrize("name, n", _case_ids([*JAX_CASES, *LOADER_CASES]))
def test_loss_curve_matches_the_single_device_run(runs, name, n):
    ranks = runs["worlds"][n]
    np.testing.assert_allclose(ranks[0]["cases"][name]["loss"], runs["single"][name]["loss"], **LOSS)
    assert all(r["cases"][name]["loss"] is None for r in ranks[1:])  # rank 0 alone writes metrics.jsonl


@pytest.mark.parametrize("name, n", _case_ids(BN_CASES))
def test_batchnorm_statistics_match_the_single_device_run(runs, name, n):
    want = runs["single"][name]["stats"]
    held = [key for key in want if key not in _free(want)]
    assert held
    for rank, out in enumerate(runs["worlds"][n]):
        got = out["cases"][name]["stats"]
        assert got.keys() == want.keys()
        for key in held:
            np.testing.assert_allclose(got[key], want[key], **STATS, err_msg=f"{key} on rank {rank} of {n}")


@pytest.mark.parametrize("n", [2, 4])
def test_a_mean_of_per_rank_means_would_fail_the_unequal_rows_batch(n):
    """The unequal-rows case is one that a per-rank mean gets wrong: its
    shares' real-row counts differ, so the mean of their means is not the
    global mean."""
    batch = _unequal_batch(0, 5)
    rng = np.random.default_rng(1)
    per_row = rng.uniform(0.1, 2.0, size=len(batch["y_mask"]))
    mask = batch["y_mask"]
    shares = [share_of_batch(batch, r, n)["y_mask"] for r in range(n)]
    per, slices = share_slices(len(mask), n)
    counts = [s.sum() for s in shares]
    assert len(set(counts)) > 1
    means = [float((per_row[sl] * mask[sl]).sum() / max(mask[sl].sum(), 1.0)) for sl in slices]
    global_mean = float((per_row * mask).sum() / mask.sum())
    assert abs(np.mean(means) - global_mean) > 1e-2


def test_make_mesh_raises_the_jax_errors_and_names_torchrun(monkeypatch):
    with pytest.raises(ValueError, match="mesh 8x2 needs 16 devices, have 8"):
        make_mesh(n_data=8, n_model=2, devices=range(8))
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh(n_model=16, devices=range(8))
    with pytest.raises(ValueError, match="needs"):
        make_mesh(n_data=0, n_model=1, devices=range(8))
    with pytest.raises(ValueError, match="leaves 2 of 8 ranks out"):
        make_mesh(n_data=3, n_model=2, devices=range(8))
    with pytest.raises(ValueError, match="mesh 0x2 needs 2 devices, have 1"):
        make_mesh(n_model=2, devices=range(1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match=r"torchrun --nproc-per-node 4 -m point_cloud_classifier_tpu_torch"):
        make_mesh(devices=range(1), device="cuda")


@pytest.mark.parametrize("env, want", [
    ({"PCC_DATA_PARALLEL": "1"}, (True, 1)), ({"PCC_DATA_PARALLEL": "0"}, (False, 1)),
    ({"PCC_N_MODEL": "2"}, (False, 2)), ({"PCC_DATA_PARALLEL": "true"}, "PCC_DATA_PARALLEL must be"),
    ({"PCC_N_MODEL": "two"}, "PCC_N_MODEL must be an integer"),
])
def test_mesh_environment_is_read_as_the_jax_trainer_reads_it(monkeypatch, env, want):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            mesh_options(False, 1)
    else:
        assert mesh_options(False, 1) == want


@pytest.mark.parametrize("n", [2, 4])
def test_model_axis_state_resumes_on_every_rank(runs, n):
    """The tensor-parallel run's resumable state (rank 0 writes the full
    weights and optimizer state) restores each rank's row blocks and their
    Adam moments exactly."""
    assert [r["cases"]["tensor_parallel"]["resumed"] for r in runs["worlds"][n]] == [True] * n


def test_rank_grid_follows_the_jax_device_grid(runs):
    """Rank r sits at (r // n_model, r % n_model), as JAX reshapes its
    devices: on 4 ranks with n_model=2, data groups {0, 2} and {1, 3}."""
    grid = [r["grid"] for r in runs["worlds"][4]]
    assert [g["shape"] for g in grid] == [{"data": 2, "model": 2}] * 4
    assert [g["coords"] for g in grid] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [g["data_group"] for g in grid] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [g["model_group"] for g in grid] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [g["writer"] for g in grid] == [True, False, False, False]


def _read(path):
    with open(path) as f:
        return f.read()


def test_data_parallel_command_line_run_writes_its_files_once(runs):
    """``PCC_DATA_PARALLEL=1`` through ``cli.main`` on two ranks: one run
    directory, made by rank 0, with a meshless run's ``config.yaml`` (its
    own path aside) and ``meta.json`` keys, and metrics within the loss
    bound of the meshless run's."""
    root = runs["root"]
    assert runs["worlds"][2][0]["cli"] == runs["worlds"][2][1]["cli"] == ["version_0"]
    mesh_run, single_run = root / "cli_2" / "version_0", root / "cli_single" / "version_0"
    assert sorted(os.listdir(mesh_run)) == sorted(os.listdir(single_run))
    assert _read(mesh_run / "config.yaml").replace("cli_2", "cli_single") == _read(single_run / "config.yaml")
    meta, want = json.loads(_read(mesh_run / "meta.json")), json.loads(_read(single_run / "meta.json"))
    assert list(meta) == list(want) and list(meta["metrics"]) == list(want["metrics"])
    assert meta["metrics"]["parameters"] == want["metrics"]["parameters"]
    rows = [json.loads(line) for line in _read(mesh_run / "metrics.jsonl").splitlines()]
    want_rows = [json.loads(line) for line in _read(single_run / "metrics.jsonl").splitlines()]
    assert [r["tag"] for r in rows] == [r["tag"] for r in want_rows]
    for row, ref in zip(rows, want_rows):
        if re.match(r"(Loss|Accuracy)/", row["tag"]):
            assert row["value"] == pytest.approx(ref["value"], rel=5e-4, abs=5e-4), row["tag"]

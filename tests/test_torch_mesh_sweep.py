"""The sweep's arm axis over a mesh against the JAX package's, on the CPU.

``train_configs_vmapped(mesh=…)`` splits K arms over the data ranks of gloo
worlds of 2 and 4 CPU ranks (spawned once each for the module, what a rank
runs in the jax-free ``tests/torch_mesh_jobs.py``), as the JAX package
shards its arm axis over ``make_mesh()`` (``tests/test_vmap_sweep.py``
104-140): with K divisible by the ranks, each trains K/n arms and every rank
returns all K; otherwise every rank trains all K.  Both hold to the port's
meshless arms and to the JAX package's unsharded and sharded arms from the
JAX init (``convert.py``).  Then ``sweep.main(["--vmap", "--mesh"])`` on 2
ranks: rank 0 alone writes the search directory, whose leaderboard is the
meshless search's.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

import torch_mesh_jobs  # noqa: E402
from point_cloud_classifier_tpu.models import FullyConnectedNet as JaxFCN  # noqa: E402
from point_cloud_classifier_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from point_cloud_classifier_tpu.parallel.vmap_sweep import (  # noqa: E402
    train_configs_vmapped as jax_train_configs_vmapped,
)
from point_cloud_classifier_tpu_torch import convert, sweep  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2pt_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.parallel.ranks import run_ranks  # noqa: E402

# tests/test_vmap_sweep.py's sharded-against-unsharded bounds
VAL_ACC_ATOL = 1e-6
PARAMS = dict(rtol=1e-4, atol=1e-6)
# the port against the JAX package from one init (test_torch_vmap_sweep.py)
JAX_PARAM_ATOL = 1e-5
CFG = dict(input_dim=9, hidden_layers=[16], batch_normalization=False, output_dim=1)


def _tabular(seed, b=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 9)).astype(np.float32)
    y = (x[:, :1] + 0.5 * rng.normal(size=(b, 1)) > 0).astype(np.float32)
    return {"x": x, "y": y, "y_mask": np.ones((b,), np.float32)}


def _loaders():
    return [_tabular(s) for s in range(4)], [_tabular(99, 64)]


ARMS = {"divisible": [10 ** (-2 - 0.1 * i) for i in range(8)], "replicated": [1e-2, 1e-3, 3e-3]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_sweep")
    train, val = _loaders()
    jax_model = JaxFCN(**CFG)
    cases, jax_runs = {}, {}
    for name, lrs in ARMS.items():
        seeds = list(range(len(lrs)))
        variables = jax.vmap(lambda s: jax_model.init(jax.random.PRNGKey(s), train[0], train=False))(
            jnp.asarray(seeds, dtype=jnp.uint32))
        init = [convert.to_torch_state_dict("fully_connected_net", {"model": CFG},
                                            jax.tree.map(lambda x: np.asarray(x)[arm], variables["params"]), {})
                for arm in range(len(seeds))]
        case = dict(family="fully_connected_net", kwargs=CFG, lrs=lrs, optimizer="adam", epochs=3, train=train,
                    val=val, seeds=seeds, init_states=init)
        cases[name] = case
        cases[f"{name}_meshless"] = dict(case, meshless=True)

    data = str(root / "data")
    write_s2pt_cache(data, n_events=(100, 30, 30), seed=1)

    def argv(search, mesh):
        return ["fully_connected_net", "--vmap", *(["--mesh"] if mesh else []), "--seed", "0", "--max-runs", "3",
                "--epochs", "1", "--force", "--data-dir", data, "--search-dir", str(root / search)]

    with ThreadPoolExecutor(2) as pool:
        pending = {n: pool.submit(run_ranks, torch_mesh_jobs.sweep_world, n, cases,
                                  argv("search_2", True) if n == 2 else None, timeout=600) for n in (2, 4)}
        for name, lrs in ARMS.items():
            for label, mesh in (("single", None), ("mesh", jax_make_mesh())):
                jax_runs[name, label] = jax_train_configs_vmapped(
                    jax_model, lrs, "adam", 3, train, val, seeds=list(range(len(lrs))), mesh=mesh)
        sweep.main(argv("search_single", False), device="cpu")
        worlds = {n: f.result() for n, f in pending.items()}
    return dict(worlds=worlds, jax=jax_runs, root=root)


def _params(result, arm):
    return {k: np.asarray(v) for k, v in result["final_state"][arm].items()}


@pytest.mark.parametrize("name", list(ARMS))
@pytest.mark.parametrize("n", [2, 4])
def test_arms_over_the_mesh_match_the_meshless_arms(runs, name, n):
    for rank, out in enumerate(runs["worlds"][n]):
        got, want = out["arms"][name], out["arms"][f"{name}_meshless"]
        assert len(got["val_accs"]) == len(ARMS[name])
        np.testing.assert_allclose(got["val_accs"], want["val_accs"], atol=VAL_ACC_ATOL, err_msg=f"rank {rank}")
        assert got["best_improved"] == want["best_improved"]
        for arm in range(len(ARMS[name])):
            for key, value in _params(want, arm).items():
                np.testing.assert_allclose(_params(got, arm)[key], value, **PARAMS, err_msg=f"arm {arm} {key}")


@pytest.mark.parametrize("name", list(ARMS))
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("label", ["single", "mesh"])
def test_arms_over_the_mesh_match_the_jax_arms(runs, name, n, label):
    theirs = runs["jax"][name, label]
    ours = runs["worlds"][n][0]["arms"][name]
    np.testing.assert_allclose(ours["val_accs"], theirs["val_accs"], atol=VAL_ACC_ATOL)
    assert ours["n_params"] == theirs["n_params"]
    for arm in range(len(ARMS[name])):
        ref = convert.to_torch_state_dict("fully_connected_net", {"model": CFG},
                                          theirs["final_state"][arm]["params"], {})
        for key, value in ref.items():
            np.testing.assert_allclose(_params(ours, arm)[key], value, rtol=0, atol=JAX_PARAM_ATOL,
                                       err_msg=f"arm {arm} {key}")


def test_mesh_sweep_writes_its_search_directory_once(runs):
    mesh_dir, single_dir = runs["root"] / "search_2", runs["root"] / "search_single"
    assert sorted(os.listdir(mesh_dir)) == sorted(os.listdir(single_dir))
    assert not (mesh_dir / "status_log.txt").exists()
    with open(mesh_dir / "search_results.json") as f:
        board = json.load(f)
    with open(single_dir / "search_results.json") as f:
        want = json.load(f)
    assert [(r["version"], r["parameters"]) for r in board] == [(r["version"], r["parameters"]) for r in want]
    for row, ref in zip(board, want):
        assert row["val_acc"] == pytest.approx(ref["val_acc"], abs=VAL_ACC_ATOL)
    for version in os.listdir(mesh_dir):
        if version.startswith("version_"):
            assert sorted(os.listdir(mesh_dir / version)) == sorted(os.listdir(single_dir / version))

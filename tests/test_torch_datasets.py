"""Dataset creation in the port (``data/module.py``, ``data/npz_io.py`` and the
``create_dataset`` paths of ``data/tabular.py``, ``data/pointcloud.py`` and
``data/graph.py``) against the JAX package and scikit-learn, on the CPU:
``save_npz``'s bytes; the numpy ``train_test_split`` against scikit-learn's
over a seeded sweep of sizes (odd and tiny among them), label balances, three
classes and ties, its errors included; the numpy ``StandardScaler`` bit for
bit against scikit-learn's on every array layout the pipelines hand it; the
scaler pickle both ways (the port reads joblib's, ``joblib.load`` reads the
port's and transforms to the same bits); and the S2PT, S2PPC and S2PG caches
built from the JAX generator's raw files, array for array, dtype, file name
and S2PT row order equal to the JAX package's ``create_dataset=True``, with
one and two workers, plus the loaders of the freshly built splits."""

import contextlib
import filecmp
import glob
import io
import os
import shutil
import warnings

import joblib
import numpy as np
import pandas as pd
import pytest
from sklearn.model_selection import train_test_split as sk_train_test_split
from sklearn.preprocessing import StandardScaler as SkStandardScaler

from point_cloud_classifier_tpu.data import graph as jax_graph
from point_cloud_classifier_tpu.data import npz_io as jax_npz_io
from point_cloud_classifier_tpu.data import pointcloud as jax_pointcloud
from point_cloud_classifier_tpu.data import tabular as jax_tabular
from point_cloud_classifier_tpu.data.synthetic import write_synthetic_dataset
from point_cloud_classifier_tpu_torch.data import graph as port_graph
from point_cloud_classifier_tpu_torch.data import npz_io as port_npz_io
from point_cloud_classifier_tpu_torch.data import pointcloud as port_pointcloud
from point_cloud_classifier_tpu_torch.data import tabular as port_tabular
from point_cloud_classifier_tpu_torch.data.module import (
    StandardScaler,
    feature_block,
    load_scaler,
    save_scaler,
    train_test_split,
)

NPZ_CASES = {
    "graph": dict(features=np.arange(12, dtype=np.float32).reshape(3, 4), edges=np.arange(8).reshape(4, 2).T,
                  weights=np.ones(4, np.float32), label=1, event_id=17),
    "columns": dict(event_id=np.arange(5), label=np.zeros(5, np.int64), x=np.linspace(0, 1, 5)),
    "fortran-and-empty": dict(a=np.asfortranarray(np.ones((3, 2))), b=np.zeros((0, 4), np.int16),
                              c=np.float64(2.0)),
}


@pytest.mark.parametrize("case", list(NPZ_CASES))
def test_save_npz_writes_the_jax_bytes(tmp_path, case):
    port_npz_io.save_npz(str(tmp_path / "port.npz"), **NPZ_CASES[case])
    jax_npz_io.save_npz(str(tmp_path / "jax.npz"), **NPZ_CASES[case])
    assert filecmp.cmp(tmp_path / "port.npz", tmp_path / "jax.npz", shallow=False)
    loaded = port_npz_io.load_npz(str(tmp_path / "jax.npz"))
    for k, v in NPZ_CASES[case].items():
        np.testing.assert_array_equal(loaded[k], np.asarray(v))


SPLIT_SWEEPS = {
    "tiny": (4, 12, 2),
    "small": (12, 60, 2),
    "odd-and-large": (61, 400, 2),
    "three-classes": (9, 200, 3),
    "one-class": (4, 90, 1),
}


@pytest.mark.parametrize("sweep", list(SPLIT_SWEEPS))
def test_split_matches_sklearn(sweep):
    """Membership and order of both parts, over 60 seeded draws of size,
    label balance and test size (the pipelines' 0.2 and 0.25 among them);
    where scikit-learn refuses a draw, the port refuses it too."""
    lo, hi, k = SPLIT_SWEEPS[sweep]
    rng = np.random.default_rng(len(sweep))
    for trial in range(60):
        n = int(rng.integers(lo, hi))
        p = rng.dirichlet(np.ones(k)) if trial % 2 else np.full(k, 1.0 / k)
        y = rng.choice(k, size=n, p=p)
        ids = rng.permutation(n) * 3 + 11
        test_size = (0.2, 0.2 / (0.2 + 0.6), 0.5, 0.1)[trial % 4]
        try:
            want = sk_train_test_split(ids, y, test_size=test_size, stratify=y, random_state=42)
        except ValueError:
            with pytest.raises(ValueError):
                train_test_split(ids, y, test_size=test_size, stratify=y)
            continue
        got = train_test_split(ids, y, test_size=test_size, stratify=y)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    frame = {"a": np.arange(10), "label": np.array([0, 1] * 5)}
    got = train_test_split(frame, test_size=0.2, stratify=frame["label"])
    want = sk_train_test_split(pd.DataFrame(frame), test_size=0.2, stratify=frame["label"], random_state=42)
    for part, ref in zip(got, want):
        np.testing.assert_array_equal(part["a"], ref["a"].to_numpy())


def _scaler_case(case, rng):
    """(X as the port's pipeline hands it, what scikit-learn is given, names)."""
    n = 20000 if "large" in case else 57
    if case.startswith("frame"):
        df = pd.DataFrame({"a": rng.normal(3, 2, n), "b": rng.exponential(1, n) * 1e4,
                           "n": rng.integers(0, 9, n), "const": np.full(n, 0.1)})
        return feature_block({k: df[k].to_numpy() for k in df}, list(df)), df, list(df)
    if case.startswith("column"):
        v = rng.normal(size=n) * 1e3
        if "nan" in case:
            v[::7] = np.nan
        return feature_block({"energy": v}, ["energy"]), pd.DataFrame({"energy": v}), ["energy"]
    stacked = rng.normal(size=(n, 4)).astype(np.float32)
    return stacked[:, 0:1], stacked[:, 0:1], None


@pytest.mark.parametrize("case", ["frame", "frame-large", "column", "column-large", "column-nan",
                                  "float32-view", "float32-view-large"])
def test_scaler_is_bit_equal_to_sklearn(case):
    X, given, names = _scaler_case(case, np.random.default_rng(3))
    ref = SkStandardScaler().fit(given)
    ours = StandardScaler().fit(X, feature_names=names)
    for attr in ("mean_", "var_", "scale_"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr))
    assert ours.n_samples_seen_ == ref.n_samples_seen_ and ours.n_features_in_ == ref.n_features_in_
    got, want = ours.transform(X), ref.transform(given)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["frame", "column", "float32-view"])
def test_scaler_pickle_round_trips_with_joblib(tmp_path, case):
    X, given, names = _scaler_case(case, np.random.default_rng(4))
    ref = SkStandardScaler().fit(given)
    joblib.dump(ref, tmp_path / "joblib.pkl")
    read = load_scaler(str(tmp_path / "joblib.pkl"))
    for attr in ("mean_", "var_", "scale_"):
        np.testing.assert_array_equal(getattr(read, attr), getattr(ref, attr))
    np.testing.assert_array_equal(read.transform(X), ref.transform(given))
    if names:
        assert list(read.feature_names_in_) == names

    save_scaler(StandardScaler().fit(X, feature_names=names), str(tmp_path / "port.pkl"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no version or feature-name warning
        theirs = joblib.load(tmp_path / "port.pkl")
        assert type(theirs) is SkStandardScaler
        np.testing.assert_array_equal(theirs.transform(given), ref.transform(given))
    if names:
        assert list(theirs.feature_names_in_) == names
    assert list(theirs.__getstate__()) == list(ref.__getstate__())
    with open(tmp_path / "bad.pkl", "wb") as f:
        f.write(b"\x80\x04garbage")
    with pytest.raises(ValueError):
        load_scaler(str(tmp_path / "bad.pkl"))


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    return write_synthetic_dataset(str(root), n_events_per_file=35, n_files_per_particle=2, seed=3)


REPRESENTATIONS = {
    "S2PT": (jax_tabular.Step2PointTabular, port_tabular.Step2PointTabular, dict(convert_to_tensor=True)),
    "S2PPC": (jax_pointcloud.Step2PointPointCloud, port_pointcloud.Step2PointPointCloud,
              dict(energy_cutoff=0.015)),
    "S2PG": (jax_graph.Step2PointGraph, port_graph.Step2PointGraph, {}),
}


def _cache(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*.npz"), recursive=True)):
        with np.load(path) as z:
            out[os.path.relpath(path, root)] = {k: z[k] for k in z.files}
    return out


def _batches(loader):
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("name", list(REPRESENTATIONS))
def test_cache_equals_the_jax_packages(raw, tmp_path, name, workers):
    jax_cls, port_cls, kwargs = REPRESENTATIONS[name]
    dirs = {side: shutil.copytree(raw, str(tmp_path / side)) for side in ("jax", "port")}
    with contextlib.redirect_stdout(io.StringIO()):
        theirs = jax_cls(data_dir=dirs["jax"], create_dataset=True, workers=workers, batch_size=8, **kwargs)
        ours = port_cls(data_dir=dirs["port"], create_dataset=True, workers=workers, batch_size=8, **kwargs)
    a, b = _cache(os.path.join(dirs["port"], name)), _cache(os.path.join(dirs["jax"], name))
    assert list(a) == list(b) and len(a) >= 3
    for fname in a:
        assert list(a[fname]) == list(b[fname]), fname
        for key in a[fname]:
            assert a[fname][key].dtype == b[fname][key].dtype, (fname, key)
            np.testing.assert_array_equal(a[fname][key], b[fname][key], err_msg=f"{fname} {key}")
        if name != "S2PPC":  # np.savez stamps the time into its zip
            assert filecmp.cmp(os.path.join(dirs["port"], name, fname), os.path.join(dirs["jax"], name, fname),
                               shallow=False), fname
    read = load_scaler(os.path.join(dirs["port"], name, f"{name}_scaler.pkl"))
    ref = joblib.load(os.path.join(dirs["jax"], name, f"{name}_scaler.pkl"))
    for attr in ("mean_", "scale_"):
        np.testing.assert_array_equal(getattr(read, attr), getattr(ref, attr))
    for split in ("train", "val", "test"):
        with contextlib.redirect_stdout(io.StringIO()):
            ours_b = _batches(getattr(ours, f"get_{split}_loader")())
            theirs_b = _batches(getattr(theirs, f"get_{split}_loader")())
        assert len(ours_b) == len(theirs_b) > 0
        for x, y in zip(ours_b, theirs_b):
            assert sorted(x) == sorted(y)
            for key in x:
                np.testing.assert_array_equal(x[key], y[key], err_msg=f"{split} {key}")


def test_a_failing_file_names_itself(raw, tmp_path):
    """A file the reader refuses fails the build naming the file, in one
    worker and in a pool of two (whose workers are then killed)."""
    data = shutil.copytree(raw, str(tmp_path / "data"))
    with open(os.path.join(data, "piM_file1.h5"), "wb") as f:
        f.write(b"not hdf5")
    for workers in (1, 2):
        with contextlib.redirect_stdout(io.StringIO()), pytest.raises(RuntimeError, match="piM_file1.h5"):
            port_tabular.Step2PointTabular(data_dir=data, create_dataset=True, workers=workers)


def test_forked_workers_end_with_their_pool(raw, tmp_path):
    """No forked worker outlives ``create_dataset``, built or failed, and a
    worker that does not exit within the grace is killed: a worker left
    behind keeps the pool's manager thread, and so the interpreter's exit,
    waiting."""
    import multiprocessing
    import time
    from concurrent.futures import ProcessPoolExecutor

    from point_cloud_classifier_tpu_torch.data.module import _close_pool

    data = shutil.copytree(raw, str(tmp_path / "data"))
    with contextlib.redirect_stdout(io.StringIO()):
        port_tabular.Step2PointTabular(data_dir=data, create_dataset=True, workers=2)
    assert multiprocessing.active_children() == []
    with open(os.path.join(data, "piM_file1.h5"), "wb") as f:
        f.write(b"not hdf5")
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(RuntimeError, match="piM_file1.h5"):
        port_tabular.Step2PointTabular(data_dir=str(tmp_path / "data"), create_dataset=True, workers=2)
    assert multiprocessing.active_children() == []

    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("fork"))
    busy = pool.submit(time.sleep, 120)
    while not busy.running():
        time.sleep(0.01)
    t0 = time.monotonic()
    _close_pool(pool, 0.5)
    assert time.monotonic() - t0 < 30
    assert multiprocessing.active_children() == []

"""The port's S2PPC cache reader against the JAX package's.

A seeded cache in the JAX package's layout (two parts per split, the rows of
several events interleaved) goes through both ``get_dataloader("s2ppc")``
calls; the batches must be byte-identical.
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from point_cloud_classifier_tpu import factory as jax_factory  # noqa: E402
from point_cloud_classifier_tpu_torch import factory  # noqa: E402
from point_cloud_classifier_tpu_torch.data import synthetic  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402

COLUMNS = ("energy", "energy_total", "position_x", "position_y", "position_z", "time")


def write_cache(data_dir, seed=0, events_per_part=(20, 7, 7), parts=2):
    """``S2PPC_{split}_{part}.npz`` as the JAX package saves them, with the
    rows of an event not contiguous and some events of one hit."""
    rng = np.random.default_rng(seed)
    first_id = 0
    for split, n_events in zip(("train", "val", "test"), events_per_part):
        out = os.path.join(data_dir, "S2PPC", split)
        os.makedirs(out)
        for part in range(parts):
            sizes = rng.integers(1, 30, size=n_events)
            ids = np.repeat(np.arange(first_id, first_id + n_events), sizes)
            first_id += n_events
            order = rng.permutation(len(ids))
            labels = rng.integers(0, 2, size=n_events)[ids - ids.min()]
            cols = {c: rng.normal(size=len(ids)) for c in COLUMNS}
            np.savez(
                os.path.join(out, f"S2PPC_{split}_{part + 3}.npz"),
                event_id=ids[order], label=labels[order],
                **{c: v[order] for c, v in cols.items()},
            )


def _cfg(data_dir, batch_size=8, **extra):
    return {"dataset": {"data_dir": str(data_dir), "batch_size": batch_size,
                        "sparse_batching": True, "energy_cutoff": 0.015, **extra}}


def _assert_same_batches(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seg_encoding", ["ids", "counts"])
@pytest.mark.parametrize("parts", [None, 1])
def test_batches_byte_identical_to_jax(tmp_path, parts, seg_encoding):
    write_cache(tmp_path)
    cfg = _cfg(tmp_path, parts=parts, seg_encoding=seg_encoding)
    ours = factory.get_dataloader("s2ppc", cfg)
    ref = jax_factory.get_dataloader("s2ppc", cfg)
    train, train_ref = ours.get_train_loader(), ref.get_train_loader()
    for _ in range(2):  # two shuffled epochs from the same loaders
        _assert_same_batches(train, train_ref)
    _assert_same_batches(ours.get_val_loader(), ref.get_val_loader())
    _assert_same_batches(ours.get_test_loader(), ref.get_test_loader())


def test_synthetic_cache_reads_as_the_jax_package_reads_it(tmp_path):
    synthetic.write_s2ppc_cache(str(tmp_path), n_events=(40, 9, 9), min_points=3, max_points=9)
    cfg = _cfg(tmp_path, batch_size=16)
    _assert_same_batches(
        factory.get_dataloader("s2ppc", cfg).get_train_loader(),
        jax_factory.get_dataloader("s2ppc", cfg).get_train_loader(),
    )


FLAGSHIP_WIRE = {"layout": "auto", "transfer_dtype": "float16", "factor_event_cols": [1],
                 "length_sorted": True}


@pytest.mark.parametrize("batch_size", [32, 128, 256])
@pytest.mark.parametrize("seg_encoding", ["ids", "counts"])
def test_flagship_wire_batches_byte_identical_to_jax(tmp_path, batch_size, seg_encoding):
    """bench.py's wire (auto layout, fp16, energy_total factored, length
    sorted) through both factories, three train epochs and the val and test
    splits; from B = 128 the train split ships dense and flat batches."""
    synthetic.write_s2ppc_cache(str(tmp_path), n_events=(1100, 300, 300), min_points=3,
                                max_points=12, seed=4)
    cfg = _cfg(tmp_path, batch_size=batch_size, seg_encoding=seg_encoding, **FLAGSHIP_WIRE)
    ours = factory.get_dataloader("s2ppc", cfg)
    ref = jax_factory.get_dataloader("s2ppc", cfg)
    train, train_ref = ours.get_train_loader(), ref.get_train_loader()
    wires = set()
    for _ in range(3):
        batches = list(train)
        _assert_same_batches(batches, train_ref)
        wires |= {b["points"].ndim for b in batches}
        assert all(b["points"].dtype == np.float16 and b["points"].shape[-1] == 5 for b in batches)
        assert all(b["event_feats"].shape == (batch_size + 1, 1) for b in batches)
    assert wires == ({2, 3} if batch_size >= 128 else {2})
    _assert_same_batches(ours.get_val_loader(), ref.get_val_loader())
    _assert_same_batches(ours.get_test_loader(), ref.get_test_loader())


@pytest.mark.parametrize("extra", [{"layout": "dense"}, {"bucket_factor": 1.25},
                                   {"factor_event_cols": [4, 1]}],
                         ids=["dense", "bucket_factor", "two-factored-cols"])
def test_wire_options_byte_identical_to_jax(tmp_path, extra):
    write_cache(tmp_path)
    cfg = _cfg(tmp_path, **extra)
    _assert_same_batches(factory.get_dataloader("s2ppc", cfg).get_train_loader(),
                         jax_factory.get_dataloader("s2ppc", cfg).get_train_loader())


@pytest.mark.parametrize("extra, match", [({"create_dataset": True}, "S2PPC_scaler.pkl")], ids=["create_dataset"])
def test_unported_dataset_options_raise(tmp_path, extra, match):
    """``create_dataset``, refused before the port read raw HDF5, now builds
    the cache from the JAX generator's raw files (its scaler among the
    files) and gives the JAX package's batches."""
    data = {side: write_synthetic_dataset(str(tmp_path / side), n_events_per_file=20, seed=5)
            for side in ("port", "jax")}
    ours = factory.get_dataloader("s2ppc", _cfg(tmp_path / "port", **extra))
    theirs = jax_factory.get_dataloader("s2ppc", _cfg(tmp_path / "jax", **extra))
    assert match in os.listdir(os.path.join(data["port"], "S2PPC"))
    for split in ("train", "val", "test"):
        _assert_same_batches(getattr(ours, f"get_{split}_loader")(), getattr(theirs, f"get_{split}_loader")())


def test_get_dataloader_errors(tmp_path):
    creating = _cfg(tmp_path)
    creating["dataset"] = {"data_dir": str(tmp_path), "create_dataset": True}
    for name in ("s2pt", "s2pg"):  # creation without raw files
        with pytest.raises(FileNotFoundError, match="no raw shower files"):
            factory.get_dataloader(name, creating)
    with pytest.raises(FileNotFoundError, match="Required file is missing"):
        factory.get_dataloader("s2pt", {"dataset": {"data_dir": str(tmp_path)}})
    with pytest.raises(ValueError, match="Unknown dataset"):
        factory.get_dataloader("mnist", _cfg(tmp_path))
    with pytest.raises(FileNotFoundError, match="No files found"):
        factory.get_dataloader("s2ppc", _cfg(tmp_path))

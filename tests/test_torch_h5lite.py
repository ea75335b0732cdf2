"""The port's numpy HDF5 reader and writer (``data/h5lite.py``) and its shower
file layer (``data/hdf5.py``) against h5py and the JAX package, on the CPU:
every dataset of the JAX generator's files and of h5py files written
contiguous, compact, chunked, gzip + shuffle, big-endian, with ``|S`` names,
after a user block, with continuation blocks and 300 names a group, read equal
to h5py's (values, dtype, shape); each unsupported feature refused by a
``ValueError`` naming it; truncations and flipped bytes refused the same way;
h5py reading the port's ``write_shower_file`` output equal to the JAX writer's
and ``write_h5`` round trips; and ``load_shower_file`` and its helpers equal to
the JAX package's."""

import os

import h5py
import numpy as np
import pytest

from point_cloud_classifier_tpu.data import hdf5 as jax_hdf5
from point_cloud_classifier_tpu.data import synthetic as jax_synthetic
from point_cloud_classifier_tpu_torch.data import hdf5 as port_hdf5
from point_cloud_classifier_tpu_torch.data import synthetic as port_synthetic
from point_cloud_classifier_tpu_torch.data.h5lite import read_h5, write_h5

RNG = np.random.default_rng(0)
ARRAYS = {
    "i8": RNG.integers(-9, 9, 1000),
    "f4": RNG.normal(size=1000).astype(np.float32),
    "f8": RNG.normal(size=(37, 3)),
    "u2": RNG.integers(0, 60000, 77).astype(np.uint16),
    "i1": RNG.integers(-100, 100, 10).astype(np.int8),
    "f2": RNG.normal(size=9).astype(np.float16),
    "S": np.array([b"HCalBarrel", b"ECal", b"x"]),
    "pos": RNG.normal(size=(5000, 3)).astype(np.float32),
}


def _h5py_all(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        ref = np.asarray(ref)
        assert got[name].dtype == ref.dtype and got[name].shape == ref.shape, name
        np.testing.assert_array_equal(got[name], ref, err_msg=name)


def _contiguous(f):
    for k, v in ARRAYS.items():
        f.create_dataset(f"g/{k}", data=v)
    f.create_dataset("scalar", data=np.float64(3.5))
    f.create_dataset("empty", data=np.zeros((0,), np.float32))
    f.create_dataset("nested/a/b/c", data=np.arange(3))
    f["g"].attrs["note"] = "an attribute, skipped"


def _chunked(f, **kw):
    for k, v in ARRAYS.items():
        f.create_dataset(k, data=v, chunks=tuple(max(1, s // 3) for s in v.shape), **kw)


def _compact(f):
    for k in ("i8", "S", "f8"):
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        f.create_dataset(k, data=ARRAYS[k][:20], dcpl=dcpl)


def _big_endian(f):
    for k in ("i8", "f4", "f8", "u2"):
        f.create_dataset(k, data=ARRAYS[k].astype(ARRAYS[k].dtype.newbyteorder(">")))


def _partial_chunks(f):
    f.create_dataset("part", shape=(100,), dtype="f4", chunks=(10,), fillvalue=7.0)
    f["part"][:15] = 1
    f.create_dataset("grow", data=np.arange(30.0), maxshape=(None,), chunks=(7,), compression="gzip")
    f.create_dataset("unwritten", shape=(5,), dtype="i8", fillvalue=-3)


def _continuations(f):
    ds = f.create_dataset("x", data=np.arange(10.0))
    for i in range(60):
        ds.attrs[f"a{i}"] = np.arange(i)
    for i in range(300):
        f.create_dataset(f"wide/n{i:03d}", data=np.arange(i % 4))


LAYOUTS = {
    "contiguous": (_contiguous, {}),
    "chunked": (lambda f: _chunked(f), {}),
    "gzip-shuffle": (lambda f: _chunked(f, compression="gzip", shuffle=True), {}),
    "gzip-9": (lambda f: _chunked(f, compression="gzip", compression_opts=9), {}),
    "shuffle": (lambda f: _chunked(f, shuffle=True), {}),
    "compact": (_compact, {}),
    "big-endian": (_big_endian, {}),
    "partial-chunks-and-fill": (_partial_chunks, {}),
    "user-block": (lambda f: f.create_dataset("x", data=ARRAYS["f8"]), {"userblock_size": 1024}),
    "continuations-and-300-names": (_continuations, {}),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reads_what_h5py_reads(tmp_path, layout):
    make, file_kw = LAYOUTS[layout]
    path = str(tmp_path / f"{layout}.h5")
    with h5py.File(path, "w", **file_kw) as f:
        make(f)
    want = _h5py_all(path)
    _assert_same(read_h5(path), want)
    with open(path, "rb") as f:
        _assert_same(read_h5(f.read()), want)


def test_reads_the_jax_generators_files(tmp_path):
    jax_synthetic.write_synthetic_dataset(str(tmp_path), n_events_per_file=40, n_files_per_particle=2, seed=3)
    for name in sorted(os.listdir(tmp_path)):
        path = str(tmp_path / name)
        _assert_same(read_h5(path), _h5py_all(path))
        ours, theirs = port_hdf5.load_shower_file(path), jax_hdf5.load_shower_file(path)
        assert list(ours) == list(theirs)
        _assert_same(ours, theirs)


def _latest(f):
    f.create_dataset("x", data=np.arange(3))


def _vlen(f):
    f.create_dataset("s", data=np.array(["a", "bc"], dtype=h5py.string_dtype()))


REFUSED = {
    "libver-latest": (_latest, {"libver": "latest"}, "superblock version 3"),
    "track-order": (_latest, {"track_order": True}, "object header version 2"),
    "vlen-strings": (_vlen, {}, "variable-length strings"),
    "lzf": (lambda f: f.create_dataset("x", data=np.arange(100), compression="lzf"), {}, "lzf filter"),
    "fletcher32": (lambda f: f.create_dataset("x", data=np.arange(100), fletcher32=True), {}, "fletcher32 filter"),
    "soft-link": (lambda f: (f.create_dataset("x", data=np.arange(3)), f.__setitem__("y", h5py.SoftLink("/x"))),
                  {}, "y: soft links"),
    "compound": (lambda f: f.create_dataset("x", data=np.zeros(3, dtype=[("a", "i4"), ("b", "f8")])), {},
                 "x: datatype class 6 \\(compound\\)"),
    "enum-bool": (lambda f: f.create_dataset("x", data=np.zeros(3, dtype=bool)), {}, "class 8 \\(enum\\)"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refuses_unsupported_features_by_name(tmp_path, case):
    make, file_kw, message = REFUSED[case]
    path = str(tmp_path / "x.h5")
    with h5py.File(path, "w", **file_kw) as f:
        make(f)
    with pytest.raises(ValueError, match=message):
        read_h5(path)


@pytest.mark.parametrize("case", ["truncated", "garbage", "empty", "external"])
def test_refuses_broken_files_by_name(tmp_path, case):
    path = str(tmp_path / "x.h5")
    if case == "external":
        with h5py.File(path, "w") as f:
            f.create_dataset("x", shape=(4,), dtype="f8", external=[(str(tmp_path / "ext.bin"), 0, 32)])
        message = "x: external storage"
    elif case == "truncated":
        jax_synthetic.write_shower_file(path, "proton", 20, 1)
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])
        message = "truncated file"
    else:
        with open(path, "wb") as f:
            f.write(b"this is not an hdf5 file" * (10 if case == "garbage" else 0))
        message = "not an HDF5 file"
    with pytest.raises(ValueError, match=message):
        read_h5(path)


def test_cut_or_flipped_bytes_raise_value_error_only(tmp_path):
    """A file cut at 120 places, and 120 copies with 20 bytes flipped at
    random, each read raises ``ValueError`` or reads; no other exception."""
    path = str(tmp_path / "x.h5")
    with h5py.File(path, "w") as f:
        _chunked(f, compression="gzip", shuffle=True)
        f.create_dataset("plain/f8", data=ARRAYS["f8"])
    with open(path, "rb") as f:
        blob = f.read()
    rng = np.random.default_rng(1)
    cases = [blob[:cut] for cut in np.linspace(0, len(blob) - 1, 120).astype(int)]
    for _ in range(120):
        flipped = np.frombuffer(blob, np.uint8).copy()
        flipped[rng.integers(0, len(blob), 20)] = rng.integers(0, 256, 20)
        cases.append(flipped.tobytes())
    for case in cases:
        try:
            read_h5(case)
        except ValueError:
            pass


def test_h5py_reads_the_ports_shower_files_equal_to_the_jax_writers(tmp_path):
    jax_synthetic.write_synthetic_dataset(str(tmp_path / "jax"), n_events_per_file=35, n_files_per_particle=2, seed=7)
    port_synthetic.write_synthetic_dataset(str(tmp_path / "port"), n_events_per_file=35, n_files_per_particle=2,
                                           seed=7)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "piM_file0.h5", "piM_file1.h5", "proton_file0.h5", "proton_file1.h5"]
    for name in names:
        ours, theirs = _h5py_all(str(tmp_path / "port" / name)), _h5py_all(str(tmp_path / "jax" / name))
        _assert_same(ours, theirs)
        _assert_same(read_h5(str(tmp_path / "port" / name)), theirs)


def test_write_h5_round_trips_through_h5py(tmp_path):
    arrays = {f"group/{k}": v for k, v in ARRAYS.items() if k != "pos"}
    arrays.update({"top": np.arange(5, dtype=">i4"), "deep/er/x": np.float32(2.5),
                   **{f"many/m{i:02d}": np.arange(i, dtype=np.float64) for i in range(40)}})
    path = str(tmp_path / "w.h5")
    write_h5(path, arrays)
    _assert_same(_h5py_all(path), {k: np.asarray(v) for k, v in arrays.items()})
    _assert_same(read_h5(path), {k: np.asarray(v) for k, v in arrays.items()})
    with pytest.raises(ValueError, match="integers, IEEE floats and fixed-length bytes"):
        write_h5(path, {"x": np.zeros(2, dtype=bool)})


def test_shower_helpers_match_jax(tmp_path):
    jax_synthetic.write_synthetic_dataset(str(tmp_path / "a" / "b"), n_events_per_file=5, seed=1)
    for particle in ("proton", "piM", "x"):
        assert port_hdf5.find_shower_files(str(tmp_path), particle) == jax_hdf5.find_shower_files(
            str(tmp_path), particle)
    for name in ("proton_file0.h5", "/a/b/piM_file12.hdf5", "x_y_file3.h5"):
        assert port_hdf5.parse_part_number(name) == jax_hdf5.parse_part_number(name)
    raw = np.array(port_synthetic.SUBDETECTOR_NAMES * 3)[np.random.default_rng(0).permutation(15)]
    decoded = port_hdf5.decode_subdetectors(raw)
    np.testing.assert_array_equal(decoded, jax_hdf5.decode_subdetectors(raw))
    np.testing.assert_array_equal(port_hdf5.detector_category(decoded), jax_hdf5.detector_category(decoded))
    path = str(tmp_path / "partial.h5")
    write_h5(path, {"steps/energy": np.zeros(2)})
    with pytest.raises(KeyError, match="metadata/subdetector_names"):
        port_hdf5.load_shower_file(path)

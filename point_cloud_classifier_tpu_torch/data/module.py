"""Dataset creation shared by the three representations, on numpy columns.

Counterpart of ``point_cloud_classifier_tpu/data/module.py`` (``DataModule``),
which runs on pandas and scikit-learn; neither is on the H100 machine, so the
two pieces of scikit-learn it calls are copied here in numpy, bit for bit:

- :func:`train_test_split` with ``stratify`` and ``random_state``: scikit-learn
  1.9's ``_validate_shuffle_split`` (``n_test = ceil(test_size · n)``) and
  ``StratifiedShuffleSplit._iter_indices`` over ``np.random.RandomState``
  (``_approximate_mode``'s tie-breaking draws, the stable argsort by class,
  one permutation a class, then a permutation of each side);
- :class:`StandardScaler`: ``fit`` as ``partial_fit`` computes it through
  ``_incremental_mean_and_var`` (float64 sums, the correction term of the
  two-pass algorithm, ``_is_constant_feature`` and
  ``_handle_zeros_in_scale``), ``transform`` as ``(X - mean) / scale`` in X's
  type.  The sums run over the same array layout as scikit-learn's (a
  DataFrame of several columns reaches it Fortran-ordered), so they round
  alike.

The scaler is kept where the JAX package keeps it,
``{data_dir}/{NAME}/{NAME}_scaler.pkl``.  :func:`load_scaler` reads it
whether joblib wrote it (each array a ``NumpyArrayWrapper`` whose bytes
follow the pickle stream, an object array pickled inside it) or this module
did, without joblib or scikit-learn: a pure-Python unpickler that resolves a
short list of classes and reads each wrapped array's bytes after its BUILD.
:func:`save_scaler` writes a plain pickle whose class reference is
``sklearn.preprocessing._data.StandardScaler`` (emitted by hand, since the
class cannot be imported here) with the state scikit-learn's
``__getstate__`` gives, so the JAX package's ``joblib.load`` returns a
working scikit-learn scaler, ``feature_names_in_`` included.

A split is a dict of columns (``Columns``) in the JAX frame's column order.
:class:`DataModule` runs the JAX pipeline: the file jobs (each particle's
files in ``os.walk`` order), their load and preprocess fanned out over
``workers`` forked processes (``PCC_FILE_TIMEOUT`` seconds a file, the
workers killed on a failure), then in order the event-id offsets, the
per-file stratified 60/20/20 split at seed 42, the concatenation, the
bookkeeping assert, the train-fit scaler and the representation's save.
The forked workers run numpy only; a worker that touched CUDA would fail
(torch refuses CUDA in a child forked after the parent initialized it).
"""

from __future__ import annotations

import math
import os
import pickle
import time
from typing import Dict, List, Sequence

import numpy as np

from point_cloud_classifier_tpu_torch.data.hdf5 import find_shower_files, load_shower_file

LABEL_MAP = {"proton": 0, "piM": 1}
SPLITS = ("train", "val", "test")
Columns = Dict[str, np.ndarray]


# -- scikit-learn's stratified split -------------------------------------------


def _n_train_test(n_samples: int, test_size) -> tuple:
    """``_validate_shuffle_split`` for a float or integer ``test_size``."""
    if isinstance(test_size, float):
        if not 0 < test_size < 1:
            raise ValueError(f"test_size={test_size} should be in the (0, 1) range")
        n_test = math.ceil(test_size * n_samples)
    else:
        if not 0 < test_size < n_samples:
            raise ValueError(f"test_size={test_size} should be positive and smaller than {n_samples}")
        n_test = int(test_size)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples} and test_size={test_size} the train set is empty")
    return n_train, n_test


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_split(n_samples: int, y, test_size, random_state: int = 42) -> tuple:
    """(train indices, test indices): ``StratifiedShuffleSplit`` with one
    split, as ``train_test_split(..., stratify=y)`` calls it."""
    n_train, n_test = _n_train_test(n_samples, test_size)
    classes, y_indices, class_counts = np.unique(np.asarray(y), return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is too few. Classes with "
            f"too few members are: {classes[class_counts < 2].tolist()}"
        )
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train and test sizes {n_train}, {n_test} are under the {len(classes)} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        permutation = rng.permutation(class_counts[i])
        perm_indices_class_i = class_indices[i].take(permutation, mode="clip")
        train.extend(perm_indices_class_i[: n_i[i]])
        test.extend(perm_indices_class_i[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _take(a, idx):
    if isinstance(a, dict):
        return {k: v[idx] for k, v in a.items()}
    if isinstance(a, list):
        return [a[i] for i in idx]
    return np.asarray(a)[idx]


def train_test_split(*arrays, test_size, stratify, random_state: int = 42) -> list:
    """``sklearn.model_selection.train_test_split`` with ``stratify``: for
    each of ``arrays`` (numpy arrays, lists, or dicts of columns, whose
    rows are then taken in the split's order) its train part, then its test
    part."""
    n = len(next(iter(arrays[0].values()))) if isinstance(arrays[0], dict) else len(arrays[0])
    train, test = _stratified_split(n, stratify, test_size, random_state)
    return [part for a in arrays for part in (_take(a, train), _take(a, test))]


# -- scikit-learn's StandardScaler ------------------------------------------------

_SKLEARN_MODULE = "sklearn.preprocessing._data"
_SKLEARN_VERSION = "1.9.0"  # the scikit-learn whose arithmetic this copies


def _accumulate(op, x: np.ndarray, **kwargs):
    """``_safe_accumulator_op``: sums of float32 accumulate in float64."""
    if x.dtype.kind == "f" and x.dtype.itemsize < 8:
        return op(x, **kwargs, dtype=np.float64)
    return op(x, **kwargs)


def _validated(X) -> np.ndarray:
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"Expected a 2D array, got {X.ndim}D")
    if X.dtype not in (np.float64, np.float32):
        X = X.astype(np.float64)
    if np.isinf(X).any():
        raise ValueError("Input X contains infinity or a value too large for dtype('float64').")
    return X


class StandardScaler:
    """scikit-learn's ``StandardScaler`` (``with_mean`` and ``with_std``),
    with its fitted attributes and pickled state."""

    def __init__(self):
        self.with_mean = True
        self.with_std = True
        self.copy = True

    def fit(self, X, feature_names: Sequence[str] = None) -> "StandardScaler":
        """Fit ``X`` [N, F] as scikit-learn does one batch; ``feature_names``
        are a DataFrame's columns (``feature_names_in_``)."""
        self.__dict__ = {"with_mean": True, "with_std": True, "copy": True}
        X = _validated(X)
        if feature_names is not None:
            self.feature_names_in_ = np.asarray(list(feature_names), dtype=object)
        self.n_features_in_ = X.shape[1]
        last_sample_count = np.zeros(X.shape[1], dtype=np.float64)
        last_mean, last_variance = 0.0, 0.0
        last_sum = last_mean * last_sample_count
        nan_mask = np.isnan(X)
        sum_op = np.nansum if nan_mask.any() else np.sum
        new_sum = _accumulate(sum_op, X, axis=0)
        new_sample_count = X.shape[0] - _accumulate(sum_op, nan_mask.astype(X.dtype), axis=0)
        updated_sample_count = last_sample_count + new_sample_count
        updated_mean = (last_sum + new_sum) / updated_sample_count
        T = new_sum / new_sample_count
        temp = X - T
        correction = _accumulate(sum_op, temp, axis=0)
        temp **= 2
        new_unnormalized_variance = _accumulate(sum_op, temp, axis=0)
        new_unnormalized_variance -= correction**2 / new_sample_count
        last_unnormalized_variance = last_variance * last_sample_count
        with np.errstate(divide="ignore", invalid="ignore"):
            last_over_new_count = last_sample_count / new_sample_count
            updated_unnormalized_variance = (
                last_unnormalized_variance
                + new_unnormalized_variance
                + last_over_new_count / updated_sample_count * (last_sum / last_over_new_count - new_sum) ** 2
            )
        zeros = last_sample_count == 0
        updated_unnormalized_variance[zeros] = new_unnormalized_variance[zeros]
        self.mean_ = updated_mean
        self.var_ = updated_unnormalized_variance / updated_sample_count
        self.n_samples_seen_ = updated_sample_count
        if np.max(self.n_samples_seen_) == np.min(self.n_samples_seen_):
            self.n_samples_seen_ = self.n_samples_seen_[0]
        eps = np.finfo(np.float64).eps
        n = self.n_samples_seen_
        constant_mask = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
        self.scale_ = np.sqrt(self.var_)
        self.scale_[constant_mask] = 1.0
        return self

    def transform(self, X) -> np.ndarray:
        X = np.array(_validated(X), copy=True)
        X -= self.mean_.astype(X.dtype)
        X /= self.scale_.astype(X.dtype)
        return X

    def fit_transform(self, X, feature_names: Sequence[str] = None) -> np.ndarray:
        return self.fit(X, feature_names).transform(X)

    # scikit-learn's pickled state: its attributes in __getstate__'s order
    _STATE = ("with_mean", "with_std", "copy", "feature_names_in_", "n_features_in_",
              "n_samples_seen_", "mean_", "var_", "scale_")

    def __getstate__(self) -> dict:
        state = {k: self.__dict__[k] for k in self._STATE if k in self.__dict__}
        state["_sklearn_version"] = _SKLEARN_VERSION
        return state

    def __setstate__(self, state: dict) -> None:
        state = dict(state)
        state.pop("_sklearn_version", None)
        self.__dict__.update(state)


class _ScalerPickler(pickle._Pickler):
    """Pickles :class:`StandardScaler` under scikit-learn's class name."""

    def save_global(self, obj, name=None):
        if obj is not StandardScaler:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(_SKLEARN_MODULE)
            self.save("StandardScaler")
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{_SKLEARN_MODULE}\nStandardScaler\n".encode())
        self.memoize(obj)


def save_scaler(scaler: StandardScaler, path: str) -> None:
    """Write ``scaler`` as a pickle of scikit-learn's ``StandardScaler``
    (``joblib.load`` and ``pickle.load`` read it where scikit-learn is)."""
    with open(path, "wb") as f:
        _ScalerPickler(f, protocol=4).dump(scaler)


class _ArrayWrapper:
    """joblib's ``NumpyArrayWrapper``: an array's dtype, shape and order,
    its bytes following in the file."""


def _numpy_globals() -> dict:
    arr = np.zeros(1)
    found = {
        ("numpy", "ndarray"): np.ndarray,
        ("numpy", "dtype"): np.dtype,
        ("_codecs", "encode"): __import__("codecs").encode,
    }
    for fn in (arr.__reduce__()[0], np.float64(0).__reduce__()[0], arr.__reduce_ex__(5)[0]):
        for module in ("numpy.core", "numpy._core"):
            for sub in ("multiarray", "numeric"):
                found[(f"{module}.{sub}", fn.__name__)] = fn
    return found


class _ScalerUnpickler(pickle._Unpickler):
    """Reads a scaler pickle, joblib's or a plain one, resolving only
    numpy's array pieces, joblib's array wrapper and scikit-learn's
    ``StandardScaler`` (as :class:`StandardScaler`)."""

    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, file):
        super().__init__(file)
        self._fh = file
        self._globals = _numpy_globals()

    def find_class(self, module, name):
        if name == "StandardScaler" and module in (_SKLEARN_MODULE, "sklearn.preprocessing.data"):
            return StandardScaler
        if (module, name) == ("joblib.numpy_pickle", "NumpyArrayWrapper"):
            return _ArrayWrapper
        if (module, name) in self._globals:
            return self._globals[(module, name)]
        raise pickle.UnpicklingError(f"a scaler pickle refers to {module}.{name}")

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack.append(self._wrapped_array(self.stack.pop()))

    dispatch[pickle.BUILD[0]] = load_build

    def _wrapped_array(self, wrapper: _ArrayWrapper) -> np.ndarray:
        dtype, shape = np.dtype(wrapper.dtype), tuple(wrapper.shape)
        if dtype.hasobject:
            return _ScalerUnpickler(self._fh).load()
        if getattr(wrapper, "numpy_array_alignment_bytes", None) is not None:
            self._fh.read(self._fh.read(1)[0])
        count = int(np.prod(shape, dtype=np.int64))
        raw = self._fh.read(count * dtype.itemsize)
        if len(raw) != count * dtype.itemsize:
            raise ValueError("a truncated scaler pickle")
        array = np.frombuffer(raw, dtype=dtype, count=count).copy()
        if wrapper.order == "F":
            return array.reshape(shape[::-1]).transpose()
        return array.reshape(shape)


def load_scaler(path: str) -> StandardScaler:
    """The scaler pickled at ``path`` by joblib (the JAX package) or by
    :func:`save_scaler`, read without joblib or scikit-learn."""
    with open(path, "rb") as f:
        if f.read(1) != pickle.PROTO:
            raise ValueError(f"{path}: not an uncompressed pickle of protocol 2 or later")
        f.seek(0)
        try:
            scaler = _ScalerUnpickler(f).load()
        except (pickle.UnpicklingError, EOFError, TypeError, AttributeError) as exc:
            raise ValueError(f"{path}: not a StandardScaler pickle ({exc})") from exc
    if not isinstance(scaler, StandardScaler):
        raise ValueError(f"{path}: holds a {type(scaler).__name__}, not a StandardScaler")
    return scaler


def scaler_path(data_dir: str, name: str) -> str:
    return os.path.join(data_dir, name, f"{name}_scaler.pkl")


# -- columns ----------------------------------------------------------------------


def take_rows(columns: Columns, idx) -> Columns:
    return {k: v[idx] for k, v in columns.items()}


def concat_columns(parts: List[Columns]) -> Columns:
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def remap_event_ids(event_ids: np.ndarray) -> np.ndarray:
    """Event ids → 0..n-1 in their order of first appearance."""
    uniq, first, inv = np.unique(event_ids, return_index=True, return_inverse=True)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    return rank[inv]


def feature_block(columns: Columns, names: Sequence[str]) -> np.ndarray:
    """``columns[names]`` as the 2-D array scikit-learn makes of a
    DataFrame's columns: float64, and Fortran-ordered for several columns
    (one column is both orders)."""
    block = np.empty((len(names), len(columns[names[0]])), dtype=np.float64)
    for j, name in enumerate(names):
        block[j] = columns[name]
    return block.T


# seconds a forked worker has to exit once its pool is shut down; then it is
# killed, since one that hangs on a lock inherited from a threaded parent
# would keep the pool's manager thread, and so the interpreter's exit, waiting
_POOL_EXIT_GRACE = 10.0


def _close_pool(pool, grace: float) -> None:
    """Shut ``pool`` (a ``ProcessPoolExecutor``) down, cancelling what has not
    started; give its workers ``grace`` seconds to exit, kill any still
    alive, and wait for its manager thread."""
    procs = list((getattr(pool, "_processes", None) or {}).values())  # shutdown forgets them
    manager = getattr(pool, "_executor_manager_thread", None)
    pool.shutdown(wait=False, cancel_futures=True)
    deadline = time.monotonic() + grace
    for proc in procs:
        proc.join(timeout=max(0.0, deadline - time.monotonic()))
        if proc.is_alive():
            proc.kill()
            proc.join()
    if manager is not None:
        manager.join(timeout=max(1.0, deadline - time.monotonic()))


class DataModule:
    """Dataset creation for one representation (subclasses give
    ``_preprocess_data``, ``_save_datasets`` and their name)."""

    name = "BASE"

    def __init__(
        self,
        data_dir: str,
        particles: Sequence[str] = ("proton", "piM"),
        create_dataset: bool = False,
        feature_scaling: bool = True,
        batch_size: int = None,
        workers: int = 1,
    ):
        self.data_dir = data_dir
        self.particles = list(particles)
        self.create_dataset = create_dataset
        self.feature_scaling = feature_scaling
        self.batch_size = batch_size
        self.workers = max(1, int(workers))
        self.data_split = (0.6, 0.2, 0.2)
        self.datasets: Dict[str, object] = {s: [] for s in SPLITS}
        # dataset creation renumbers events; raw inference keeps the file's ids
        self.remap_event_ids = True

    # -- the file jobs -----------------------------------------------------------

    def _file_jobs(self) -> List[tuple]:
        """(particle, path) of every file, each particle's in ``os.walk`` order."""
        jobs = [(p, fp) for p in self.particles for fp in find_shower_files(self.data_dir, p)]
        if not jobs:
            raise FileNotFoundError(f"no raw shower files (*.h5, *.hdf5) of {self.particles} under {self.data_dir}")
        return jobs

    def _preprocess_file(self, job: tuple):
        """(events in the file, its preprocessed rows with the file's own
        event ids) for one job."""
        particle, filepath = job
        raw = load_shower_file(filepath)
        return len(np.unique(raw["event_id"])), self._preprocess_data(raw, particle)

    def _map_files(self, jobs: List[tuple]):
        """``_preprocess_file`` of every job, in job order, over ``workers``
        forked processes (sequential for one worker, or where fork is not
        available).  A file that fails, or takes more than
        ``PCC_FILE_TIMEOUT`` seconds (default 3600), raises naming it, and
        the workers are killed; on success each worker has a few seconds to
        exit, then is killed (:func:`_close_pool`)."""
        import multiprocessing

        n = min(self.workers, len(jobs))
        if n <= 1 or "fork" not in multiprocessing.get_all_start_methods():
            for job in jobs:
                try:
                    yield self._preprocess_file(job)
                except Exception as e:
                    raise RuntimeError(f"preprocessing failed on {job[1]}") from e
            return
        from concurrent.futures import ProcessPoolExecutor

        timeout = float(os.environ.get("PCC_FILE_TIMEOUT", "3600"))
        pool = ProcessPoolExecutor(max_workers=n, mp_context=multiprocessing.get_context("fork"))
        futures = [(job, pool.submit(self._preprocess_file, job)) for job in jobs]
        grace = _POOL_EXIT_GRACE
        try:
            for job, fut in futures:
                try:
                    yield fut.result(timeout=timeout)
                except Exception as e:
                    grace = 0.0
                    raise RuntimeError(
                        f"preprocessing failed (or timed out after {timeout:.0f}s: a forked worker "
                        f"can deadlock on an inherited lock; retry with workers=1) on {job[1]}"
                    ) from e
        finally:
            _close_pool(pool, grace)

    # -- the pipeline ------------------------------------------------------------

    def _create_dataset(self) -> None:
        """Per file: offset its event ids by the events before it, split
        it; then concatenate each split, check the event count, scale and
        save."""
        parts = {s: [] for s in SPLITS}
        event_id_offset = 0
        jobs = self._file_jobs()
        for (particle, filepath), (num_events, columns) in zip(jobs, self._map_files(jobs)):
            print(os.path.basename(filepath))
            columns["source_file"] = np.full(len(columns["event_id"]), os.path.basename(filepath))
            columns["event_id"] = columns["event_id"] + event_id_offset
            event_id_offset += num_events
            for split, part in zip(SPLITS, self._split_dataset(columns)):
                parts[split].append(part)

        self.datasets = {s: concat_columns(parts[s]) for s in SPLITS}
        total_events = sum(len(np.unique(self.datasets[s]["event_id"])) for s in SPLITS)
        assert event_id_offset == total_events, (
            f"event bookkeeping mismatch: offset={event_id_offset} events={total_events}"
        )
        if self.feature_scaling:
            self._scale_features()
        self._save_datasets()
        for split in SPLITS:
            self.datasets[split].pop("source_file")

    def _split_dataset(self, columns: Columns):
        """Event-level stratified 60/20/20 at seed 42, as the JAX package
        calls scikit-learn: test first, with the ids in order of appearance
        beside the labels in sorted-id order (a ``groupby``), then val out of
        train with the labels of the train ids; rows keep their order."""
        train_frac, val_frac, test_frac = self.data_split
        event_ids = columns["event_id"]
        uniq, first = np.unique(event_ids, return_index=True)
        appearance = uniq[np.argsort(first, kind="stable")]
        labels_by_id = columns["label"][first]
        train_ids, test_ids = train_test_split(appearance, test_size=test_frac, stratify=labels_by_id)
        train_ids, val_ids = train_test_split(
            train_ids,
            test_size=val_frac / (val_frac + train_frac),
            stratify=labels_by_id[np.searchsorted(uniq, train_ids)],
        )
        return tuple(take_rows(columns, np.isin(event_ids, ids)) for ids in (train_ids, val_ids, test_ids))

    def _feature_columns(self) -> List[str]:
        return [c for c in self.datasets["train"] if c not in ("label", "event_id", "source_file")]

    def _scale_features(self, feature_cols: List[str] = None) -> None:
        """Fit a scaler on the train split's ``feature_cols``, apply it to
        every split and pickle it to ``{data_dir}/{NAME}/{NAME}_scaler.pkl``."""
        if feature_cols is None:
            feature_cols = self._feature_columns()
        print("Scaling the following columns:", feature_cols)
        scaler = StandardScaler()
        scaled = {"train": scaler.fit_transform(feature_block(self.datasets["train"], feature_cols),
                                                feature_names=feature_cols)}
        for split in ("val", "test"):
            scaled[split] = scaler.transform(feature_block(self.datasets[split], feature_cols))
        self.scaler = scaler
        os.makedirs(os.path.join(self.data_dir, self.name), exist_ok=True)
        save_scaler(scaler, scaler_path(self.data_dir, self.name))
        for split in SPLITS:
            for j, col in enumerate(feature_cols):
                self.datasets[split][col] = scaled[split][:, j]

    # -- the representation ---------------------------------------------------------

    def _preprocess_data(self, raw: Dict[str, np.ndarray], particle: str):
        raise NotImplementedError

    def _save_datasets(self) -> None:
        raise NotImplementedError

"""The port's numpy PointCloudLoader gives byte-identical batches to the JAX
package's loader on every wire: flat and dense, f32 and fp16, with and
without factored event columns, unsorted and length-sorted."""

import numpy as np
import pytest

from point_cloud_classifier_tpu.data.batching import PointCloudLoader as JaxLoader
from point_cloud_classifier_tpu.data.batching import pow2_bucket as jax_pow2_bucket
from point_cloud_classifier_tpu_torch.data.batching import PointCloudLoader, pow2_bucket


def _events(seed=0, n=45):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 90, size=n)
    sizes[3] = 0  # an empty event
    events = [rng.normal(size=(int(k), 6)).astype(np.float32) for k in sizes]
    labels = rng.integers(0, 2, size=n)
    return events, labels


def _assert_same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)  # same keys in the same order
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            assert a[key].tobytes() == b[key].tobytes(), key


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(seg_encoding="ids"),
        dict(seg_encoding="counts"),
        dict(seg_encoding="ids", shuffle=True, seed=3),
        dict(seg_encoding="counts", shuffle=True),
        dict(seg_encoding="ids", min_bucket=64),
        dict(seg_encoding="counts", min_bucket=8),
    ],
    ids=["ids", "counts", "ids-shuffled", "counts-shuffled", "ids-bucket64", "counts-bucket8"],
)
def test_flat_batches_are_byte_identical(kwargs):
    events, labels = _events()
    kwargs = {"shuffle": False, **kwargs}
    ours = PointCloudLoader(events, labels, 8, **kwargs)
    theirs = JaxLoader(events, labels, 8, layout="flat", **kwargs)
    assert len(ours) == len(theirs)
    _assert_same_batches(ours, theirs)
    if kwargs["shuffle"]:  # the second epoch reshuffles the same way
        _assert_same_batches(ours, theirs)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1000, 65536, 65537])
@pytest.mark.parametrize("min_size", [8, 256])
def test_pow2_bucket_matches_jax(n, min_size):
    assert pow2_bucket(n, min_size) == jax_pow2_bucket(n, min_size)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 321, 1000, 65536, 65537])
@pytest.mark.parametrize("factor", [1.25, 2.0])
def test_pow2_bucket_with_a_factor_matches_jax(n, factor):
    assert pow2_bucket(n, 256, factor) == jax_pow2_bucket(n, 256, factor)


@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_pow2_bucket_refuses_a_factor_that_cannot_grow(factor):
    with pytest.raises(ValueError, match="bucket factor"):
        pow2_bucket(300, 256, factor)


def _wire_events(b, seed=1):
    """``3·b + 5`` events, columns 1 and 4 constant per event: the first
    ``b`` of 20–24 points (the auto gate ships them dense from B = 128),
    the rest of 1–59 (flat), event 3 empty."""
    rng = np.random.default_rng(seed)
    n = 3 * b + 5
    sizes = np.concatenate([rng.integers(20, 25, size=b), rng.integers(1, 60, size=n - b)])
    sizes[3] = 0
    events = [rng.normal(size=(int(k), 6)).astype(np.float32) for k in sizes]
    for e in events:
        e[:, 1], e[:, 4] = rng.normal(), rng.normal()
    return events, rng.integers(0, 2, size=n)


@pytest.mark.parametrize("shuffle", [False, True], ids=["in-order", "shuffled"])
@pytest.mark.parametrize("seg_encoding", ["ids", "counts"])
@pytest.mark.parametrize("length_sorted", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("factor_event_cols", [(), (1,), (1, 4)], ids=["no-fac", "fac1", "fac14"])
@pytest.mark.parametrize("transfer_dtype", ["float32", "float16"], ids=["f32", "f16"])
@pytest.mark.parametrize("layout", ["flat", "dense", "auto"])
@pytest.mark.parametrize("b", [4, 128, 130])
def test_every_wire_is_byte_identical_over_three_epochs(
    b, layout, transfer_dtype, factor_event_cols, length_sorted, seg_encoding, shuffle
):
    events, labels = _wire_events(b)
    kwargs = dict(shuffle=shuffle, seed=5, min_bucket=64, layout=layout,
                  transfer_dtype=transfer_dtype, factor_event_cols=factor_event_cols,
                  length_sorted=length_sorted, seg_encoding=seg_encoding)
    ours, theirs = PointCloudLoader(events, labels, b, **kwargs), JaxLoader(events, labels, b, **kwargs)
    for _ in range(3):
        _assert_same_batches(ours, theirs)


@pytest.mark.parametrize("b", [128, 130])
def test_auto_layout_takes_both_wires(b):
    events, labels = _wire_events(b)
    wires = [batch["points"].ndim for batch in PointCloudLoader(events, labels, b, False, layout="auto")]
    assert wires[0] == 3 and 2 in wires
    assert {batch["points"].ndim for batch in PointCloudLoader(events, labels, 127, False, layout="auto")} == {2}


def test_unknown_seg_encoding_raises():
    events, labels = _events()
    with pytest.raises(ValueError):
        PointCloudLoader(events, labels, 8, shuffle=False, seg_encoding="dense")

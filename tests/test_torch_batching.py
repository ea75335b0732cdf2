"""The port's numpy PointCloudLoader gives byte-identical batches to the JAX
package's loader on the flat wire."""

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


def test_unknown_seg_encoding_raises():
    events, labels = _events()
    with pytest.raises(ValueError):
        PointCloudLoader(events, labels, 8, shuffle=False, seg_encoding="dense")

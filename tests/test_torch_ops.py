"""PyTorch port of ops/activations, ops/segment and utils/config against the
JAX package, on the same seeded numpy inputs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.ops import activations as jax_act  # noqa: E402
from point_cloud_classifier_tpu.ops import segment as jax_seg  # noqa: E402
from point_cloud_classifier_tpu.utils.config import load_config as jax_load_config  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import activations, segment  # noqa: E402
from point_cloud_classifier_tpu_torch.utils.config import load_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(seed=0, n=513):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.linspace(-8, 8, n), rng.normal(size=n) * 3]).astype(np.float32)


@pytest.mark.parametrize("gelu", ["quick", "exact"])
@pytest.mark.parametrize("name", ["relu", "silu", "tanh", "gelu"])
def test_activation_matches_jax(name, gelu, monkeypatch):
    monkeypatch.setenv("PCC_GELU", gelu)
    x = _x()
    ref = np.asarray(jax_act.resolve_activation(name)(jnp.asarray(x)))
    out = activations.resolve_activation(name)(torch.from_numpy(x)).numpy()
    # f32 elementwise: both evaluate the same formula; transcendental
    # implementations differ by a few ulps
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_unknown_activation_and_gelu_variant_raise(monkeypatch):
    with pytest.raises(ValueError):
        activations.resolve_activation("swish")
    monkeypatch.setenv("PCC_GELU", "poly")  # the JAX package's polynomial form is not ported
    with pytest.raises(ValueError):
        activations.resolve_activation("gelu")


def _segments(seed=0, p=200, s=9, h=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s, size=p).astype(np.int32)
    ids[ids == 4] = 5  # segment 4 is empty
    return rng.normal(size=(p, h)).astype(np.float32), ids, s


def test_segment_sum_and_count_match_jax():
    data, ids, s = _segments()
    ref = np.asarray(jax_seg.segment_sum(jnp.asarray(data), jnp.asarray(ids), s))
    out = segment.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), s).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)
    ref_c = np.asarray(jax_seg.segment_count(jnp.asarray(ids), s))
    out_c = segment.segment_count(torch.from_numpy(ids), s).numpy()
    np.testing.assert_array_equal(out_c, ref_c)
    assert out_c[4] == 0


def test_segment_max_matches_jax_with_empty_segment():
    data, ids, s = _segments(seed=1)
    ref = np.asarray(jax_seg.segment_max(jnp.asarray(data), jnp.asarray(ids), s))
    out = segment.segment_max(torch.from_numpy(data), torch.from_numpy(ids), s).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[4] == 0).all()


@pytest.mark.parametrize("counts", [[3, 0, 5, 1, 7], [0, 0, 4], [16], [1, 1, 1, 0]])
def test_counts_to_segment_ids_matches_jax(counts):
    counts = np.asarray(counts, dtype=np.int32)
    total = int(counts.sum())
    ref = np.asarray(jax_seg.counts_to_segment_ids(jnp.asarray(counts), total))
    out = segment.counts_to_segment_ids(torch.from_numpy(counts), total)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n_cols", [1, 2])
def test_spread_by_segment_matches_jax_exactly(dtype, n_cols):
    """Each row is one value of ``values``, cast: the port's gather and the
    JAX one-hot product give the same bits (fp16 values, as the wire ships
    them, in every compute type)."""
    rng = np.random.default_rng(n_cols)
    values = rng.normal(size=(9, n_cols)).astype(np.float16)
    ids = rng.integers(0, 9, size=300).astype(np.int32)
    ids[:40] = 8  # the padding segment's zero row
    values[8] = 0
    want = np.asarray(jax_seg.spread_by_segment(jnp.asarray(values), jnp.asarray(ids),
                                                dtype=jnp.dtype(dtype)).astype(jnp.float32))
    got = segment.spread_by_segment(torch.from_numpy(values), torch.from_numpy(ids),
                                    dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (300, n_cols)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        segment.spread_by_segment(torch.from_numpy(values), torch.from_numpy(ids.astype(np.int16))).numpy(),
        values[ids])


@pytest.mark.parametrize("model", ["deep_sets", "fully_connected_net", "graph_net"])
def test_load_config_matches_jax(model):
    base = os.path.join(REPO, "configs", "base.yaml")
    specific = os.path.join(REPO, "configs", f"{model}.yaml")
    assert load_config(base, specific) == jax_load_config(base, specific)

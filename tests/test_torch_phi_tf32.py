"""f32 K1's and K2's tf32x3 products, in plain PyTorch, against the JAX package.

K1's tf32x3 variant (``csrc/phi_pool.cu``) forms every f32 product on the
tensor cores from TF32 operands: each value ``x`` is split into ``hi =
tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna``: to nearest, ties away from
zero, 10 explicit mantissa bits) and the products ``hi·hi + hi·lo + lo·hi``
are summed in f32.  ``ops/fused_phi.py:phi_pool_tf32x3_plain`` does the same
arithmetic in plain PyTorch.  Here it is held, on seeded numpy inputs, to the
JAX package's φ-pool (``phi_pool_xla``; ``phi_pool_pallas`` in interpret
mode for the config chain) at the chains the variant serves: the DeepSets
config chain, φ [512, 512], φ [1024, 1024], the tail's one bare
[256, 256] layer, and the sweep's φ [128] × 1, [128] × 3 residual, [256] ×
4 plain and [512] × 3 residual, in gelu, relu and silu (the sweep samples
gelu and silu).  The bound, 1e-5 of max(1, max |ref|), is ten times under
K1's bound on the card (1e-4 against ``phi_pool_plain``, chip_smoke.py).
The last test shows why the split is needed: a one-pass TF32 product misses
1e-4 on the layers' unpooled values, where the split keeps within 1e-5.

K2's tf32x3 variant (``csrc/phi_pool_bwd.cu``) takes every product of the
backward the same way: ``ops/fused_phi.py:phi_pool_bwd_tf32x3_plain``, held
to the JAX package's backward (the VJP of ``phi_pool_xla``;
``phi_pool_bwd_pallas`` in interpret mode, the sweep's [128] × 3 among its
chains) at the chains the variant serves, the DeepSets config chain (φ
[256, 256]), φ [512, 512], φ [1024, 1024], the tail's bare [256, 256]
layer and the sweep's chains above, in gelu, relu and silu, with and
without ``d_points``, every gradient within the same 1e-5; there a one-pass
TF32 backward misses 1e-4 too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.ops import fused_phi as jax_phi  # noqa: E402
from point_cloud_classifier_tpu_torch.ops import fused_phi  # noqa: E402

RES = (("plain", False), ("residual", False))
PLAIN = (("plain", False),)
# (spec, input width, layer widths): the chains of K1's tf32x3 variant on
# the main path, and the hyperparameter sweep's chains of none, two and three
# square layers (sweep.py: φ [d] × n, plain or residual)
CHAINS = {
    "config": (RES, 6, [256, 256]),
    "phi512": (RES, 6, [512, 512]),
    "phi1024": (RES, 6, [1024, 1024]),
    "tail": ((), 256, [256]),
    "phi128x1": (PLAIN, 6, [128]),
    "phi128x3": (RES + RES[1:], 6, [128] * 3),
    "phi256x4-plain": (PLAIN * 4, 6, [256] * 4),
    "phi512x3": (RES + RES[1:], 6, [512] * 3),
}
REL = 1e-5  # of max(1, max |ref|): the split against f32
ONE_PASS_MISS = 1e-4  # K1's card bound, which a one-pass TF32 product misses


def _inputs(chain, p=128, b=5, seed=0):
    """Seeded numpy points, sorted ids (padding rows get id b, event 2
    empty) and ``(w [in, out], b, None, None)`` a spec layer (no layer
    norm) or ``(w, b)`` a bare one, drawn as the layers' own initialiser
    draws them (uniform, bound 1/sqrt(fan-in))."""
    spec, in_dim, widths = CHAINS[chain]
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(p, in_dim)).astype(np.float32)
    seg = np.sort(rng.integers(0, b + 1, size=p)).astype(np.int32)
    seg[seg == 2] = 3
    params, last = [], in_dim
    for n, width in enumerate(widths):
        bound = last**-0.5
        layer = (rng.uniform(-bound, bound, (last, width)).astype(np.float32),
                 rng.uniform(-bound, bound, (width,)).astype(np.float32))
        params.append(layer + (None, None) if n < len(spec) else layer)
        last = width
    return spec, pts, seg, b + 1, tuple(params)


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(1.0, np.abs(ref).max()))


def _torch(params):
    return tuple(tuple(None if a is None else torch.from_numpy(a) for a in layer) for layer in params)


def _jax(params):
    return tuple(tuple(None if a is None else jnp.asarray(a) for a in layer) for layer in params)


# f32 bit patterns and their TF32 rounding: ties (the dropped 13 bits
# exactly 0x1000) away from zero, either sign; below and above half; a
# carry into the exponent; zeros and infinity unchanged
ROUNDING = {
    "exact": (0x3F800000, 0x3F800000),
    "below half": (0x3F800FFF, 0x3F800000),
    "tie up": (0x3F801000, 0x3F802000),
    "tie odd up": (0x3F803000, 0x3F804000),
    "above half": (0x3F801001, 0x3F802000),
    "negative tie": (0xBF801000, 0xBF802000),
    "carry into exponent": (0x3FFFF000, 0x40000000),
    "zero": (0x00000000, 0x00000000),
    "negative zero": (0x80000000, 0x80000000),
    "infinity": (0x7F800000, 0x7F800000),
}


@pytest.mark.parametrize("case", list(ROUNDING))
def test_tf32_round_is_cvt_rna(case):
    given, want = ROUNDING[case]
    x = torch.from_numpy(np.array([given], dtype=np.uint32).view(np.float32))
    got = fused_phi.tf32_round(x).numpy().view(np.uint32)[0]
    assert got == want, (hex(got), hex(want))


@pytest.mark.parametrize("activation", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("chain", list(CHAINS))
def test_tf32x3_plain_matches_xla(chain, activation):
    spec, pts, seg, s, params = _inputs(chain)
    ref = jax_phi.phi_pool_xla(jnp.asarray(pts), jnp.asarray(seg), spec, _jax(params), activation, s)
    out = fused_phi.phi_pool_tf32x3_plain(
        torch.from_numpy(pts), torch.from_numpy(seg), spec, _torch(params), activation, s)
    assert out.dtype == torch.float32 and tuple(out.shape) == tuple(ref.shape)
    assert _rel(out.numpy(), ref) <= REL


def test_tf32x3_plain_matches_pallas_interpret():
    spec, pts, seg, s, params = _inputs("config", p=64)
    ref = jax_phi.phi_pool_pallas(jnp.asarray(pts), jnp.asarray(seg), spec, _jax(params), "gelu", s,
                                  interpret=True)
    out = fused_phi.phi_pool_tf32x3_plain(
        torch.from_numpy(pts), torch.from_numpy(seg), spec, _torch(params), "gelu", s)
    assert _rel(out.numpy(), ref) <= REL


@pytest.mark.parametrize("chain", list(CHAINS))
def test_one_pass_tf32_misses_where_the_split_holds(chain):
    """Every layer's unpooled values [P, width] against the JAX chain cut
    after that layer: the split within REL at each layer, a one-pass TF32
    product (``hi·hi`` alone) over ONE_PASS_MISS at the worst layer."""
    spec, pts, _, _, params = _inputs(chain)
    split, one_pass = [], []
    for n in range(1, len(params) + 1):
        cut_spec, cut = spec[:n], params[:n]
        ref = jax_phi.phi_forward_xla(jnp.asarray(pts), cut_spec, _jax(cut), "gelu")
        for passes, errs in ((3, split), (1, one_pass)):
            h = fused_phi.phi_forward_tf32x3(torch.from_numpy(pts), cut_spec, _torch(cut), "gelu", passes)
            errs.append(_rel(h.numpy(), ref))
    assert max(split) <= REL, split
    assert max(one_pass) > ONE_PASS_MISS, one_pass


# the chains of K2's tf32x3 variant on the main path: the DeepSets config
# chain (φ 256, one block a tile), φ 512 and 1024, the tail's bare layer,
# and the sweep's chains of none, two and three square layers
BWD_CHAINS = ("config", "phi512", "phi1024", "tail", "phi128x1", "phi128x3", "phi256x4-plain", "phi512x3")


def _cotangent(params, s, seed=7):
    """A seeded f32 cotangent [s, width] of the pooled sums, the padding
    segment's row included."""
    width = params[-1][0].shape[1]
    return np.random.default_rng(seed).normal(size=(s, width)).astype(np.float32)


def _jax_bwd(spec, pts, seg, s, params, g, activation, with_points):
    """The JAX package's backward, the VJP of ``phi_pool_xla``: ``[d_points]
    (with_points) + [d_w0, d_b0, …]``."""

    def f(x, prm):
        return jax_phi.phi_pool_xla(x, jnp.asarray(seg), spec, prm, activation, s)

    _, vjp = jax.vjp(f, jnp.asarray(pts), _jax(params))
    d_points, d_params = vjp(jnp.asarray(g))
    return ([np.asarray(d_points)] if with_points else []) + [
        np.asarray(t) for layer in d_params for t in layer if t is not None
    ]


def _port_bwd(spec, pts, seg, s, params, g, activation, with_points, passes=3):
    d_points, grads = fused_phi.phi_pool_bwd_tf32x3_plain(
        torch.from_numpy(pts), torch.from_numpy(seg), torch.from_numpy(g), spec, _torch(params),
        activation, s, with_points, passes)
    assert (d_points is None) != with_points and all(t.dtype == torch.float32 for t in grads)
    return ([d_points.numpy()] if with_points else []) + [t.numpy() for t in grads]


@pytest.mark.parametrize("with_points", [True, False], ids=["d_points", "no-d_points"])
@pytest.mark.parametrize("activation", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("chain", BWD_CHAINS)
def test_tf32x3_bwd_plain_matches_jax_vjp(chain, activation, with_points):
    spec, pts, seg, s, params = _inputs(chain)
    g = _cotangent(params, s)
    ref = _jax_bwd(spec, pts, seg, s, params, g, activation, with_points)
    out = _port_bwd(spec, pts, seg, s, params, g, activation, with_points)
    assert len(out) == len(ref)
    for got, want in zip(out, ref):
        assert got.shape == want.shape
        assert _rel(got, want) <= REL


@pytest.mark.parametrize("chain", ["config", "phi512", "tail", "phi128x3"])
def test_tf32x3_bwd_plain_matches_pallas_interpret(chain):
    spec, pts, seg, s, params = _inputs(chain, p=64)
    g = _cotangent(params, s)
    d_points, flat = jax_phi.phi_pool_bwd_pallas(
        jnp.asarray(pts), jnp.asarray(seg), jnp.asarray(g), spec,
        tuple((jnp.asarray(layer[0]), jnp.asarray(layer[1])) for layer in params), "gelu", s,
        interpret=True)
    shapes = [np.shape(a) for layer in params for a in layer[:2]]
    ref = [np.asarray(d_points)] + [np.asarray(t).reshape(shape) for t, shape in zip(flat, shapes)]
    out = _port_bwd(spec, pts, seg, s, params, g, "gelu", True)
    assert len(out) == len(ref)
    for got, want in zip(out, ref):
        assert _rel(got, want) <= REL


@pytest.mark.parametrize("chain", BWD_CHAINS)
def test_one_pass_tf32_bwd_misses_where_the_split_holds(chain):
    """Every gradient, d_points among them, against the JAX VJP: the split
    within REL, a one-pass TF32 backward (``hi·hi`` alone in every product)
    over ONE_PASS_MISS at the worst."""
    spec, pts, seg, s, params = _inputs(chain)
    g = _cotangent(params, s)
    ref = _jax_bwd(spec, pts, seg, s, params, g, "gelu", True)
    split, one_pass = ([_rel(got, want) for got, want in
                        zip(_port_bwd(spec, pts, seg, s, params, g, "gelu", True, passes), ref)]
                       for passes in (3, 1))
    assert max(split) <= REL, split
    assert max(one_pass) > ONE_PASS_MISS, one_pass


@pytest.mark.parametrize("code, name", [(0, "general"), (1, "sliced"), (2, "tf32x3"), (3, "wide")])
def test_kernel_variant_names_the_c_entry_codes(monkeypatch, code, name):
    from point_cloud_classifier_tpu_torch import native

    class Lib:
        @staticmethod
        def pcc_phi_pool_variant(*args):
            return code

    monkeypatch.setattr(native, "kernel_library", lambda: type("Built", (), {"lib": Lib})())
    fused_phi.kernel_variant.cache_clear()
    try:
        assert fused_phi.kernel_variant((6, 256, 256), (0, 1), False, False) == name
    finally:
        fused_phi.kernel_variant.cache_clear()


@pytest.mark.parametrize("general, redesigned", [(False, 1), (True, 0)], ids=["main-path", "timing-entry"])
def test_kernel_variant_asks_for_the_entry_it_names(monkeypatch, general, redesigned):
    """``kernel_variant(general=True)`` names the choice of the timing entries
    (``pcc_phi_pool_bwd_general``: the tf32x3 and wide plans left out), and
    the default the main path's: the C query's last argument says which."""
    from point_cloud_classifier_tpu_torch import native

    asked = []

    class Lib:
        @staticmethod
        def pcc_phi_pool_variant(*args):
            asked.append(args)
            return 1

    monkeypatch.setattr(native, "kernel_library", lambda: type("Built", (), {"lib": Lib})())
    fused_phi.kernel_variant.cache_clear()
    try:
        assert fused_phi.kernel_variant((6, 256, 256), (0, 1), True, True, general) == "sliced"
    finally:
        fused_phi.kernel_variant.cache_clear()
    assert len(asked) == 1 and asked[0][3:] == (1, 1, redesigned)

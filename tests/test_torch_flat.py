"""mgard_tpu_torch's flat-stream codecs and quantizer against mgard_tpu's,
on the CPU.

Integer stages are held bit for bit (tolerance 0): fed the same int32 or
int64 stream, the port's chunked ``encode`` (K12), per-group
``encode_pergroup`` and wide ``encode64`` give exponents, ``words[:count]``
and ``count`` byte-identical to ``mgard_tpu.ops.bitplane``'s (the chunked
one against both its XLA fallback and its Pallas kernels in interpret
mode), and each package's decoder (K11 for the chunked stream) gives the
other's stream back exactly.  On the same pyramid, the flat-stream scaling
and ``_quantized_flat`` give the same floats, integers and status codes as
the JAX package traces with its tolerance as a Python float under
``jax_enable_x64`` (the tests' setting).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mgard_tpu.config import Config as JConfig, Layout as JLayout
from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.models.compressor import Compressor as JCompressor
from mgard_tpu.ops import bitplane as jb
from mgard_tpu.ops import quantize as jq
from mgard_tpu.ops import transform as jt

from mgard_tpu_torch.config import Config, Layout
from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.models.compressor import Compressor
from mgard_tpu_torch.ops import bitplane as tb
from mgard_tpu_torch.ops import bp_kernels as bk
from mgard_tpu_torch.ops import quantize as tq
from mgard_tpu_torch.ops import transform as tt


def _stream32(n, seed=0):
    """An int32 stream with every magnitude class and the int32 minimum,
    whose zigzag word is 0xFFFFFFFF (tests/test_pallas_codec.py)."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=n)
         * rng.choice([0, 1, 5, 1000, 1e6], size=n)).astype(np.int32)
    q[0] = -2 ** 31
    return q


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _port(out):
    e, w, c = out
    c = int(c)
    return e.numpy(), w[:c].numpy().view(np.uint32), c


def _jax(out):
    e, w, c = out
    c = int(c)
    return np.asarray(e), np.asarray(w)[:c], c


# ---------------------------------------------------------------------------
# chunked codec (K12 / K11)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("C", [128, 4096])
@pytest.mark.parametrize("n", [5000, 300000])
def test_chunked_codec_matches_jax(n, C, pallas, monkeypatch):
    q = _stream32(n)
    mine = _port(tb.encode(torch.from_numpy(q), C))
    # the switch is read while tracing: each call traces a new partial,
    # so no jit cache hands one mode's trace to the other
    monkeypatch.setenv("MGARD_TPU_PALLAS_CODEC", "1" if pallas else "0")
    with pltpu.force_tpu_interpret_mode():
        theirs = _jax(jax.jit(functools.partial(jb.encode, C=C))(
            jnp.asarray(q)))
        cap = np.zeros(jb.max_words(n, C), np.uint32)
        cap[:mine[2]] = mine[1]
        jax_of_mine = np.asarray(jax.jit(functools.partial(
            jb.decode, n=n, C=C))(jnp.asarray(mine[0]), jnp.asarray(cap)))
    assert mine[2] == theirs[2]
    _same(mine[0], theirs[0])
    _same(mine[1], theirs[1])
    port_of_theirs = tb.decode(torch.from_numpy(theirs[0]),
                               torch.from_numpy(theirs[1].view(np.int32)),
                               n, C)
    _same(port_of_theirs.numpy(), q)
    _same(jax_of_mine, q)


def test_empty_stream_decodes_to_zeros():
    """A stream with no words (every exponent 0) decodes to zeros in K4's
    and K11's plain versions, as in the JAX package, which pads the words
    to capacity (compressor.py:615-616)."""
    nchunks, C, n = 4, 128, 3 * 32 * 128 + 5
    e = torch.zeros(nchunks, dtype=torch.int32)
    offsets = torch.zeros(nchunks, dtype=torch.int32)
    words = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(bk.bp_decode_condense(words, C, offsets, e, n),
                       torch.zeros(n, dtype=torch.int32))
    assert torch.equal(bk.bp_decode_condense_f32(words, C, offsets, e, 0.5,
                                                 n),
                       torch.zeros(n, dtype=torch.float32))
    exps = torch.zeros(tb.num_chunks_tiled(n, C), dtype=torch.uint8)
    assert not tb.decode(exps, words, n, C).any()
    assert not tb.decode_pergroup(exps, words, n).any()
    assert not tb.decode64(exps, words, n, C).any()


# ---------------------------------------------------------------------------
# per-group and wide codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5000, 300000])
def test_pergroup_codec_matches_jax(n):
    q = _stream32(n, seed=3)
    mine = _port(tb.encode_pergroup(torch.from_numpy(q)))
    theirs = _jax(jax.jit(jb.encode_pergroup)(jnp.asarray(q)))
    assert mine[2] == theirs[2]
    _same(mine[0], theirs[0])
    _same(mine[1], theirs[1])
    cap = np.zeros(len(theirs[0]) * 33, np.uint32)
    cap[:mine[2]] = mine[1]
    jax_of_mine = jax.jit(jb.decode_pergroup, static_argnums=2)(
        jnp.asarray(mine[0]), jnp.asarray(cap), n)
    _same(np.asarray(jax_of_mine), q)
    port_of_theirs = tb.decode_pergroup(
        torch.from_numpy(theirs[0]),
        torch.from_numpy(theirs[1].view(np.int32)), n)
    _same(port_of_theirs.numpy(), q)


@pytest.mark.parametrize("C", [128, 2048])
@pytest.mark.parametrize("n", [5000, 300000])
def test_wide_codec_matches_jax(n, C):
    rng = np.random.default_rng(5)
    q = (rng.normal(size=n) * rng.choice([0, 1, 7, 1e9, 1e17], size=n)
         ).astype(np.int64)
    q[:6] = [2 ** 62, -2 ** 62, 2 ** 63 - 1, -2 ** 63, -1, 2 ** 31]
    mine = _port(tb.encode64(torch.from_numpy(q), C))
    theirs = _jax(jax.jit(jb.encode64, static_argnums=1)(jnp.asarray(q), C))
    assert mine[2] == theirs[2]
    _same(mine[0], theirs[0])
    _same(mine[1], theirs[1])
    cap = np.zeros(jb.max_words64(n, C), np.uint32)
    cap[:mine[2]] = mine[1]
    jax_of_mine = jax.jit(jb.decode64, static_argnums=(2, 3))(
        jnp.asarray(mine[0]), jnp.asarray(cap), n, C)
    _same(np.asarray(jax_of_mine), q)
    port_of_theirs = tb.decode64(torch.from_numpy(theirs[0]),
                                 torch.from_numpy(theirs[1].view(np.int32)),
                                 n, C)
    _same(port_of_theirs.numpy(), q)


# ---------------------------------------------------------------------------
# quantizer and _quantized_flat
# ---------------------------------------------------------------------------

def _pyramid(shape, dtype, seed=0):
    """Random level arrays of a hierarchy's shapes (coefficients of every
    magnitude class, so that some sit on bin edges after scaling)."""
    rng = np.random.default_rng(seed)
    h = Hierarchy(shape)
    return [(rng.normal(size=s) * rng.choice([0.0, 1e-4, 0.01, 3.0], size=s)
             ).astype(dtype) for s in h.shapes]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,tol", [((65, 65, 65), 1e-3),
                                       ((33, 65), 3.3e-5),
                                       ((129,), 0.25)], ids=str)
def test_scale_pyramid_matches_jax(shape, tol, dtype):
    pyr = _pyramid(shape, dtype)
    jh = JHierarchy(shape)
    ints = jnp.int64 if dtype == np.float64 else jnp.int32

    @jax.jit
    def jax_side(p, t):
        scaled = jq.scale_pyramid(jh, p, math.inf, t)
        qpyr = [jq.round_quantize(s, ints) for s in scaled]
        return scaled, qpyr, jq.dequantize_pyramid(jh, qpyr, math.inf, t,
                                                   dtype)

    scaled, qpyr, back = jax_side([jnp.asarray(p) for p in pyr], tol)
    mine = tq.scale_pyramid(Hierarchy(shape), [torch.from_numpy(p)
                                               for p in pyr], math.inf, tol)
    for a, b, q in zip(mine, scaled, qpyr):
        _same(a.numpy(), np.asarray(b))
        _same(tq.round_quantize(a, torch.int64 if dtype == np.float64
                                else torch.int32).numpy(), np.asarray(q))
    mine_back = tq.dequantize_pyramid(
        Hierarchy(shape), [torch.from_numpy(np.asarray(q)) for q in qpyr],
        math.inf, tol, dtype)
    for a, b in zip(mine_back, back):
        _same(a.numpy(), np.asarray(b))


def _flat_both(monkeypatch, shape, dtype, v, tol, pyr):
    """Both packages' ``_quantized_flat`` with their transforms made to
    return the same pyramid ``pyr``."""
    monkeypatch.setattr(jt, "decompose",
                        lambda hier, x: [jnp.asarray(p) for p in pyr])
    monkeypatch.setattr(tt, "decompose",
                        lambda hier, x: [torch.from_numpy(p) for p in pyr])
    cfg = dict(layout=JLayout.PYRAMID, adapt_lossless=False)
    jc = JCompressor(JHierarchy(shape), dtype, config=JConfig(**cfg))
    jflat, jst = jax.jit(jc._quantized_flat)(jnp.asarray(v), tol)
    tc = Compressor(Hierarchy(shape), dtype, device="cpu",
                    config=Config(layout=Layout.PYRAMID,
                                  adapt_lossless=False))
    tflat, tst = tc._quantized_flat(torch.from_numpy(v), tol)
    return (np.asarray(jflat), int(jst)), (tflat.numpy(), int(tst))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantized_flat_matches_jax(dtype, monkeypatch):
    shape = (33, 33, 33)
    pyr = _pyramid(shape, dtype, seed=2)
    v = np.zeros(shape, dtype)
    (jflat, jst), (tflat, tst) = _flat_both(monkeypatch, shape, dtype, v,
                                            1e-3, pyr)
    assert jst == tst == 0
    _same(tflat, jflat)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["overflow", "nan_coefficient",
                                  "nonfinite_input"])
def test_flat_status_matches_jax(case, dtype, monkeypatch):
    """Status 1 past the integer ceiling (2^31 - 1, or 2^62 for float64)
    or on a NaN coefficient, 2 for a non-finite input, as in JAX."""
    shape = (17, 17)
    pyr = _pyramid(shape, dtype, seed=4)
    v = np.zeros(shape, dtype)
    tol = 1e-3
    if case == "overflow":
        pyr[-1][3, 5] = 1e12 if dtype == np.float32 else 1e21
    elif case == "nan_coefficient":
        pyr[-1][3, 5] = np.nan
    else:
        v[2, 2] = np.inf
    (_, jst), (_, tst) = _flat_both(monkeypatch, shape, dtype, v, tol, pyr)
    assert tst == jst == {"overflow": 1, "nan_coefficient": 1,
                          "nonfinite_input": 2}[case]

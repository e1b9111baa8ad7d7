"""mgard_tpu_torch's MDR (progressive refactoring and retrieval) against
mgard_tpu's, on the CPU.

Integer stages are bit for bit the JAX package's: the bit transposes,
each level's exponent, sign words and planes in both encodings (with the
level's max planted at powers of two and one ulp either side, where the
exponent's ceil(log2) and the scale's exp2 are least forgiving), every
stream byte of a refactor of the same pyramid, and the metadata bytes.
The residual sums are float sums in another order: within rtol 1e-5,
and the plane counts that requests derive from them equal.  Artifacts
cross both ways: each package reconstructs from the other's metadata and
streams within the tolerance.

Each JAX refactor and each JAX reconstruct compiles (seconds apiece), so
the JAX artifacts are made once a module (:func:`_jax_artifact`) and the
JAX reconstructs are few.
"""

import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.models import mdr as jmdr
from mgard_tpu.ops import bitplane as jbp

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.models import mdr
from mgard_tpu_torch.ops import bitplane as tbp
from mgard_tpu_torch.ops import norms
from mgard_tpu_torch.ops import transform as tt

from test_torch_flat_e2e import _field

SQ_RTOL = 1e-5
STRATEGIES = ("greedy", "inorder", "roundrobin")
SM, NB = mdr.ENC_SIGN_MAGNITUDE, mdr.ENC_NEGABINARY


def _smooth(shape, seed):
    return _field(shape, np.float64, seed)


def _i32(u32: np.ndarray) -> np.ndarray:
    return np.asarray(u32).astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_artifact(shape, encoding, seed=7):
    """(float64 field, JAX hierarchy, JAX refactor result, JAX pyramid),
    once a key."""
    v = _smooth(shape, seed)
    jh = JHierarchy(shape)
    jr = jmdr.mdr_refactor(jh, v, B=30, lossless=mdr.LOSSLESS_NONE,
                           encoding=encoding)
    jpyr = [np.array(p) for p in jax.jit(
        lambda a: jmdr.transform.decompose(jh, a))(jnp.asarray(v))]
    return v, jh, jr, jpyr


def _as_port(result):
    """A JAX artifact as the port reads it: metadata bytes and streams."""
    return mdr.MDRefactorResult(mdr.MDRMetadata.unpack(
        result.metadata.pack()), result.streams)


def _feed(rec, result, counts, start=None):
    for l, c in enumerate(counts):
        streams = {} if start else {0: result.streams[l][0]}
        for b in range(start[l] if start else 0, c):
            streams[1 + b] = result.streams[l][1 + b]
        rec.add_streams(l, streams)


@pytest.mark.parametrize("shape", [(32, 7), (4, 32, 128)], ids=str)
def test_transpose32_bit_identical(shape):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64
                     ).astype(np.uint32)
    x.reshape(-1)[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    j = jax.jit(jbp.transpose32 if len(shape) == 2
                else jbp.transpose32_mid)(jnp.asarray(x))
    fn = tbp.transpose32 if len(shape) == 2 else tbp.transpose32_mid
    t = fn(torch.from_numpy(_i32(x)))
    assert np.array_equal(t.numpy(), _i32(np.asarray(j)))
    assert np.array_equal(fn(t).numpy(), _i32(x))     # an involution


def _planted_levels(dtype):
    """Levels of 300 values whose max is 2^k or one ulp either side, for
    k over the range MDR levels see, a random level and an all-zero
    one."""
    rng = np.random.default_rng(11)
    out = []
    for k in (-20, -3, -1, 0, 1, 2, 4, 13):
        p = dtype(2.0 ** k)
        for top in (p, np.nextafter(p, dtype(np.inf)),
                    np.nextafter(p, dtype(0))):
            x = (rng.standard_normal(300) * 0.3 * float(p)).astype(dtype)
            x = np.clip(x, -top, top)
            x[17] = -top if k % 2 else top
            out.append(x)
    out.append(rng.standard_normal(300).astype(dtype))
    out.append(np.zeros(300, dtype))
    return out


@pytest.mark.parametrize("encoding", [SM, NB])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_encode_level_bit_identical(dtype, encoding):
    B = 30
    jenc = jax.jit(lambda f: jmdr.encode_level(f, B, encoding))
    for x in _planted_levels(dtype):
        je, js, jp, jsq, jmx = (np.asarray(a) for a in jenc(jnp.asarray(x)))
        te, ts, tp, tsq, tmx = mdr.encode_level(torch.from_numpy(x), B,
                                                encoding)
        assert te == int(je), (x.max(), te, je)
        assert np.array_equal(ts.numpy(), _i32(js))
        assert np.array_equal(tp.numpy(), _i32(jp))
        assert np.array_equal(tmx.numpy(), jmx)
        np.testing.assert_allclose(tsq.numpy(), jsq, rtol=SQ_RTOL)


def test_exponent_and_scale_scalars_match_xla():
    """The host scalars against XLA's own ceil(log2) and exp2 of a scalar
    (a level's max, as encode_level takes them) over the range a level
    sees: every power of two in the normal range, one and two ulps either
    side, and random magnitudes."""
    rng = np.random.default_rng(5)
    for dtype, kmax in ((np.float32, 126), (np.float64, 300)):
        p = (2.0 ** np.arange(-kmax, kmax + 1)).astype(dtype)
        up = np.nextafter(p, dtype(np.inf))
        down = np.nextafter(p, dtype(0))
        vals = np.concatenate([
            p, up, down, np.nextafter(up, dtype(np.inf)),
            np.nextafter(down, dtype(0)),
            (rng.random(500) * 10.0 ** rng.integers(-30, 30, 500)
             ).astype(dtype)])
        tiny = np.finfo(dtype).tiny
        log2 = jax.jit(lambda a: jnp.ceil(jnp.log2(jnp.maximum(
            jnp.max(a), tiny))).astype(jnp.int32))
        j = [int(log2(np.array([v]))) for v in vals]
        assert [mdr.ceil_log2(v, dtype) for v in vals] == j, dtype
        exp2 = jax.jit(lambda a: jnp.exp2(jnp.max(a)))
        ks = np.arange(-kmax, kmax + 1)
        j = np.array([exp2(np.array([k], dtype)) for k in ks], dtype)
        t = np.array([mdr.exp2(int(k), dtype) for k in ks], dtype)
        assert np.array_equal(t, j), dtype


@pytest.mark.parametrize("encoding", [SM, NB])
def test_decode_level_bit_identical(encoding):
    B = 30
    x = _planted_levels(np.float32)[-2]
    je, js, jp, _, _ = jax.jit(
        lambda f: jmdr.encode_level(f, B, encoding))(jnp.asarray(x))
    for kept in (0, 17, B):
        j = np.asarray(jax.jit(lambda s, p, e: jmdr.decode_level(
            s, p, e, B, kept, x.size, np.float32, encoding))(js, jp, je))
        t = mdr.decode_level(torch.from_numpy(_i32(js)),
                             torch.from_numpy(_i32(jp)), int(je), B, kept,
                             x.size, np.float32, encoding)
        assert np.array_equal(t.numpy().view(np.int32), j.view(np.int32))


@pytest.mark.parametrize("shape,encoding", [((17, 17), SM),
                                            ((9, 9, 9, 9), NB)], ids=str)
def test_refactor_on_jax_pyramid(shape, encoding, monkeypatch):
    """The port's refactor of the JAX package's own pyramid (the transform
    is held against JAX elsewhere, within a float bound): every stream
    byte, size, exponent and max error equal, squared errors within
    rtol, and each interpreter's plane counts equal at s = inf and
    s = 0."""
    v, jh, jr, jpyr = _jax_artifact(shape, encoding)
    monkeypatch.setattr(mdr.transform, "decompose",
                        lambda h, x: [torch.from_numpy(p) for p in jpyr])
    tr = mdr.mdr_refactor(Hierarchy(shape), v, B=30,
                          lossless=mdr.LOSSLESS_NONE, encoding=encoding,
                          device="cpu")
    jmd, tmd = jr.metadata, tr.metadata
    assert tr.streams == jr.streams
    for tl, jl in zip(tmd.levels, jmd.levels):
        assert (tl.n, tl.exponent) == (jl.n, jl.exponent)
        assert np.array_equal(tl.max_errors, jl.max_errors)
        assert np.array_equal(tl.stream_sizes, jl.stream_sizes)
        np.testing.assert_allclose(tl.sq_errors, jl.sq_errors, rtol=SQ_RTOL)
    for s in (math.inf, 0.0):
        for tol in (1e-1, 1e-2, 1e-3):
            for st in STRATEGIES:
                assert mdr.mdr_request(tmd, tol, s, strategy=st) \
                    == jmdr.mdr_request(jmd, tol, s, strategy=st), \
                    (s, tol, st)


def test_metadata_pack_bit_identical_and_version1():
    jr = _jax_artifact((17, 17), SM)[2]
    md = mdr.MDRMetadata.unpack(jr.metadata.pack())
    assert md.pack() == jr.metadata.pack()
    assert jmdr.MDRMetadata.unpack(md.pack()).pack() == md.pack()
    # a version-1 buffer: no lossless/encoding bytes, no stream sizes
    v1 = bytearray(b"\x01" + bytes([len(md.shape)]))
    v1 += np.array(md.shape, "<u8").tobytes()
    v1 += bytes([0, md.num_bitplanes, len(md.levels)])
    for lm in md.levels:
        v1 += np.array([lm.n], "<u8").tobytes() \
            + np.array([lm.exponent], "<i4").tobytes()
        v1 += lm.sq_errors.astype("<f8").tobytes() \
            + lm.max_errors.astype("<f8").tobytes()
    t1, j1 = (mdr.MDRMetadata.unpack(bytes(v1)),
              jmdr.MDRMetadata.unpack(bytes(v1)))
    assert (t1.lossless, t1.encoding, t1.dtype) == (
        mdr.LOSSLESS_NONE, SM, np.float32)
    assert t1.pack() == j1.pack()
    assert all(not lm.stream_sizes.any() for lm in t1.levels)


@pytest.mark.parametrize("shape,encoding,jax_plan",
                         [((17, 17), SM, (1e-3, "greedy")),
                          ((9, 9, 9, 9), NB, (1e-2, "roundrobin"))],
                         ids=str)
def test_cross_reconstruct_both_ways(shape, encoding, jax_plan):
    """The port's MDReconstructor on the JAX package's artifact for every
    interpreter and tolerance, at s = inf and s = 0 (each error by the
    port's norms), and the JAX one on the port's (one plan a shape: each
    of its reconstructs compiles)."""
    v, jh, jr, _ = _jax_artifact(shape, encoding)
    th = Hierarchy(shape)
    res = _as_port(jr)
    for s in (math.inf, 0.0):
        for tol in (1e-1, 1e-3):
            for st in STRATEGIES:
                counts = mdr.mdr_request(res.metadata, tol, s, strategy=st)
                rec = mdr.MDReconstructor(th, res.metadata, device="cpu")
                _feed(rec, res, counts)
                err = torch.from_numpy(rec.reconstruct(counts) - v)
                assert float(norms.norm(th, err, s)) <= tol, (s, tol, st)
    tr = mdr.mdr_refactor(th, v, B=30, lossless=mdr.LOSSLESS_NONE,
                          encoding=encoding, device="cpu")
    tol, st = jax_plan
    md = jmdr.MDRMetadata.unpack(tr.metadata.pack())
    counts = jmdr.mdr_request(md, tol, strategy=st)
    rec = jmdr.MDReconstructor(jh, md)
    _feed(rec, tr, counts)
    assert np.abs(rec.reconstruct(counts) - v).max() <= tol


def test_incremental_equals_one_shot_and_adaptive_resolution():
    shape = (17, 17)
    v, jh, jr, _ = _jax_artifact(shape, SM)
    th = Hierarchy(shape)
    v32 = v.astype(np.float32)
    tr = mdr.mdr_refactor(th, v32, B=30, lossless=mdr.LOSSLESS_NONE,
                          device="cpu")
    md = tr.metadata
    c1, c2 = mdr.mdr_request(md, 1e-2), mdr.mdr_request(md, 1e-4)
    rec = mdr.MDReconstructor(th, md, device="cpu")
    _feed(rec, tr, c1)
    out1 = rec.reconstruct(c1)
    assert np.abs(out1 - v32).max() <= 1e-2
    _feed(rec, tr, c2, start=c1)
    out2 = rec.reconstruct(c2)
    one = mdr.mdr_reconstruct(th, tr, 1e-4, device="cpu")
    assert out2.dtype == np.float32
    assert np.array_equal(out2.view(np.int32), one.view(np.int32))
    assert np.abs(out2 - v32).max() <= 1e-4
    # one artifact (JAX's) at a coarser level in both packages: the same
    # planes, recomposed in float64 by each
    lvl = th.L - 1
    t = mdr.mdr_reconstruct(th, _as_port(jr), 1e-3, target_level=lvl,
                            device="cpu")
    j = jmdr.mdr_reconstruct(jh, jr, 1e-3, target_level=lvl)
    assert t.shape == th.shapes[lvl] == j.shape
    assert np.abs(t - j).max() <= 1e-12 * np.abs(j).max()


def test_zstd_streams():
    """zstd streams (one flag byte, raw where zstd does not shrink): the
    port packs each stream as the JAX package's packer does, and each
    package's zstd artifact reconstructs in the port."""
    pytest.importorskip("zstandard")
    big = (65, 65)
    vb, hb = _smooth(big, 9), Hierarchy(big)
    tz = mdr.mdr_refactor(hb, vb, B=30, lossless=mdr.LOSSLESS_ZSTD,
                          device="cpu")
    tn = mdr.mdr_refactor(hb, vb, B=30, lossless=mdr.LOSSLESS_NONE,
                          device="cpu")
    assert tz.streams == [[jmdr._stream_pack(b, mdr.LOSSLESS_ZSTD)
                           for b in st] for st in tn.streams]
    assert {b[:1] for st in tz.streams for b in st} == {b"\x00", b"\x01"}
    out = mdr.mdr_reconstruct(hb, tz, 1e-3, device="cpu")
    assert np.abs(out - vb).max() <= 1e-3
    shape = (17, 17)
    v, _, jr, _ = _jax_artifact(shape, SM)
    # the JAX artifact, its streams packed by the JAX packer
    streams = [[jmdr._stream_pack(b, mdr.LOSSLESS_ZSTD) for b in st]
               for st in jr.streams]
    md = mdr.MDRMetadata.unpack(jr.metadata.pack())
    md.lossless = mdr.LOSSLESS_ZSTD
    for lm, st in zip(md.levels, streams):
        lm.stream_sizes = np.array([len(b) for b in st], np.uint32)
    out = mdr.mdr_reconstruct(Hierarchy(shape), mdr.MDRefactorResult(
        md, streams), 1e-3, device="cpu")
    assert np.abs(out - v).max() <= 1e-3


def test_zstd_streams_raise_without_zstandard(monkeypatch):
    """No silent fallback: with zstandard hidden, a zstd refactor raises
    rather than storing raw streams."""
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ModuleNotFoundError):
        mdr.mdr_refactor(Hierarchy((17, 17)), _smooth((17, 17), 1),
                         lossless=mdr.LOSSLESS_ZSTD, device="cpu")


def test_domain_decomposed():
    """Slabs cut as the JAX package cuts them, each slab's artifact its
    own, every slab within an L-infinity request's tolerance."""
    shape = (40, 17)
    v = _smooth(shape, 45)
    tds = mdr.mdr_refactor_dd(v, max_block_bytes=2000,
                              lossless=mdr.LOSSLESS_NONE, device="cpu")
    nblocks = -(-v.nbytes // 2000)
    assert len(tds.results) == nblocks >= 2 and tds.dd_dim == 0
    assert tds.edges == list(np.linspace(0, 40, nblocks + 1).astype(int))
    for tol in (1e-1, 1e-3):
        out = tds.reconstruct(tol)
        assert out.shape == shape and np.abs(out - v).max() <= tol
    assert tds.retrieved_bytes(1e-1) < tds.retrieved_bytes(1e-3)
    assert tds._block_tol(1e-2, 0.0) == 1e-2 / math.sqrt(nblocks)
    with pytest.raises(ValueError, match="strategy"):
        mdr.mdr_request(tds.results[0].metadata, 1e-2, strategy="fastest")


def test_level_layout_roundtrip():
    """_level_flat / _level_unflat invert each other on a 4-D pyramid."""
    h = Hierarchy((9, 9, 9, 9))
    pyr = tt.decompose(h, torch.from_numpy(_smooth(h.shape, 2)))
    back = mdr._level_unflat(h, mdr._level_flat(h, pyr))
    for a, b in zip(pyr, back):
        assert torch.equal(a, b)
    assert math.isclose(mdr._level_max_volume(h, h.L),
                        float(np.prod([np.max(h.dims[d][h.L].volumes)
                                       for d in range(4)])))

"""mgard_tpu_torch's host losslesses (Huffman + zlib/zstd, NONE) and the
zstd/LZ4 second stages against mgard_tpu's, on the CPU.

The codec stages are bit for bit the JAX package's on the same integer
stream or bytes: Huffman, LZ4 and the NONE section.  Containers are
compared by cross-decoding (the transform's float sums may move a
coefficient across a bin edge): each package decodes the other's within
the tolerance, for every ``Lossless`` value, on one domain and on
blocks.  A zstd lossless with ``zstandard`` hidden raises; the port
never loads or writes ``native/*.so``.
"""

import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mgard_tpu
from mgard_tpu.config import Config as JConfig, Lossless as JLossless
from mgard_tpu.io import huffman_native as jhuff
from mgard_tpu.io import lz4_native as jlz4
from mgard_tpu.models.compressor import get_compressor as jget

import mgard_tpu_torch as mt
from mgard_tpu_torch.io import format as tfmt
from mgard_tpu_torch.io import huffman_native as thuff
from mgard_tpu_torch.io import lz4_native as tlz4
from mgard_tpu_torch.models.compressor import get_compressor as tget
from mgard_tpu_torch.ops import _build, norms

from test_torch_flat_e2e import _field

ROOT = Path(__file__).resolve().parent.parent
HOST = (mt.Lossless.HUFFMAN_ZLIB, mt.Lossless.HUFFMAN_ZSTD, mt.Lossless.NONE)


def _needs(lossless):
    if "ZSTD" in lossless.name:
        pytest.importorskip("zstandard")


def _stream(n, scale, seed=0, dtype=np.int64):
    rng = np.random.default_rng(seed)
    return np.round(rng.laplace(0, scale, n)).astype(dtype)


@pytest.mark.parametrize("n,scale", [(0, 1.0), (1, 0.0), (5000, 3.0),
                                     (70000, 2000.0)], ids=str)
def test_huffman_bytes_bit_identical(n, scale):
    q = _stream(n, scale)
    if n > 100:
        q[7] = 10 ** 6              # misses far outside the dictionary
        q[8] = -10 ** 6
    enc = thuff.huffman_encode(q)
    assert enc == jhuff.huffman_encode(q)
    tree, hit, bits, miss = enc
    assert np.array_equal(thuff.huffman_decode(tree, hit, bits, miss, n), q)
    assert np.array_equal(jhuff.huffman_decode(tree, hit, bits, miss, n), q)
    with pytest.raises(ValueError, match="corrupted"):
        thuff.huffman_decode(tree, hit[:-1], bits, miss, n)


@pytest.mark.parametrize("data", [b"", b"x", bytes(100000),
                                  bytes(range(256)) * 300,
                                  np.random.default_rng(1).bytes(70000)],
                         ids=["empty", "one", "zeros", "ramp", "random"])
def test_lz4_bytes_bit_identical(data):
    enc = tlz4.lz4_compress(data)
    assert enc == jlz4.lz4_compress(data)
    assert tlz4.lz4_decompress(enc) == data
    assert jlz4.lz4_decompress(enc) == data
    if len(data) > 1:
        with pytest.raises(ValueError):
            tlz4.lz4_decompress(enc, max_output_size=len(data) - 1)
        with pytest.raises(ValueError):
            tlz4.lz4_decompress(enc[:12 + 4 * (-(-len(data) // 32768)) - 1])


@pytest.mark.parametrize("lossless", HOST, ids=lambda l: l.name)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_host_section_bit_identical(lossless, dtype):
    """One integer stream through both packages' host encoders: the same
    section bytes, and each decodes the other's to the same stream (the
    NONE width byte picked from the stream's range: i1, i2, i4, i8)."""
    _needs(lossless)
    shape = (17, 2, 17)
    cfg = dict(lossless=lossless)
    jc = jget(shape, dtype, config=JConfig(lossless=JLossless(int(lossless))))
    tc = tget(shape, dtype, config=mt.Config(**cfg), device="cpu")
    n = tc._nstream
    assert n == jc._nstream
    # the Huffman codec stores misses as int32, in both packages
    scales = (3.0, 2000.0, 2.0 ** 20) + (
        (2.0 ** 40,) if dtype == np.float64 and lossless == mt.Lossless.NONE
        else ())
    for scale in scales:
        q = _stream(n, scale, dtype=np.int64 if dtype == np.float64
                    else np.int32)
        sec = tc._host_lossless_encode(q)
        assert sec == jc._host_lossless_encode(q)
        if lossless == mt.Lossless.NONE:
            assert sec[0] == (2 if scale < 100 else 1 if scale < 1e4
                              else 0 if scale < 1e8 else 3)
        back = tc._host_lossless_decode(sec, lossless)
        assert back.dtype == q.dtype and np.array_equal(back, q)
        assert np.array_equal(jc._host_lossless_decode(sec, lossless), q)


def _cross(v, tol, lossless, s=math.inf, **cfg):
    jcfg = JConfig(lossless=JLossless(int(lossless)), **cfg)
    tcfg = mt.Config(lossless=lossless, **cfg)
    bj = mgard_tpu.compress(v, tol, s=s, config=jcfg)
    bt = mt.compress(v, tol, s=s, config=tcfg, device="cpu")
    hier = mt.Hierarchy(v.shape)
    for buf in (bj, bt):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            assert out.shape == v.shape and out.dtype == v.dtype
            err = torch.from_numpy(out.astype(np.float64) - v)
            assert float(norms.norm(hier, err, s)) <= tol
    hj, sj = tfmt.read_container(bj)
    ht, st = tfmt.read_container(bt)
    assert (ht.lossless, ht.layout, ht.dd_nblocks, ht.n_levels) == (
        hj.lossless, hj.layout, hj.dd_nblocks, hj.n_levels)
    assert len(st) == len(sj)
    return bj, bt, ht, st


@pytest.mark.parametrize("lossless", list(mt.Lossless), ids=lambda l: l.name)
def test_cross_decode_every_lossless(lossless):
    _needs(lossless)
    v = _field((17, 17, 17), np.float32, 3)
    _, bt, ht, st = _cross(v, 1e-3, lossless)
    if lossless in HOST:
        assert len(st) == 1
    if lossless.second_stage == "lz4":
        # each section is the unstaged container's, LZ4-framed
        plain = {mt.Lossless.BITPLANE_LZ4: mt.Lossless.BITPLANE,
                 mt.Lossless.BITPLANE_GROUP_LZ4: mt.Lossless.BITPLANE_GROUP}
        ref = tfmt.read_container(mt.compress(
            v, 1e-3, config=mt.Config(lossless=plain[lossless]),
            device="cpu"))[1]
        assert [tlz4.lz4_decompress(x) for x in st] == ref


@pytest.mark.parametrize("lossless,dtype,s,layout", [
    (mt.Lossless.HUFFMAN_ZLIB, np.float64, math.inf, mt.Layout.PYRAMID_SEG),
    (mt.Lossless.NONE, np.float32, 0.0, mt.Layout.LEVEL_BLOCKS),
    (mt.Lossless.BITPLANE_LZ4, np.float64, 0.0, mt.Layout.PYRAMID_SEG),
    (mt.Lossless.HUFFMAN_ZSTD, np.float32, math.inf, mt.Layout.FINE),
], ids=str)
def test_cross_decode_dtypes_norms_layouts(lossless, dtype, s, layout):
    """float64 (int64 streams), s = 0, and the other layouts."""
    _needs(lossless)
    v = _field((17, 2, 17), dtype, 4)
    _cross(v, 1e-3 if math.isinf(s) else 1e-2, lossless, s=s, layout=layout)


@pytest.mark.parametrize("lossless", [mt.Lossless.NONE,
                                      mt.Lossless.HUFFMAN_ZLIB],
                         ids=lambda l: l.name)
def test_multiblock_host_lossless(lossless, monkeypatch):
    """Slabs of a host-lossless container: one section a block, each NONE
    block with its own width byte; both packages decode both."""
    import jax
    first = jax.local_devices()[:1]
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: first)
    v = _field((48, 33), np.float32, 5)
    v[32:] *= 1e-3             # a narrower third slab
    _, bt, ht, st = _cross(v, 1e-3, lossless, max_block_bytes=2200)
    assert ht.dd_nblocks == 3 and len(st) == 3
    if lossless == mt.Lossless.NONE:
        assert st[0][0] != st[2][0]


def test_no_silent_fallback_without_zstandard(monkeypatch):
    """With zstandard hidden, every zstd lossless raises on compress and on
    decompress, rather than writing or reading other bytes."""
    pytest.importorskip("zstandard")
    v = _field((17, 17), np.float32, 6)
    bufs = {l: mt.compress(v, 1e-3, config=mt.Config(lossless=l),
                           device="cpu")
            for l in (mt.Lossless.BITPLANE_ZSTD, mt.Lossless.HUFFMAN_ZSTD)}
    monkeypatch.setitem(sys.modules, "zstandard", None)
    for l in (mt.Lossless.BITPLANE_ZSTD, mt.Lossless.BITPLANE_GROUP_ZSTD,
              mt.Lossless.HUFFMAN_ZSTD):
        with pytest.raises(ModuleNotFoundError):
            mt.compress(v, 1e-3, config=mt.Config(lossless=l), device="cpu")
    for buf in bufs.values():
        with pytest.raises(ModuleNotFoundError):
            mt.decompress(buf, device="cpu")


def test_host_stream_is_the_quantized_stream():
    """The stream that Huffman decodes is ``_quantized_flat``'s, bit for
    bit, and a corrupted section is refused."""
    v = _field((33, 33), np.float32, 7)
    comp = tget(v.shape, np.float32, device="cpu",
                config=mt.Config(lossless=mt.Lossless.HUFFMAN_ZLIB))
    flat, status = comp._quantized_flat(torch.from_numpy(v), 1e-3)
    assert int(status) == 0
    (sec,) = comp.sections_from_outputs(
        *comp.encode_device(torch.from_numpy(v), 1e-3))
    back = comp._host_lossless_decode(sec, mt.Lossless.HUFFMAN_ZLIB)
    assert np.array_equal(back, flat.numpy())
    with pytest.raises(ValueError, match="corrupted"):
        comp._host_lossless_decode(sec[:20], mt.Lossless.HUFFMAN_ZLIB)
    none = tget(v.shape, np.float32, device="cpu",
                config=mt.Config(lossless=mt.Lossless.NONE))
    (sec,) = none.sections_from_outputs(
        *none.encode_device(torch.from_numpy(v), 1e-3))
    with pytest.raises(ValueError, match="corrupted"):
        none._host_lossless_decode(sec[:-1], mt.Lossless.NONE)
    with pytest.raises(ValueError, match="corrupted"):
        none._host_lossless_decode(b"\x09" + sec[1:], mt.Lossless.NONE)


def test_host_codecs_build_into_the_port_build_dir():
    """The codecs load from ``mgard_tpu_torch/_build``; a failed g++ build
    raises; no port module names ``native/*.so``."""
    for name in ("mgard_huffman", "mgard_lz4"):
        path = _build.host_library(name)
        assert path.parent == _build.BUILD_DIR and path.exists()
    for py in (ROOT / "mgard_tpu_torch").rglob("*.py"):
        assert not re.search(r"mgard_(huffman|lz4)\.so", py.read_text()), py


def test_failed_host_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "mgard_bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        _build.host_library("mgard_bad")
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("lossless", HOST, ids=lambda l: l.name)
def test_planner_counts_the_host_stream_peak(lossless):
    """A host lossless's encode (the integer stream, no codec words) is
    planned at its own measured peak, or at a higher one that applies."""
    from mgard_tpu_torch import api
    peak = api.PEAK_PER_BYTE
    cfg = mt.Config(lossless=lossless)
    assert api.footprint_per_byte((512,) * 3, np.float32, cfg) \
        == 1.15 * peak["host"] > api.FOOTPRINT_PER_BYTE
    assert api.footprint_per_byte((512,) * 3, np.float64, cfg) \
        == 1.15 * peak["wide"]
    assert api.footprint_per_byte(
        (512,) * 3, np.float32, cfg.replace(layout=mt.Layout.PYRAMID)) \
        == 1.15 * max(peak["host"], peak["pyramid"])

"""mgard_tpu_torch's flat-stream paths end to end against mgard_tpu, on
the CPU: the per-group codec that the default ``Config`` takes under 2^22
values, the PYRAMID layout's chunked stream (K12/K11), float64 data on the
wide codec, an all-zero field (an empty stream), and the ``adjust_shape``
and ``dd_method="block"`` options, where they keep one domain and where
they reshape or split it.

Containers are compared by cross-decoding (they are not canonical across
implementations, doc/FORMAT.md): each package decodes the other's within
the error bound (tolerance: the bound itself, no slack), in both
directions, and both write the same header choices.
"""

import numpy as np
import pytest

import mgard_tpu
from mgard_tpu.config import Config as JConfig, Layout as JLayout
from mgard_tpu.config import Lossless as JLossless

import mgard_tpu_torch as mt
from mgard_tpu_torch.config import Layout
from mgard_tpu_torch.io import format as tfmt


def _field(shape, dtype=np.float32, seed=0):
    """A smooth field plus noise (bench.py's form, at a small size)."""
    x = [np.linspace(0.0, 1.0, s) for s in shape]
    f = np.zeros(shape)
    for k in (1, 3, 7):
        term = np.ones(shape)
        for d, xx in enumerate(x):
            shp = [1] * len(shape)
            shp[d] = len(xx)
            term = term * np.cos(np.pi * k * xx + 0.1 * k * (d + 1)
                                 ).reshape(shp)
        f = f + term / k
    rng = np.random.default_rng(seed)
    return (f + 0.001 * rng.standard_normal(shape)).astype(dtype)


def _cross_check(v, tol, jcfg=None, tcfg=None, mode="abs",
                 coordinates=None):
    bj = mgard_tpu.compress(v, tol, mode=mode, config=jcfg,
                            coordinates=coordinates)
    bt = mt.compress(v, tol, mode=mode, config=tcfg,
                     coordinates=coordinates, device="cpu")
    bound = tol * (float(np.abs(v).max()) if mode == "rel" else 1.0)
    for buf in (bj, bt):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            assert out.shape == v.shape and out.dtype == v.dtype
            assert np.abs(out.astype(np.float64) - v).max() <= bound
    hj, _ = tfmt.read_container(bj)
    ht, _ = tfmt.read_container(bt)
    assert (ht.lossless, ht.layout, ht.chunk_groups, ht.n_levels,
            ht.dtype) == (hj.lossless, hj.layout, hj.chunk_groups,
                          hj.n_levels, hj.dtype)
    assert ht.tolerance == hj.tolerance and ht.norm == hj.norm
    return ht


@pytest.mark.parametrize("shape", [(33, 33, 33), (65, 65, 65), (64, 64)],
                         ids=str)
def test_cross_decode_default_config(shape):
    """Under 2^22 values the default Config takes the per-group codec."""
    ht = _cross_check(_field(shape), 1e-3)
    assert ht.lossless == int(JLossless.BITPLANE_GROUP)


def test_cross_decode_pyramid_chunked():
    """The PYRAMID layout's flat chunked stream (K12 and K11)."""
    ht = _cross_check(_field((65, 65, 65)), 1e-3,
                      JConfig(layout=JLayout.PYRAMID, adapt_lossless=False),
                      mt.Config(layout=Layout.PYRAMID, adapt_lossless=False))
    assert (ht.lossless, ht.layout) == (int(JLossless.BITPLANE),
                                        int(JLayout.PYRAMID))


@pytest.mark.parametrize("shape", [(33, 33, 33), (65, 65, 65)], ids=str)
def test_cross_decode_float64(shape):
    """float64 data on the wide codec, 2048 groups a chunk."""
    ht = _cross_check(_field(shape, np.float64), 1e-6)
    assert ht.lossless == int(JLossless.BITPLANE)
    assert ht.chunk_groups in (0, 2048)


def test_cross_decode_float64_rel_nonuniform():
    shape = (33, 17, 40)
    rng = np.random.default_rng(3)
    coords = []
    for s in shape:
        c = np.sort(rng.uniform(size=s))
        c[0], c[-1] = 0.0, 1.0
        coords.append(c)
    _cross_check(_field(shape, np.float64, seed=4), 1e-5, mode="rel",
                 coordinates=coords)


@pytest.mark.parametrize("cfg", ["segmented", "pergroup", "pyramid"])
def test_all_zero_field_cross_decodes(cfg):
    """An all-zero field encodes to an empty stream, which each package
    decodes to zeros."""
    j, t = {"segmented": (JConfig(adapt_lossless=False),
                          mt.Config(adapt_lossless=False)),
            "pergroup": (None, None),
            "pyramid": (JConfig(layout=JLayout.PYRAMID,
                                adapt_lossless=False),
                        mt.Config(layout=Layout.PYRAMID,
                                  adapt_lossless=False))}[cfg]
    v = np.zeros((33, 33, 33), np.float32)
    bj = mgard_tpu.compress(v, 1e-3, config=j)
    bt = mt.compress(v, 1e-3, config=t, device="cpu")
    for buf in (bj, bt):
        assert not np.any(mt.decompress(buf, device="cpu"))
        assert not np.any(mgard_tpu.decompress(buf))


@pytest.mark.parametrize("option", [dict(adjust_shape=True),
                                    dict(dd_method="block")], ids=str)
def test_single_domain_options(option):
    """adjust_shape that keeps 33^3 and a one-block dd_method="block"
    grid write the ordinary container in both packages; at (16, 1024),
    which adjust_shape reshapes and block_edge=256 cuts into four blocks,
    both packages write the same header and each decodes the other's
    container in the original shape."""
    ht = _cross_check(_field((33, 33, 33)), 1e-2, JConfig(**option),
                      mt.Config(**option))
    assert ht.orig_shape is None and ht.dd_grid is None
    assert not ht.dd_nblocks
    assert mt.api.adjust_shape((16, 1024)) \
        == mgard_tpu.api.adjust_shape((16, 1024)) != (16, 1024)
    v = _field((16, 1024))
    ht = _cross_check(v, 1e-2, JConfig(**option), mt.Config(**option))
    hj, _ = tfmt.read_container(mgard_tpu.compress(
        v, 1e-2, config=JConfig(**option)))
    assert (ht.shape, ht.orig_shape, ht.dd_grid, ht.dd_nblocks) \
        == (hj.shape, hj.orig_shape, hj.dd_grid, hj.dd_nblocks)
    if "adjust_shape" in option:
        assert ht.orig_shape == (16, 1024)
        assert ht.shape == mt.api.adjust_shape((16, 1024))
    else:
        assert ht.dd_grid == (1, 4) and ht.orig_shape is None


@pytest.mark.parametrize("case", ["pergroup", "pyramid", "float64"])
def test_corrupted_flat_streams_rejected(case):
    """Each flat codec checks the word section against its exponents, and
    each exponent against the codec's plane count."""
    dtype = np.float64 if case == "float64" else np.float32
    cfg = mt.Config(layout=Layout.PYRAMID, adapt_lossless=False) \
        if case == "pyramid" else None
    buf = mt.compress(_field((33, 33, 33), dtype), 1e-3, config=cfg,
                      device="cpu")
    header, (exps, words) = tfmt.read_container(buf)
    too_big = bytes([65]) + exps[1:]
    for sections in ([exps, words[:-4]], [exps, words + bytes(4)],
                     [too_big, words]):
        bad = tfmt.write_container(header, sections)
        with pytest.raises(ValueError, match="corrupted"):
            mt.decompress(bad, device="cpu")

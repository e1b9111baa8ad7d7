"""mgard_tpu_torch's host tables and container format against mgard_tpu's.

The level structure and the header bytes are part of the wire format, so
the port's copies must agree exactly: every DimLevel field over a sweep of
shapes (dyadic, nondyadic, flat dims, nonuniform coordinates), and the
same container bytes for the same Header.
"""

import dataclasses

import numpy as np
import pytest

from mgard_tpu import config as jcfg
from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.io import format as jfmt

from mgard_tpu_torch import config as tcfg
from mgard_tpu_torch.hierarchy import DimLevel, Hierarchy
from mgard_tpu_torch.io import format as tfmt

SHAPES = [(9,), (6,), (2,), (9, 17), (6, 7), (50, 30), (1, 9, 5),
          (17, 17, 17), (20, 33, 18), (16, 128, 256), (512, 512, 512),
          (2, 2048, 1025), (162, 162, 162), (5, 1, 1, 7)]


def _field_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, np.ndarray):
        return a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    return a == b


def _assert_same_hierarchy(th, jh):
    assert th.L == jh.L
    assert th.shapes == jh.shapes
    assert th.uniform == jh.uniform
    for d in range(jh.ndim):
        for l in range(jh.L + 1):
            np.testing.assert_array_equal(th.level_indices(l, d),
                                          jh.level_indices(l, d))
            for f in dataclasses.fields(DimLevel):
                a = getattr(th.dims[d][l], f.name)
                b = getattr(jh.dims[d][l], f.name)
                assert _field_equal(a, b), (d, l, f.name)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dimlevels_match_jax(shape):
    _assert_same_hierarchy(Hierarchy(shape), JHierarchy(shape))


@pytest.mark.parametrize("shape", [(9, 17), (20, 33, 18), (6,)], ids=str)
def test_nonuniform_dimlevels_match_jax(shape):
    rng = np.random.default_rng(3)
    coords = [np.sort(rng.uniform(0, 5, s)) if s > 1 else np.zeros(1)
              for s in shape]
    _assert_same_hierarchy(Hierarchy(shape, coordinates=coords),
                           JHierarchy(shape, coordinates=coords))


def test_reference_placement_matches_jax():
    _assert_same_hierarchy(Hierarchy((50, 30), placement="reference"),
                           JHierarchy((50, 30), placement="reference"))


def test_enum_wire_values_match_jax():
    for name in ("Lossless", "Decomposition", "Layout", "ErrorMode"):
        t, j = getattr(tcfg, name), getattr(jcfg, name)
        assert {m.name: int(m) for m in t} == {m.name: int(m) for m in j}
    assert tcfg.Config().lossless == jcfg.Config().lossless
    assert tcfg.Config().layout == jcfg.Config().layout
    for m in tcfg.Lossless:
        jm = jcfg.Lossless(int(m))
        assert (m.grouped, m.chunked, m.second_stage) == (
            jm.grouped, jm.chunked, jm.second_stage)


def _headers(mod):
    coords = [np.linspace(0, 1, 5) ** 2, np.arange(7.0)]
    return [
        mod.Header(dtype=np.float32, shape=(512, 512, 512), uniform=True,
                   coordinates=None, error_mode=0, s=float("inf"),
                   tolerance=1e-3, norm=1.0, lossless=0, n_levels=9,
                   section_sizes=(), layout=3, chunk_groups=4096),
        mod.Header(dtype=np.float64, shape=(5, 7), uniform=False,
                   coordinates=coords, error_mode=1, s=0.5,
                   tolerance=2.5e-4, norm=3.25, lossless=5, n_levels=3,
                   section_sizes=(), roi_block=4, roi_l_th=1, roi_scalar=9,
                   dd_dim=1, dd_nblocks=2, decomposition=1, layout=2,
                   orig_shape=(35,), dd_edges=(0, 3, 7), dd_grid=(1, 2)),
        mod.Header(dtype=np.float32, shape=(65, 65, 65), uniform=True,
                   coordinates=None, error_mode=0, s=float("inf"),
                   tolerance=1e-2, norm=1.0, lossless=0, n_levels=6,
                   section_sizes=(), layout=3, chunk_groups=2048),
    ]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_container_bytes_match_jax(which):
    sections = [b"\x01\x02\x03", b"", bytes(range(256)) * 3]
    tb = tfmt.write_container(_headers(tfmt)[which], sections)
    jb = jfmt.write_container(_headers(jfmt)[which], sections)
    assert tb == jb
    th, ts = tfmt.read_container(jb)
    jh, js = jfmt.read_container(tb)
    assert ts == js == sections
    for f in dataclasses.fields(jfmt.Header):
        a, b = getattr(th, f.name), getattr(jh, f.name)
        if f.name == "coordinates" and a is not None:
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert a == b, f.name


def test_container_corruption_detected():
    buf = bytearray(tfmt.write_container(_headers(tfmt)[0], [b"abc",
                                                             b"defg"]))
    bad_hdr = bytearray(buf)
    bad_hdr[30] ^= 0xFF
    with pytest.raises(ValueError, match="header CRC"):
        tfmt.read_container(bytes(bad_hdr))
    bad_payload = bytearray(buf)
    bad_payload[-1] ^= 0xFF
    with pytest.raises(ValueError, match="section 1 CRC"):
        tfmt.read_container(bytes(bad_payload))
    with pytest.raises(ValueError, match="truncated"):
        tfmt.read_container(bytes(buf[:-2]))
    with pytest.raises(ValueError, match="bad magic"):
        tfmt.read_container(b"XXXXXXXX" + bytes(buf[8:]))

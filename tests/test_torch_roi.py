"""mgard_tpu_torch's MGARD-ROI against mgard_tpu's, on the CPU.

The tile map, the node map, the per-block maps and the ROI quantizer are
bit for bit the JAX package's on the same inputs.  Containers cross both
ways: each package decodes the other's within the tolerance on ROI and
buffer nodes and within ``scalar`` times it on background nodes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgard_tpu
from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.models import roi as jroi

import mgard_tpu_torch as mt
from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.io import format as tfmt
from mgard_tpu_torch.models import roi
from mgard_tpu_torch.ops import norms

from test_torch_flat_e2e import _field


def _hotspot(shape, seed=80, dtype=np.float32):
    """A small smooth field with a raised box (the region of interest)."""
    v = 0.05 * _field(shape, np.float64, seed)
    v[tuple(slice(s // 4, s // 4 + max(s // 8, 2)) for s in shape)] += 1.0
    return v.astype(dtype)


CASES = [((17, 17), 4, 0.5, 2), ((33, 33, 33), 8, 0.5, 2),
         ((40, 17), 8, 0.3, 1), ((9, 9, 9, 9), 4, 0.6, 3),
         ((17, 1, 17), 8, 0.5, 2)]


@pytest.mark.parametrize("shape,block,threshold,l_th", CASES, ids=str)
def test_maps_bit_identical(shape, block, threshold, l_th):
    v = _hotspot(shape)
    jh, th = JHierarchy(shape), Hierarchy(shape)
    jt = np.asarray(jax.jit(lambda a: jroi.roi_tile_map(
        jh, a, threshold, block))(jnp.asarray(v)))
    tt_ = roi.roi_tile_map(th, torch.from_numpy(v), threshold, block)
    assert np.array_equal(tt_.numpy(), jt)
    assert set(np.unique(jt)) <= {roi.ROI, roi.BUFFER_ZONE, roi.BACKGROUND}
    ju = np.asarray(jax.jit(lambda t: jroi.node_map_from_tiles(
        jh, t, block, l_th))(jnp.asarray(jt)))
    tu = roi.node_map_from_tiles(th, torch.from_numpy(jt), block, l_th)
    assert np.array_equal(tu.numpy(), ju)
    assert np.array_equal(roi.build_roi_map(
        th, torch.from_numpy(v), threshold, block, l_th).numpy(), ju)
    jb = jax.jit(lambda u: jroi._map_blocks(jh, u))(jnp.asarray(ju))
    tb = roi._map_blocks(th, torch.from_numpy(ju))
    assert all(np.array_equal(t.numpy(), np.asarray(j))
               for t, j in zip(tb, jb))


@pytest.mark.parametrize("s", [math.inf, 0.0], ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantizer_bit_identical(dtype, s):
    """The ROI quanta on the JAX package's own blocks: integers equal; the
    dequantized blocks within two ulps (jitted, XLA divides by a constant
    as a product with its reciprocal)."""
    shape, tol, scalar = (33, 33), 1e-3, 23
    v = _hotspot(shape, dtype=dtype)
    jh, th = JHierarchy(shape), Hierarchy(shape)
    umap = np.asarray(jroi.build_roi_map(jh, jnp.asarray(v), 0.5, 8, 2))

    @jax.jit
    def jq(a, u, tol):
        blocks = jroi.transform.pyramid_to_blocks(
            jh, jroi.transform.decompose(jh, a))
        mb = jroi._map_blocks(jh, u)
        q = jroi.quantize_blocks_roi(jh, blocks, mb, s, tol, scalar)
        return blocks, q, jroi.dequantize_blocks_roi(jh, q, mb, s, tol,
                                                     scalar, a.dtype)

    jblocks, jqs, jdq = jq(jnp.asarray(v), jnp.asarray(umap), tol)
    mb = roi._map_blocks(th, torch.from_numpy(umap))
    tqs = roi.quantize_blocks_roi(
        th, [torch.from_numpy(np.array(b)) for b in jblocks], mb, s, tol,
        scalar)
    for t, j in zip(tqs, jqs):
        assert np.array_equal(t.numpy(), np.asarray(j))
    tdq = roi.dequantize_blocks_roi(th, tqs, mb, s, tol, scalar, dtype)
    for t, j in zip(tdq, jdq):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=0,
                                   rtol=2 * np.finfo(dtype).eps)


def _check(out, v, umap, tol, scalar):
    err = np.abs(out.astype(np.float64) - v)
    assert err[umap != roi.BACKGROUND].max() <= tol
    assert err.max() <= scalar * tol


@pytest.mark.parametrize("shape,block,s", [((17, 17, 17), 4, math.inf),
                                           ((40, 17), 4, 0.0)], ids=str)
def test_cross_decode_both_ways(shape, block, s):
    v, tol = _hotspot(shape, seed=81), 1e-3
    bj = jroi.compress_roi(v, tol, s=s, threshold=0.5, block=block)
    bt = roi.compress_roi(v, tol, s=s, threshold=0.5, block=block,
                          device="cpu")
    hj, sj = tfmt.read_container(bj)
    ht, st = tfmt.read_container(bt)
    assert (ht.roi_block, ht.roi_l_th, ht.roi_scalar, ht.lossless,
            ht.chunk_groups, ht.n_levels) == (
        hj.roi_block, hj.roi_l_th, hj.roi_scalar, hj.lossless,
        hj.chunk_groups, hj.n_levels)
    assert st[2] == sj[2] and len(st[0]) == len(sj[0])
    th = Hierarchy(shape)
    umap = roi.build_roi_map(th, torch.from_numpy(v), 0.5, block).numpy()
    scalar = roi.default_scalar(th.effective_ndim)
    assert ht.roi_scalar == scalar
    for buf in (bj, bt):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            assert out.shape == v.shape and out.dtype == v.dtype
            if math.isinf(s):
                _check(out, v, umap, tol, scalar)
            else:
                err = torch.from_numpy(out.astype(np.float64) - v)
                assert float(norms.norm(th, err, s)) <= scalar * tol
    # background nodes stored at a coarser quantum: fewer stream words
    # than the per-group container of the same field (whose exponent
    # section drops its zero tail, as an ROI container's does not)
    plain = tfmt.read_container(mt.compress(v, tol, s=s, device="cpu"))
    assert plain[0].lossless == ht.lossless
    assert len(st[1]) < len(plain[1][1])


def test_corrupted_roi_container_refused():
    v = _hotspot((17, 17))
    buf = roi.compress_roi(v, 1e-3, block=4, device="cpu")
    header, sections = tfmt.read_container(buf)
    for bad in ([sections[0], sections[1][:-4], sections[2]],
                [sections[0], sections[1], sections[2][:-1]],
                sections[:2]):
        with pytest.raises(ValueError, match="corrupted"):
            mt.decompress(tfmt.write_container(header, bad), device="cpu")
    with pytest.raises(ValueError, match="decompress"):
        mt.api.compressor_for(header, device="cpu")
    out = roi.decompress_roi(header, sections, device="cpu")
    assert np.array_equal(out, mt.decompress(buf, device="cpu"))

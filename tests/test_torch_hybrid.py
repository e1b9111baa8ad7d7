"""The HYBRID decomposition of mgard_tpu_torch against mgard_tpu, on the
CPU.

* The host tables (``padded_shape``, ``coarse_shape``,
  ``hybrid_stream_size``, ``hybrid_coords``, ``hybrid_operators``,
  ``hybrid_volume_weights``, the uniform block operators) equal the JAX
  ones bit for bit: both are the same float64 numpy.
* ``_edge_pad`` (narrow + expand + cat) equals ``np.pad(mode="edge")``
  on 1-D to 4-D arrays.
* The hybrid L-infinity quantum and its float32 inverse are the jitted
  JAX compressor's bit for bit.
* The block products and ``decompose_hybrid``/``recompose_hybrid``
  agree with the JAX functions (jitted; ``dot_general`` at HIGHEST)
  within ``REL_BOUND * max|v|`` in float32 (the bound of
  ``test_torch_transform.py``; the products sum in another order) and
  ``1e-12 * max|v|`` in float64, on uniform and nonuniform grids with one
  and two local levels; recompose inverts decompose within the same
  bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgard_tpu.config import Config as JConfig, Decomposition as JDec
from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.models.compressor import get_compressor as jget
from mgard_tpu.ops import transform_hybrid as jth

import mgard_tpu_torch as mt
from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.models.compressor import get_compressor as tget
from mgard_tpu_torch.ops import transform_hybrid as tth

from test_torch_layouts import _coords
from test_torch_longdims import _field
from test_torch_singledim import _close

REL_BOUND = 1e-5
SHAPES = [(5,), (17, 2, 17), (6, 10, 3), (20, 33, 17), (9, 9, 9, 9)]


def _grid(shape, nonuniform):
    return _coords(shape, 9) if nonuniform else [
        np.linspace(0.0, 1.0, n) if n > 1 else np.zeros(1) for n in shape]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES + [(512, 512, 512), (100, 1, 37)],
                         ids=str)
def test_shapes_and_stream_size_match_jax(shape, k):
    assert tth.padded_shape(shape, k) == jth.padded_shape(shape, k)
    assert tth.coarse_shape(shape, k) == jth.coarse_shape(shape, k)
    assert tth.hybrid_stream_size(shape, k) == jth.hybrid_stream_size(shape,
                                                                      k)


@pytest.mark.parametrize("nonuniform", [False, True],
                         ids=["uniform", "nonuniform"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_host_tables_match_jax(shape, nonuniform):
    coords = _grid(shape, nonuniform)
    for a, b in zip(tth._local_mats(), jth._local_mats()):
        assert np.array_equal(a, b)
    for k in (1, 2):
        for la, lb in zip(tth.hybrid_coords(shape, k, coords),
                          jth.hybrid_coords(shape, k, coords)):
            assert all(np.array_equal(a, b) for a, b in zip(la, lb))
        for la, lb in zip(tth.hybrid_volume_weights(shape, k, coords),
                          jth.hybrid_volume_weights(shape, k, coords)):
            assert all(np.array_equal(a, b) for a, b in zip(la, lb))
        for la, lb in zip(tth.hybrid_operators(shape, k, coords),
                          jth.hybrid_operators(shape, k, coords)):
            for a, b in zip(la, lb):
                assert (a is None) == (b is None)
                if a is not None:
                    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape,target", [
    ((5,), (8,)), ((3, 6), (8, 6)), ((5, 1, 7), (8, 1, 8)),
    ((2, 3, 4, 5), (8, 3, 8, 6))], ids=str)
def test_edge_pad_1d_to_4d(shape, target):
    v = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.pad(v, [(0, t - s) for s, t in zip(shape, target)],
                  mode="edge")
    got = tth._edge_pad(torch.from_numpy(v), target).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    assert tth._edge_pad(torch.from_numpy(v), shape).shape == shape


@pytest.mark.parametrize("tol", [1e-3, 0.37, 3.3e-7], ids=str)
@pytest.mark.parametrize("shape", [(17, 9, 33), (65, 65, 65), (100, 37)],
                         ids=str)
def test_hybrid_quantum_bit_identical(shape, tol):
    jc = jget(shape, np.float32, config=JConfig(decomposition=JDec.HYBRID))
    tc = tget(shape, np.float32,
              config=mt.Config(decomposition=mt.Decomposition.HYBRID),
              device="cpu")
    q, inv = jax.jit(lambda t: (jc._hybrid_quantum(t),
                                (1.0 / jc._hybrid_quantum(t)
                                 ).astype(np.float32)))(tol)
    tq = tc._hybrid_quantum(tol)
    assert np.float64(tq).view(np.int64) == np.float64(q).view(np.int64)
    assert np.float32(1.0 / tq).view(np.int32) \
        == np.float32(inv).view(np.int32)
    assert tc._nstream == jc._nstream


def test_block_products_match_jax():
    rng = np.random.default_rng(2)
    B = rng.standard_normal((16, 24, 5)).astype(np.float32)
    Ms = rng.standard_normal((3, 5, 8))
    for axis, bsz, M in ((0, 8, tth._K), (1, 8, tth._E), (2, 5, tth._P)):
        if B.shape[axis] % bsz:
            continue
        _close(tth._apply_blocked(M, torch.from_numpy(B), axis, bsz),
               jth._apply_blocked(M, jnp.asarray(B), axis, bsz),
               REL_BOUND * 10)
    _close(tth._apply_blocked_batched(Ms, torch.from_numpy(B), 1, 8),
           jth._apply_blocked_batched(Ms, jnp.asarray(B), 1, 8),
           REL_BOUND * 10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("nonuniform", [False, True],
                         ids=["uniform", "nonuniform"])
@pytest.mark.parametrize("shape", [(17, 2, 17), (20, 33, 17), (9, 9, 9, 9)],
                         ids=str)
def test_transform_matches_jax(shape, nonuniform, k, dtype):
    coords = _grid(shape, nonuniform)
    lc = tth.hybrid_coords(shape, k, coords)[-1]
    th = Hierarchy(tth.coarse_shape(shape, k), coordinates=lc)
    jh = JHierarchy(jth.coarse_shape(shape, k), coordinates=lc)
    tops = tth.hybrid_operators(shape, k, coords) if nonuniform else None
    jops = jth.hybrid_operators(shape, k, coords) if nonuniform else None
    v = _field(shape, seed=4).astype(dtype)
    bound = (REL_BOUND if dtype == np.float32 else 1e-12) \
        * float(np.abs(v).max())
    tp, td = tth.decompose_hybrid(th, torch.from_numpy(v), k, ops=tops)
    jp, jd = jax.jit(lambda a: jth.decompose_hybrid(jh, a, k, ops=jops))(
        jnp.asarray(v))
    for a, b in zip(tp + td, list(jp) + list(jd)):
        _close(a, b, bound)
    out = tth.recompose_hybrid(th, tp, td, shape, ops=tops)
    _close(out, v, bound)
    jout = jax.jit(lambda p, d: jth.recompose_hybrid(jh, p, d, shape,
                                                     ops=jops))(
        [jnp.asarray(a.numpy()) for a in tp],
        [jnp.asarray(a.numpy()) for a in td])
    _close(out, jout, bound)
    flat = tth.flatten_hybrid(th, tp, td)
    assert flat.numel() == tth.hybrid_stream_size(shape, k)
    up, ud = tth.unflatten_hybrid(th, flat, shape, k)
    for a, b in zip(up + ud, tp + td):
        _close(a, b.numpy(), 0.0)


def test_planner_hybrid_factor_covers_every_local_level_count():
    """The planner's HYBRID factor is 1.15 times the highest HYBRID encode
    peak measured on the card at 512^3 (local level counts 1-4 and 10,
    the last that shrinks the global grid: 7.6379x at ten), one factor
    for every count."""
    from mgard_tpu_torch import api
    assert api.PEAK_PER_BYTE["hybrid"] == 7.6379
    assert {api.footprint_per_byte(
        (512,) * 3, np.float32,
        mt.Config(decomposition=mt.Decomposition.HYBRID, num_local_levels=k))
        for k in (1, 3, 4, 10)} == {1.15 * 7.6379}
    assert tth.coarse_shape((512,) * 3, 10) \
        == tth.coarse_shape((512,) * 3, 11) != tth.coarse_shape((512,) * 3, 9)

"""mgard_tpu_torch's transform against mgard_tpu's, on the CPU.

* K1 (coarse extraction) is a pure selection: the port's plain version,
  the port's CPU path and the JAX Pallas kernel in interpret mode are all
  bit-identical to ``mgard_tpu.ops.transform._extract_old_all``.
* decompose / recompose agree with JAX-on-CPU within
  ``1e-5 * max|v|``.  Both run the same float32 operators; the sums in
  the dense correction and prolongation contractions are taken in
  another order by the two BLAS back ends, which moves results by a few
  float32 ulps of the data's magnitude per level (observed ~2e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import extract_kernels as jxk
from mgard_tpu.ops import transform as jt

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.io.carry import pyramid_from_numpy
from mgard_tpu_torch.ops import extract_kernels as xk
from mgard_tpu_torch.ops import transform as tt

REL_BOUND = 1e-5


def _field(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = [np.linspace(0, 1, s) for s in shape]
    v = np.ones(shape)
    for d, xx in enumerate(x):
        shp = [1] * len(shape)
        shp[d] = len(xx)
        v = v * np.cos(3 * xx + d).reshape(shp)
    return (v + 0.01 * rng.standard_normal(shape)).astype(np.float32)


def _coords(shape, seed=5):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.uniform(0, 2, s)) if s > 1 else np.zeros(1)
            for s in shape]


@pytest.mark.parametrize("shape,l", [((16, 128, 256), None),
                                     ((16, 128, 256), -1),
                                     ((33, 33, 33), None),
                                     ((20, 33, 18), None),
                                     ((20, 33, 18), -1)], ids=str)
def test_extract_plain_bit_identical(shape, l):
    jh, th = JHierarchy(shape), Hierarchy(shape)
    l = jh.L if l is None else jh.L + l
    A = _field(jh.shapes[l], 1)
    ref = np.asarray(jax.jit(lambda a: jt._extract_old_all(jh, a, l))(A))
    got = xk.extract_coarse_3d(th, torch.from_numpy(A), l).numpy()
    cpu_path = tt._extract_old_all(th, torch.from_numpy(A), l).numpy()
    assert got.tobytes() == ref.tobytes()
    assert cpu_path.tobytes() == ref.tobytes()


def test_extract_pallas_interpret_bit_identical():
    """The TPU kernel itself, interpreted, at a level its gate admits
    apart from the backend check."""
    shape = (16, 128, 256)
    jh, th = JHierarchy(shape), Hierarchy(shape)
    A = _field(shape, 2)
    with pltpu.force_tpu_interpret_mode():
        pk = np.asarray(jxk.extract_coarse_3d(jh, jnp.asarray(A), jh.L))
    ref = np.asarray(jt._extract_old_all(jh, jnp.asarray(A), jh.L))
    got = xk.extract_coarse_3d(th, torch.from_numpy(A), th.L).numpy()
    assert pk.tobytes() == ref.tobytes() == got.tobytes()


def test_extract_gate():
    """The CPU tensor never takes the kernel's gate; the level pattern
    part of the gate follows the JAX package's."""
    th = Hierarchy((16, 128, 256))
    A = torch.zeros(th.shape)
    assert not xk.extract_supported(th, th.L, A)
    small = Hierarchy((17, 17, 17))
    assert not xk.extract_supported(small, small.L, torch.zeros(small.shape))


CASES = [(17, 17, 17), (33, 33, 33), (65, 65, 65), (20, 33, 18),
         (1, 9, 40), (33, 65), (129,)]


@pytest.mark.parametrize("shape", CASES, ids=str)
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "coords"])
def test_decompose_recompose_match_jax(shape, uniform):
    coords = None if uniform else _coords(shape)
    jh = JHierarchy(shape, coordinates=coords)
    th = Hierarchy(shape, coordinates=coords)
    v = _field(shape)
    scale = float(np.abs(v).max())

    jp = [np.asarray(p) for p in
          jax.jit(lambda a: jt.decompose(jh, a))(jnp.asarray(v))]
    tp = [p.numpy() for p in tt.decompose(th, torch.from_numpy(v))]
    assert [p.shape for p in tp] == [p.shape for p in jp]
    assert all(p.dtype == np.float32 for p in tp)
    err = max(float(np.abs(a - b).max()) for a, b in zip(jp, tp))
    assert err <= REL_BOUND * scale, err

    # the port recomposes the JAX package's own pyramid
    rj = np.asarray(jax.jit(lambda *p: jt.recompose(jh, list(p)))(*jp))
    rt = tt.recompose(th, pyramid_from_numpy(th, jp, "cpu")).numpy()
    assert np.abs(rj - rt).max() <= REL_BOUND * scale
    assert np.abs(rt - v).max() <= REL_BOUND * scale


def test_recompose_to_level_matches_jax():
    shape = (33, 33, 33)
    jh, th = JHierarchy(shape), Hierarchy(shape)
    v = _field(shape, 4)
    jp = [np.asarray(p) for p in
          jax.jit(lambda a: jt.decompose(jh, a))(jnp.asarray(v))]
    for lmax in (0, 2, jh.L - 1):
        rj = np.asarray(jax.jit(
            lambda *p: jt.recompose_to_level(jh, list(p), lmax))(*jp))
        rt = tt.recompose_to_level(
            th, pyramid_from_numpy(th, jp, "cpu"), lmax).numpy()
        assert rt.shape == th.shapes[lmax]
        assert np.abs(rj - rt).max() <= REL_BOUND * np.abs(v).max()


def test_long_dims_not_ported():
    """(Named for the refusal it once checked.)  A dim over 4096 nodes
    takes the per-dim transform, as in the JAX package: the pyramids and
    the round trip agree with JAX's within the same bound."""
    shape = (5000,)
    jh, th = JHierarchy(shape), Hierarchy(shape)
    assert not tt._use_matmul(th, th.L)
    v = _field(shape, 6)
    scale = float(np.abs(v).max())
    jp = [np.asarray(p) for p in
          jax.jit(lambda a: jt.decompose(jh, a))(jnp.asarray(v))]
    tp = [p.numpy() for p in tt.decompose(th, torch.from_numpy(v))]
    assert max(float(np.abs(a - b).max()) for a, b in zip(jp, tp)) \
        <= REL_BOUND * scale
    rt = tt.recompose(th, pyramid_from_numpy(th, jp, "cpu")).numpy()
    assert np.abs(rt - v).max() <= REL_BOUND * scale


def test_pyramid_from_numpy_checks_shapes():
    th = Hierarchy((9, 9))
    with pytest.raises(ValueError, match="levels"):
        pyramid_from_numpy(th, [np.zeros((9, 9))], "cpu")
    arrays = [np.zeros(s, np.float32) for s in th.shapes]
    arrays[1] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="level 1"):
        pyramid_from_numpy(th, arrays, "cpu")

"""mgard_tpu_torch's shift-stencil forms (``ops/stencil.py``) against
``mgard_tpu.ops.stencil`` on the CPU, on the same seeded numpy inputs.

* ``supported`` agrees with the JAX function at every level of every
  case, levels where it is False included.
* ``interp_all`` and ``detail_stencil`` at the finest and the coarsest
  level are bit-identical on uniform grids.  On nonuniform grids they
  are held within ``NONUNIFORM_BOUND * max|A|``: the JAX module's lerps
  run op by op here, but under ``jit`` XLA's CPU fuses ``(1-w)*l + w*r``
  and rounds it otherwise.  (Each JAX op compiles once a shape, about a
  second a level, so the middle levels are left out.)
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import stencil as jst

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.ops import stencil as st

NONUNIFORM_BOUND = 1e-6


def _coords(shape, seed=3):
    """Sorted random coordinates on [0, 1] with fixed end points."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shape:
        c = np.sort(rng.uniform(size=s))
        c[0], c[-1] = 0.0, 1.0
        out.append(c)
    return out


@functools.lru_cache(maxsize=None)
def _hiers(shape, uniform):
    coords = None if uniform else _coords(shape)
    return (JHierarchy(shape, coordinates=coords),
            Hierarchy(shape, coordinates=coords))


# (shape, uniform grid, dtype): 1-D to 4-D, a flat dim, and (20, 33, 18),
# whose coarsest level has a dim with parents not at +-1.
CASES = [((33,), True, np.float32),
         ((17, 9), False, np.float64),
         ((9, 1, 17), True, np.float64),
         ((16, 32, 24), False, np.float32),
         ((9, 9, 9, 9), True, np.float32),
         ((20, 33, 18), False, np.float64),
         ((20, 33, 18), True, np.float32),
         ((12, 40, 9), True, np.float64)]


@pytest.mark.parametrize("shape,uniform,dtype", CASES,
                         ids=lambda c: getattr(c, "__name__", str(c)))
def test_stencil_forms_match_jax(shape, uniform, dtype):
    jh, th = _hiers(shape, uniform)
    admitted = refused = 0
    for l in range(1, th.L + 1):
        ok = st.supported(th, l)
        assert ok == jst.supported(jh, l), l
        refused += not ok
        if not ok or l not in (1, th.L):
            continue
        admitted += 1
        A = np.random.default_rng(l).standard_normal(
            th.shapes[l]).astype(dtype)
        bound = 0.0 if uniform else NONUNIFORM_BOUND * np.abs(A).max()
        for ours, theirs in ((st.interp_all, jst.interp_all),
                             (st.detail_stencil, jst.detail_stencil)):
            got = ours(th, torch.from_numpy(A), l)
            ref = np.asarray(theirs(jh, jnp.asarray(A), l))
            assert got.dtype == torch.from_numpy(A).dtype
            assert got.shape == ref.shape
            assert np.abs(got.numpy() - ref).max() <= bound, (l, ours)
    assert admitted
    if shape == (20, 33, 18):
        assert refused == 1


def test_vectors_are_float64_and_cached():
    _, th = _hiers((17, 1, 9), False)
    vecs = st._interp_vectors(th, th.L)
    assert vecs[1] is None
    assert all(v.dtype == np.float64 for mv in (vecs[0], vecs[2])
               for v in mv)
    assert st._interp_vectors(th, th.L) is vecs

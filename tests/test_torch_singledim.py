"""The SINGLEDIM decomposition of mgard_tpu_torch against mgard_tpu, on
the CPU.

* ``decompose_sd``/``recompose_sd`` agree with the JAX functions (jitted)
  within ``REL_BOUND * max|v|`` in float32 (the bound of
  ``test_torch_transform.py``) and ``1e-12 * max|v|`` in float64: the
  JAX scan contracts ``d - w * carry`` into a fused multiply-add on the
  CPU, and the lerps and mass products round in another order, so the
  float stages agree within a bound, not bit for bit.  The port's
  recompose inverts its decompose within the same bounds.
* ``slab_specs``, ``flatten_slabs``/``unflatten_slabs`` and the slab
  quanta (``scale_slabs``/``unscale_slabs`` at s = inf, 0 and 1) are
  bit-identical to the JAX ones on the same inputs.
* On the CPU the correction's solve is ``mass_solve``'s plain version
  (S1's on the card), once per level and dim each way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import transform_singledim as jsd

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.ops import _build, transform_singledim as tsd
from mgard_tpu_torch.ops import tridiag

from test_torch_layouts import _coords, _same
from test_torch_longdims import _field

REL_BOUND = 1e-5
SHAPES = [((5,), False), ((17, 2, 17), False), ((6, 10, 3), False),
          ((33, 33, 33), True), ((9, 9, 9, 9), False), ((9, 4200), False)]
IDS = [f"{s}{'-nonuniform' if nu else ''}" for s, nu in SHAPES]


def _hiers(shape, nonuniform):
    coords = _coords(shape, 4) if nonuniform else None
    return (Hierarchy(shape, coordinates=coords),
            JHierarchy(shape, coordinates=coords))


def _close(a, b, bound):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    assert a.shape == np.shape(b)
    diff = np.abs(a.astype(np.float64) - np.asarray(b, np.float64))
    assert a.size == 0 or diff.max() <= bound


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
@pytest.mark.parametrize("shape,nonuniform", SHAPES, ids=IDS)
def test_transform_matches_jax(shape, nonuniform, dtype):
    th, jh = _hiers(shape, nonuniform)
    v = _field(shape, seed=2).astype(dtype)
    bound = (REL_BOUND if dtype == np.float32 else 1e-12) \
        * float(np.abs(v).max())
    tc, ts = tsd.decompose_sd(th, torch.from_numpy(v))
    jc, js = jax.jit(lambda a: jsd.decompose_sd(jh, a))(jnp.asarray(v))
    _close(tc, jc, bound)
    for l in range(1, th.L + 1):
        assert sorted(ts[l]) == sorted(js[l])
        for d in ts[l]:
            _close(ts[l][d], js[l][d], bound)
    out = tsd.recompose_sd(th, tc, ts)
    _close(out, v, bound)
    jout = jax.jit(lambda c, s: jsd.recompose_sd(jh, c, s))(
        jnp.asarray(tc.numpy()), [None if s is None else
                                  {d: jnp.asarray(b.numpy())
                                   for d, b in s.items()} for s in ts])
    _close(out, jout, bound)


def test_solves_once_a_level_and_dim():
    th, _ = _hiers((17, 9, 33), False)
    v = torch.from_numpy(_field((17, 9, 33), seed=1))
    calls = []
    saved = tsd.mass_solve
    tsd.mass_solve = lambda b, off, div, axis: calls.append(axis) or \
        saved(b, off, div, axis)
    try:
        c, s = tsd.decompose_sd(th, v)
        assert calls == [0, 1, 2] * th.L
        tsd.recompose_sd(th, c, s)
        assert calls == [0, 1, 2] * th.L + [2, 1, 0] * th.L
    finally:
        tsd.mass_solve = saved
    # on the CPU the counted wrapper takes the plain version: no launch
    _build.reset_launches()
    tsd.decompose_sd(th, v)
    assert tridiag.mass_solve.launches == 0


@pytest.mark.parametrize("s", [np.inf, 0.0, 1.0], ids=str)
@pytest.mark.parametrize("shape,nonuniform", SHAPES[1:5], ids=IDS[1:5])
def test_slabs_match_jax(shape, nonuniform, s):
    th, jh = _hiers(shape, nonuniform)
    assert tsd.slab_specs(th) == jsd.slab_specs(jh)
    rng = np.random.default_rng(6)
    coarse = rng.standard_normal(th.shapes[0]).astype(np.float32)
    slabs = [None] + [{d: rng.standard_normal(shp).astype(np.float32)
                       for (l_, d, shp) in tsd.slab_specs(th) if l_ == l}
                      for l in range(1, th.L + 1)]
    tcs = torch.from_numpy(coarse)
    tsl = [None if x is None else {d: torch.from_numpy(b)
                                   for d, b in x.items()} for x in slabs]
    jsl = [None if x is None else {d: jnp.asarray(b) for d, b in x.items()}
           for x in slabs]
    tol = 1e-3
    sc, ss = tsd.scale_slabs(th, tcs, tsl, s, tol)
    jc, js = jsd.scale_slabs(jh, jnp.asarray(coarse), jsl, s, tol)
    _same(sc, jc)
    for l in range(1, th.L + 1):
        for d in ss[l]:
            _same(ss[l][d], js[l][d])
    flat = tsd.flatten_slabs(th, sc, ss)
    _same(flat, jsd.flatten_slabs(jh, jc, js))
    q = torch.round(flat).to(torch.int32)
    uc, us = tsd.unflatten_slabs(th, q)
    juc, jus = jsd.unflatten_slabs(jh, jnp.asarray(q.numpy()))
    _same(uc, juc)
    dc, ds = tsd.unscale_slabs(th, uc, us, s, tol, np.float32)
    jdc, jds = jsd.unscale_slabs(jh, juc, jus, s, tol, np.float32)
    _same(dc, jdc)
    for l in range(1, th.L + 1):
        for d in ds[l]:
            _same(us[l][d], jus[l][d])
            _same(ds[l][d], jds[l][d])

"""The FINE and LEVEL_BLOCKS layout maps of mgard_tpu_torch against
mgard_tpu, on the CPU.

* ``Hierarchy.regions``, ``dates_of_birth``, ``date_of_birth_grid``,
  ``shuffle_permutation`` and ``level_counts`` equal the JAX ones.
* Every layout map and its inverse (``block_specs``,
  ``pyramid_to_fine``/``fine_to_pyramid``,
  ``pyramid_to_blocks``/``blocks_to_pyramid``,
  ``flatten_pyramid``/``unflatten_pyramid``) is bit-identical to the
  JAX one (jitted) on the same float32 and int32 inputs: both select and
  embed exactly, and add the same zeros.
* The block quanta (``scale_blocks``, ``quantize_blocks``,
  ``dequantize_blocks``) are bit-identical to the JAX functions called
  eagerly at s = inf, 0 and 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import quantize as jq, transform as jt

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.ops import quantize as tq, transform as tt


def _coords(shape, seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in shape:
        c = np.sort(rng.uniform(size=n))
        c[0], c[-1] = 0.0, 1.0
        out.append(c)
    return out


# (shape, nonuniform); "reference" places the non-dyadic level's nodes
# as the reference does, so its parents take the general (gather and
# scatter) branches
GRIDS = [((5,), False), ((17, 2, 17), False), ((6, 10, 3), False),
         ((33, 33, 33), True), ((9, 9, 9, 9), False),
         ((6, 10, 3), "reference")]
IDS = [f"{s}{'-' + str(nu) if nu else ''}".replace("True", "nonuniform")
       for s, nu in GRIDS]


def _hiers(shape, nonuniform):
    if nonuniform == "reference":
        return (Hierarchy(shape, placement="reference"),
                JHierarchy(shape, placement="reference"))
    coords = _coords(shape, 3) if nonuniform else None
    return (Hierarchy(shape, coordinates=coords),
            JHierarchy(shape, coordinates=coords))


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _same(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    assert np.array_equal(_bits(t), _bits(j))


def _pyramid(hier, dtype, seed):
    """Random level arrays in the pyramid's shapes, zero at each detail
    level's parent positions as a decomposition leaves them."""
    rng = np.random.default_rng(seed)
    pyr = []
    for l, shp in enumerate(hier.shapes):
        a = rng.standard_normal(shp) * 100
        if l:
            keep = np.ones(shp, dtype=bool)
            sel = np.ix_(*[hier.dims[d][l].coarse_pos
                           if hier.dims[d][l].coarse_pos is not None
                           else np.arange(shp[d]) for d in range(len(shp))])
            keep[sel] = False
            a = np.where(keep, a, 0)
        pyr.append(a.astype(dtype))
    return pyr


@pytest.mark.parametrize("shape,nonuniform", GRIDS, ids=IDS)
def test_hierarchy_methods_match_jax(shape, nonuniform):
    th, jh = _hiers(shape, nonuniform)
    assert "dates_of_birth" not in th.__dict__     # built at first use
    for a, b in zip(th.dates_of_birth, jh.dates_of_birth):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert np.array_equal(th.date_of_birth_grid(), jh.date_of_birth_grid())
    assert np.array_equal(th.shuffle_permutation(), jh.shuffle_permutation())
    assert np.array_equal(th.level_counts(), jh.level_counts())
    for l in range(1, th.L + 1):
        tr, jr = list(th.regions(l)), list(jh.regions(l))
        assert [(r, bs, [k for k, _ in sel]) for r, bs, sel in tr] \
            == [(r, bs, [k for k, _ in sel]) for r, bs, sel in jr]
    ts, js = tt.block_specs(th), jt.block_specs(jh)
    assert len(ts) == len(js)
    for (l, r, bs, pos), (jl, jr_, jbs, jpos) in zip(ts, js):
        assert (l, r, bs) == (jl, jr_, jbs)
        assert all(np.array_equal(a, b) for a, b in zip(pos, jpos))


@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=str)
@pytest.mark.parametrize("shape,nonuniform", GRIDS, ids=IDS)
def test_layout_maps_match_jax(shape, nonuniform, dtype):
    th, jh = _hiers(shape, nonuniform)
    pyr = _pyramid(th, dtype, seed=len(shape))
    tp = [torch.from_numpy(a) for a in pyr]
    jp = [jnp.asarray(a) for a in pyr]

    fine = tt.pyramid_to_fine(th, tp)
    _same(fine, jax.jit(lambda p: jt.pyramid_to_fine(jh, p))(jp))
    for a, b in zip(tt.fine_to_pyramid(th, fine),
                    jax.jit(lambda f: jt.fine_to_pyramid(jh, f))(
                        jnp.asarray(fine.numpy()))):
        _same(a, b)

    blocks = tt.pyramid_to_blocks(th, tp)
    jblocks = jax.jit(lambda p: jt.pyramid_to_blocks(jh, p))(jp)
    for a, b in zip(blocks, jblocks):
        _same(a.contiguous(), b)
    for a, b in zip(tt.blocks_to_pyramid(th, blocks),
                    jax.jit(lambda bl: jt.blocks_to_pyramid(jh, bl))(
                        jblocks)):
        _same(a, b)

    flat = tt.flatten_pyramid(th, tp)
    _same(flat, jax.jit(lambda p: jt.flatten_pyramid(jh, p))(jp))
    for a, b, orig in zip(tt.unflatten_pyramid(th, flat),
                          jax.jit(lambda f: jt.unflatten_pyramid(jh, f))(
                              jnp.asarray(flat.numpy())), pyr):
        _same(a, b)
        _same(a, orig)


def test_fine_to_pyramid_of_ints_takes_the_slices(monkeypatch):
    """The FINE decode splits the integer stream with slices: K1's gate
    is never asked to take it."""
    from mgard_tpu_torch.ops import extract_kernels as xk
    th, _ = _hiers((33, 33, 33), False)
    asked = []
    monkeypatch.setattr(xk, "extract_supported",
                        lambda hier, l, A: asked.append(A.dtype) or False)
    fine = torch.arange(33 ** 3, dtype=torch.int32).reshape(33, 33, 33)
    pyr = tt.fine_to_pyramid(th, fine)
    assert all(p.dtype == torch.int32 for p in pyr)
    assert asked == [torch.int32] * th.L
    _same(tt.pyramid_to_fine(th, pyr), fine)


@pytest.mark.parametrize("s", [np.inf, 0.0, 1.0], ids=str)
@pytest.mark.parametrize("shape,nonuniform", GRIDS[1:4], ids=IDS[1:4])
def test_block_quanta_match_jax(shape, nonuniform, s):
    th, jh = _hiers(shape, nonuniform)
    tol = 1e-3
    pyr = _pyramid(th, np.float32, seed=5)
    blocks = [b.contiguous() for b in tt.pyramid_to_blocks(
        th, [torch.from_numpy(a) for a in pyr])]
    jblocks = [jnp.asarray(b.numpy()) for b in blocks]
    for a, b in zip(tq.scale_blocks(th, blocks, s, tol),
                    jq.scale_blocks(jh, jblocks, s, tol)):
        _same(a, b)
    q = tq.quantize_blocks(th, blocks, s, tol)
    jqb = jq.quantize_blocks(jh, jblocks, s, tol)
    for a, b in zip(q, jqb):
        _same(a, b)
    for a, b in zip(tq.dequantize_blocks(th, q, s, tol, np.float32),
                    jq.dequantize_blocks(jh, jqb, s, tol, np.float32)):
        _same(a, b)

"""mgard_tpu_torch on long dims (over 4096 nodes) against mgard_tpu, on
the CPU: the per-dim transform that the JAX package takes there (the lerp
``prolong``, and the correction through ``mass_apply``, ``restrict`` and
the Thomas solve), the two switches that choose it, the fast divisor
recurrence of the hierarchy, and S1's plain solve.

* ``prolong`` and the fallback pyramids agree with JAX-on-CPU within
  ``REL_BOUND * max|v|`` (the bound of ``test_torch_transform.py``).
* The divisors are the JAX hierarchy's bit for bit.
* ``mass_solve_plain`` repeats the JAX scan's operations bit for bit
  (checked against a numpy replica of them); XLA's CPU backend contracts
  ``d - w * carry`` into one fused multiply-add, so against the JAX
  function itself it agrees within a few float ulps of ``max|x|``.
* S1's tiled schedule is emulated and held against the plain version
  in ``test_torch_s1_tiled.py``.
* End to end (``test_torch_longdims_e2e.py``), each package decodes the
  other's containers within the bound, with the same container sizes
  and header fields.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mgard_tpu
from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import transform as jt, tridiag as jtd

import mgard_tpu_torch as mt
from mgard_tpu_torch import api, hierarchy as th_mod
from mgard_tpu_torch.hierarchy import DimLevel, Hierarchy, dyadic_num_levels
from mgard_tpu_torch.io.carry import pyramid_from_numpy
from mgard_tpu_torch.ops import bp_kernels as bk, transform as tt
from mgard_tpu_torch.ops import tridiag as ttd

ROOT = Path(__file__).resolve().parent.parent
REL_BOUND = 1e-5
LONG = [(5000,), (9, 4200), (5, 9, 4100)]
# with _MATMUL_MAX_N patched to 16 in both packages
SMALL = [(33, 33, 33), (17, 2, 17)]


def _field(shape, seed=0):
    """bench.py's smooth field (three cosine modes plus 1e-3 noise) at a
    small size."""
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
    return (f + 0.001 * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture
def short_matmul(monkeypatch):
    """Both packages take the per-dim transform over 16 nodes a dim; the
    JAX package reads its switch while it traces, so its compressor cache
    is cleared around the test."""
    monkeypatch.setattr(jt, "_MATMUL_MAX_N", 16)
    monkeypatch.setattr(tt, "_MATMUL_MAX_N", 16)
    mgard_tpu.release_cache()
    mt.release_cache()
    yield
    mgard_tpu.release_cache()
    mt.release_cache()


# ---------------------------------------------------------------------------
# prolong
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,placement,branch", [
    ((33, 5), "tpu", "stride2"),
    ((20, 9), "tpu", "front"),
    ((20, 9), "reference", "general"),
    ((11, 7, 30), "reference", "general"),
], ids=str)
def test_prolong_matches_jax(shape, placement, branch):
    jh = JHierarchy(shape, placement=placement)
    th = Hierarchy(shape, placement=placement)
    for axis in range(len(shape)):
        lev = th.dims[axis][th.L]
        kind = ("stride2" if lev.coarse_is_stride2 else "front"
                if lev.front_nc is not None else "general")
        if axis == 0:
            assert kind == branch
        cshape = list(shape)
        cshape[axis] = len(lev.coarse_pos)
        c = _field(tuple(cshape), seed=axis)
        want = np.asarray(jt.prolong(jnp.asarray(c), jh.dims[axis][jh.L],
                                     axis))
        got = tt.prolong(torch.from_numpy(c), lev, axis).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= REL_BOUND * np.abs(c).max()


def test_lerp_tables_match_the_jax_loops():
    """The general branch's vectorized tables are the JAX loops'."""
    for shape in ((20,), (11,), (30,)):
        lev = Hierarchy(shape, placement="reference").dims[0][-1]
        la = np.zeros(lev.n, dtype=np.int64)
        ra = np.zeros(lev.n, dtype=np.int64)
        w = np.zeros(lev.n, dtype=np.float64)
        inv_old = {int(p): j for j, p in enumerate(lev.coarse_pos)}
        for pos in range(lev.n):
            if pos in inv_old:
                la[pos] = ra[pos] = inv_old[pos]
        for k, pos in enumerate(lev.new_pos):
            la[pos] = inv_old[int(lev.new_left[k])]
            ra[pos] = inv_old[int(lev.new_right[k])]
            w[pos] = lev.new_ratio[k]
        got = tt._lerp_tables(lev)
        for a, b in zip(got, (la, ra, w)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the per-dim transform
# ---------------------------------------------------------------------------

def _pyramids(shape, seed):
    jh, th = JHierarchy(shape), Hierarchy(shape)
    v = _field(shape, seed)
    jp = [np.asarray(p) for p in
          jax.jit(lambda a: jt.decompose(jh, a))(jnp.asarray(v))]
    tp = [p.numpy() for p in tt.decompose(th, torch.from_numpy(v))]
    return jh, th, v, jp, tp


def _check_pyramids(shape, seed):
    jh, th, v, jp, tp = _pyramids(shape, seed)
    scale = float(np.abs(v).max())
    assert [p.shape for p in tp] == [p.shape for p in jp]
    assert max(float(np.abs(a - b).max()) for a, b in zip(jp, tp)) \
        <= REL_BOUND * scale
    rj = np.asarray(jax.jit(lambda *p: jt.recompose(jh, list(p)))(*jp))
    rt = tt.recompose(th, pyramid_from_numpy(th, jp, "cpu")).numpy()
    assert np.abs(rj - rt).max() <= REL_BOUND * scale
    assert np.abs(rt - v).max() <= REL_BOUND * scale
    return th


@pytest.mark.parametrize("shape", LONG, ids=str)
def test_long_dims_match_jax(shape):
    th = _check_pyramids(shape, seed=1)
    assert not tt._use_matmul(th, th.L)


@pytest.mark.parametrize("shape", SMALL, ids=str)
def test_forced_per_dim_transform_matches_jax(shape, short_matmul):
    th = _check_pyramids(shape, seed=2)
    assert [tt._use_matmul(th, l) for l in range(1, th.L + 1)] \
        == [jt._use_matmul(JHierarchy(shape), l)
            for l in range(1, th.L + 1)]
    assert not tt._use_matmul(th, th.L)


@pytest.mark.parametrize("shape", [(9, 4200), (33, 33, 33)], ids=str)
def test_fallback_correction_matches_jax(shape, short_matmul):
    jh, th = JHierarchy(shape), Hierarchy(shape)
    l = th.L
    det = _field(th.shapes[l], seed=3)
    want = np.asarray(jax.jit(lambda a: jt._correction(jh, a, l))(
        jnp.asarray(det)))
    got = tt._correction(th, torch.from_numpy(det), l).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL_BOUND * np.abs(det).max()


def test_solver_scan_takes_the_per_dim_transform(monkeypatch):
    monkeypatch.setattr(tt, "_SOLVER", "scan")
    th = Hierarchy((17, 17))
    assert not any(tt._use_matmul(th, l) for l in range(1, th.L + 1))
    calls = []
    solve = ttd.mass_solve

    def counted(*args):
        calls.append(args[-1])
        return solve(*args)

    monkeypatch.setattr(tt, "mass_solve", counted)
    v = _field((17, 17))
    p = tt.decompose(th, torch.from_numpy(v))
    assert calls == [0, 1] * th.L
    out = tt.recompose(th, p).numpy()
    assert np.abs(out - v).max() <= REL_BOUND * np.abs(v).max()


@pytest.mark.parametrize("env,solver,max_n", [
    ({}, "matmul", 4096),
    ({"MGARD_TPU_SOLVER": "scan"}, "scan", 4096),
    ({"MGARD_TPU_MATMUL_MAX_N": "64"}, "matmul", 64),
], ids=str)
def test_switches_are_read_at_import(env, solver, max_n):
    base = {k: v for k, v in os.environ.items()
            if k not in ("MGARD_TPU_SOLVER", "MGARD_TPU_MATMUL_MAX_N")}
    out = subprocess.run(
        [sys.executable, "-c", "import mgard_tpu_torch.ops.transform as t;"
         " print(t._SOLVER, t._MATMUL_MAX_N)"], check=True, cwd=ROOT,
        env={**base, **env}, capture_output=True, text=True).stdout.split()
    assert out == [solver, str(max_n)]


# ---------------------------------------------------------------------------
# the divisors
# ---------------------------------------------------------------------------

def _same_levels(th, jh):
    assert th.L == jh.L and th.shapes == jh.shapes
    for d in range(jh.ndim):
        for l in range(jh.L + 1):
            for f in dataclasses.fields(DimLevel):
                a = getattr(th.dims[d][l], f.name)
                b = getattr(jh.dims[d][l], f.name)
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype, (d, l, f.name)
                    assert a.tobytes() == b.tobytes(), (d, l, f.name)
                else:
                    assert a == b, (d, l, f.name)


@pytest.mark.parametrize("shape,coords", [
    ((5,), None), ((4097,), None), (((1 << 20) + 1,), None),
    ((30001,), None), ((9, 6000), None), ((20000,), "random"),
], ids=str)
def test_divisors_bit_for_bit(shape, coords):
    """Uniform 2^k+1 and other lengths, a second dim, and a nonuniform
    grid: every table, the divisors among them, is the JAX hierarchy's
    byte for byte."""
    if coords is not None:
        rng = np.random.default_rng(7)
        coords = [np.sort(rng.uniform(0, 3, s)) for s in shape]
    _same_levels(Hierarchy(shape, coordinates=coords),
                 JHierarchy(shape, coordinates=coords))


@pytest.mark.parametrize("overlap", [1, 2], ids=str)
def test_divisor_walks(overlap, monkeypatch):
    """With an overlap too short for the chunks' runs to meet the exact
    ones, the walks repair every chunk."""
    monkeypatch.setattr(th_mod, "_DIV_OVERLAP", overlap)
    rng = np.random.default_rng(overlap)
    x = np.sort(rng.uniform(0, 1, 12345))
    jh = JHierarchy((12345,), coordinates=[x])
    assert jh.dims[0][-1].divisors.tobytes() == th_mod._thomas_divisors(
        *_diag_off(jh.dims[0][-1].h)).tobytes()
    _same_levels(Hierarchy((30001,)), JHierarchy((30001,)))


def _diag_off(h):
    n = len(h) + 1
    diag = np.empty(n)
    diag[0], diag[-1] = h[0] / 3, h[-1] / 3
    diag[1:-1] = (h[:-1] + h[1:]) / 3
    return diag, h / 6


# ---------------------------------------------------------------------------
# the solve: the plain version
# ---------------------------------------------------------------------------

def _replica(b, offdiag, divisors):
    """The JAX scan's operations on axis 0, one rounding each, in numpy
    (float32 scalars stay float32)."""
    dt = b.dtype.type
    off = np.asarray(offdiag).astype(dt)
    div = np.asarray(divisors).astype(dt)
    w = off / div[:-1]
    n = len(b)
    d = [b[0]]
    for i in range(1, n):
        d.append(b[i] - w[i - 1] * d[-1])
    x = [None] * n
    x[n - 1] = d[n - 1] / div[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = (d[i] - off[i] * x[i + 1]) / div[i]
    return np.stack(x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform",
                                                        "nonuniform"])
def test_mass_solve_plain_matches_jax(dtype, uniform):
    shape = (9, 17, 6)
    rng = np.random.default_rng(int(uniform))
    coords = None if uniform else [np.sort(rng.uniform(0, 1, s))
                                   for s in shape]
    jh = JHierarchy(shape, coordinates=coords)
    eps = float(np.finfo(dtype).eps)
    for axis in range(3):
        lev = jh.dims[axis][jh.L]
        b = rng.standard_normal(shape).astype(dtype)
        got = ttd.mass_solve_plain(torch.from_numpy(b), lev.offdiag,
                                   lev.divisors, axis).numpy()
        rep = np.moveaxis(_replica(np.moveaxis(b, axis, 0), lev.offdiag,
                                   lev.divisors), 0, axis)
        assert got.dtype == dtype and got.tobytes() == rep.tobytes()
        want = np.asarray(jax.jit(lambda u: jtd.mass_solve(
            u, lev.offdiag, lev.divisors, axis))(jnp.asarray(b)))
        assert np.abs(got - want).max() <= 16 * eps * np.abs(want).max()
        # the wrapper takes the plain version for a CPU tensor
        assert ttd.mass_solve(torch.from_numpy(b), lev.offdiag,
                              lev.divisors, axis).numpy().tobytes() \
            == got.tobytes()


@pytest.mark.parametrize("n,blocks", [(280953867, 1), (1 << 29, 1),
                                      ((1 << 29) + 1, 2)], ids=str)
def test_one_domain_fits_one_k2_launch(n, blocks):
    """The default planner cuts a float32 series over 2^29 values into
    slabs, so no domain has more segments than one K2 launch takes."""
    cfg = mt.Config(max_memory_footprint=1 << 62)
    assert api.plan_blocks((n,), np.float32, cfg, "cpu") == blocks
    longest = int(np.diff(api._block_edges(n, blocks)).max())
    levels = dyadic_num_levels(longest)
    levels += (1 << levels) + 1 != longest
    assert levels + 1 <= bk.SEGMENT_CAPACITY


# ---------------------------------------------------------------------------
# device memory of the per-dim form
# ---------------------------------------------------------------------------

def _pad(x, before, after, axis):
    """The zero pads the transform summed before its in-place form."""
    parts = []
    for k in (before, after):
        shp = list(x.shape)
        shp[axis] = k
        parts.append(x.new_zeros(shp))
    return torch.cat([parts[0], x, parts[1]], dim=axis)


def _old_mass_apply(v, h, axis):
    n = v.shape[axis]
    hb = ttd.along_axis(h, v, axis)
    lo, hi = v.narrow(axis, 0, n - 1), v.narrow(axis, 1, n - 1)
    third, sixth = hb / 3, hb / 6
    return _pad(third * lo + sixth * hi, 0, 1, axis) \
        + _pad(sixth * lo + third * hi, 1, 0, axis)


def _old_restrict(v, lev, axis):
    nc = len(lev.coarse_pos)
    old = v.index_select(axis, torch.as_tensor(lev.coarse_pos))
    fc = nc if lev.coarse_is_stride2 else lev.front_nc
    new = tt._slice_axis(v, 1, 2 * fc - 1, 2, axis)
    rj = ttd.along_axis(lev.new_ratio, v, axis)
    return old + _pad((1 - rj) * new, 0, nc - fc + 1, axis) \
        + _pad(rj * new, 1, nc - fc, axis)


def _levels():
    """Stride-2 and front-interleaved levels, uniform and not."""
    out = []
    for n, coords in ((33, None), (40, None), (40, "random"), (4100, None)):
        c = None if coords is None else [np.sort(np.concatenate(
            [[0.0, 1.0], np.random.default_rng(n).uniform(size=n - 2)]))]
        h = Hierarchy((n,), coordinates=c)
        out += [h.dims[0][h.L], h.dims[0][h.L - 1]]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_in_place_operators_bit_for_bit(axis, dtype):
    """``mass_apply`` and ``restrict`` in one output are the padded sums
    bit for bit (-0 and the end nodes too), and the sliced
    ``extract_old`` is the ``coarse_pos`` gather."""
    view = torch.int32 if dtype == torch.float32 else torch.int64
    levels = _levels()
    assert any(lv.coarse_is_stride2 for lv in levels)
    assert any(lv.front_nc is not None for lv in levels)
    assert any(not np.allclose(np.diff(lv.h), 0) for lv in levels)
    for lev in levels:
        shape = [3, 4, 5]
        shape[axis] = lev.n
        v = torch.from_numpy(np.random.default_rng(lev.n).standard_normal(
            shape)).to(dtype)
        v.select(axis, 0).fill_(-0.0)
        v.select(axis, lev.n - 1)[0] = -0.0
        for got, want in (
                (ttd.mass_apply(v, lev.h, axis),
                 _old_mass_apply(v, lev.h, axis)),
                (tt.restrict(v, lev, axis), _old_restrict(v, lev, axis)),
                (tt.extract_old(v, lev, axis),
                 v.index_select(axis, torch.as_tensor(lev.coarse_pos)))):
            assert got.shape == want.shape
            assert torch.equal(got.contiguous().view(view),
                               want.contiguous().view(view))


def test_per_dim_tables_leave_the_card(monkeypatch):
    """With a card faked (the CPU takes the card's table path, a copy
    standing in for each upload), each encode and decode of a long-dim
    array copies its tables in table scopes, one per level, and leaves
    none after it; outside a scope a table is copied for each use."""
    monkeypatch.setattr(ttd, "_on_card", lambda device: True)
    monkeypatch.setattr(ttd, "_upload", lambda host, device: host.clone())
    made = []
    kept = ttd._kept
    monkeypatch.setattr(ttd, "_kept", lambda arr, key, build: made.append(
        len(ttd._SCOPES)) or kept(arr, key, build))
    comp = mt.get_compressor((5000,), np.float32, device="cpu")
    v = _field((5000,))
    out = comp.encode_device(torch.from_numpy(v), 1e-3)
    assert made and min(made) == 2          # call scope + level scope
    assert not ttd._SCOPES
    n = len(made)
    comp.sections_from_outputs(*out)
    buf = comp.compress(v, 1e-3)
    assert np.abs(mt.decompress(buf, device="cpu") - v).max() <= 1e-3
    assert len(made) > n and not ttd._SCOPES
    lev = comp.hier.dims[0][comp.hier.L]
    t = ttd.cached_tensor(lev.h, torch.float32, "cpu")
    again = ttd.cached_tensor(lev.h, torch.float32, "cpu")
    assert again is not t and torch.equal(again, t)
    with ttd.table_scope():
        t = ttd.cached_tensor(lev.h, torch.float32, "cpu")
        with ttd.table_scope():
            u = ttd.cached_tensor(lev.new_ratio, torch.float32, "cpu")
            assert ttd.cached_tensor(lev.new_ratio, torch.float32,
                                     "cpu") is u
            assert ttd.cached_tensor(lev.h, torch.float32, "cpu") is t
        # the table and its host array, in the scope that made it
        assert len(ttd._SCOPES) == 1 and len(ttd._SCOPES[0]) == 2
    assert not ttd._SCOPES and ttd.locked_bytes() == 0
    mt.release_cache()


def test_planner_counts_the_per_dim_peak():
    """A long-dim shape is planned at the port's measured peak, over the
    JAX estimate: a cap between the two splits it where the JAX package
    would not."""
    shape = (1 << 26,)
    cap = (mgard_tpu.estimate_memory_footprint(shape, np.float32)
           + api.estimate_memory_footprint(shape, np.float32)) // 2
    assert api.footprint_per_byte(shape) \
        == 1.15 * api.PEAK_PER_BYTE["per_dim"]
    cfg = mt.Config(max_memory_footprint=cap)
    assert api.plan_blocks(shape, np.float32, cfg, "cpu") == 2
    assert mgard_tpu.api.plan_blocks(shape, np.float32, mgard_tpu.Config(
        max_memory_footprint=cap)) == 1
    assert api.footprint_per_byte((4096, 4096)) == api.FOOTPRINT_PER_BYTE


@pytest.mark.parametrize("config, shape, key", [
    (dict(decomposition=mt.Decomposition.SINGLEDIM), (512,) * 3,
     "singledim"),
    (dict(decomposition=mt.Decomposition.SINGLEDIM), (1 << 20,), "per_dim"),
    (dict(decomposition=mt.Decomposition.HYBRID, num_local_levels=2),
     (512,) * 3, "hybrid"),
    (dict(layout=mt.Layout.PYRAMID), (512,) * 3, "pyramid"),
    (dict(layout=mt.Layout.FINE), (512,) * 3, "fine"),
    (dict(layout=mt.Layout.LEVEL_BLOCKS), (512,) * 3, "level_blocks"),
    (dict(layout=mt.Layout.FINE), (8, 8192), "per_dim"),
], ids=str)
def test_planner_factor_per_configuration(config, shape, key):
    """Each flat stream is planned at its own measured peak, a long dim
    at the per-dim one where that is higher, float64 at the wide codec's
    where that is."""
    cfg = mt.Config(**config)
    assert api.footprint_per_byte(shape, np.float32, cfg) \
        == 1.15 * api.PEAK_PER_BYTE[key]
    wide = max(api.PEAK_PER_BYTE[key], api.PEAK_PER_BYTE["wide"])
    assert api.footprint_per_byte(shape, np.float64, cfg) == 1.15 * wide

"""mgard_tpu_torch's mass-matrix operators (``ops/tridiag.py``), the
per-dimension restriction (``ops/transform.py``) and the norms
(``ops/norms.py``) against mgard_tpu on the CPU, in float64.  The port
computes the same operations in another order in places (its solve is a
loop, its sums are torch's), so each result is held to 1e-12 relative
to the JAX one, on uniform and nonuniform grids, with a flat dim, and on
every branch of ``restrict`` (stride 2, front-interleaved, general).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import norms as jn, transform as jt, tridiag as jtd

from mgard_tpu_torch.hierarchy import Hierarchy as THierarchy
from mgard_tpu_torch.ops import norms as tn, transform as tt, tridiag as ttd

ROOT = Path(__file__).resolve().parent.parent
REL = 1e-12


def _coords(shape, seed):
    rng = np.random.default_rng(seed)
    out = []
    for s in shape:
        if s == 1:
            out.append(np.zeros(1))
            continue
        c = np.sort(rng.uniform(size=s))
        c[0], c[-1] = 0.0, 1.0
        out.append(c)
    return out


def _hiers(shape, uniform, seed=0, placement="tpu"):
    coords = None if uniform else _coords(shape, seed)
    return (JHierarchy(shape, coordinates=coords, placement=placement),
            THierarchy(shape, coordinates=coords, placement=placement))


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float64
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got.numpy() - want).max()) <= REL * scale


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform",
                                                        "nonuniform"])
@pytest.mark.parametrize("axis", [0, 1, 2], ids=str)
def test_mass_apply_and_solve(uniform, axis):
    shape = (9, 17, 6)
    jh, th = _hiers(shape, uniform, seed=axis)
    v = np.random.default_rng(axis).standard_normal(shape)
    lev = jh.dims[axis][jh.L]
    tlev = th.dims[axis][th.L]
    _close(ttd.mass_apply(torch.from_numpy(v), tlev.h, axis),
           jtd.mass_apply(jnp.asarray(v), lev.h, axis))
    x = ttd.mass_solve(torch.from_numpy(v), tlev.offdiag, tlev.divisors,
                       axis)
    _close(x, jtd.mass_solve(jnp.asarray(v), lev.offdiag, lev.divisors,
                             axis))
    # the solve inverts the apply
    _close(ttd.mass_apply(x, tlev.h, axis), v)


@pytest.mark.parametrize("shape,placement,branch", [
    ((17, 9), "tpu", "stride2"),
    ((20, 9), "tpu", "front"),
    ((20, 9), "reference", "general"),
    ((11, 7, 30), "reference", "general"),
], ids=str)
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform",
                                                        "nonuniform"])
def test_restrict_matches_jax(shape, placement, branch, uniform):
    jh, th = _hiers(shape, uniform, seed=len(shape), placement=placement)
    l = jh.L
    lev = th.dims[0][l]
    kind = "stride2" if lev.coarse_is_stride2 else \
        "front" if lev.front_nc is not None else "general"
    assert kind == branch
    v = np.random.default_rng(1).standard_normal(shape)
    for axis in range(len(shape)):
        _close(tt.restrict(torch.from_numpy(v), th.dims[axis][l], axis),
               jt.restrict(jnp.asarray(v), jh.dims[axis][l], axis))
    # level 0 has no parents: restrict is the identity
    v0 = np.random.default_rng(2).standard_normal(th.shapes[0])
    assert torch.equal(tt.restrict(torch.from_numpy(v0), th.dims[0][0], 0),
                       torch.from_numpy(v0))


@pytest.mark.parametrize("shape", [(17, 1, 33), (9, 20, 12), (30,)],
                         ids=str)
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform",
                                                        "nonuniform"])
def test_norms_match_jax(shape, uniform):
    jh, th = _hiers(shape, uniform, seed=3)
    u = np.random.default_rng(4).standard_normal(shape)
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    comps_j = jax.jit(lambda x: jn.orthogonal_component_square_norms(
        jh, x))(ju)
    comps_t = tn.orthogonal_component_square_norms(th, tu)
    assert len(comps_t) == len(comps_j) == th.L + 1
    top = max(float(c) for c in comps_j)
    for cj, ct in zip(comps_j, comps_t):
        assert abs(float(ct) - float(cj)) <= REL * top
    for s in (np.inf, 0.0, 1.0, -1.0, 0.5):
        nj = float(jax.jit(lambda x: jn.norm(jh, x, s))(ju))
        nt = float(tn.norm(th, tu, s))
        assert abs(nt - nj) <= REL * abs(nj), s
    assert float(tn.l2_norm(th, tu)) == pytest.approx(
        float(tn.s_norm(th, tu, 0.0)), rel=1e-10)
    assert float(tn.linf_norm(tu)) == float(np.abs(u).max())


def test_tridiag_rejects_one_node():
    with pytest.raises(ValueError, match="2 nodes"):
        ttd.mass_apply(torch.zeros(1, 3), np.zeros(0), 0)
    with pytest.raises(ValueError, match="2 nodes"):
        ttd.mass_solve(torch.zeros(1, 3), np.zeros(0), np.ones(1), 0)


def test_new_modules_import_no_jax():
    code = ("import sys, mgard_tpu_torch.ops.norms, "
            "mgard_tpu_torch.ops.tridiag; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mgard_tpu' "
            "or m.startswith('mgard_tpu.') or m == 'zstandard']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)

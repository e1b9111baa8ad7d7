"""mgard_tpu_torch on long dims (over 4096 nodes) end to end against
mgard_tpu, on the CPU: each package decodes the other's containers
within the bound they record (max|v - out| for s = inf, ||v - out||_0 by
the JAX norms for s = 0), ABS and REL, with the same container sizes
and header fields, at (5000,), (9, 4200) and (5, 9, 4100), and with
``_MATMUL_MAX_N`` patched to 16 in both packages at (33, 33, 33) and
(17, 2, 17).  The transform, the solve and the divisors are held in
``test_torch_longdims.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mgard_tpu
from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import norms as jn

import mgard_tpu_torch as mt
from mgard_tpu_torch.io import format as tfmt

from test_torch_longdims import _field, short_matmul  # noqa: F401


def _jax_norm(shape, s):
    jh = JHierarchy(shape)
    return jax.jit(lambda u: jn.norm(jh, u, s))


def _cross_check(shape, s, mode, tol=1e-3):
    v = _field(shape, seed=4)
    bj = mgard_tpu.compress(v, tol, s=s, mode=mode)
    bt = mt.compress(v, tol, s=s, mode=mode, device="cpu")
    assert len(bt) == len(bj)
    hj, _ = tfmt.read_container(bj)
    ht, _ = tfmt.read_container(bt)
    assert (ht.shape, ht.lossless, ht.layout, ht.chunk_groups, ht.n_levels,
            ht.dtype, ht.s, ht.error_mode) == (
                hj.shape, hj.lossless, hj.layout, hj.chunk_groups,
                hj.n_levels, hj.dtype, hj.s, hj.error_mode)
    assert ht.norm == pytest.approx(hj.norm, rel=1e-12)
    assert ht.tolerance == pytest.approx(hj.tolerance, rel=1e-12)
    norm = None if np.isinf(s) else _jax_norm(shape, s)
    for buf, bound in ((bj, hj.tolerance), (bt, ht.tolerance)):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            assert out.shape == v.shape and out.dtype == np.float32
            diff = out.astype(np.float64) - v.astype(np.float64)
            err = float(np.abs(diff).max()) if norm is None \
                else float(norm(jnp.asarray(diff)))
            assert err <= bound


@pytest.mark.parametrize("shape,s,mode", [
    ((5000,), np.inf, "abs"), ((5000,), 0.0, "rel"),
    ((9, 4200), 0.0, "abs"), ((9, 4200), np.inf, "rel"),
    ((5, 9, 4100), np.inf, "abs"), ((5, 9, 4100), 0.0, "rel"),
], ids=str)
def test_long_dims_cross_decode(shape, s, mode):
    _cross_check(shape, s, mode)


@pytest.mark.parametrize("shape,s,mode", [
    ((33, 33, 33), np.inf, "abs"), ((33, 33, 33), 0.0, "rel"),
    ((17, 2, 17), 0.0, "abs"), ((17, 2, 17), np.inf, "rel"),
], ids=str)
def test_forced_per_dim_cross_decode(shape, s, mode, short_matmul):
    _cross_check(shape, s, mode)

"""The FINE and LEVEL_BLOCKS layouts and the SINGLEDIM and HYBRID
decompositions of mgard_tpu_torch end to end against mgard_tpu, on the
CPU: each package decodes the other's containers within the bound, in
both directions, with equal container sizes and header fields (L-infinity
errors as max|v - out|, s-norm errors by the JAX package's norms).
Containers are compared by cross-decoding, not by bytes: the float32
sums of the transform and of HYBRID's block products run in another
order, which can move a coefficient across a quantization bin edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import mgard_tpu
from mgard_tpu.config import (Config as JConfig,
                              Decomposition as JDecomposition,
                              Layout as JLayout)

import mgard_tpu_torch as mt
from mgard_tpu_torch.io import format as tfmt

from test_torch_e2e import _field
from test_torch_snorm_e2e import _jax_norm

SHAPE = (17, 9, 33)
TOL = 1e-3
# (decomposition, layout, num_local_levels)
CONFIGS = {"FINE": (0, 0, 1), "LEVEL_BLOCKS": (0, 1, 1),
           "SINGLEDIM": (1, 3, 1), "HYBRID1": (2, 3, 1),
           "HYBRID2": (2, 3, 2)}
# (mode, s, dtype)
CASES = [("abs", np.inf, np.float32), ("rel", np.inf, np.float32),
         ("abs", 0.0, np.float32), ("abs", np.inf, np.float64)]


def _configs(name, **kw):
    dec, layout, k = CONFIGS[name]
    return (JConfig(decomposition=JDecomposition(dec), layout=JLayout(layout),
                    num_local_levels=k, **kw),
            mt.Config(decomposition=mt.Decomposition(dec),
                      layout=mt.Layout(layout), num_local_levels=k, **kw))


def _error(out, v, s):
    if np.isinf(s):
        return float(np.abs(out.astype(np.float64) - v).max())
    return float(_jax_norm(v.shape, s)(jnp.asarray(
        out.astype(np.float64) - v.astype(np.float64))))


@pytest.mark.parametrize("mode,s,dtype", CASES, ids=str)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cross_decode(name, mode, s, dtype):
    v = _field(SHAPE, seed=7).astype(dtype)
    jcfg, tcfg = _configs(name)
    bj = mgard_tpu.compress(v, TOL, s=s, mode=mode, config=jcfg)
    bt = mt.compress(v, TOL, s=s, mode=mode, config=tcfg, device="cpu")
    hj, _ = tfmt.read_container(bj)
    ht, _ = tfmt.read_container(bt)
    assert len(bt) == len(bj)
    assert (ht.decomposition, ht.layout, ht.lossless, ht.chunk_groups,
            ht.n_levels, ht.s) == (hj.decomposition, hj.layout, hj.lossless,
                                   hj.chunk_groups, hj.n_levels, hj.s)
    assert ht.tolerance == hj.tolerance and ht.norm == hj.norm
    for buf in (bj, bt):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            assert out.shape == v.shape and out.dtype == dtype
            assert _error(out, v, s) <= ht.tolerance


@pytest.mark.parametrize("name", ["SINGLEDIM", "HYBRID2"])
def test_nonuniform_grid(name):
    """Explicit coordinates: SINGLEDIM's solves and HYBRID's per-block
    operators (``hybrid_operators``) on the actual spacings."""
    rng = np.random.default_rng(11)
    coords = []
    for n in SHAPE:
        c = np.sort(rng.uniform(size=n))
        c[0], c[-1] = 0.0, 1.0
        coords.append(c)
    v = _field(SHAPE, seed=8)
    jcfg, tcfg = _configs(name)
    bj = mgard_tpu.compress(v, TOL, config=jcfg, coordinates=coords)
    bt = mt.compress(v, TOL, config=tcfg, coordinates=coords, device="cpu")
    assert len(bt) == len(bj)
    for buf in (bj, bt):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            assert np.abs(out - v).max() <= TOL


@pytest.mark.parametrize("k", [1, 2])
def test_multiblock_hybrid_wire_byte(k):
    """A multi-block HYBRID container records 1 + its local level count
    in the decomposition byte, as the JAX package writes it, and both
    packages decode it block by block."""
    v = _field((40, 9, 33), seed=9)
    jcfg, tcfg = _configs(f"HYBRID{k}", max_block_bytes=20000)
    bj = mgard_tpu.compress(v, TOL, config=jcfg)
    bt = mt.compress(v, TOL, config=tcfg, device="cpu")
    hj, _ = tfmt.read_container(bj)
    ht, _ = tfmt.read_container(bt)
    assert ht.dd_nblocks == hj.dd_nblocks > 1
    assert ht.decomposition == hj.decomposition == 1 + k
    assert len(bt) == len(bj)
    for buf in (bj, bt):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            assert np.abs(out - v).max() <= TOL

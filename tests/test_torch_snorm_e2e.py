"""mgard_tpu_torch's s-norm error control (finite s) end to end against
mgard_tpu, on the CPU: cross-decodes both ways on each codec that
carries finite s, the errors measured by the JAX package's norms, and
REL mode, whose recorded norm (the root of the sum of squares, summed in
float64) is the JAX one within 1e-12 relative.  Containers are compared
by cross-decoding, not by bytes: the float64 sum that gives the REL norm
runs in another order.
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

from test_torch_e2e import _field
from test_torch_snorm import CODECS, SHAPE, TOL


def _jax_norm(shape, s):
    jh = JHierarchy(shape)
    return jax.jit(lambda u: jn.norm(jh, u, s))


@pytest.mark.parametrize("codec,s", [("segmented", 0.0), ("segmented", 1.0),
                                     ("segmented", -1.0), ("pyramid", 1.0),
                                     ("pergroup", -1.0), ("wide", 0.0)],
                         ids=str)
def test_cross_decode(codec, s):
    dtype, jcfg, tcfg, _ = CODECS[codec]
    v = _field(SHAPE, seed=3).astype(dtype)
    bj = mgard_tpu.compress(v, TOL, s=s, config=jcfg)
    bt = mt.compress(v, TOL, s=s, config=tcfg, device="cpu")
    hj, _ = tfmt.read_container(bj)
    ht, _ = tfmt.read_container(bt)
    assert (ht.lossless, ht.layout, ht.s, ht.tolerance, ht.norm) == (
        hj.lossless, hj.layout, hj.s, hj.tolerance, hj.norm)
    norm = _jax_norm(SHAPE, s)
    for buf in (bj, bt):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            assert out.shape == v.shape and out.dtype == dtype
            err = float(norm(jnp.asarray(out.astype(np.float64)
                                         - v.astype(np.float64))))
            assert err <= TOL


@pytest.mark.parametrize("codec", ["segmented", "wide"])
def test_rel_mode(codec):
    """REL with finite s scales the tolerance by sqrt(sum v^2), summed in
    float64 and cast to the data's dtype; both packages record it."""
    dtype, jcfg, tcfg, _ = CODECS[codec]
    v = _field(SHAPE, seed=4).astype(dtype)
    s = 0.0
    bj = mgard_tpu.compress(v, 1e-4, s=s, mode="rel", config=jcfg)
    bt = mt.compress(v, 1e-4, s=s, mode="rel", config=tcfg, device="cpu")
    hj, _ = tfmt.read_container(bj)
    ht, _ = tfmt.read_container(bt)
    rms = float(np.sqrt(np.sum(v.astype(np.float64) ** 2)).astype(dtype))
    assert ht.norm == pytest.approx(hj.norm, rel=1e-12)
    assert ht.norm == pytest.approx(rms, rel=1e-12)
    assert ht.norm > float(np.abs(v).max())
    assert ht.tolerance == pytest.approx(1e-4 * ht.norm, rel=1e-15)
    norm = _jax_norm(SHAPE, s)
    for buf, bound in ((bj, hj.tolerance), (bt, ht.tolerance)):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            err = float(norm(jnp.asarray(out.astype(np.float64)
                                         - v.astype(np.float64))))
            assert err <= bound

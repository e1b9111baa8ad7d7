"""mgard_tpu_torch's MGARD-QOI against mgard_tpu's, on the CPU.

The component square norms of a functional's Riesz representative agree
with the JAX package's within rtol 1e-10 in float64, for a callable
(its load vector by ``torch.autograd`` here, ``jax.grad`` there) and for
a weight array; ``compress_qoi`` containers cross both ways and hold
``|Q(u) - Q(u')| <= tol``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgard_tpu
from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.models import qoi as jqoi

import mgard_tpu_torch as mt
from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.models import qoi

from test_torch_flat_e2e import _field

RTOL = 1e-10


def _box(shape):
    return tuple(slice(n // 4, n // 4 + max(n // 3, 1)) for n in shape)


@pytest.mark.parametrize("shape", [(17, 17), (33, 33, 33), (40, 17),
                                   (9, 9, 9, 9)], ids=str)
def test_component_norms_callable_and_weights(shape):
    box = _box(shape)
    rng = np.random.default_rng(4)
    w = rng.standard_normal(shape)
    cases = ((lambda u: jnp.mean(u[box]), lambda u: u[box].mean()),
             (w, w))
    for jf, tf in cases:
        jq = jqoi.QuantityOfInterest(JHierarchy(shape), jf)
        tq = qoi.QuantityOfInterest(Hierarchy(shape), tf, device="cpu")
        np.testing.assert_allclose(tq.component_square_norms,
                                   jq.component_square_norms, rtol=RTOL)
        for s in (0.0, 1.0, -1.0):
            assert abs(tq.norm(s) - jq.norm(s)) <= RTOL * jq.norm(s)


def test_callable_equals_its_weights_and_shape_checked():
    shape = (9, 9)
    w = np.full(shape, 1.0 / 81)
    h = Hierarchy(shape)
    q1 = qoi.QuantityOfInterest(h, lambda u: (u * torch.from_numpy(w)).sum(),
                                device="cpu")
    q2 = qoi.QuantityOfInterest(h, w, device="cpu")
    np.testing.assert_allclose(q1.component_square_norms,
                               q2.component_square_norms, rtol=RTOL)
    assert q1.norm(1.0) <= q1.norm(0.0) * 1.01
    with pytest.raises(ValueError, match="shape"):
        qoi.QuantityOfInterest(h, np.ones((9, 8)), device="cpu")


@pytest.mark.parametrize("shape", [(17, 17, 17)], ids=str)
def test_compress_qoi_cross_decode(shape):
    v = _field(shape, np.float64, 50)
    box = _box(shape)
    tq = qoi.QuantityOfInterest(Hierarchy(shape), lambda u: u[box].mean(),
                                device="cpu")
    jq = jqoi.QuantityOfInterest(JHierarchy(shape),
                                 lambda u: jnp.mean(u[box]))
    tol = 1e-4
    bt = qoi.compress_qoi(v, tq, tol, s=0.0, device="cpu")
    bj = jqoi.compress_qoi(v, jq, tol, s=0.0)
    q = float(np.mean(v[box]))
    for buf in (bt, bj):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            assert abs(float(np.mean(out[box])) - q) <= tol

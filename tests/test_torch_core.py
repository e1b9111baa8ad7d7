"""mgard_tpu_torch's sign-magnitude transpose cores (K14
``bp_encode_core``, K15 ``bp_decode_core``) against mgard_tpu's Pallas
kernels in interpret mode, on the CPU.  Integer stages, so every
comparison is bit for bit, with the int32 minimum (whose magnitude wraps
to 2^31), the int32 maximum, an all-zero chunk and mixed bit lengths
planted, at chunk counts that are not a multiple of the Pallas tile.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mgard_tpu.ops import pallas_kernels as pk

from mgard_tpu_torch.ops import bp_kernels as bk


def _chunks(nchunks, seed=0):
    """int32 (nchunks, 32, 128): chunk 0 random over the whole range,
    chunk 1 zero, chunk 2 shifted to 12 bits, chunk 3 holding -2^31 and
    2^31 - 1, the rest with a bit length that varies by group."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-2 ** 31, 2 ** 31, size=(nchunks, 32, 128),
                     dtype=np.int64).astype(np.int32)
    q[1] = 0
    q[2] >>= 20
    q[3, 5, 7], q[3, 0, 127], q[3, 31, 0] = -2 ** 31, 2 ** 31 - 1, -1
    shifts = rng.integers(0, 32, size=(nchunks - 4, 1, 128))
    q[4:] = (q[4:].astype(np.int64) >> shifts).astype(np.int32)
    return q


def _u32(t):
    return np.asarray(t).view(np.uint32) if isinstance(t, np.ndarray) \
        else t.numpy().view(np.uint32)


@pytest.mark.parametrize("nchunks", [5, 7], ids=str)
def test_encode_core_matches_pallas(nchunks):
    assert nchunks % pk.BP_CB
    q = _chunks(nchunks)
    with pltpu.force_tpu_interpret_mode():
        jp, js, je = pk.bp_encode_core(jnp.asarray(q))
    planes, sign, e = bk.bp_encode_core(torch.from_numpy(q))
    assert planes.dtype == sign.dtype == e.dtype == torch.int32
    assert _u32(planes).tobytes() == np.asarray(jp).tobytes()
    assert _u32(sign).tobytes() == np.asarray(js).tobytes()
    assert e.tolist() == np.asarray(je).tolist()
    assert e.tolist()[:4] == [31, 0, 12, 32]
    # bit i of plane b of group g is bit b of |q[i, g]|
    m = np.abs(q[3].astype(np.int64)).astype(np.uint64)
    p = _u32(planes)[3].astype(np.uint64)
    for i, g in ((5, 7), (0, 127), (31, 0)):
        want = [(int(m[i, g]) >> b) & 1 for b in range(32)]
        assert [(int(p[b, g]) >> i) & 1 for b in range(32)] == want
    assert _u32(sign)[3, 7] >> 5 & 1 == 1 and _u32(sign)[3, 127] & 1 == 0


@pytest.mark.parametrize("nchunks", [5, 6], ids=str)
def test_decode_core_matches_pallas(nchunks):
    """K15 decodes the JAX kernel's planes to the JAX output, and arbitrary
    plane and sign words (every magnitude, wrapping negations) alike."""
    q = _chunks(nchunks, seed=1)
    with pltpu.force_tpu_interpret_mode():
        jp, js, _ = pk.bp_encode_core(jnp.asarray(q))
        jout = pk.bp_decode_core(jp, js)
    planes = torch.from_numpy(np.asarray(jp).view(np.int32).copy())
    sign = torch.from_numpy(np.asarray(js).view(np.int32).copy())
    out = bk.bp_decode_core(planes, sign)
    assert out.numpy().tobytes() == np.asarray(jout).tobytes() == q.tobytes()

    rng = np.random.default_rng(nchunks)
    words = rng.integers(0, 2 ** 32, size=(nchunks, 32, 128),
                         dtype=np.uint64).astype(np.uint32)
    signs = rng.integers(0, 2 ** 32, size=(nchunks, 128),
                         dtype=np.uint64).astype(np.uint32)
    with pltpu.force_tpu_interpret_mode():
        jout = pk.bp_decode_core(jnp.asarray(words), jnp.asarray(signs))
    out = bk.bp_decode_core(torch.from_numpy(words.view(np.int32)),
                            torch.from_numpy(signs.view(np.int32)))
    assert out.numpy().tobytes() == np.asarray(jout).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2], ids=str)
def test_decode_core_inverts_encode_core(seed):
    q = torch.from_numpy(_chunks(9, seed=seed))
    planes, sign, e = bk.bp_encode_core(q)
    assert torch.equal(bk.bp_decode_core(planes, sign), q)
    # every plane at or above e is zero
    b = torch.arange(32)[None, :, None]
    assert not planes.masked_select(b >= e[:, None, None]).any()


def test_core_shapes_checked():
    with pytest.raises(ValueError, match="int32"):
        bk.bp_encode_core(torch.zeros((2, 32, 128), dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        bk.bp_encode_core(torch.zeros((2, 32, 4096), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        bk.bp_decode_core(torch.zeros((2, 32, 128), dtype=torch.int32),
                          torch.zeros((3, 128), dtype=torch.int32))
    planes, sign, e = bk.bp_encode_core(torch.zeros((0, 32, 128),
                                                    dtype=torch.int32))
    assert planes.shape == (0, 32, 128) and sign.shape == (0, 128)
    assert e.shape == (0,)

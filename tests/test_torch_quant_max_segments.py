"""K2 over a whole pyramid in one launch (``bp_quant_max_segments``)
against the one-segment wrapper and the JAX package, on the CPU.

The batched wrapper's plain version is the concatenation of the
one-segment plain results, so on the CPU it is held bit for bit against
``bp_quant_max`` segment by segment and against the Pallas
``bp_quant_max`` run in interpret mode (as ``tests/test_torch_codec.py``
runs the Pallas codec).  Where a chunk holds a non-finite or overflowing
value its status must agree everywhere; its maximum is not defined by
the Pallas kernel (which folds XLA's saturated words in) and is compared
only where the status is 0.  ``encode_segments`` calls the batched
wrapper once and writes the JAX package's stream.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mgard_tpu.ops import pallas_kernels as jpk

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.ops import bitplane as tb
from mgard_tpu_torch.ops import bp_kernels as bk

from test_torch_codec import _assert_same_stream, _jax_encode, _port_encode

C = 128
INV_Q = float(np.float32(3.7))


def _pyramid_segments(shape=(33, 33, 17), seed=5):
    """Segments of the sizes of a small pyramid: ragged last chunks, and
    CHUNK_TILE padding chunks past every segment's values."""
    rng = np.random.default_rng(seed)
    sizes = [int(np.prod(s)) for s in Hierarchy(shape).shapes]
    return [(rng.standard_normal(n) * rng.choice([0.0, 1.0, 50.0, 4e3],
                                                 size=n)).astype(np.float32)
            for n in sizes]


def _ncs(segs, C=C):
    return [tb.num_chunks_tiled(s.size, C) for s in segs]


def _pallas_k2(seg, nc, C=C, inv_q=INV_Q):
    xc = np.zeros(nc * 32 * C, np.float32)
    xc[:seg.size] = seg
    with pltpu.force_tpu_interpret_mode():
        zmax, status = jpk.bp_quant_max(jnp.asarray(xc.reshape(nc, 32, C)),
                                        inv_q)
    return (np.asarray(zmax).view(np.int32), np.asarray(status))


def _batched(segs, C=C, inv_q=INV_Q):
    return bk.bp_quant_max_segments([torch.from_numpy(s) for s in segs],
                                    _ncs(segs, C), C, inv_q)


def _per_segment(segs, C=C, inv_q=INV_Q):
    outs = [bk.bp_quant_max(torch.from_numpy(s), nc, C, inv_q)
            for s, nc in zip(segs, _ncs(segs, C))]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def test_pyramid_segments_match_per_segment_and_pallas():
    segs = _pyramid_segments()
    ncs = _ncs(segs)
    assert any(s.size % (32 * C) for s in segs)        # ragged tails
    assert any(nc * 32 * C - s.size >= 32 * C           # padding chunks
               for s, nc in zip(segs, ncs))
    zmax, status = _batched(segs)
    assert zmax.dtype == status.dtype == torch.int32
    assert zmax.shape == status.shape == (sum(ncs),)
    want = _per_segment(segs)
    assert torch.equal(zmax, want[0]) and torch.equal(status, want[1])
    pallas = [_pallas_k2(s, nc) for s, nc in zip(segs, ncs)]
    assert zmax.numpy().tobytes() == np.concatenate(
        [p[0] for p in pallas]).tobytes()
    assert not status.any()
    # padding chunks past a segment's values give 0 and 0
    starts = np.cumsum([0] + ncs)
    for s, a in zip(segs, starts):
        full = -(-s.size // (32 * C))
        assert not zmax[a + full:a + _ncs([s])[0]].any()


def test_planted_nan_and_overflow_land_on_their_chunks():
    segs = _pyramid_segments(seed=6)
    big = int(np.argmax([s.size for s in segs]))
    other = big - 1
    segs[big] = segs[big].copy()
    segs[other] = segs[other].copy()
    segs[big][32 * C + 7] = np.nan                       # chunk 1
    segs[other][3] = np.float32(2.0 ** 32 / INV_Q)       # chunk 0
    ncs = _ncs(segs)
    starts = np.cumsum([0] + ncs)
    zmax, status = _batched(segs)
    want = _per_segment(segs)
    assert torch.equal(zmax, want[0]) and torch.equal(status, want[1])
    expect = np.zeros(sum(ncs), np.int32)
    expect[starts[big] + 1] = 2
    expect[starts[other]] = 1
    assert status.numpy().tolist() == expect.tolist()
    pallas = [_pallas_k2(s, nc) for s, nc in zip(segs, ncs)]
    pz = np.concatenate([p[0] for p in pallas])
    ps = np.concatenate([p[1] for p in pallas])
    assert ps.tolist() == expect.tolist()
    ok = expect == 0
    assert zmax.numpy()[ok].tobytes() == pz[ok].tobytes()


def test_empty_segment_list():
    zmax, status = bk.bp_quant_max_segments([], [], C, INV_Q)
    assert zmax.shape == status.shape == (0,)
    assert zmax.dtype == status.dtype == torch.int32


def test_more_segments_than_capacity_raise():
    cap = bk.SEGMENT_CAPACITY
    assert cap == 32
    segs = [torch.ones(10)] * (cap + 1)
    with pytest.raises(ValueError, match="at most 32"):
        bk.bp_quant_max_segments(segs, [4] * (cap + 1), C, INV_Q)
    zmax, _ = bk.bp_quant_max_segments(segs[:cap], [4] * cap, C, INV_Q)
    assert zmax.shape == (4 * cap,)


def test_input_checks():
    with pytest.raises(ValueError, match="one chunk count"):
        bk.bp_quant_max_segments([torch.ones(10)], [4, 4], C, INV_Q)
    with pytest.raises(ValueError, match="larger"):
        bk.bp_quant_max_segments([torch.ones(5000)], [1], C, INV_Q)
    with pytest.raises(ValueError, match="float32"):
        bk.bp_quant_max_segments([torch.ones(10, dtype=torch.float64)],
                                 [4], C, INV_Q)


@pytest.mark.parametrize("C", [128, 4096])
def test_encode_segments_calls_it_once_and_matches_jax(C, monkeypatch):
    """``encode_segments`` takes every chunk's maximum and status from one
    ``bp_quant_max_segments`` call and writes the exponents, words, count
    and status of ``mgard_tpu.ops.bitplane.encode_segments``."""
    segs = _pyramid_segments(shape=(33, 33, 33), seed=8)
    calls = []
    real = tb.bp_quant_max_segments

    def spy(*args):
        calls.append(len(args[0]))
        return real(*args)

    monkeypatch.setattr(tb, "bp_quant_max_segments", spy)
    port = _port_encode(segs, INV_Q, C)
    assert calls == [len(segs)]
    _assert_same_stream(port, _jax_encode(segs, INV_Q, C, pallas=False))
    if C == 128:
        _assert_same_stream(port, _jax_encode(segs, INV_Q, C, pallas=True))

"""mgard_tpu_torch's quantizer and segmented bitplane codec (K2-K4) against
mgard_tpu's, on the CPU.

Integer stages are held bit for bit: fed the same float32 segments and
``inv_q``, the port's ``encode_segments`` gives exponents, ``words[:count]``,
``count`` and ``status`` byte-identical to
``mgard_tpu.ops.bitplane.encode_segments`` — both its XLA fallback and its
Pallas kernels in interpret mode — and ``decode_segments`` gives
bit-identical floats.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import bitplane as jb
from mgard_tpu.ops.quantize import supremum_quantum as j_supremum_quantum

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.ops import bitplane as tb
from mgard_tpu_torch.ops import bp_kernels as bk
from mgard_tpu_torch.ops.quantize import (inverse_quantum, round_quantize,
                                          supremum_quantum)


def _segments(sizes, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * rng.choice([0.0, 1.0, 40.0, 3e3], size=s)
             ).astype(np.float32) for s in sizes]


def _jax_encode(segs, inv_q, C, pallas: bool):
    old = os.environ.get("MGARD_TPU_PALLAS_CODEC")
    os.environ["MGARD_TPU_PALLAS_CODEC"] = "1" if pallas else "0"
    try:
        js = [jnp.asarray(s) for s in segs]
        if pallas:
            with pltpu.force_tpu_interpret_mode():
                out = jb.encode_segments(js, inv_q, C=C)
        else:
            out = jb.encode_segments(js, inv_q, C=C)
    finally:
        if old is None:
            del os.environ["MGARD_TPU_PALLAS_CODEC"]
        else:
            os.environ["MGARD_TPU_PALLAS_CODEC"] = old
    e, w, c, st = out
    c = int(c)
    return np.asarray(e), np.asarray(w)[:c], c, int(st)


def _port_encode(segs, inv_q, C):
    e, w, c, st = tb.encode_segments([torch.from_numpy(s) for s in segs],
                                     float(np.float32(inv_q)), C=C)
    c = int(c)
    return e.numpy(), w[:c].numpy().view(np.uint32), c, int(st)


def _assert_same_stream(a, b):
    assert a[2] == b[2]                       # count
    assert a[3] == b[3]                       # status
    assert a[0].dtype == b[0].dtype == np.uint8
    assert a[0].tobytes() == b[0].tobytes()   # exponents
    assert a[1].astype("<u4").tobytes() == b[1].astype("<u4").tobytes()


# ---------------------------------------------------------------------------
# quantum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(512, 512, 512), (65, 65, 65), (33, 65),
                                   (162, 162, 162), (1, 9, 40), (129,)],
                         ids=str)
@pytest.mark.parametrize("tol", [1e-3, 1e-2, 3.3e-5, 0.25])
def test_quantum_bit_equal_to_jax(shape, tol):
    """The float32 quantum and inverse quantum equal the ones the JAX
    compressor traces (compressor.py:309-311 with a float32 tolerance)."""
    jh, th = JHierarchy(shape), Hierarchy(shape)

    @jax.jit
    def jax_q(t):
        q = j_supremum_quantum(jh, t).astype(jnp.float32)
        return q, (1.0 / j_supremum_quantum(jh, t)).astype(jnp.float32)

    jq, jinv = jax_q(np.float32(tol))
    assert np.float32(jq).tobytes() == supremum_quantum(th, tol).tobytes()
    assert np.float32(jinv).tobytes() == inverse_quantum(th, tol).tobytes()


def test_round_quantize_half_away_from_zero():
    x = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.49, -2.5, 0.0, -0.0])
    assert round_quantize(x).tolist() == [1, -1, 2, -2, 2, -3, 0, 0]


# ---------------------------------------------------------------------------
# K2-K4 through encode_segments / decode_segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [128, 4096])
@pytest.mark.parametrize("inv_q", [3.7, 128.0])
def test_encode_segments_matches_jax_xla(C, inv_q):
    sizes = [9 ** 3, 17 ** 3, 130000]
    segs = _segments(sizes)
    _assert_same_stream(_port_encode(segs, inv_q, C),
                        _jax_encode(segs, inv_q, C, pallas=False))


def test_encode_segments_matches_jax_pallas_interpret():
    """The TPU kernels (bp_quant_max + bp_quant_condense) themselves, in
    interpret mode, at C = 128."""
    sizes = [9 ** 3, 17 ** 3]
    segs = _segments(sizes, seed=7)
    _assert_same_stream(_port_encode(segs, 3.7, 128),
                        _jax_encode(segs, 3.7, 128, pallas=True))


def test_rounding_ties_and_extremes_match_jax():
    # exact .5 ties after scaling, signed zeros, values near the int32
    # ceiling that still pass the overflow test
    seg = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.0, -0.0,
                    2.0 ** 31 - 256, -(2.0 ** 31 - 256), 1e-30, -7.25],
                   dtype=np.float32)
    segs = [seg, np.ones(5000, np.float32) * -3.5]
    _assert_same_stream(_port_encode(segs, 1.0, 128),
                        _jax_encode(segs, 1.0, 128, pallas=False))


@pytest.mark.parametrize("C", [128, 4096])
def test_decode_segments_bit_identical_to_jax(C):
    sizes = [9 ** 3, 17 ** 3, 130000]
    segs = _segments(sizes, seed=3)
    inv_q = np.float32(3.7)
    quantum = np.float32(1.0) / inv_q
    e, w, c, _ = _jax_encode(segs, float(inv_q), C, pallas=False)
    wfull = np.zeros(jb.max_words_segments(sizes, C), np.uint32)
    wfull[:c] = w
    want = jb.decode_segments(jnp.asarray(e), jnp.asarray(wfull), sizes,
                              quantum=quantum, C=C)
    got = tb.decode_segments(torch.tensor(e),
                             torch.tensor(w.view(np.int32)), sizes,
                             float(quantum), C=C)
    for a, b in zip(want, got):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    # the port's own round trip is the exact dequantized quantization
    for seg, out in zip(segs, got):
        t = np.trunc(np.abs(seg * inv_q) + np.float32(0.5))
        q = np.where(seg * inv_q < 0, -t, t).astype(np.int32)
        assert out.numpy().tobytes() == (q.astype(np.float32)
                                         * quantum).tobytes()


@pytest.mark.parametrize("bad,code", [(np.inf, 2), (-np.inf, 2),
                                      (np.nan, 2), (3e9, 1), (-2.0 ** 31, 1)],
                         ids=["inf", "-inf", "nan", "over", "-over"])
def test_status_codes_match_jax(bad, code):
    segs = _segments([3000, 9 ** 3], seed=4)
    segs[1] = segs[1].copy()
    segs[1][17] = bad
    port = _port_encode(segs, 1.0, 128)
    jax_ = _jax_encode(segs, 1.0, 128, pallas=False)
    assert port[3] == jax_[3] == code
    # per chunk: only the chunk holding the bad value is flagged
    nc = tb.num_chunks_tiled(segs[1].size, 128)
    zmax, status = bk.bp_quant_max(torch.from_numpy(segs[1]), nc, 128, 1.0)
    assert status.tolist() == [code] + [0] * (nc - 1)


def test_words_layout():
    """Value i*C + g of a chunk is bit i of plane word g (LSB-first
    planes of the zigzag image)."""
    C = 128
    seg = np.zeros(32 * C, np.float32)
    seg[5 * C + 9] = -2.0          # zigzag 3: planes 0 and 1
    seg[31 * C + 0] = 1.0          # zigzag 2: plane 1
    e, w, c, st = _port_encode([seg], 1.0, C)
    assert st == 0 and e[0] == 2 and c == 2 * C
    planes = w.reshape(2, C)
    assert planes[0, 9] == 1 << 5 and planes[1, 9] == 1 << 5
    assert planes[1, 0] == 1 << 31
    assert np.count_nonzero(planes) == 3


def test_plain_butterfly_is_a_transpose():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 2 ** 32, size=(32, 7),
                                      dtype=np.int64))
    y = bk.butterfly(x, 0)
    bits_x = (x[:, None, :] >> torch.arange(32)[None, :, None]) & 1
    bits_y = (y[:, None, :] >> torch.arange(32)[None, :, None]) & 1
    assert torch.equal(bits_y, bits_x.transpose(0, 1))
    assert torch.equal(bk.butterfly(y, 0), x)


def test_wrappers_check_their_inputs():
    seg = torch.zeros(1000)
    with pytest.raises(ValueError, match="larger"):
        bk.bp_quant_max(seg, 1, 16, 1.0)
    with pytest.raises(ValueError, match="float32"):
        bk.bp_quant_max(seg.double(), 1, 128, 1.0)
    with pytest.raises(ValueError, match="one entry per chunk"):
        bk.bp_quant_condense(seg, 1, 128, 1.0, torch.zeros(2, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32),
                             torch.zeros(33 * 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="whole"):
        bk.bp_decode_condense_f32(torch.zeros(100, dtype=torch.int32), 128,
                                  torch.zeros(1, dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32), 1.0, 10)

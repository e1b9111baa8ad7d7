"""The port's two ZFP codecs held against ``mgard_tpu`` on the CPU: the
native fixed-rate codec (``mgard_tpu_torch/models/zfp.py``) writes the
JAX package's stream byte for byte and decodes it bit for bit, and
``models/zfp_stream.py`` (the reference port's stream format) matches the
reference's golden streams and the JAX package's copy.  Inputs are made
from numpy seeds."""

import pathlib

import numpy as np
import pytest

from mgard_tpu.models import zfp as jz
from mgard_tpu.models import zfp_stream as jzs
from mgard_tpu_torch.models import zfp as pz
from mgard_tpu_torch.models import zfp_stream as pzs

DATA = pathlib.Path(__file__).parent / "data"


def _walk(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(size=shape), axis=-1) * 0.1).astype(dtype)


def _same(v, rate):
    """The port's stream is the JAX package's byte for byte, and each
    package's decode of it is the other's bit for bit."""
    theirs = jz.compress_zfp(v, rate)
    ours = pz.compress_zfp(v, rate, device="cpu")
    assert ours == theirs
    a = pz.decompress_zfp(theirs, device="cpu")
    b = jz.decompress_zfp(theirs)
    assert a.shape == v.shape and a.dtype == v.dtype
    assert a.tobytes() == b.tobytes()
    return a


@pytest.mark.parametrize("shape,dtype,rate", [
    ((40,), np.float32, 1), ((40,), np.float64, 32),
    ((17, 9), np.float32, 8), ((17, 9), np.float64, 16),
    ((16, 16), np.float32, 16), ((16, 16), np.float64, 1),
    ((9, 10, 11), np.float32, 8), ((9, 10, 11), np.float64, 16),
    ((8, 8, 8), np.float32, 32), ((5, 6, 7, 9), np.float32, 16),
    ((5, 6, 7, 9), np.float64, 8), ((4, 4, 4, 4), np.float64, 32),
])
def test_native_stream_equal(shape, dtype, rate):
    _same(_walk(shape, dtype, seed=sum(shape) + rate), rate)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_maxima_at_powers_of_two(dtype):
    """Blocks whose maximum is 2^k, 2^k + 1 ulp and 2^k - 1 ulp (where
    the block exponent has to be XLA's log2, not frexp's), and all-zero
    blocks (an infinite scale times 0).  Subnormal maxima are left out:
    XLA's CPU backend flushes them to zero, the port does not."""
    one = dtype(1.0)
    v = np.zeros((8, 8, 12), dtype)
    v[:4, :4, :4] = 1.0
    v[4:, :4, :4] = np.nextafter(dtype(2.0), dtype(3.0))
    v[:4, 4:, :4] = np.nextafter(dtype(0.5), dtype(0.0))
    v[4:, 4:, :4] = dtype(2.0 ** -20)
    v[:4, :4, 4:8] = np.nextafter(one, dtype(0)) * np.linspace(
        -1, 1, 64).reshape(4, 4, 4)
    v[4:, :4, 4:8] = np.finfo(dtype).tiny
    v[:4, 4:, 4:8] = -dtype(2.0 ** 40)
    v[4:, 4:, 4:8] = np.nextafter(dtype(2.0 ** -7), dtype(1.0))
    # v[:, :, 8:] stays zero: all-zero blocks
    _same(v, 8)


def test_all_zero_field():
    v = np.zeros((9, 9, 9), np.float32)
    out = _same(v, 8)
    assert not out.any()


def test_size_is_rate_bits_a_value():
    shape, rate = (64, 64), 8
    v = _walk(shape, np.float32, seed=3)
    buf = pz.compress_zfp(v, rate, device="cpu")
    meta = pz.ZfpMeta(shape, "float32", rate).pack()
    nblocks = (64 // pz.BLOCK) ** 2
    assert len(buf) == len(meta) + nblocks + pz._num_units(shape) \
        + 4 * rate * pz._num_groups(shape)
    assert len(buf) == len(pz.compress_zfp(
        np.random.default_rng(0).normal(size=shape).astype(np.float32),
        rate, device="cpu"))


def test_rejections():
    with pytest.raises(TypeError):
        pz.compress_zfp(np.zeros(8, np.int32), 8, device="cpu")
    with pytest.raises(ValueError, match="rate"):
        pz.compress_zfp(np.zeros(8, np.float32), 33, device="cpu")
    with pytest.raises(ValueError, match="ZFPT"):
        pz.decompress_zfp(b"XXXX" + bytes(20), device="cpu")


# --- zfp_stream: the reference port's stream format --------------------------

def test_stream_1d_f64_golden():
    v = np.load(DATA / "golden_zfp_48_input.npy")
    g = (DATA / "golden_zfp_48_f64_r16.zfps").read_bytes()
    rec = np.fromfile(DATA / "golden_zfp_48_f64_r16.recon", dtype=np.float64)
    assert pzs.zfp_encode(v, 16) == g
    assert np.array_equal(pzs.zfp_decode(g, (48,), np.float64, 16), rec)


def test_stream_2d_f32_golden():
    v = np.load(DATA / "golden_zfp_16sq_input.npy")
    g = (DATA / "golden_zfp_16sq_f32_r12.zfps").read_bytes()
    assert pzs.zfp_encode(v, 12) == g
    assert np.abs(pzs.zfp_decode(g, (16, 16), np.float32, 12) - v
                  ).max() <= 1e-3


def test_stream_3d_f32_golden():
    v = np.load(DATA / "golden_zfp_20cube_input.npy")
    g = (DATA / "golden_zfp_20cube_f32_r8.zfps").read_bytes()
    rec = np.fromfile(DATA / "golden_zfp_20cube_f32_r8.recon",
                      dtype=np.float32)
    assert pzs.zfp_encode(v, 8) == g
    d = pzs.zfp_decode(g, (20, 20, 20), np.float32, 8).reshape(-1)
    st = pzs._strides((20, 20, 20), "reference")
    touched = np.zeros(20 ** 3, bool)
    for origin, extent in pzs._blocks_iter((20, 20, 20)):
        touched[pzs._block_addr(origin, extent, st).reshape(-1)] = True
    assert np.array_equal(d[touched], rec[touched])
    assert np.all(d[~touched] == 0)


@pytest.mark.parametrize("shape,dtype,rate", [
    ((8, 24), np.float32, 16), ((5, 7, 9), np.float64, 20),
    ((30,), np.float32, 12), ((13, 6), np.float64, 7)])
def test_stream_correct_strides_equal(shape, dtype, rate):
    v = _walk(shape, dtype, seed=1)
    buf = pzs.zfp_encode(v, rate, strides="correct")
    assert buf == jzs.zfp_encode(v, rate, strides="correct")
    assert len(buf) == pzs.zfp_stream_bytes(shape, rate)
    d = pzs.zfp_decode(buf, shape, dtype, rate, strides="correct")
    assert d.tobytes() == jzs.zfp_decode(buf, shape, dtype, rate,
                                         strides="correct").tobytes()
    assert np.abs(d - v).max() <= float(np.abs(v).max()) * 2.0 ** (6 - rate)


def test_stream_reference_strides_reject_oob_shape():
    with pytest.raises(NotImplementedError, match="out-of-bounds"):
        pzs.zfp_encode(np.zeros((100, 4, 4), np.float32), 8)
    with pytest.raises(NotImplementedError, match="out-of-bounds"):
        pzs.zfp_decode(bytes(4096), (100, 4, 4), np.float32, 8)

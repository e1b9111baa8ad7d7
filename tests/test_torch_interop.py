"""Reference-MGARD interop of the port (``mgard_tpu_torch/io/mgard_compat.py``
and ``io/protowire.py``) held against ``mgard_tpu`` on the CPU: the CPU
and MGARD-X containers each package writes decode with the other within
the tolerance, the X Huffman blob, the headers and the CPU-format
buffers are byte-identical when both are fed the same int64 stream, and
the reference's own buffers in tests/data decode within the JAX tests'
bounds.  Inputs are made from numpy seeds."""

import math
import pathlib

import numpy as np
import pytest
import torch

import mgard_tpu
import mgard_tpu_torch as mt
from mgard_tpu.io import mgard_compat as jmc
from mgard_tpu.io import protowire as jpw
from mgard_tpu_torch.io import mgard_compat as pmc
from mgard_tpu_torch.io import protowire as ppw

DATA = pathlib.Path(__file__).parent / "data"
# Both packages decode one buffer to within this share of max|v| (the
# same integers, recomposed in float64 for the X format and in float32
# for the CPU format; measured at most 1.9e-7 here)
AGREE = 1e-6
# The X writer's 3-D s = 0 quanta are far below the tolerance: at 33^3
# the RMS of the error is 1.0-1.6e-3 of tol * norm; a quantum or a
# dequantization off by a factor of two gives errors of the field's own
# size
X_S0_RMS = 5e-3


def _field(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = [np.linspace(0.0, 1.0, n) for n in shape]
    f = np.zeros(shape)
    for k in (1, 3):
        term = np.ones(())
        for d, xx in enumerate(x):
            term = term[..., None] * np.cos(np.pi * k * xx + 0.1 * k * (d + 1))
        f += term / k
    return (f + 1e-3 * rng.standard_normal(shape)).astype(dtype)


def _snorm0(v, out):
    """||v - out||_0 by the JAX package's norms, as
    tests/test_mgard_compat.py holds the CPU format."""
    import jax.numpy as jnp
    from mgard_tpu.hierarchy import Hierarchy
    from mgard_tpu.ops import norms
    return float(norms.norm(Hierarchy(v.shape),
                            jnp.asarray(out.astype(np.float64) - v), 0.0))


def _header_bytes(buf, read):
    """The container's magic, preamble and proto header: everything
    before the payload."""
    return buf[:len(buf) - len(read(buf)[1])]


def _rms(v, out):
    return float(np.sqrt(np.mean((out.astype(np.float64) - v) ** 2)))


def _within(v, out, tol, s, x_format, norm=1.0):
    if math.isinf(s):
        return float(np.abs(out.astype(np.float64) - v).max()) <= tol * norm
    if x_format:   # the X tool's s = 0 bounds the RMS of the error
        return _rms(v, out) <= tol * norm
    return _snorm0(v, out) <= tol


# --- protowire and the container ---------------------------------------------

_MSG = {
    "mgard_version": {"major_": 1, "minor_": 6, "patch_": 3},
    "domain": {"topology": 0, "cartesian_grid_topology": {
        "dimension": 3, "shape": [17, 300, 70000]}, "geometry": 1,
        "explicit_cube_geometry": {"coordinates": [0.0, 0.25, -1e300]},
        "explicit_cube_filename": "grid.bin"},
    "dataset": {"type": 1, "dimension": 1},
    "error_control": {"mode": 1, "norm": 1, "s": -0.5, "tolerance": 1e-3,
                      "norm_of_original_data": 3.5},
    "encoding": {"preprocessor": 0, "compressor": 5,
                 "huffman_dictionary_size": 8192,
                 "huffman_block_size": 20480},
}


def test_protowire_bytes_equal():
    a = ppw.encode_message(pmc.SCHEMAS["Header"], pmc.SCHEMAS, _MSG)
    b = jpw.encode_message(jmc.SCHEMAS["Header"], jmc.SCHEMAS, _MSG)
    assert a == b
    assert ppw.decode_message(pmc.SCHEMAS["Header"], pmc.SCHEMAS, a) == \
        jpw.decode_message(jmc.SCHEMAS["Header"], jmc.SCHEMAS, a)
    assert pmc.SCHEMAS == jmc.SCHEMAS


@pytest.mark.parametrize("little_endian", [False, True])
def test_container_round_trip(little_endian):
    payload = bytes(range(256)) * 3
    buf = pmc.write_container(_MSG, payload, little_endian=little_endian)
    assert buf == jmc.write_container(_MSG, payload,
                                      little_endian=little_endian)
    for read in (pmc.read_container, jmc.read_container):
        header, back = read(buf)
        assert back == payload
        assert header["domain"]["cartesian_grid_topology"]["shape"] == \
            [17, 300, 70000]
    bad = bytearray(buf)
    bad[20] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        pmc.read_container(bytes(bad))
    with pytest.raises(ValueError, match="magic"):
        pmc.read_container(b"XGARD" + buf[5:])


# --- writers cross-decoded ---------------------------------------------------

_CPU_CASES = [((17, 17, 17), math.inf), ((17, 17, 17), 0.0),
              ((17, 33), math.inf), ((17, 33), 0.0), ((65,), math.inf),
              ((20, 12), math.inf), ((20, 12), 0.0), ((33, 33, 33), 0.0)]


@pytest.mark.parametrize("zstd", [False, True])
@pytest.mark.parametrize("shape,s", _CPU_CASES)
def test_cpu_format_cross_decode(shape, s, zstd):
    v = _field(shape, seed=len(shape) * 7 + shape[0])
    tol = 1e-3
    ours = pmc.compress_mgard(v, tol, s=s, zstd=zstd, device="cpu")
    theirs = jmc.compress_mgard(v, tol, s=s, zstd=zstd)
    assert _header_bytes(ours, pmc.read_container) == \
        _header_bytes(theirs, jmc.read_container)
    # each distinct buffer, decoded by both packages
    for buf in {ours, theirs}:
        out = mt.decompress(buf, device="cpu")
        ref = jmc.decompress_mgard(buf)
        for x in (out, ref):
            assert x.shape == shape and x.dtype == np.float32
            assert _within(v, x, tol, s, x_format=False)
        # the same integers recomposed in float32 by each package
        assert np.abs(out.astype(np.float64) - ref).max() <= \
            AGREE * np.abs(v).max()


_X_CASES = [((17, 17, 17), math.inf, "abs", False),
            ((17, 33), math.inf, "rel", True),
            ((33, 33, 33), math.inf, "abs", False),
            ((33, 33, 33), math.inf, "abs", True),
            ((33, 33, 33), math.inf, "rel", False),
            ((33, 33), 0.0, "abs", True), ((33, 33), 0.0, "rel", False),
            ((65537,), math.inf, "abs", False),
            ((33, 33, 33), 0.0, "abs", False),
            ((33, 33, 33), 0.0, "rel", True)]


@pytest.mark.parametrize("shape,s,mode,zstd", _X_CASES)
def test_x_format_cross_decode(shape, s, mode, zstd):
    v = _field(shape, seed=len(shape) * 5 + shape[0])
    # the 3-D s = 0 quanta are so fine that a small tolerance stores the
    # subdomain raw
    tol = 4.0 if (s == 0.0 and len(shape) == 3) else 1e-3
    # the 1-D series in chunks of 4096 symbols (20,480 by default): the
    # decodes step through a chunk's symbols one at a time
    kw = dict(s=s, mode=mode, zstd=zstd,
              chunk_size=4096 if len(shape) == 1 else 20480)
    ours = pmc.compress_mgard_x(v, tol, device="cpu", **kw)
    theirs = jmc.compress_mgard_x(v, tol, **kw)
    assert _header_bytes(ours, pmc.read_container) == \
        _header_bytes(theirs, jmc.read_container)
    hp = pmc.read_container(ours)[0]
    norm = hp["error_control"].get("norm_of_original_data", 1.0) \
        if mode == "rel" else 1.0
    # each distinct buffer, decoded by both packages
    for buf in {ours, theirs}:
        out = mt.decompress(buf, device="cpu")
        ref = mgard_tpu.decompress(buf)
        for x in (out, ref):
            assert x.shape == shape and x.dtype == np.float32
            assert _within(v, x, tol, s, x_format=True, norm=norm)
        # the same integers recomposed in float64 by each package
        assert np.abs(out.astype(np.float64) - ref).max() <= \
            AGREE * np.abs(v).max()
        if s == 0.0 and len(shape) == 3:
            assert _rms(v, out) <= X_S0_RMS * tol * norm


def test_x_format_compresses_where_expected():
    """The cross-decodes above are not all raw fallbacks: 33^3 and the
    1-D series are Huffman-coded."""
    for shape, tol, s in (((33, 33, 33), 1e-3, math.inf),
                          ((65537,), 1e-4, math.inf),
                          ((33, 33, 33), 4.0, 0.0)):
        v = _field(shape, seed=1)
        buf = pmc.compress_mgard_x(v, tol, s=s, zstd=False, device="cpu")
        assert len(buf) < v.nbytes


def test_float64_and_outliers():
    """f64 plus a spike that quantizes far outside the dictionary (the
    outlier channel), both ways."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((65, 33)) * 1e-3
    v[7, 11] = 50.0
    ours = pmc.compress_mgard_x(v, 1e-4, zstd=True, device="cpu")
    theirs = jmc.compress_mgard_x(v, 1e-4, zstd=True)
    assert pmc.read_container(ours)[0] == jmc.read_container(theirs)[0]
    for out in (mgard_tpu.decompress(ours),
                mt.decompress(theirs, device="cpu")):
        assert out.dtype == np.float64
        assert np.abs(out - v).max() <= 1e-4


def test_raw_fallback():
    """Incompressible data: both writers store the raw subdomain, and both
    readers return it exactly."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal((33, 33)).astype(np.float32)
    ours = pmc.compress_mgard_x(v, 1e-7, zstd=False, device="cpu")
    assert ours == jmc.compress_mgard_x(v, 1e-7, zstd=False)
    assert np.array_equal(mt.decompress(ours, device="cpu"), v)
    assert np.array_equal(mgard_tpu.decompress(ours), v)


# --- the integer stages bit for bit ------------------------------------------

def _stream(n, seed, spread=300, outlier_every=997):
    rng = np.random.default_rng(seed)
    q = np.round(rng.standard_normal(n) * spread).astype(np.int64)
    q[::outlier_every] = 10 ** 6
    q[5::outlier_every] = -(10 ** 7)
    return q


@pytest.mark.parametrize("n,chunk", [(1, 20480), (5000, 20480),
                                     (50000, 20480), (7001, 1000)])
def test_x_huffman_blob_bytes_equal(n, chunk):
    q = _stream(n, seed=n)
    blob = pmc._encode_x_huffman(torch.from_numpy(q), chunk_size=chunk)
    assert blob == jmc._encode_x_huffman(q, chunk_size=chunk)
    assert np.array_equal(pmc._decode_x_huffman(blob, "cpu").numpy(), q)
    assert np.array_equal(jmc._decode_x_huffman(blob), q)


def test_codebook_with_unused_lengths():
    """Frequencies (8, 1, 1, 1, 1) give lengths 1, 3, 3, 3, 3: length 2
    is unused, first[2] = 2^64 - 1.  The codebooks are equal, and the
    decode's table and its prefix compares (forced by a 1-bit table)
    both keep the unsigned order."""
    freq = np.zeros(8192, np.int64)
    freq[[10, 20, 30, 40, 50]] = [8, 1, 1, 1, 1]
    lengths = pmc._huffman_code_lengths(freq)
    assert np.array_equal(lengths, jmc._huffman_code_lengths(freq))
    assert sorted(lengths[lengths > 0]) == [1, 3, 3, 3, 3]
    for a, b in zip(pmc._x_codebook(lengths), jmc._x_codebook(lengths)):
        assert np.array_equal(a, b)
    first = pmc._x_codebook(lengths)[0]
    assert first[2] == np.iinfo(np.uint64).max
    rng = np.random.default_rng(2)
    q = rng.choice(np.array([10, 20, 30, 40, 50]) - 4096, size=3000,
                   p=np.array([8, 1, 1, 1, 1]) / 12)
    blob = jmc._encode_x_huffman(q)
    assert pmc._encode_x_huffman(torch.from_numpy(q)) == blob
    assert np.array_equal(pmc._decode_x_huffman(blob, "cpu").numpy(), q)


@pytest.mark.parametrize("table_bits", [1, 4, 20])
def test_x_decode_long_codes(table_bits, monkeypatch):
    """Fibonacci frequencies give codes of up to 18 bits; with a narrower
    root table they decode through the prefix compares, bit for bit."""
    fib = [1, 1]
    while len(fib) < 20:
        fib.append(fib[-1] + fib[-2])
    q = np.repeat(np.arange(20) - 4090, fib).astype(np.int64)
    np.random.default_rng(4).shuffle(q)
    blob = jmc._encode_x_huffman(q, chunk_size=4096)
    assert pmc._encode_x_huffman(torch.from_numpy(q), chunk_size=4096) == blob
    monkeypatch.setattr(pmc, "_X_TABLE_BITS", table_bits)
    assert np.array_equal(pmc._decode_x_huffman(blob, "cpu").numpy(), q)


def test_corrupt_stream_bit_count():
    q = _stream(3000, seed=9)
    blob = bytearray(jmc._encode_x_huffman(q))
    # the first chunk's recorded bit count (huffmeta word 0) off by one
    blob[24] ^= 1
    with pytest.raises(ValueError, match="bit count"):
        pmc._decode_x_huffman(bytes(blob), "cpu")


def test_cpu_format_buffer_bytes_equal(monkeypatch):
    """Fed the JAX package's int64 stream, the port writes the JAX
    package's CPU-format buffer byte for byte (header, Huffman + zstd or
    zlib payload)."""
    v = _field((17, 33), seed=8)
    tol, s = 1e-3, 0.0
    hier = jmc.Hierarchy(v.shape, placement="reference")
    flat = jmc._pyramid_coeffs_block_order(hier, v).astype(np.float64)
    perm, quanta = jmc._quanta_shuffled(hier, s, tol)
    scaled = flat[perm] / quanta
    q = np.trunc(np.copysign(0.5 + np.abs(scaled), scaled)).astype(np.int64)
    monkeypatch.setattr(pmc, "_cpu_quantized", lambda *a: q)
    for zstd in (False, True):
        assert pmc.compress_mgard(v, tol, s=s, zstd=zstd, device="cpu") == \
            jmc.compress_mgard(v, tol, s=s, zstd=zstd)


def test_x_quantized_stream_equal(monkeypatch):
    """The port's X quantization is the JAX package's: the stream that
    the JAX writer Huffman-codes (read back from its container) equals
    the port's bit for bit when the port quantizes the JAX package's own
    pyramid, at s = inf (REL) and at s = 0 (the level quanta, ABS and
    REL); from the port's own float32 pyramid it differs by at most 1,
    on a few nodes whose scaled value lies within an ulp of a rounding
    boundary."""
    import jax
    import jax.numpy as jnp
    from mgard_tpu.ops import transform as jtransform

    v = _field((33, 33, 33), seed=12)
    hier, _ = jmc._x_hierarchy(v.shape)
    blocks = [torch.from_numpy(np.array(b)) for b in jax.jit(
        lambda x: jtransform.pyramid_to_blocks(
            hier, jtransform.decompose(hier, x)))(jnp.asarray(v))]
    for tol, s, mode in ((1e-3, math.inf, "rel"), (4.0, 0.0, "abs"),
                         (4.0, 0.0, "rel")):
        buf = jmc.compress_mgard_x(v, tol, s=s, mode=mode, zstd=False)
        assert len(buf) < v.nbytes      # Huffman-coded, not raw
        q_jax = jmc._decode_x_huffman(jmc.read_container(buf)[1][8:])
        q, tol_t, norm = pmc._x_quantized(v, tol, s, mode,
                                          torch.device("cpu"))
        assert tol_t == float(np.float32(tol))
        if mode == "rel":
            assert norm == jmc.read_container(buf)[0]["error_control"][
                "norm_of_original_data"]
        diff = q.reshape(-1).numpy() - q_jax
        assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= 4
        with monkeypatch.context() as m:
            m.setattr(pmc.transform, "decompose", lambda h, x: None)
            m.setattr(pmc.transform, "pyramid_to_blocks",
                      lambda h, p: blocks)
            q_same = pmc._x_quantized(v, tol, s, mode,
                                      torch.device("cpu"))[0]
        assert np.array_equal(q_same.reshape(-1).numpy(), q_jax)
        blob = pmc._encode_x_huffman(q_same.reshape(-1))
        assert blob == jmc.read_container(buf)[1][8:]


# --- the reference's own buffers ---------------------------------------------

def _cube33():
    x = np.linspace(0, 1, 33)
    return (np.sin(3 * x)[:, None, None] * np.cos(2 * x)[None, :, None]
            * (1 + x)[None, None, :]).astype(np.float32)


def test_golden_2d_huffman():
    v = np.load(DATA / "golden_17x17_f32.npy")
    out = mt.decompress((DATA / "golden_17x17_f32_abs1e-3.mgardx"
                         ).read_bytes(), device="cpu")
    assert out.shape == v.shape and out.dtype == np.float32
    assert np.abs(out.astype(np.float64) - v).max() <= 1e-3


def test_golden_3d_huffman_zstd():
    buf = (DATA / "golden_33cube_f32_abs1e-3_zstd.mgardx").read_bytes()
    out = mt.decompress(buf, device="cpu")
    assert np.abs(out.astype(np.float64) - _cube33()).max() <= 2e-5
    assert np.array_equal(out, mgard_tpu.decompress(buf))


def test_golden_reorder1_level_linearized():
    buf = (DATA / "golden_33cube_f32_reorder1_zstd.mgardx").read_bytes()
    ref = np.fromfile(DATA / "golden_33cube_f32_reorder1_ref_recon.bin",
                      dtype=np.float32).reshape(33, 33, 33)
    out = mt.decompress(buf, device="cpu")
    assert np.abs(out.astype(np.float64) - _cube33()).max() <= 1e-3
    assert np.abs(out.astype(np.float64) - ref).max() <= 1e-6


def test_linearized_order_is_a_permutation():
    for shape in ((33, 33, 33), (17, 9), (65,), (9, 17, 5)):
        lt = min(len(pmc._x_levels(n)) for n in shape if n > 1) - 1
        order = pmc._x_linear_order(shape, lt, "cpu").numpy()
        assert np.array_equal(np.sort(order), np.arange(np.prod(shape)))
        q = np.arange(np.prod(shape), dtype=np.int64)
        assert np.array_equal(
            pmc._x_linearized_to_corner(torch.from_numpy(q), shape,
                                        lt).numpy(),
            jmc._x_linearized_to_corner(q, shape, lt))


@pytest.mark.parametrize("shape,dd", [
    ((34, 17, 17), {"method": 2, "decomposition_size": 17}),
    ((50, 40, 30), {"method": 2, "decomposition_size": 17}),
    ((100, 33), {"method": 1, "decomposition_dimension": 0,
                 "decomposition_size": 33}),
    ((20, 70, 9), {"method": 1, "decomposition_dimension": 1,
                   "decomposition_size": 32}),
    ((9, 9), {"method": 0}),
])
def test_subdomains_equal(shape, dd):
    assert pmc._x_subdomains(shape, dd) == jmc._x_subdomains(shape, dd)


def test_x_maxdim_buffer_decodes():
    """A MaxDim-decomposed X buffer (two 33^3 slabs), assembled from the
    JAX writer's per-subdomain streams, decodes the same in both."""
    v = _field((66, 33, 33), seed=14)
    parts = [jmc.compress_mgard_x(np.ascontiguousarray(v[:33]), 1e-4,
                                  zstd=False),
             jmc.compress_mgard_x(np.ascontiguousarray(v[33:]), 1e-4,
                                  zstd=False)]
    header, _ = jmc.read_container(parts[0])
    header["domain"]["cartesian_grid_topology"]["shape"] = [66, 33, 33]
    header["domain_decomposition"] = {"method": 1,
                                      "decomposition_dimension": 0,
                                      "decomposition_size": 33}
    buf = jmc.write_container(header, b"".join(
        jmc.read_container(p)[1] for p in parts), little_endian=True)
    out = mt.decompress(buf, device="cpu")
    assert np.abs(out.astype(np.float64) - v).max() <= 1e-4
    assert np.array_equal(out, mgard_tpu.decompress(buf))


@pytest.mark.parametrize("field,value", [("geometry", 1), ("hierarchy", 2),
                                         ("hierarchy", 0)])
def test_x_refusals(field, value):
    """An X buffer with explicit coordinates or another hierarchy is
    refused by the port; the JAX package decodes it with the uniform
    MultiDim math, without an error (the recorded divergence)."""
    v = _field((33, 33, 33), seed=15)
    header, payload = jmc.read_container(
        jmc.compress_mgard_x(v, 1e-3, zstd=False))
    if field == "geometry":
        header["domain"]["geometry"] = value
        header["domain"]["explicit_cube_geometry"] = {
            "coordinates": list(np.linspace(0, 2, 33)) * 3}
    else:
        header["function_decomposition"]["hierarchy"] = value
    buf = jmc.write_container(header, payload, little_endian=True)
    with pytest.raises(NotImplementedError, match=field):
        mt.decompress(buf, device="cpu")
    assert mgard_tpu.decompress(buf).shape == v.shape


def test_cpu_format_coordinates_stay_legal():
    rng = np.random.default_rng(16)
    coords = [np.sort(np.concatenate([[0.0, 1.0], rng.random(n - 2)]))
              for n in (17, 19)]
    v = _field((17, 19), seed=16)
    ours = pmc.compress_mgard(v, 1e-3, coordinates=coords, zstd=False,
                              device="cpu")
    for out in (jmc.decompress_mgard(ours),
                mt.decompress(ours, device="cpu")):
        assert np.abs(out.astype(np.float64) - v).max() <= 1e-3


def test_missing_header_fields_raise():
    with pytest.raises(ValueError, match="domain"):
        pmc.decompress_mgard(b"MGARD" + bytes(64), device="cpu")
    header, payload = jmc.read_container(
        jmc.compress_mgard(_field((17, 17), seed=1), 1e-3, zstd=False))
    del header["error_control"]
    with pytest.raises(ValueError, match="error_control"):
        pmc.decompress_mgard(jmc.write_container(header, payload),
                             device="cpu")

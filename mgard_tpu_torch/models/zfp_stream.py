"""Bit-compatible codec for MGARD-X's ported ZFP fixed-rate streams (the
port's own copy of ``mgard_tpu/models/zfp_stream.py``: host numpy, one
Python loop over the blocks, as there).

The reference carries the actual zfp block codec as an alternate
``CompressorType`` (include/mgard-x/ExternalCompressionLowLevel/ZFP/
Compressor.hpp:40-126); this module reads and writes that exact stream
format (round-5 VERDICT item 8), validated bit-for-bit against streams
produced by the reference's own serial build (tests/data/*.zfps).

Format (fixed-rate mode, the only mode the reference wires up):

* the array is tiled into 4^d blocks, x = LAST array dim fastest,
  blocks in raster order with x fastest (ZFP.hpp:26-90); partial blocks
  pad by periodic replication (encode.h:17-34 pad_block);
* every block owns exactly ``maxbits = floor(4^d * rate + 0.5)`` bits
  at bit offset ``block_idx * maxbits``; bits fill u64 words LSB-first
  (BlockReader/BlockWriter, decode.h:25-98);
* block payload: 1 continuation bit, biased exponent (8 bits f32 / 11
  f64), then embedded bitplane coding of the negabinary-mapped,
  decorrelated coefficients MSB-plane first with unary run-length
  group testing (encode.h:279-316 encode_block, decode.h:102-151
  decode_ints);
* the decorrelating transform is zfp's non-orthogonal lifting
  (shared.h:96-137), coefficient order the sequency permutation tables
  (constants.h perm_1/perm_2/perm_3d).

Everything here is host-side numpy: the reference treats ZFP as an
external CPU/GPU codec outside the MGARD pipeline, and the per-block
bitstream chases are byte-oriented; the card runs the native
fixed-rate codec (models/zfp.py).  ``rate`` is bits per value.

Two faithfulness notes, verified against the reference build:

* the port's ``#if ZFP_ROUNDING_MODE == ZFP_ROUND_LAST`` guards compare
  UNDEFINED macros (0 == 0), so the decoder's inv_round bias is active
  upstream and is reproduced here;
* the port passes ``Array::ld`` values as strides (ZFP.hpp:47-90):
  ``stride_y = shape(0)`` in 2-D and ``stride_y = shape(1), stride_z =
  shape(0)`` in 3-D — NOT the row-major strides.  For squares/cubes
  the resulting (colliding) address pattern is a self-consistent
  permutation and round-trips; for other shapes the upstream code
  reads out of bounds (we observed its 2-D serial encoder corrupting
  the heap).  ``strides="reference"`` (default) reproduces the port's
  addressing bit-for-bit and rejects shapes whose addresses leave the
  array; ``strides="correct"`` uses true row-major strides — the
  layout upstream zfp itself uses for its (headerless) fixed-rate
  streams.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["zfp_encode", "zfp_decode", "zfp_maxbits", "zfp_stream_bytes"]

_NBMASK = 0xAAAAAAAAAAAAAAAA

# sequency permutations (constants.h); PERM[d] maps coding order ->
# block-flat index (x fastest within the 4^d block)
_PERM1 = np.arange(4)
_PERM2 = np.array([0, 1, 4, 5, 2, 8, 6, 9, 3, 12, 10, 7, 13, 11, 14, 15])


def _perm3():
    trip = [
        (0, 0, 0),
        (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (0, 1, 1), (1, 0, 1), (1, 1, 0),
        (2, 0, 0), (0, 2, 0), (0, 0, 2),
        (1, 1, 1),
        (2, 1, 0), (2, 0, 1), (0, 2, 1), (1, 2, 0), (1, 0, 2), (0, 1, 2),
        (3, 0, 0), (0, 3, 0), (0, 0, 3),
        (2, 1, 1), (1, 2, 1), (1, 1, 2),
        (0, 2, 2), (2, 0, 2), (2, 2, 0),
        (3, 1, 0), (3, 0, 1), (0, 3, 1), (1, 3, 0), (1, 0, 3), (0, 1, 3),
        (1, 2, 2), (2, 1, 2), (2, 2, 1),
        (3, 1, 1), (1, 3, 1), (1, 1, 3),
        (3, 2, 0), (3, 0, 2), (0, 3, 2), (2, 3, 0), (2, 0, 3), (0, 2, 3),
        (2, 2, 2),
        (3, 2, 1), (3, 1, 2), (1, 3, 2), (2, 3, 1), (2, 1, 3), (1, 2, 3),
        (0, 3, 3), (3, 0, 3), (3, 3, 0),
        (3, 2, 2), (2, 3, 2), (2, 2, 3),
        (1, 3, 3), (3, 1, 3), (3, 3, 1),
        (2, 3, 3), (3, 2, 3), (3, 3, 2),
        (3, 3, 3),
    ]
    return np.array([x + 4 * (y + 4 * z) for (x, y, z) in trip])


_PERMS = {1: _PERM1, 2: _PERM2, 3: _perm3()}


def _traits(dtype):
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        return dict(prec=32, ebits=8, ebias=127, idt=np.int32,
                    udt=np.uint32, fdt=np.float32)
    if dtype == np.float64:
        return dict(prec=64, ebits=11, ebias=1023, idt=np.int64,
                    udt=np.uint64, fdt=np.float64)
    raise TypeError("zfp streams: float32/float64 only")


def zfp_maxbits(ndim: int, rate: float) -> int:
    """Per-block bit budget (Compressor.hpp:79-83)."""
    return int(math.floor((4 ** ndim) * rate + 0.5))


def zfp_stream_bytes(shape, rate: float) -> int:
    """Stream allocation in bytes (shared.cpp calc_device_mem*d, which
    sizes by PADDED dims in 3-D and unpadded elsewhere; we use padded
    block counts uniformly — identical whenever dims divide 4, and a
    safe superset otherwise)."""
    nblocks = int(np.prod([-(-int(n) // 4) for n in shape]))
    total_bits = nblocks * zfp_maxbits(len(shape), rate)
    return (-(-total_bits // 64)) * 8


def _fwd_lift(v):
    x, y, z, w = v[0], v[1], v[2], v[3]
    x += w
    x >>= 1
    w -= x
    z += y
    z >>= 1
    y -= z
    x += z
    x >>= 1
    z -= x
    w += y
    w >>= 1
    y -= w
    w += y >> 1
    y -= w >> 1
    v[0], v[1], v[2], v[3] = x, y, z, w


def _inv_lift(v):
    x, y, z, w = v[0], v[1], v[2], v[3]
    y += w >> 1
    w -= y >> 1
    y += w
    w = w << 1
    w -= y
    z += x
    x = x << 1
    x -= z
    y += z
    z = z << 1
    z -= y
    w += x
    x = x << 1
    x -= w
    v[0], v[1], v[2], v[3] = x, y, z, w


def _xform(block, ndim: int, inverse: bool):
    """(De)correlate one block in place; ``block`` is a signed int
    array shaped (4,)*ndim with x (the fastest stream dim) LAST."""
    lift = _inv_lift if inverse else _fwd_lift
    # encode.h transform<BlockSize>: along x, then y, then z; the
    # inverse runs z, y, x.  Axis ndim-1 is x.
    axes = list(range(ndim - 1, -1, -1))   # x first
    if inverse:
        axes = axes[::-1]
    with np.errstate(over="ignore"):
        for ax in axes:
            v = np.moveaxis(block, ax, 0)
            lift(v)


def _encode_block_ints(ublock, maxbits: int, intprec: int, kmin: int):
    """encode.h:281-316 encode_block bit-emitting core -> (chunk int,
    nothing else); unwritten budget bits stay zero."""
    size = len(ublock)
    bits = maxbits
    out = 0
    pos = 0
    n = 0
    for k in range(intprec - 1, kmin - 1, -1):
        if not bits:
            break
        x = 0
        for i in range(size):
            x += ((int(ublock[i]) >> k) & 1) << i
        m = min(n, bits)
        bits -= m
        out |= (x & ((1 << m) - 1)) << pos
        pos += m
        x >>= m
        while n < size and bits:
            bits -= 1
            b = 1 if x else 0
            out |= b << pos
            pos += 1
            if not b:
                break
            while n < size - 1 and bits:
                bits -= 1
                bb = x & 1
                out |= bb << pos
                pos += 1
                if bb:
                    break
                x >>= 1
                n += 1
            x >>= 1
            n += 1
    return out


def _decode_block_ints(chunk: int, pos: int, maxbits: int, intprec: int,
                       kmin: int, size: int):
    """decode.h:102-151 decode_ints -> list of ints (the UInt block),
    including the inv_round bias (decode.h:10-23): the port's rounding
    #ifs compare undefined macros, so inv_round IS compiled upstream.
    """
    data = [0] * size
    bits = maxbits
    n = 0
    m = 0
    k = intprec
    while True:
        if not bits:
            break               # m, k keep their last-iteration values
        m = 0
        k -= 1
        if k < kmin:
            break               # here m == 0, k == kmin - 1
        m = min(n, bits)
        bits -= m
        x = (chunk >> pos) & ((1 << m) - 1)
        pos += m
        while bits and n < size:
            bits -= 1
            bit = (chunk >> pos) & 1
            pos += 1
            if bit:
                while bits and n < size - 1:
                    bits -= 1
                    b = (chunk >> pos) & 1
                    pos += 1
                    if b:
                        break
                    n += 1
                x += 1 << n
                n += 1
                m = n
            else:
                m = size
                break
        for i in range(size):
            data[i] += ((x >> i) & 1) << k
    # inv_round: add ~1/6 ulp to the negabinary values (first m get one
    # extra bit of precision)
    prec_used = intprec - k
    if prec_used < intprec - 1:
        umask = (1 << intprec) - 1
        b_hi = ((_NBMASK & umask) >> 2) >> prec_used
        b_lo = ((_NBMASK & umask) >> 1) >> prec_used
        for i in range(size):
            data[i] = (data[i] + (b_hi if i < m else b_lo)) & umask
    return data


def _strides(shape, mode: str):
    """Element strides, slowest dim first.  ``reference`` reproduces the
    port's Array::ld values (ZFP.hpp:47-90): 2-D stride_y = shape(0),
    3-D stride_y = shape(1) and stride_z = shape(0) — intentionally NOT
    row-major, to match the upstream streams bit-for-bit.  ``correct``
    is plain row-major (what upstream zfp itself does)."""
    nd = len(shape)
    if mode == "correct":
        s = [1] * nd
        for d in range(nd - 2, -1, -1):
            s[d] = s[d + 1] * shape[d + 1]
        return tuple(s)
    if mode != "reference":
        raise ValueError("strides must be 'reference' or 'correct'")
    if nd == 1:
        return (1,)
    if nd == 2:
        return (int(shape[0]), 1)
    return (int(shape[0]), int(shape[1]), 1)


def _check_addressable(shape, strides):
    """The reference-stride address pattern must stay inside the array
    (outside it, the upstream port itself reads/writes out of bounds —
    observed corrupting the heap in its 2-D serial encoder)."""
    top = sum((int(n) - 1) * int(s) for n, s in zip(shape, strides))
    if top >= int(np.prod(shape)):
        raise NotImplementedError(
            "reference-stride ZFP addressing leaves the array for shape "
            f"{tuple(shape)} (the upstream port is out-of-bounds/broken "
            "here too); pass strides='correct' for true row-major zfp "
            "layout")


def _blocks_iter(shape):
    """(origin, extent) of every 4^d block, raster order, x (last dim)
    fastest (Decode3Functor block indexing)."""
    counts = [-(-n // 4) for n in shape]
    for flat in range(int(np.prod(counts))):
        idx, rem = [], flat
        for c in reversed(counts):
            idx.append(rem % c)
            rem //= c
        idx = idx[::-1]
        origin = tuple(4 * i for i in idx)
        extent = tuple(min(4, n - o) for o, n in zip(origin, shape))
        yield origin, extent


def _block_addr(origin, extent, strides):
    """Flat element addresses of one block's live cells, shaped
    ``extent`` (slowest dim first) — the gather3/scatter3 pointer walk
    as an index array."""
    axes = [np.arange(o, o + e) * s
            for o, e, s in zip(origin, extent, strides)]
    addr = np.zeros(extent, dtype=np.int64)
    nd = len(extent)
    for d, a in enumerate(axes):
        shp = [1] * nd
        shp[d] = len(a)
        addr = addr + a.reshape(shp)
    return addr


def _pad_block(vals, shape, extent):
    """Periodic pad of a partial block to (4,)*d (encode.h pad_block,
    applied per axis: [p0, p0, p1, p0] patterns depending on count)."""
    ndim = len(shape)
    out = np.zeros((4,) * ndim, dtype=vals.dtype)
    out[tuple(slice(0, e) for e in extent)] = vals
    for ax in range(ndim - 1, -1, -1):   # x-axis padding first
        n = extent[ax]
        if n == 4:
            continue
        v = np.moveaxis(out, ax, 0)
        if n == 0:
            pass                                   # all zeros
        elif n == 1:
            v[1] = v[0]
            v[2] = v[1]
            v[3] = v[0]
        elif n == 2:
            v[2] = v[1]
            v[3] = v[0]
        elif n == 3:
            v[3] = v[0]
    return out


def zfp_encode(data: np.ndarray, rate: float,
               strides: str = "reference") -> bytes:
    """Encode to the reference port's exact fixed-rate stream bytes."""
    data = np.asarray(data)
    tr = _traits(data.dtype)
    ndim = data.ndim
    if ndim not in (1, 2, 3):
        raise ValueError("zfp streams: 1-3 dims")
    st = _strides(data.shape, strides)
    if strides == "reference":
        _check_addressable(data.shape, st)
    flat = data.reshape(-1)
    maxbits = zfp_maxbits(ndim, rate)
    size = 4 ** ndim
    perm = _PERMS[ndim]
    prec, ebias, ebits = tr["prec"], tr["ebias"], tr["ebits"] + 1
    # linear-time stream assembly: each block's chunk ORs into its byte
    # span of a preallocated buffer (a single Python bigint accumulator
    # would recopy the whole stream per block — O(nblocks^2))
    out = np.zeros(zfp_stream_bytes(data.shape, rate), dtype=np.uint8)
    base = 0
    for origin, extent in _blocks_iter(data.shape):
        vals = flat[_block_addr(origin, extent, st)]
        fblock = _pad_block(vals, data.shape, extent)
        amax = float(np.abs(fblock).max())
        if amax > 0:
            _, e = math.frexp(amax)
            emax = max(e, 1 - ebias)
        else:
            emax = -ebias
        maxprec = min(prec, max(0, emax - (-1074) + 8))
        e_field = (emax + ebias) if maxprec else 0
        if e_field:
            chunk = (2 * e_field + 1) & ((1 << ebits) - 1)
            s = np.asarray(math.ldexp(1.0, prec - 2 - emax), tr["fdt"])
            with np.errstate(over="ignore", invalid="ignore"):
                iblock = (fblock * s).astype(tr["idt"])
            _xform(iblock, ndim, inverse=False)
            iflat = iblock.reshape(-1)
            ub = (iflat[perm].astype(tr["udt"]).astype(np.uint64)
                  + np.uint64(_NBMASK & ((1 << prec) - 1))) \
                & np.uint64((1 << prec) - 1)
            ub = ub ^ np.uint64(_NBMASK & ((1 << prec) - 1))
            kmin = prec - maxprec if prec > maxprec else 0
            body = _encode_block_ints(ub, maxbits - ebits, prec, kmin)
            chunk |= body << ebits
            bit0 = base & 7
            byte0 = base >> 3
            span = (bit0 + maxbits + 7) >> 3
            piece = np.frombuffer(
                (chunk << bit0).to_bytes(span, "little"), np.uint8)
            out[byte0:byte0 + span] |= piece
        base += maxbits
    return out.tobytes()


def zfp_decode(buf: bytes, shape, dtype, rate: float,
               strides: str = "reference") -> np.ndarray:
    """Decode the reference port's fixed-rate stream bytes."""
    tr = _traits(dtype)
    shape = tuple(int(n) for n in shape)
    ndim = len(shape)
    st = _strides(shape, strides)
    if strides == "reference":
        _check_addressable(shape, st)
    maxbits = zfp_maxbits(ndim, rate)
    size = 4 ** ndim
    perm = _PERMS[ndim]
    prec, ebias, ebits = tr["prec"], tr["ebias"], tr["ebits"] + 1
    out = np.zeros(int(np.prod(shape)), dtype=dtype)
    base = 0
    mask_prec = (1 << prec) - 1
    for origin, extent in _blocks_iter(shape):
        # linear-time chunk slice (bigint '>> base' recopies the whole
        # remaining stream per block)
        bit0 = base & 7
        byte0 = base >> 3
        span = (bit0 + maxbits + 7) >> 3
        chunk = (int.from_bytes(buf[byte0:byte0 + span], "little")
                 >> bit0) & ((1 << maxbits) - 1)
        base += maxbits
        addr = _block_addr(origin, extent, st)
        if not (chunk & 1):          # continuation bit 0: zero block
            out[addr] = 0
            continue
        e_field = (chunk >> 1) & ((1 << (ebits - 1)) - 1)
        emax = e_field - ebias
        maxprec = min(prec, max(0, emax - (-1074) + 8))
        kmin = prec - maxprec if prec > maxprec else 0
        ub = _decode_block_ints(chunk, ebits, maxbits - ebits, prec,
                                kmin, size)
        iflat = np.zeros(size, dtype=np.int64)
        for i in range(size):
            u = ub[i] ^ (_NBMASK & mask_prec)
            v = (u - (_NBMASK & mask_prec)) & mask_prec
            if v > (mask_prec >> 1):     # two's complement at prec bits
                v -= 1 << prec
            iflat[perm[i]] = v
        iblock = iflat.astype(tr["idt"]).reshape((4,) * ndim)
        _xform(iblock, ndim, inverse=True)
        inv_w = math.ldexp(1.0, emax - (prec - 2))
        fblock = (iblock.astype(np.float64) * inv_w).astype(dtype)
        out[addr] = fblock[tuple(slice(0, e) for e in extent)]
    return out.reshape(shape)

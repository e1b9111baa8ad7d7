"""ctypes binding of the LZ4 block-format codec (the port's own copy of
``mgard_tpu/io/lz4_native.py``).

The C++ source is ``native/mgard_lz4.cpp``, built at first use like the
Huffman codec (``io/huffman_native.py``) into the build directory
(``utils/cache.py``; ``mgard_tpu_torch/_build/`` by default).

Framing (the reference's batched-LZ4 stage: nvcomp chunks of
``lz4_block_size``, default 1 << 15): the payload is cut into blocks,
each LZ4-compressed on its own, behind a little-endian table::

    <u8 raw_len> <u4 block_size> <u4 comp_len[0]> ... <u4 comp_len[n-1]>

with ``n = ceil(raw_len / block_size)`` implicit.  A ``comp_len`` equal
to the block's raw size marks a stored block, copied as it is: the LZ4
block format cannot represent data it cannot shrink.
"""

from __future__ import annotations

import ctypes
import struct
import threading

from ..ops import _build

__all__ = ["lz4_compress", "lz4_decompress", "BLOCK_SIZE"]

BLOCK_SIZE = 1 << 15

_LOCK = threading.Lock()
_LIB = None


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build.host_library("mgard_lz4")))
        lib.mlz4_bound.restype = ctypes.c_size_t
        lib.mlz4_bound.argtypes = [ctypes.c_size_t]
        lib.mlz4_encode.restype = ctypes.c_long
        lib.mlz4_encode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
        lib.mlz4_decode.restype = ctypes.c_long
        lib.mlz4_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
        _LIB = lib
        return lib


def lz4_compress(data: bytes, block_size: int = BLOCK_SIZE) -> bytes:
    lib = _load()
    n = len(data)
    nblocks = -(-n // block_size) if n else 0
    lens, chunks = [], []
    cap = int(lib.mlz4_bound(block_size))
    dst = ctypes.create_string_buffer(cap)
    for i in range(nblocks):
        raw = data[i * block_size:(i + 1) * block_size]
        rc = lib.mlz4_encode(raw, len(raw), dst, cap)
        if 0 < rc < len(raw):
            lens.append(rc)
            chunks.append(dst.raw[:rc])
        else:                      # incompressible: stored
            lens.append(len(raw))
            chunks.append(raw)
    head = struct.pack("<QI", n, block_size)
    table = struct.pack(f"<{nblocks}I", *lens)
    return head + table + b"".join(chunks)


def lz4_decompress(buf: bytes, max_output_size: int = 0) -> bytes:
    """Decode a framed LZ4 payload.  The framing is checked before any
    allocation: ``block_size`` must be positive and, where the caller
    passes ``max_output_size`` (the capacity its own header implies),
    ``raw_len`` may not pass it."""
    lib = _load()
    if len(buf) < 12:
        raise ValueError("truncated LZ4 framing")
    raw_len, block_size = struct.unpack_from("<QI", buf, 0)
    if block_size <= 0:
        raise ValueError("corrupt LZ4 framing: block_size must be > 0")
    if max_output_size and raw_len > max_output_size:
        raise ValueError(
            f"LZ4 framing claims {raw_len} bytes, over the caller's "
            f"{max_output_size}-byte cap")
    nblocks = -(-raw_len // block_size) if raw_len else 0
    if 12 + 4 * nblocks > len(buf):
        raise ValueError("truncated LZ4 block table")
    off = 12
    lens = struct.unpack_from(f"<{nblocks}I", buf, off)
    off += 4 * nblocks
    out = bytearray(raw_len)
    pos = 0
    for i, clen in enumerate(lens):
        raw_n = min(block_size, raw_len - pos)
        blk = buf[off:off + clen]
        if clen == raw_n:          # stored block
            out[pos:pos + raw_n] = blk
        else:
            dst = (ctypes.c_char * raw_n).from_buffer(out, pos)
            rc = lib.mlz4_decode(blk, len(blk), dst, raw_n)
            if rc != raw_n:
                raise ValueError(
                    f"corrupt LZ4 block {i}: decoded {rc} of {raw_n}")
        off += clen
        pos += raw_n
    if pos != raw_len or off > len(buf):
        raise ValueError("truncated LZ4 payload")
    return bytes(out)

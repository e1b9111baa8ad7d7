"""ctypes binding of the reference-compatible host Huffman codec (the
port's own copy of ``mgard_tpu/io/huffman_native.py``).

The C++ source is ``native/mgard_huffman.cpp`` (the format notes are
there: the reference's ``src/compressors.cpp:316-419``).  It is built at
first use with one ``g++`` call into the build directory
(``ops/_build.host_library``; ``utils/cache.py`` chooses the directory,
``mgard_tpu_torch/_build/`` by default); ``native/*.so`` is never loaded or
written.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops import _build

__all__ = ["huffman_encode", "huffman_decode"]

_LOCK = threading.Lock()
_LIB = None


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build.host_library("mgard_huffman")))
        lib.mh_encode.restype = ctypes.c_int
        lib.mh_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mh_decode.restype = ctypes.c_int
        lib.mh_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.mh_free.restype = None
        lib.mh_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def huffman_encode(q: np.ndarray):
    """Encode int64 values -> (tree bytes, hit bytes, hit_bits, miss
    bytes).  ``hit bytes`` follows the reference layout: ``hit_bits / 8 +
    4`` bytes."""
    lib = _load()
    q = np.ascontiguousarray(q, dtype=np.int64)
    tree_p, hit_p, miss_p = (ctypes.c_void_p() for _ in range(3))
    tree_n, hit_bits, miss_n = (ctypes.c_size_t() for _ in range(3))
    rc = lib.mh_encode(
        q.ctypes.data_as(ctypes.c_void_p), q.size,
        ctypes.byref(tree_p), ctypes.byref(tree_n),
        ctypes.byref(hit_p), ctypes.byref(hit_bits),
        ctypes.byref(miss_p), ctypes.byref(miss_n))
    if rc != 0:
        raise RuntimeError(f"huffman encode failed: {rc}")
    try:
        tree = ctypes.string_at(tree_p, tree_n.value)
        hit = ctypes.string_at(hit_p, hit_bits.value // 8 + 4)
        miss = ctypes.string_at(miss_p, miss_n.value)
    finally:
        lib.mh_free(tree_p)
        lib.mh_free(hit_p)
        lib.mh_free(miss_p)
    return tree, hit, hit_bits.value, miss


def huffman_decode(tree: bytes, hit: bytes, hit_bits: int, miss: bytes,
                   n: int) -> np.ndarray:
    """Decode ``n`` int64 values.  The decoder may read up to 64 bits past
    ``hit_bits`` before it finds a corrupt stream, so the hit words are
    handed over with that much zero padding."""
    if len(hit) != hit_bits // 8 + 4:
        raise ValueError(f"corrupted buffer: {len(hit)} hit bytes for "
                         f"{hit_bits} bits")
    lib = _load()
    out = np.empty(n, dtype=np.int64)
    rc = lib.mh_decode(
        tree, len(tree), hit + bytes(12), hit_bits, miss, len(miss),
        out.ctypes.data_as(ctypes.c_void_p), n)
    if rc != 0:
        raise ValueError(f"corrupted buffer: huffman decode failed: {rc}")
    return out

"""The bitplane codecs of the quantized coefficient stream, the port of
``mgard_tpu/ops/bitplane.py``.  See ``doc/FORMAT.md``.

Every codec cuts its values into groups of 32; a group's zigzag words
(or magnitudes) are bit-transposed, so that plane ``b`` of the group is
one 32-bit word, and only the planes up to an exponent are stored.

* **Segmented** (``encode_segments``/``decode_segments``, the
  PYRAMID_SEG layout): each segment (pyramid level) is padded to whole
  chunks of ``32 * C`` values; a chunk whose largest zigzag word has bit
  length ``e`` emits its ``e`` lowest planes (LSB first, ``C`` words
  each) into one shared stream, at the row where the exclusive cumsum of
  the exponents puts it.  Encode is two passes over the floats: K2
  (``bp_quant_max_segments``, one launch over all segments) gives each
  chunk's max and status, a cumsum gives the row offsets, and K3
  (``bp_quant_condense``, per segment) writes every segment's rows into
  the shared buffer.  Decode is K4
  (``bp_decode_condense_f32``) per segment, or K11 per segment where the
  caller dequantizes (finite s).
* **Chunked** (``encode``/``decode``): the same stream over one flat
  int32 vector, quantized already; K12 (``bp_encode_condense``) and K11
  (``bp_decode_condense``) do the transposes and the condense.
* **Per-group** (``encode_pergroup``/``decode_pergroup``): one exponent
  per 32-value group, a sign word and the magnitude planes MSB first,
  condensed word by word.  Plain PyTorch, as the JAX package's is XLA.
* **Wide** (``encode64``/``decode64``, float64 data): the chunked stream
  over int64 values, up to 64 planes a chunk (planes 0..31 from the low
  32-bit digit, 32..63 from the high one).  Plain PyTorch, as in JAX.

Words travel as int32 tensors holding the wire's uint32 bit patterns;
the plain parts compute in int64, where every uint32 is a value.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..utils.log import span
from .bp_kernels import (GROUP, butterfly, bp_decode_condense,
                         bp_decode_condense_f32, bp_encode_condense,
                         bp_quant_condense, bp_quant_max_segments, chunked,
                         gather_planes, scatter_planes)

__all__ = ["encode_segments", "decode_segments", "max_words_segments",
           "encode", "decode", "encode_pergroup", "decode_pergroup",
           "encode64", "decode64", "max_words", "max_words64",
           "num_chunks", "num_chunks_tiled", "num_chunks64",
           "num_chunks64_tiled", "GROUP", "CHUNK_GROUPS", "CHUNK_TILE",
           "WIDE_CHUNK_GROUPS", "encoded_nbytes", "transpose32",
           "transpose32_mid"]

# The JAX package's switches, read at import as it reads them (seeded by
# ``utils/autotune.apply_tuned`` from a tuned table).
# Groups per chunk == words per emitted plane row; a wire parameter that
# containers record (flags&8 of the header).
CHUNK_GROUPS = int(os.environ.get("MGARD_TPU_CHUNK_GROUPS", "4096"))
# Chunks per segment are padded to a multiple of this.  The GPU needs no
# such tile, but the padding sets the length of the exponent array on
# the wire, which no header records: a container written under another
# MGARD_TPU_BP_CB decodes only under that value, in either package.
CHUNK_TILE = int(os.environ.get("MGARD_TPU_BP_CB", "4"))
if not 1 <= CHUNK_TILE <= 8:
    raise ValueError("MGARD_TPU_BP_CB must be in [1, 8]")
# The wide codec's own default chunk width (bitplane.py:219).
WIDE_CHUNK_GROUPS = int(os.environ.get("MGARD_TPU_WIDE_CHUNK_GROUPS",
                                       "2048"))

_U32 = 0xFFFFFFFF
_I32_MIN = -2 ** 31
_I64_MIN = -2 ** 63


def transpose32(x: torch.Tensor) -> torch.Tensor:
    """Transpose a batch of 32x32 bit matrices (``bitplane.py:120``):
    ``x`` (32, G) of int32 bit patterns; bit j of row i of group g becomes
    bit i of row j.  An involution.  Plain PyTorch, as the JAX package's
    is XLA."""
    return butterfly(x, 0)


def transpose32_mid(x: torch.Tensor) -> torch.Tensor:
    """The bit transpose along axis 1 of a (C, 32, W) int32 array: bit i
    of out[c, b, w] = bit b of x[c, i, w] (``bitplane.py:157``)."""
    return butterfly(x, 1)


def num_chunks(n: int, C: int = 0) -> int:
    return -(-(-(-n // GROUP)) // (C or CHUNK_GROUPS))


def num_chunks_tiled(n: int, C: int = 0) -> int:
    """Chunk count padded to whole tiles of ``CHUNK_TILE`` chunks."""
    return -(-num_chunks(n, C) // CHUNK_TILE) * CHUNK_TILE


def max_words(n: int, C: int = 0) -> int:
    """Word capacity of the chunked stream of ``n`` values (33 rows a
    chunk; also a superset of the per-group stream's)."""
    return num_chunks_tiled(n, C) * (C or CHUNK_GROUPS) * (GROUP + 1)


def encoded_nbytes(exponents, count) -> int:
    """Total payload bytes given encoder outputs: a byte an exponent, four
    a word (``bitplane.py:105``)."""
    size = exponents.numel() if isinstance(exponents, torch.Tensor) \
        else np.asarray(exponents).size
    return int(size) + 4 * int(count)


def num_chunks64(n: int, C: int = 0) -> int:
    return -(-(-(-n // GROUP)) // (C or WIDE_CHUNK_GROUPS))


def num_chunks64_tiled(n: int, C: int = 0) -> int:
    return -(-num_chunks64(n, C) // CHUNK_TILE) * CHUNK_TILE


def max_words64(n: int, C: int = 0) -> int:
    """Word capacity of the wide stream of ``n`` values (65 rows a
    chunk)."""
    return num_chunks64_tiled(n, C) * (C or WIDE_CHUNK_GROUPS) \
        * (2 * GROUP + 1)


def max_words_segments(sizes, C: int = 0) -> int:
    """Stream word capacity for segmented encode of ``sizes``."""
    return sum(num_chunks_tiled(int(n), C) for n in sizes) \
        * (C or CHUNK_GROUPS) * (GROUP + 1)


def _bit_length32(z: torch.Tensor) -> torch.Tensor:
    """Bit length (0 -> 0) of int32 tensors holding uint32 bit patterns,
    as int32."""
    x = z.long() & 0xFFFFFFFF
    v = x
    e = torch.zeros_like(v)
    for shift in (16, 8, 4, 2, 1):
        big = v >= (1 << shift)
        e = e + big * shift
        v = torch.where(big, v >> shift, v)
    return torch.where(x == 0, 0, e + 1).to(torch.int32)


def _bit_length64(z: torch.Tensor) -> torch.Tensor:
    """Bit length (0 -> 0) of int64 tensors holding uint64 bit patterns,
    as int32: a pattern with the sign bit set has 64 bits."""
    v = z
    e = torch.zeros_like(v)
    for shift in (32, 16, 8, 4, 2, 1):
        big = v >= (1 << shift)
        e = e + big * shift
        v = torch.where(big, v >> shift, v)
    return torch.where(z == 0, 0, torch.where(z < 0, 64, e + 1)
                       ).to(torch.int32)


def _umax(zc: torch.Tensor, sign_bit: int) -> torch.Tensor:
    """Per-chunk max of ``zc`` (nchunks, ...) read as unsigned words.
    Flipping the sign bit maps unsigned order onto signed order, so a
    signed max of the flipped words finds the unsigned max: a zigzag
    word of the int32 minimum (0xFFFFFFFF) ranks above every other."""
    return (zc ^ sign_bit).flatten(1).amax(1) ^ sign_bit


def _zigzag(q: torch.Tensor) -> torch.Tensor:
    """int32 -> uint32 zigzag (as int32 bit patterns), int64 -> uint64
    (as int64): 0, -1, 1, -2, ... -> 0, 1, 2, 3, ...; the sign lives in
    the LSB (bitplane.py:316)."""
    return (q << 1) ^ (q >> (q.element_size() * 8 - 1))


def _chunk_exponents(zc: torch.Tensor) -> torch.Tensor:
    """Per-chunk exponent of int32 zigzag words (nchunks, 32, C): the
    bit length of the chunk's largest word, as int32."""
    return _bit_length32(_umax(zc, _I32_MIN))


def _offsets(e: torch.Tensor) -> torch.Tensor:
    """Exclusive cumsum of the per-chunk plane counts, int32."""
    ends = torch.cumsum(e, 0, dtype=torch.int64)
    return (ends - e).to(torch.int32)


def encode_segments(segs, inv_q: float, C: int = 0):
    """Fused quantize + encode of a list of float32 segments.

    Each segment is scaled by the float32 ``inv_q``, rounded half away
    from zero, zigzag-mapped and condensed into ONE stream whose chunks
    are segment-aligned.

    Returns ``(exponents uint8 (total_chunks,), words int32 (cap,),
    count int64 scalar, status int32 scalar)``, all on the segments'
    device; only ``words[:count]`` is meaningful and status is 1 for
    overflow, 2 for non-finite input.
    """
    with span("mgard.bitplane"):
        C = C or CHUNK_GROUPS
        segs = [s.reshape(-1).contiguous() for s in segs]
        device = segs[0].device
        ncs = [num_chunks_tiled(s.numel(), C) for s in segs]
        total_chunks = sum(ncs)
        cap_rows = total_chunks * (GROUP + 1)

        zmax, flags = bp_quant_max_segments(segs, ncs, C, inv_q)
        e = _bit_length32(zmax)
        offsets = _offsets(e)
        words = torch.zeros(cap_rows * C, dtype=torch.int32, device=device)
        a = 0
        for seg, nc in zip(segs, ncs):
            bp_quant_condense(seg, nc, C, inv_q, offsets[a:a + nc],
                              e[a:a + nc], words)
            a += nc
        count = e.sum(dtype=torch.int64) * C
        status = flags.max()
        return e.to(torch.uint8), words, count, status


def decode_segments(exponents: torch.Tensor, words: torch.Tensor, sizes,
                    quantum: Optional[float] = None, C: int = 0):
    """Inverse of :func:`encode_segments` (``bitplane.py:555``): a list of
    segments of ``sizes`` values, float32 dequantized by the float32
    ``quantum`` (K4 per segment), or without one int32 (K11 per segment,
    the finite-s decode).

    ``words`` (int32) needs to hold only the stream's rows: every chunk
    reads its own ``e`` rows and nothing past them.
    """
    C = C or CHUNK_GROUPS
    ncs = [num_chunks_tiled(int(n), C) for n in sizes]
    if exponents.numel() != sum(ncs):
        raise ValueError("exponent count does not match the segments")
    with span("mgard.bitplane"):
        e = exponents.to(torch.int32)
        offsets = _offsets(e)
        outs = []
        a = 0
        for n, nc in zip(sizes, ncs):
            off_k, e_k = offsets[a:a + nc], e[a:a + nc]
            if quantum is None:
                outs.append(bp_decode_condense(words, C, off_k, e_k, int(n)))
            else:
                outs.append(bp_decode_condense_f32(words, C, off_k, e_k,
                                                   quantum, int(n)))
            a += nc
        return outs


# ---------------------------------------------------------------------------
# Chunked codec over a flat int32 stream (K12 / K11)
# ---------------------------------------------------------------------------

def encode(q: torch.Tensor, C: int = 0):
    """Encode an int32 vector (``bitplane.py:334``).

    Returns ``(exponents uint8 (num_chunks_tiled,), words int32 (cap,),
    count int64 scalar)``; only ``words[:count]`` is meaningful.  Value
    ``i*C + g`` of chunk c is row i, column g of its (32, C) block.
    """
    with span("mgard.bitplane"):
        C = C or CHUNK_GROUPS
        nchunks = num_chunks_tiled(q.numel(), C)
        zc = _zigzag(chunked(q, nchunks, C))
        e = _chunk_exponents(zc)
        offsets = _offsets(e)
        words = torch.zeros(max_words(q.numel(), C), dtype=torch.int32,
                            device=q.device)
        bp_encode_condense(zc, offsets, e, words)
        return e.to(torch.uint8), words, e.sum(dtype=torch.int64) * C


def decode(exponents: torch.Tensor, words: torch.Tensor, n: int,
           C: int = 0) -> torch.Tensor:
    """Inverse of :func:`encode`: int32 (n,).  ``words`` needs to hold
    only the stream's rows (``bitplane.py:396``)."""
    with span("mgard.bitplane"):
        C = C or CHUNK_GROUPS
        e = exponents.to(torch.int32)
        return bp_decode_condense(words, C, _offsets(e), e, int(n))


# ---------------------------------------------------------------------------
# Per-group codec (plain PyTorch)
# ---------------------------------------------------------------------------

def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (JAX's uint32 -> int32 casts and
    negations wrap)."""
    return (((v + 2 ** 31) & _U32) - 2 ** 31).to(torch.int32)


def _to_rows(q: torch.Tensor):
    """int32 (n,) -> (sign words (G,), magnitude planes (32, G) LSB
    first, G), int64 words; the groups are padded to whole chunks of the
    process's ``CHUNK_GROUPS``, as ``bitplane.py:174`` pads them."""
    nchunks = num_chunks(q.numel())
    ngroups = nchunks * CHUNK_GROUPS
    qp = chunked(q, nchunks, CHUNK_GROUPS).reshape(-1).long()
    mt = qp.abs().view(ngroups, GROUP).T      # row i = value i of a group
    st = (qp < 0).long().view(ngroups, GROUP).T
    sign = (st << torch.arange(GROUP, device=q.device)[:, None]).sum(0)
    return sign, butterfly(mt, 0), ngroups


def _from_rows(sign: torch.Tensor, planes: torch.Tensor, n: int
               ) -> torch.Tensor:
    """Inverse of :func:`_to_rows`: int32 (n,)."""
    mt = butterfly(planes, 0)
    neg = (sign[None, :] >> torch.arange(GROUP, device=sign.device)[:, None]
           ) & 1
    return _wrap_i32(torch.where(neg == 1, -mt, mt).T.reshape(-1)[:n])


def encode_pergroup(q: torch.Tensor):
    """Per-32-value-group codec (``bitplane.py:595``): group g with
    exponent e_g > 0 stores e_g + 1 words at ``offsets[g]``: its sign
    word, then planes e_g - 1 .. 0.

    Returns ``(exponents uint8 (G,), words int32 (G*33,), count int64
    scalar)``; ``words`` is zero past ``count``.
    """
    with span("mgard.bitplane"):
        sign, planes, ngroups = _to_rows(q)
        dev = q.device
        bit_idx = torch.arange(1, GROUP + 1, device=dev)[:, None]
        e = torch.where(planes != 0, bit_idx, 0).amax(0)            # (G,)
        counts = torch.where(e > 0, e + 1, 0)
        ends = torch.cumsum(counts, 0)
        offsets = ends - counts
        slot = torch.arange(GROUP + 1, device=dev)[:, None]         # (33, 1)
        valid = (slot <= e[None, :]) & (e[None, :] > 0)
        plane_idx = (e[None, :] - slot).clamp(0, GROUP - 1)
        vals = torch.where(slot == 0, sign[None, :],
                           planes.gather(0, plane_idx))
        words = torch.zeros(ngroups * (GROUP + 1), dtype=torch.int32,
                            device=dev)
        words[(offsets[None, :] + slot)[valid]] = _wrap_i32(vals[valid])
        return e.to(torch.uint8), words, ends[-1]


def decode_pergroup(exponents: torch.Tensor, words: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """Inverse of :func:`encode_pergroup` (``bitplane.py:626``): int32
    (n,); one exponent per group, ``32 * len(exponents) >= n``."""
    with span("mgard.bitplane"):
        e = exponents.long()
        counts = torch.where(e > 0, e + 1, 0)
        offsets = torch.cumsum(counts, 0) - counts
        w = words.long() & _U32
        if w.numel() == 0:
            w = w.new_zeros(1)
        last = w.numel() - 1
        sign = torch.where(e > 0, w[offsets.clamp(0, last)], 0)
        b = torch.arange(GROUP, device=words.device)[:, None]
        idx = offsets[None, :] + e[None, :] - b
        planes = torch.where(b < e[None, :], w[idx.clamp(0, last)], 0)
        return _from_rows(sign, planes, int(n))


# ---------------------------------------------------------------------------
# Wide codec for int64 streams (float64 data; plain PyTorch)
# ---------------------------------------------------------------------------

def encode64(q: torch.Tensor, C: int = 0):
    """Encode an int64 vector (``bitplane.py:248``): the chunked stream
    with up to 64 planes a chunk.

    Returns ``(exponents uint8 (num_chunks64_tiled,), words int32 (cap,),
    count int64 scalar)``; only ``words[:count]`` is meaningful.
    """
    with span("mgard.bitplane"):
        C = C or WIDE_CHUNK_GROUPS
        nchunks = num_chunks64_tiled(q.numel(), C)
        zc = _zigzag(chunked(q, nchunks, C))
        e = _bit_length64(_umax(zc, _I64_MIN))
        offsets = _offsets(e)
        words = torch.zeros(max_words64(q.numel(), C), dtype=torch.int32,
                            device=q.device)
        planes = torch.cat([butterfly(zc & _U32, 1),
                            butterfly((zc >> 32) & _U32, 1)], 1)
        del zc
        scatter_planes(planes, offsets, e, words)
        return e.to(torch.uint8), words, e.sum(dtype=torch.int64) * C


def decode64(exponents: torch.Tensor, words: torch.Tensor, n: int,
             C: int = 0) -> torch.Tensor:
    """Inverse of :func:`encode64`: int64 (n,)."""
    with span("mgard.bitplane"):
        C = C or WIDE_CHUNK_GROUPS
        e = exponents.to(torch.int32)
        planes = gather_planes(words, C, _offsets(e), e, 2 * GROUP)
        z = butterfly(planes[:, :GROUP], 1) \
            | (butterfly(planes[:, GROUP:], 1) << 32)
        del planes
        out = ((z >> 1) & (2 ** 63 - 1)) ^ -(z & 1)
        return out.reshape(-1)[:int(n)]

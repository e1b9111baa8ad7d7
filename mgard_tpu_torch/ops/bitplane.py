"""The segmented chunked bitplane codec (PYRAMID_SEG layout), the port of
``mgard_tpu/ops/bitplane.py:467-588``.

Each segment (pyramid level) is padded to whole chunks of ``32 * C``
values; a chunk's values are zigzag-mapped and bit-transposed, and a
chunk whose largest zigzag word has bit length ``e`` emits its ``e``
lowest bitplanes (LSB first, ``C`` words each) into one shared stream,
at the row where the exclusive cumsum of the exponents puts it.  An
all-zero chunk emits nothing.  See ``doc/FORMAT.md``.

Encode is two passes over the floats: K2 (``bp_quant_max``) gives each
chunk's max and status, a cumsum gives the row offsets, and K3
(``bp_quant_condense``) writes every segment's rows into the shared
buffer.  Decode is K4 (``bp_decode_condense_f32``) per segment.
"""

from __future__ import annotations

import torch

from .bp_kernels import (GROUP, bp_decode_condense_f32, bp_quant_condense,
                         bp_quant_max)

__all__ = ["encode_segments", "decode_segments", "max_words_segments",
           "num_chunks", "num_chunks_tiled", "GROUP", "CHUNK_GROUPS",
           "CHUNK_TILE"]

# Groups per chunk == words per emitted plane row; a wire parameter that
# containers record (flags&8 of the header).
CHUNK_GROUPS = 4096
# Chunks per segment are padded to a multiple of this.  The GPU needs no
# such tile, but the padding sets the length of the exponent array on
# the wire, so it stays as in the JAX package.
CHUNK_TILE = 4


def num_chunks(n: int, C: int = 0) -> int:
    return -(-(-(-n // GROUP)) // (C or CHUNK_GROUPS))


def num_chunks_tiled(n: int, C: int = 0) -> int:
    """Chunk count padded to whole tiles of ``CHUNK_TILE`` chunks."""
    return -(-num_chunks(n, C) // CHUNK_TILE) * CHUNK_TILE


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
    C = C or CHUNK_GROUPS
    segs = [s.reshape(-1).contiguous() for s in segs]
    device = segs[0].device
    ncs = [num_chunks_tiled(s.numel(), C) for s in segs]
    total_chunks = sum(ncs)
    cap_rows = total_chunks * (GROUP + 1)

    zmaxs, flags = [], []
    for seg, nc in zip(segs, ncs):
        zm, fl = bp_quant_max(seg, nc, C, inv_q)
        zmaxs.append(zm)
        flags.append(fl)
    e = _bit_length32(torch.cat(zmaxs))
    offsets = _offsets(e)
    words = torch.zeros(cap_rows * C, dtype=torch.int32, device=device)
    a = 0
    for seg, nc in zip(segs, ncs):
        bp_quant_condense(seg, nc, C, inv_q, offsets[a:a + nc],
                          e[a:a + nc], words)
        a += nc
    count = e.sum(dtype=torch.int64) * C
    status = torch.cat(flags).max()
    return e.to(torch.uint8), words, count, status


def decode_segments(exponents: torch.Tensor, words: torch.Tensor, sizes,
                    quantum: float, C: int = 0):
    """Inverse of :func:`encode_segments`, dequantized by the float32
    ``quantum``: a list of float32 segments of ``sizes`` values.

    ``words`` (int32) needs to hold only the stream's rows: every chunk
    reads its own ``e`` rows and nothing past them.
    """
    C = C or CHUNK_GROUPS
    ncs = [num_chunks_tiled(int(n), C) for n in sizes]
    if exponents.numel() != sum(ncs):
        raise ValueError("exponent count does not match the segments")
    e = exponents.to(torch.int32)
    offsets = _offsets(e)
    outs = []
    a = 0
    for n, nc in zip(sizes, ncs):
        outs.append(bp_decode_condense_f32(words, C, offsets[a:a + nc],
                                           e[a:a + nc], quantum, int(n)))
        a += nc
    return outs

"""K2-K4, K11, K12, K14-K17: the kernels of the chunked bitplane codec,
with their plain PyTorch versions (the counterpart of
``mgard_tpu/ops/pallas_kernels.py``).

A segment is a float32 tensor of ``n`` values cut into ``nchunks`` chunks
of ``32 * C`` values (zero past ``n``); value ``i*C + g`` of a chunk is
row ``i``, column ``g``.  Stream words live in int32 tensors holding the
bit patterns of the wire's uint32 words.

* K2 ``bp_quant_max`` (replaces ``pallas_kernels.py:527``): per chunk,
  the max zigzag word and a status (2 non-finite input, 1 overflow; a
  value with a status leaves its word out of the max).  One launch takes
  every segment of a pyramid (``bp_quant_max_segments``, at most
  ``SEGMENT_CAPACITY``; the table travels in the kernel's parameters);
  ``bp_quant_max`` is its one-segment case.  Both count on
  ``bp_quant_max.launches``.
* K3 ``bp_quant_condense`` (replaces ``pallas_kernels.py:459``):
  quantize, zigzag and bit-transpose; chunk c writes planes
  0..e_c-1 at stream rows ``offsets[c]...``.
* K4 ``bp_decode_condense_f32`` (replaces ``pallas_kernels.py:605``):
  the inverse, dequantized to float32.

The flat stream (``bitplane.encode``/``decode``) comes quantized already,
as int32 values; its two kernels are K3 and K4 without the quantizer:

* K12 ``bp_encode_condense`` (replaces ``pallas_kernels.py:293``): int32
  zigzag words ``(nchunks, 32, C)`` bit-transposed and condensed.
* K11 ``bp_decode_condense`` (replaces ``pallas_kernels.py:690``): the
  inverse, unzigzagged to int32.

The segmented encode's older two-kernel split, which K2 + K3 replaced in
both packages and which no path calls (``chip_smoke.py`` holds it
against K2 and K3 on the main path's segments):

* K16 ``bp_quant_zigzag`` (replaces ``pallas_kernels.py:371``): K2 that
  also returns every zigzag word, (nchunks, 32, C).
* K17 ``bp_condense_into`` (replaces ``pallas_kernels.py:559``): one
  segment's zigzag words transposed and condensed into the shared stream
  at global row offsets.

The sign-magnitude cores, transpose only, on (nchunks, 32, 128) int32
chunks (value ``i`` of group ``(c, g)`` is ``q[c, i, g]``); no path of
either package calls them (``chip_smoke.py`` holds them on the main
path's quantized stream):

* K14 ``bp_encode_core`` (replaces ``pallas_kernels.py:93``): the 32
  magnitude planes of each group, its sign word and each chunk's plane
  count ``e``.
* K15 ``bp_decode_core`` (replaces ``pallas_kernels.py:752``): the
  inverse.

Each wrapper launches its CUDA kernel (``csrc/bp_codec.cu``) for a CUDA
tensor and counts the launch; it takes the plain version only for a
tensor on the CPU.  All nine are bound by bytes: K2 reads the segment,
K3 and K12 read it and write the stream rows, K4 and K11 read the rows
and write the values, K16 reads the segment and writes its words, K17
reads the words and writes the rows, K14 reads the values and writes
the planes and signs, K15 reads those and writes the values.  The plain versions hold words in
int64 (values in [0, 2^32)).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["bp_quant_max", "bp_quant_condense", "bp_decode_condense_f32",
           "bp_encode_condense", "bp_decode_condense",
           "bp_quant_max_plain", "bp_quant_max_segments",
           "bp_quant_max_segments_plain", "SEGMENT_CAPACITY",
           "bp_quant_condense_plain",
           "bp_decode_condense_f32_plain", "bp_encode_condense_plain",
           "bp_decode_condense_plain", "bp_quant_zigzag",
           "bp_condense_into", "bp_quant_zigzag_plain",
           "bp_condense_into_plain", "bp_encode_core", "bp_decode_core",
           "bp_encode_core_plain", "bp_decode_core_plain", "butterfly", "chunked", "gather_planes",
           "scatter_planes", "GROUP"]

GROUP = 32
_U32 = 0xFFFFFFFF
_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
_SHIFTS = (16, 8, 4, 2, 1)


# ---------------------------------------------------------------------------
# Plain building blocks (int64 words)
# ---------------------------------------------------------------------------

def butterfly(x: torch.Tensor, dim: int) -> torch.Tensor:
    """32x32 bit-matrix transpose along a length-32 ``dim`` of int64
    words in [0, 2^32), or of int32 bit patterns: bit i of out[.., b, ..]
    = bit b of x[.., i, ..].  The five masked shift/xor rounds of
    ``bitplane._butterfly``; each mask clears the bits that an arithmetic
    right shift of an int32 brings in, so the shifts act as logical
    ones."""
    rows = list(x.unbind(dim))
    for mask, sh in zip(_MASKS, _SHIFTS):
        for i in range(GROUP):
            if i & sh:
                continue
            a, b = rows[i], rows[i | sh]
            t = ((a >> sh) ^ b) & mask
            rows[i] = a ^ (t << sh)
            rows[i | sh] = b ^ t
    return torch.stack(rows, dim)


def chunked(seg: torch.Tensor, nchunks: int, C: int) -> torch.Tensor:
    """Flatten a segment (of any dtype) and zero-pad it to
    (nchunks, 32, C)."""
    f = seg.reshape(-1)
    pad = nchunks * GROUP * C - f.numel()
    if pad:
        f = torch.cat([f, f.new_zeros(pad)])
    return f.reshape(nchunks, GROUP, C)


def _quant_zigzag(x: torch.Tensor, inv_q: float) -> torch.Tensor:
    """float32 -> int64 zigzag words: scale, round half away from zero,
    zigzag (``pallas_kernels._quant_zigzag_block``).  Undefined where the
    value overflows int32; the status says so."""
    xs = x * torch.tensor(inv_q, dtype=torch.float32, device=x.device)
    t = torch.trunc(xs.abs() + 0.5)
    q = torch.where(xs < 0, -t, t).to(torch.int32).to(torch.int64)
    return ((q << 1) ^ (q >> 31)) & _U32


def _to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def scatter_planes(planes: torch.Tensor, offsets, e, words) -> None:
    """Write planes 0..e_c-1 of chunk c (``planes`` int64 (nchunks, P, C)
    in [0, 2^32)) to the C-word rows ``offsets[c]...`` of ``words``
    (int32 bit patterns), in place."""
    C = planes.shape[2]
    b = torch.arange(planes.shape[1], device=planes.device)
    valid = b[None, :] < e[:, None]
    rows = offsets[:, None].long() + b[None, :]
    words.view(-1, C)[rows[valid]] = _to_i32(planes[valid])


def gather_planes(words, C: int, offsets, e, nplanes: int = GROUP
                  ) -> torch.Tensor:
    """The inverse read: (nchunks, nplanes, C) int64 planes, row
    ``offsets[c] + b`` for b < e_c and zero above.  A stream with no
    words (every e is 0) reads as zeros."""
    rows = words.view(-1, C)
    if rows.shape[0] == 0:
        rows = words.new_zeros(1, C)
    b = torch.arange(nplanes, device=words.device)
    idx = (offsets[:, None].long() + b[None, :]).clamp(0, rows.shape[0] - 1)
    valid = b[None, :] < e[:, None]
    return torch.where(valid[:, :, None], rows[idx].long() & _U32, 0)


def _unzigzag(z: torch.Tensor) -> torch.Tensor:
    """int64 zigzag words in [0, 2^32) -> their int32 values, as int64."""
    return (z >> 1) ^ -(z & 1)


def _check_cuda(name: str, *tensors) -> torch.device:
    """The one CUDA device of ``tensors``, which must be contiguous."""
    device = _build.device_of(name, *tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return device


def _check_chunks(seg, nchunks, C):
    if seg.dtype != torch.float32:
        raise ValueError("segment must be float32")
    if not 0 <= seg.numel() <= nchunks * GROUP * C:
        raise ValueError("segment larger than its chunks")


# ---------------------------------------------------------------------------
# K2: per-chunk zigzag max + status
# ---------------------------------------------------------------------------

def _chunk_status(x: torch.Tensor, inv_q: float) -> torch.Tensor:
    """Per-chunk status of float32 chunks (nchunks, 32, C): 2 where a
    value is not finite, else 1 where one overflows int32, else 0."""
    bad = (~torch.isfinite(x)).flatten(1).any(1)
    xs = x * torch.tensor(inv_q, dtype=torch.float32, device=x.device)
    over = (xs.abs() + 0.5 >= 2.0 ** 31).flatten(1).any(1)
    return torch.maximum(2 * bad.to(torch.int32), over.to(torch.int32))


def bp_quant_max_plain(seg, nchunks: int, C: int, inv_q: float):
    """Plain K2: a value whose status is not 0 leaves its word out of the
    maximum (read as 0), as the kernel does."""
    x = chunked(seg, nchunks, C)
    xs = x * torch.tensor(inv_q, dtype=torch.float32, device=x.device)
    bad = ~torch.isfinite(x) | (xs.abs() + 0.5 >= 2.0 ** 31)
    z = torch.where(bad, 0, _quant_zigzag(x, inv_q))
    return _to_i32(z.flatten(1).amax(1)), _chunk_status(x, inv_q)


# Segments one K2 launch takes: its table travels in the kernel's
# parameters (csrc/bp_codec.cu, kMaxSegments).  The default planner keeps
# a float32 domain to 2^29 values (Config.max_block_bytes), so at most
# L = 29 levels, 30 segments, even for a 1-D series.
SEGMENT_CAPACITY = 32


def bp_quant_max_segments_plain(segs, ncs, C: int, inv_q: float):
    """Plain K2 over several segments: the per-segment results,
    concatenated."""
    outs = [bp_quant_max_plain(s, nc, C, inv_q) for s, nc in zip(segs, ncs)]
    if not outs:
        empty = torch.zeros(0, dtype=torch.int32)
        return empty, empty.clone()
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def _quant_max_launch(segs, ncs, C: int, inv_q: float):
    """One K2 launch over ``segs`` (contiguous float32 CUDA tensors on
    one device), counted on :func:`bp_quant_max`."""
    device = _check_cuda("bp_quant_max", *segs)
    total = sum(ncs)
    zmax = torch.empty(total, dtype=torch.int32, device=device)
    status = torch.empty(total, dtype=torch.int32, device=device)
    if total == 0:
        return zmax, status
    k = len(segs)
    ptrs = (ctypes.c_void_p * k)(*[s.data_ptr() for s in segs])
    ns = (ctypes.c_longlong * k)(*[s.numel() for s in segs])
    chunks = (ctypes.c_int * k)(*ncs)
    _build.launch("mgard_bp_quant_max_segments", ctypes.addressof(ptrs),
                  ctypes.addressof(ns), ctypes.addressof(chunks), k, C,
                  float(inv_q), zmax.data_ptr(), status.data_ptr(),
                  device=device)
    bp_quant_max.launches += 1
    return zmax, status


@_build.counted
def bp_quant_max(seg: torch.Tensor, nchunks: int, C: int, inv_q: float):
    """(zmax int32 (nchunks,) uint32 bit patterns, status int32
    (nchunks,)) of one float32 segment scaled by ``inv_q``: K2's launch
    with one segment."""
    _check_chunks(seg, nchunks, C)
    if seg.device.type == "cpu":
        return bp_quant_max_plain(seg, nchunks, C, inv_q)
    return _quant_max_launch([seg], [nchunks], C, inv_q)


def bp_quant_max_segments(segs, ncs, C: int, inv_q: float):
    """K2 over every segment at once: ``bp_quant_max`` of each segment
    ``segs[s]`` in ``ncs[s]`` chunks, concatenated, from ONE launch (at
    most ``SEGMENT_CAPACITY`` segments; more raise).  An empty list gives
    two empty int32 tensors on the CPU."""
    segs, ncs = list(segs), [int(nc) for nc in ncs]
    if len(segs) != len(ncs):
        raise ValueError("one chunk count per segment")
    if len(segs) > SEGMENT_CAPACITY:
        raise ValueError(f"{len(segs)} segments: one K2 launch takes at "
                         f"most {SEGMENT_CAPACITY}")
    for seg, nc in zip(segs, ncs):
        _check_chunks(seg, nc, C)
    if all(s.device.type == "cpu" for s in segs):
        return bp_quant_max_segments_plain(segs, ncs, C, inv_q)
    return _quant_max_launch(segs, ncs, C, inv_q)


# ---------------------------------------------------------------------------
# K3: quantize + zigzag + transpose + condense into the shared stream
# ---------------------------------------------------------------------------

def bp_quant_condense_plain(seg, nchunks: int, C: int, inv_q: float,
                            offsets, e, words) -> None:
    planes = butterfly(_quant_zigzag(chunked(seg, nchunks, C), inv_q), 1)
    scatter_planes(planes, offsets, e, words)


@_build.counted
def bp_quant_condense(seg: torch.Tensor, nchunks: int, C: int,
                      inv_q: float, offsets: torch.Tensor, e: torch.Tensor,
                      words: torch.Tensor) -> None:
    """Write the segment's stream rows into ``words`` (int32, a whole
    number of C-word rows) in place.  ``offsets``/``e``: int32
    (nchunks,) global row offsets and plane counts of its chunks; the
    caller sizes ``words`` to hold every row they address
    (``encode_segments`` gives 33 rows a chunk, and e <= 32)."""
    _check_chunks(seg, nchunks, C)
    if offsets.numel() != nchunks or e.numel() != nchunks:
        raise ValueError("offsets and e need one entry per chunk")
    if seg.device.type == "cpu":
        return bp_quant_condense_plain(seg, nchunks, C, inv_q, offsets, e,
                                       words)
    device = _check_cuda("bp_quant_condense", seg, offsets, e, words)
    if offsets.dtype != torch.int32 or e.dtype != torch.int32 \
            or words.dtype != torch.int32:
        raise ValueError("offsets, e and words must be int32")
    _build.launch("mgard_bp_quant_condense", seg.data_ptr(), seg.numel(),
                  nchunks, C, float(inv_q), offsets.data_ptr(), e.data_ptr(),
                  words.data_ptr(), device=device)
    bp_quant_condense.launches += 1



# ---------------------------------------------------------------------------
# K4: read e_c rows per chunk, transpose back, unzigzag, dequantize
# ---------------------------------------------------------------------------

def bp_decode_condense_f32_plain(words, C: int, offsets, e, quantum: float,
                                 n: int) -> torch.Tensor:
    z = butterfly(gather_planes(words, C, offsets, e), 1)
    out = _unzigzag(z).to(torch.float32) * torch.tensor(
        quantum, dtype=torch.float32, device=words.device)
    return out.reshape(-1)[:n]


@_build.counted
def bp_decode_condense_f32(words: torch.Tensor, C: int,
                           offsets: torch.Tensor, e: torch.Tensor,
                           quantum: float, n: int) -> torch.Tensor:
    """Decode one segment of ``n`` values from the stream rows of its
    chunks (``offsets``/``e`` int32, one entry per chunk), times
    ``quantum``, as float32."""
    nchunks = int(offsets.numel())
    if e.numel() != nchunks or n > nchunks * GROUP * C:
        raise ValueError("offsets/e do not cover the segment")
    if words.numel() % C:
        raise ValueError("the stream must hold whole C-word rows")
    if words.device.type == "cpu":
        return bp_decode_condense_f32_plain(words, C, offsets, e, quantum, n)
    device = _check_cuda("bp_decode_condense_f32", words, offsets, e)
    if offsets.dtype != torch.int32 or e.dtype != torch.int32 \
            or words.dtype != torch.int32:
        raise ValueError("offsets, e and words must be int32")
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    _build.launch("mgard_bp_decode_condense_f32", words.data_ptr(), nchunks,
                  C, offsets.data_ptr(), e.data_ptr(), float(quantum),
                  out.data_ptr(), n, device=device)
    bp_decode_condense_f32.launches += 1
    return out



# ---------------------------------------------------------------------------
# K12: transpose + condense pre-quantized zigzag words into the stream
# ---------------------------------------------------------------------------

def _check_stream_args(name, offsets, e, words, nchunks):
    if offsets.numel() != nchunks or e.numel() != nchunks:
        raise ValueError(f"{name}: offsets and e need one entry per chunk")
    if offsets.dtype != torch.int32 or e.dtype != torch.int32 \
            or words.dtype != torch.int32:
        raise ValueError(f"{name}: offsets, e and words must be int32")


def _check_condense_args(name, z, offsets, e, words) -> None:
    if z.dim() != 3 or z.shape[1] != GROUP or z.dtype != torch.int32:
        raise ValueError(f"{name}: z must be int32 (nchunks, 32, C)")
    _check_stream_args(name, offsets, e, words, z.shape[0])
    if words.numel() % z.shape[2]:
        raise ValueError(f"{name}: the stream must hold whole C-word rows")


def bp_encode_condense_plain(z, offsets, e, words) -> None:
    scatter_planes(butterfly(z.long() & _U32, 1), offsets, e, words)


@_build.counted
def bp_encode_condense(z: torch.Tensor, offsets: torch.Tensor,
                       e: torch.Tensor, words: torch.Tensor) -> None:
    """Write the stream rows of the zigzag words ``z`` (int32 uint32 bit
    patterns, (nchunks, 32, C)) into ``words`` (int32, whole C-word rows)
    in place: chunk c's planes 0..e_c-1 at rows ``offsets[c]...``.  The
    caller sizes ``words`` to hold every row they address."""
    _check_condense_args("bp_encode_condense", z, offsets, e, words)
    nchunks, _, C = z.shape
    if z.device.type == "cpu":
        return bp_encode_condense_plain(z, offsets, e, words)
    device = _check_cuda("bp_encode_condense", z, offsets, e, words)
    _build.launch("mgard_bp_encode_condense", z.data_ptr(), nchunks, C,
                  offsets.data_ptr(), e.data_ptr(), words.data_ptr(),
                  device=device)
    bp_encode_condense.launches += 1


# ---------------------------------------------------------------------------
# K11: read e_c rows per chunk, transpose back, unzigzag
# ---------------------------------------------------------------------------

def bp_decode_condense_plain(words, C: int, offsets, e, n: int
                             ) -> torch.Tensor:
    z = butterfly(gather_planes(words, C, offsets, e), 1)
    return _unzigzag(z).to(torch.int32).reshape(-1)[:n]


@_build.counted
def bp_decode_condense(words: torch.Tensor, C: int, offsets: torch.Tensor,
                       e: torch.Tensor, n: int) -> torch.Tensor:
    """Decode ``n`` int32 values from the stream rows of their chunks
    (``offsets``/``e`` int32, one entry per chunk).  Each chunk reads its
    own ``e`` rows and nothing past them."""
    nchunks = int(offsets.numel())
    if n > nchunks * GROUP * C:
        raise ValueError("offsets/e do not cover the values")
    _check_stream_args("bp_decode_condense", offsets, e, words, nchunks)
    if words.numel() % C:
        raise ValueError("the stream must hold whole C-word rows")
    if words.device.type == "cpu":
        return bp_decode_condense_plain(words, C, offsets, e, n)
    device = _check_cuda("bp_decode_condense", words, offsets, e)
    out = torch.empty(n, dtype=torch.int32, device=words.device)
    _build.launch("mgard_bp_decode_condense", words.data_ptr(), nchunks, C,
                  offsets.data_ptr(), e.data_ptr(), out.data_ptr(), n,
                  device=device)
    bp_decode_condense.launches += 1
    return out


# ---------------------------------------------------------------------------
# K16: quantize + zigzag, keeping the words, with K2's max and status
# ---------------------------------------------------------------------------

def _quant_zigzag_sat(x: torch.Tensor, inv_q: float) -> torch.Tensor:
    """:func:`_quant_zigzag` where |x * inv_q| + 0.5 is below 2^31, and
    elsewhere the word of XLA's saturating int32 cast, as the JAX kernel
    forms it: 0 for NaN, the int32 maximum's (0xFFFFFFFE) or minimum's
    (0xFFFFFFFF) past the range."""
    xs = x * torch.tensor(inv_q, dtype=torch.float32, device=x.device)
    inside = xs.abs() + 0.5 < 2.0 ** 31
    sat = torch.where(xs < 0, _U32, _U32 - 1)
    sat = torch.where(torch.isnan(xs), 0, sat)
    return torch.where(inside, _quant_zigzag(x, inv_q), sat)


def bp_quant_zigzag_plain(seg, nchunks: int, C: int, inv_q: float):
    x = chunked(seg, nchunks, C)
    z = _quant_zigzag_sat(x, inv_q)
    return _to_i32(z), _to_i32(z.flatten(1).amax(1)), _chunk_status(x,
                                                                   inv_q)


@_build.counted
def bp_quant_zigzag(seg: torch.Tensor, nchunks: int, C: int, inv_q: float):
    """(z int32 (nchunks, 32, C), zmax int32 (nchunks,), status int32
    (nchunks,)) of one float32 segment scaled by ``inv_q``: the zigzag
    words (uint32 bit patterns; value ``i*C + g`` of chunk c at
    ``z[c, i, g]``), each chunk's largest and its status.  Where the
    status is 0, zmax and status equal :func:`bp_quant_max`'s."""
    _check_chunks(seg, nchunks, C)
    if seg.device.type == "cpu":
        return bp_quant_zigzag_plain(seg, nchunks, C, inv_q)
    device = _check_cuda("bp_quant_zigzag", seg)
    z = torch.empty((nchunks, GROUP, C), dtype=torch.int32,
                    device=seg.device)
    zmax = torch.zeros(nchunks, dtype=torch.int32, device=seg.device)
    status = torch.zeros(nchunks, dtype=torch.int32, device=seg.device)
    _build.launch("mgard_bp_quant_zigzag", seg.data_ptr(), seg.numel(),
                  nchunks, C, float(inv_q), z.data_ptr(), zmax.data_ptr(),
                  status.data_ptr(), device=device)
    bp_quant_zigzag.launches += 1
    return z, zmax, status


# ---------------------------------------------------------------------------
# K17: transpose + condense one segment's words into the shared stream
# ---------------------------------------------------------------------------

# K17 computes K12's function on one segment's chunks.
bp_condense_into_plain = bp_encode_condense_plain


@_build.counted
def bp_condense_into(z: torch.Tensor, offsets: torch.Tensor,
                     e: torch.Tensor, words: torch.Tensor) -> None:
    """Write one segment's stream rows into the shared stream ``words``
    (int32, whole C-word rows) in place: chunk c of the zigzag words
    ``z`` (int32 (nchunks, 32, C), as :func:`bp_quant_zigzag` gives them)
    emits its planes 0..e_c-1 at the global rows ``offsets[c]...``.
    The JAX kernel's ``total_rows`` and its aliased buffer have no
    counterpart: ``e`` gives each chunk's row count, and the caller owns
    ``words`` and sizes it to hold every row addressed."""
    _check_condense_args("bp_condense_into", z, offsets, e, words)
    nchunks, _, C = z.shape
    if z.device.type == "cpu":
        return bp_condense_into_plain(z, offsets, e, words)
    device = _check_cuda("bp_condense_into", z, offsets, e, words)
    _build.launch("mgard_bp_condense_into", z.data_ptr(), nchunks, C,
                  offsets.data_ptr(), e.data_ptr(), words.data_ptr(),
                  device=device)
    bp_condense_into.launches += 1


# ---------------------------------------------------------------------------
# K14 / K15: sign-magnitude transpose cores
# ---------------------------------------------------------------------------

CORE_LANES = 128


def _check_core(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def bp_encode_core_plain(q: torch.Tensor):
    q64 = q.long()
    planes = butterfly(q64.abs() & _U32, 1)
    bit = torch.arange(GROUP, device=q.device)[None, :, None]
    sign = ((q64 < 0).long() << bit).sum(1)
    occ = (planes != 0).any(2)
    e = ((bit[:, :, 0] + 1) * occ).amax(1)
    return _to_i32(planes), _to_i32(sign), e.to(torch.int32)


@_build.counted
def bp_encode_core(q: torch.Tensor):
    """(planes int32 (nchunks, 32, 128), sign int32 (nchunks, 128), e
    int32 (nchunks,)) of int32 chunks ``q`` (nchunks, 32, 128): bit i of
    ``planes[c, b, g]`` is bit b of ``|q[c, i, g]|`` as uint32 (the int32
    minimum's magnitude is 2^31), bit i of ``sign[c, g]`` is
    ``q[c, i, g] < 0``, and ``e[c]`` is 1 + the highest plane of chunk c
    with a non-zero word (0 for an all-zero chunk).  Words are uint32 bit
    patterns."""
    _check_core("bp_encode_core", q, (q.shape[0], GROUP, CORE_LANES))
    nchunks = q.shape[0]
    if q.device.type == "cpu":
        return bp_encode_core_plain(q)
    device = _check_cuda("bp_encode_core", q)
    planes = torch.empty_like(q)
    sign = torch.empty((nchunks, CORE_LANES), dtype=torch.int32,
                       device=q.device)
    e = torch.empty(nchunks, dtype=torch.int32, device=q.device)
    _build.launch("mgard_bp_encode_core", q.data_ptr(), nchunks,
                  planes.data_ptr(), sign.data_ptr(), e.data_ptr(),
                  device=device)
    bp_encode_core.launches += 1
    return planes, sign, e


def bp_decode_core_plain(planes: torch.Tensor, sign: torch.Tensor):
    m = butterfly(planes.long() & _U32, 1)
    bit = torch.arange(GROUP, device=planes.device)[None, :, None]
    neg = ((sign.long() & _U32)[:, None, :] >> bit) & 1
    return _to_i32(torch.where(neg == 1, (-m) & _U32, m))


@_build.counted
def bp_decode_core(planes: torch.Tensor, sign: torch.Tensor
                   ) -> torch.Tensor:
    """Inverse of :func:`bp_encode_core`: int32 (nchunks, 32, 128), the
    magnitudes negated (wrapping) where the sign bit is set."""
    nchunks = planes.shape[0]
    _check_core("bp_decode_core", planes, (nchunks, GROUP, CORE_LANES))
    _check_core("bp_decode_core", sign, (nchunks, CORE_LANES))
    if planes.device.type == "cpu":
        return bp_decode_core_plain(planes, sign)
    device = _check_cuda("bp_decode_core", planes, sign)
    out = torch.empty_like(planes)
    _build.launch("mgard_bp_decode_core", planes.data_ptr(), sign.data_ptr(),
                  nchunks, out.data_ptr(), device=device)
    bp_decode_core.launches += 1
    return out

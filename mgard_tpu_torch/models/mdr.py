"""MDR: progressive (multiprecision) refactoring and reconstruction, the
port of ``mgard_tpu/models/mdr.py`` (reference MDR / MDR-X,
``include/mgard-x/MDR-X/``).

The multigrid coefficients of each level are aligned to one exponent,
cut into fixed point and sliced into bitplanes; the artifact stores each
level's sign stream and planes, with the residual errors after each
plane, so that a reader fetches just enough planes to meet a tolerance
and later fetches more to refine, keeping what it has.  Artifacts are
the JAX package's byte for byte: each package reconstructs from the
other's metadata and streams.

The transform runs on the device (``transform.decompose`` and
``recompose_to_level``, with their kernels); the bit transposes, the
residual sums and the decode are plain PyTorch on the device, as the
JAX package's are XLA.  Orchestration and the metadata live on the
host.

Each level's exponent and scale are host scalars computed as XLA's CPU
backend computes them in the JAX package (:func:`ceil_log2`,
:func:`exp2`): there ``jnp.log2`` is a logarithm times ``1 / log(2)``
and ``jnp.exp2(k)`` is ``exp(log(2) * k)``, neither exact at powers of
two, and ``1 / exp2(k)`` is rewritten to ``exp2(-k)``.  A level whose
exponent or scale differs has every plane different.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..hierarchy import Hierarchy
from ..ops import transform
from ..ops.bitplane import GROUP, transpose32_mid
from ..ops.quantize import TORCH_DTYPE, _scalar
from ..ops.tridiag import table_scope

__all__ = ["MDRMetadata", "LevelMetadata", "MDRefactorResult",
           "MDReconstructor", "MDRDataset", "mdr_refactor", "mdr_request",
           "mdr_reconstruct", "mdr_refactor_dd", "estimate_error",
           "encode_level", "decode_level", "LOSSLESS_NONE", "LOSSLESS_ZSTD",
           "ENC_SIGN_MAGNITUDE", "ENC_NEGABINARY", "NUM_BITPLANES"]

_MDR_W = 128  # lane width of the chunked bit-transpose layout

# stream-level lossless (reference DefaultLevelCompressor = zstd per stream)
LOSSLESS_NONE = 0
LOSSLESS_ZSTD = 1

# bitplane encodings
ENC_SIGN_MAGNITUDE = 0   # sign stream + magnitude planes
ENC_NEGABINARY = 1       # negabinary planes, no sign stream

NUM_BITPLANES = 30  # magnitude planes

_NEG_MASK32 = 0xAAAAAAAA
_U32 = 0xFFFFFFFF
_I32_MIN = -2 ** 31


def _mdr_layout(n: int):
    """(lane width, nchunks, padded ngroups) for a level of n values:
    small levels take one narrow chunk."""
    ngroups0 = max(1, -(-n // GROUP))
    w = _MDR_W if ngroups0 >= _MDR_W else ngroups0
    nchunks = -(-ngroups0 // w)
    return w, nchunks, nchunks * w


# ---------------------------------------------------------------------------
# The exponent and scale of a level, as XLA's CPU backend computes them
# ---------------------------------------------------------------------------

_F32 = np.float32
_F32_MIN = np.finfo(np.float32).tiny
_F64_MIN = np.finfo(np.float64).tiny
# The Cephes coefficients of XLA's float32 log and exp.
_LOG_P = tuple(map(_F32, (7.0376836292E-2, -1.1514610310E-1,
                          1.1676998740E-1, -1.2420140846E-1,
                          1.4249322787E-1, -1.6668057665E-1,
                          2.0000714765E-1, -2.4999993993E-1,
                          3.3333331174E-1)))
_EXP_P = tuple(map(_F32, (1.9875691500E-4, 1.3981999507E-3,
                          8.3334519073E-3, 4.1665795894E-2,
                          1.6666665459E-1, 5.0000001201E-1)))
_C1, _C2 = _F32(0.693359375), _F32(-2.12194440e-4)


def _fma32(a, b, c) -> np.float32:
    """a * b + c rounded once to float32 (the product is exact in
    float64)."""
    return _F32(np.float64(a) * np.float64(b) + np.float64(c))


def _log_f32(x: float) -> np.float32:
    """XLA's float32 log of a scalar on the CPU: the Cephes polynomial,
    its terms fused, inputs below the smallest normal float giving
    -inf."""
    x = _F32(x)
    if not x >= _F32_MIN:
        return _F32(-np.inf)
    if x == np.inf:
        return x
    bits = int(np.array(x).view(np.int32))
    e = _F32((bits >> 23) - 0x7f) + _F32(1)
    m = np.array((bits & ~0x7f800000) | 0x3f000000, np.int32).view(_F32)[()]
    tmp = m if m < _F32(0.707106781186547524) else _F32(0)
    if tmp:
        e = e - _F32(1)
    m = (m - _F32(1)) + tmp
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y, y1, y2 = (_fma32(m, p[0], p[1]), _fma32(m, p[3], p[4]),
                 _fma32(m, p[6], p[7]))
    y, y1, y2 = (_fma32(y, m, p[2]), _fma32(y1, m, p[5]),
                 _fma32(y2, m, p[8]))
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2) * x3
    y = y + e * _C2
    m = m - x2 * _F32(0.5)
    m = m + y
    return m + e * _C1


def _exp_f32(x: float) -> np.float32:
    """XLA's float32 exp on the CPU: the Cephes polynomial on the input
    reduced by n log(2), subnormal results flushed to zero."""
    x = min(max(_F32(x), _F32(-87.8)), _F32(88.8))
    n = np.floor(_fma32(x, _F32(1.44269504088896341), _F32(0.5)))
    n = min(max(n, _F32(-127)), _F32(127))
    if n <= -127:
        return _F32(0)
    x = _fma32(-_C1, n, x)
    x = _fma32(-_C2, n, x)
    p = _EXP_P
    z = _fma32(x, p[0], p[1])
    for c in p[2:]:
        z = _fma32(z, x, c)
    z = _F32(1) + _fma32(z, x * x, x)
    out = _F32(np.float64(z) * 2.0 ** int(n))
    return out if abs(out) >= _F32_MIN or out == 0 else _F32(0)


def ceil_log2(amax: float, dtype) -> int:
    """``ceil(log2(max(amax, tiny)))`` of the level's dtype, as the JAX
    package computes it (``mdr.py:205``), saturated to int32."""
    if np.dtype(dtype) == np.float64:
        x = max(float(amax), _F64_MIN)
        v = math.log(x) * (1.0 / math.log(2.0)) if math.isfinite(x) \
            else math.inf
    else:
        v = float(_log_f32(max(_F32(amax), _F32_MIN))
                  * (_F32(1) / _F32(math.log(2.0))))
    if not math.isfinite(v):
        return _I32_MIN
    return int(math.ceil(v))


def exp2(k: int, dtype) -> float:
    """``jnp.exp2`` of the integer ``k`` in ``dtype``: ``exp(log(2) *
    k)``, not exact in general."""
    if np.dtype(dtype) == np.float64:
        try:
            out = math.exp(math.log(2.0) * float(k))
        except OverflowError:
            return math.inf
        return out if out >= _F64_MIN else 0.0
    return float(_exp_f32(_F32(math.log(2.0)) * _F32(k)))


def _wrap32(k: int) -> int:
    """``k`` as an int32 computation would leave it."""
    return (k + 2 ** 31) % 2 ** 32 - 2 ** 31


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LevelMetadata:
    n: int                      # number of coefficients in this level
    exponent: int               # the level's alignment exponent
    sq_errors: np.ndarray       # (B+1,) vol-weighted residual sq-sum after b
    max_errors: np.ndarray      # (B+1,) residual max after b planes
    stream_sizes: np.ndarray    # (B+1,) stored byte size of [sign, planes...]


@dataclasses.dataclass
class MDRMetadata:
    """Refactored-dataset metadata (reference MDRMetadata), in the JAX
    package's format: version 2 writes the lossless and encoding bytes
    and the stream sizes, which version 1 lacks."""
    shape: Tuple[int, ...]
    dtype: np.dtype
    num_bitplanes: int
    levels: List[LevelMetadata]
    lossless: int = LOSSLESS_ZSTD
    encoding: int = ENC_SIGN_MAGNITUDE

    def pack(self) -> bytes:
        out = bytearray()
        out += struct.pack("<BB", 2, len(self.shape))
        out += struct.pack(f"<{len(self.shape)}Q", *self.shape)
        out += struct.pack("<BB", 0 if self.dtype == np.float32 else 1,
                           self.num_bitplanes)
        out += struct.pack("<BB", self.lossless, self.encoding)
        out += struct.pack("<B", len(self.levels))
        for lm in self.levels:
            out += struct.pack("<Qi", lm.n, lm.exponent)
            out += lm.sq_errors.astype("<f8").tobytes()
            out += lm.max_errors.astype("<f8").tobytes()
            out += lm.stream_sizes.astype("<u4").tobytes()
        return bytes(out)

    @classmethod
    def unpack(cls, buf: bytes) -> "MDRMetadata":
        off = 0
        ver, ndim = struct.unpack_from("<BB", buf, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}Q", buf, off)
        off += 8 * ndim
        dt, B = struct.unpack_from("<BB", buf, off)
        off += 2
        lossless, encoding = LOSSLESS_NONE, ENC_SIGN_MAGNITUDE
        if ver >= 2:
            lossless, encoding = struct.unpack_from("<BB", buf, off)
            off += 2
        (nlev,) = struct.unpack_from("<B", buf, off)
        off += 1
        levels = []
        for _ in range(nlev):
            n, e = struct.unpack_from("<Qi", buf, off)
            off += 12
            sq = np.frombuffer(buf, "<f8", B + 1, off)
            off += 8 * (B + 1)
            mx = np.frombuffer(buf, "<f8", B + 1, off)
            off += 8 * (B + 1)
            if ver >= 2:
                sz = np.frombuffer(buf, "<u4", B + 1, off)
                off += 4 * (B + 1)
            else:
                sz = np.zeros(B + 1, np.uint32)
            levels.append(LevelMetadata(n, e, np.array(sq), np.array(mx),
                                        np.array(sz)))
        return cls(tuple(shape), np.dtype(np.float32 if dt == 0
                                          else np.float64), B, levels,
                   lossless=lossless, encoding=encoding)


# ---------------------------------------------------------------------------
# Per-level bitplane encode/decode
# ---------------------------------------------------------------------------

def _level_sizes(hier: Hierarchy) -> List[int]:
    sizes = [0] * (hier.L + 1)
    for (l, _, bs, _) in transform.block_specs(hier):
        sizes[l] += math.prod(bs)
    return sizes


def _level_flat(hier: Hierarchy, pyramid) -> List[torch.Tensor]:
    """Each level's coefficients as one vector, its (level, region) blocks
    one after the other (the 'BlockedInterleaver' role)."""
    per_level: Dict[int, list] = {l: [] for l in range(hier.L + 1)}
    for (l, _, _, _), b in zip(transform.block_specs(hier),
                               transform.pyramid_to_blocks(hier, pyramid)):
        per_level[l].append(b.reshape(-1))
    return [torch.cat(per_level[l]) for l in range(hier.L + 1)]


def _level_unflat(hier: Hierarchy, flats: Sequence[torch.Tensor]):
    offs = [0] * (hier.L + 1)
    blocks = []
    for (l, _, bs, _) in transform.block_specs(hier):
        size = math.prod(bs)
        blocks.append(flats[l][offs[l]:offs[l] + size].reshape(bs))
        offs[l] += size
    return transform.blocks_to_pyramid(hier, blocks)


def _level_max_volume(hier: Hierarchy, l: int) -> float:
    """Upper bound on the per-node volume weight of level ``l``, which
    scales the squared-error sums so that the s-norm estimator holds on
    nonuniform grids."""
    vol = 1.0
    for d in range(hier.ndim):
        if hier.shape[d] > 1:
            vol *= float(np.max(hier.dims[d][l].volumes))
    return vol


def _to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 bit patterns of their low 32 bits."""
    w = w & _U32
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _neg2bin(u: torch.Tensor) -> torch.Tensor:
    """Negabinary words (int64 in [0, 2^32)) -> signed values, int64 in
    the int32 range (reference negabinary2binary)."""
    return _to_i32((u ^ _NEG_MASK32) - _NEG_MASK32).to(torch.int64)


def _bin2neg(x: torch.Tensor) -> torch.Tensor:
    """Signed int64 values in the int32 range -> negabinary words in
    [0, 2^32) (reference binary2negabinary)."""
    return (((x & _U32) + _NEG_MASK32) & _U32) ^ _NEG_MASK32


def encode_level(flat: torch.Tensor, B: int,
                 encoding: int = ENC_SIGN_MAGNITUDE):
    """Align one level's coefficients to one exponent and slice them into
    bitplanes (``mdr.py:186``).

    Returns (exponent int, sign words (G,) int32, planes (B, G) int32,
    MSB first, sq_err (B+1,), max_err (B+1,)); words are int32 bit
    patterns.  ``sq_err`` is the unweighted squared residual sum.  With
    ``ENC_NEGABINARY`` the sign words are zero filler and the planes hold
    negabinary bits with two bits of headroom."""
    n = flat.numel()
    W, nchunks, ngroups = _mdr_layout(n)
    pad = ngroups * GROUP - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    dtype = np.dtype(str(flat.dtype).replace("torch.", ""))
    amax = float(flat.abs().max())
    if math.isnan(amax):
        raise ValueError("MDR input contains NaN values")
    e = -1000 if amax == 0 else ceil_log2(amax, dtype)
    e_scale = B if amax == 0 else e
    sq_err, max_err = [], []
    if encoding == ENC_NEGABINARY:
        k = _wrap32(B - _wrap32(e_scale + 2))
        scale = dtype.type(exp2(k, dtype))
        inv_scale = _scalar(dtype.type(exp2(-k, dtype)), flat)
        top = _scalar(2.0 ** 31 - 1, flat)
        fp = torch.clamp(flat * _scalar(scale, flat), -top, top)
        # a saturating float -> int32 cast, as XLA's
        signed = torch.trunc(fp).to(torch.int64).clamp(_I32_MIN,
                                                       2 ** 31 - 1)
        m = _bin2neg(signed)
        planes_c = transpose32_mid(_to_i32(m).reshape(nchunks, GROUP, W))
        sign_words = torch.zeros(ngroups, dtype=torch.int32,
                                 device=flat.device)
        for b in range(B + 1):
            mask = ((1 << (B - b)) - 1) if b < B else 0
            diff = _to_i32(signed - _neg2bin(m & (_U32 ^ mask)))
            resid = diff.to(flat.dtype).abs() * inv_scale
            sq_err.append(torch.sum(resid * resid))
            max_err.append(resid.max())
    else:
        k = _wrap32(B - e_scale)
        scale = dtype.type(exp2(k, dtype))
        inv_scale = _scalar(dtype.type(exp2(-k, dtype)), flat)
        mf = torch.minimum(torch.floor(flat.abs() * _scalar(scale, flat)),
                           _scalar(2.0 ** B - 1, flat))
        m = mf.to(torch.int64)
        del mf
        planes_c = transpose32_mid(_to_i32(m).reshape(nchunks, GROUP, W))
        neg = (flat < 0).to(torch.int64).reshape(nchunks, GROUP, W)
        shifts = torch.arange(GROUP, device=flat.device).reshape(1, GROUP, 1)
        sign_words = _to_i32((neg << shifts).sum(1)).reshape(-1)
        del neg
        for b in range(B + 1):
            resid = (m & ((1 << (B - b)) - 1)).to(flat.dtype) * inv_scale
            sq_err.append(torch.sum(resid * resid))
            max_err.append(resid.max())
    del m
    # keep B planes, MSB first: plane b (0 = MSB) is bit index B-1-b
    planes = planes_c[:, :B].flip(1).transpose(0, 1).reshape(B, ngroups)
    return e, sign_words, planes, torch.stack(sq_err), torch.stack(max_err)


def decode_level(sign_words: torch.Tensor, planes: torch.Tensor, e: int,
                 B: int, b_kept: int, n: int, dtype,
                 encoding: int = ENC_SIGN_MAGNITUDE) -> torch.Tensor:
    """Reconstruct one level from its first ``b_kept`` bitplanes
    (``mdr.py:282``); ``sign_words`` (G,) and ``planes`` (>= b_kept, G)
    int32 bit patterns."""
    W, nchunks, _ = _mdr_layout(n)
    dtype = np.dtype(dtype)
    tdt = TORCH_DTYPE[dtype]

    def unscale(vals, k):
        # ``vals / exp2(k)``: the JAX package casts a float64 scale to the
        # level's dtype, and where that cast is none divides by exp2(-k)
        if dtype == np.float64:
            return vals * _scalar(exp2(-k, dtype), vals)
        return vals / _scalar(dtype.type(exp2(k, np.float64)), vals)

    full = torch.zeros((nchunks, GROUP, W), dtype=torch.int32,
                       device=planes.device)
    for bit in range(GROUP):
        # the plane of LSB index `bit` is stored as plane B-1-bit
        k = B - 1 - bit
        if 0 <= k < b_kept:
            full[:, bit, :] = planes[k].reshape(nchunks, W)
    mt = transpose32_mid(full).to(torch.int64) & _U32
    del full
    if encoding == ENC_NEGABINARY:
        return unscale(_neg2bin(mt).to(tdt),
                       _wrap32(B - _wrap32(e + 2))).reshape(-1)[:n]
    m = mt.to(tdt)
    if 0 < b_kept < B:
        # midpoint correction for the dropped planes of nonzero values
        half = 2.0 ** (B - b_kept - 1)
        m = m + torch.where(mt > 0, half, 0.0).to(tdt)
    del mt
    vals = unscale(m, _wrap32(B - e))
    del m
    shifts = torch.arange(GROUP, device=vals.device).reshape(1, GROUP, 1)
    negbit = (sign_words.reshape(nchunks, 1, W) >> shifts) & 1
    return torch.where(negbit == 1, -vals, vals).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# Error estimators (reference MDR/ErrorEstimator/)
# ---------------------------------------------------------------------------

def _max_error_amp(ndim_effective: int, encoding: int) -> float:
    """L-infinity amplification of a per-coefficient error through
    recomposition (reference MaxErrorEstimatorOB), four times that for
    negabinary."""
    d = ndim_effective
    if d == 1:
        c = 1.0 + math.sqrt(3.0) / 2.0
    elif d == 2:
        c = 1.0 + 9.0 / 4.0
    elif d == 3:
        c = 1.0 + 21.0 * math.sqrt(3.0) / 8.0
    else:
        c = 1.0 + 3.0 ** d  # conservative fallback for d > 3
    if encoding == ENC_NEGABINARY:
        c *= 4.0
    return c


def estimate_error(md: MDRMetadata, counts: Sequence[int],
                   s: float = math.inf) -> float:
    """Error estimate for a retrieval plan ``counts`` (planes per level):
    for s = inf c(d) * sum_l max_err_l, else sqrt(sum_l 2^(2sl) sq_err_l)
    (the sums are stored scaled by the level's volume bound)."""
    d = sum(1 for x in md.shape if x > 1)
    if math.isinf(s):
        amp = _max_error_amp(d, md.encoding)
        return amp * sum(lm.max_errors[c]
                         for lm, c in zip(md.levels, counts))
    tot = sum((2.0 ** (2.0 * s * l)) * lm.sq_errors[c]
              for l, (lm, c) in enumerate(zip(md.levels, counts)))
    return math.sqrt(tot)


# ---------------------------------------------------------------------------
# Refactor / Request / Reconstruct
# ---------------------------------------------------------------------------

class MDRefactorResult:
    def __init__(self, metadata: MDRMetadata,
                 streams: List[List[bytes]]):
        self.metadata = metadata
        # streams[l][0] = sign stream; streams[l][1+b] = bitplane b (MSB first)
        self.streams = streams


def _stream_pack(data: bytes, lossless: int) -> bytes:
    """Per-stream lossless behind a one-byte flag, 0 raw and 1 zstd;
    streams that zstd does not shrink stay raw."""
    if lossless == LOSSLESS_ZSTD:
        import zstandard
        packed = zstandard.ZstdCompressor(level=3).compress(data)
        if len(packed) < len(data):
            return b"\x01" + packed
        return b"\x00" + data
    return data


def _stream_unpack(data: bytes, lossless: int, raw_size: int) -> bytes:
    if lossless == LOSSLESS_ZSTD:
        if data[:1] == b"\x01":
            import zstandard
            return zstandard.ZstdDecompressor().decompress(
                data[1:], max_output_size=raw_size)
        return data[1:]
    return data


def _device(device) -> torch.device:
    from ..api import resolve_device
    return resolve_device(device)


def _as_tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def mdr_refactor(hier: Hierarchy, v, B: int = NUM_BITPLANES,
                 lossless: int = LOSSLESS_ZSTD,
                 encoding: int = ENC_SIGN_MAGNITUDE,
                 device=None) -> MDRefactorResult:
    """Decompose and bitplane-refactor ``v`` (numpy or torch) on
    ``device`` (None: the card); each stream is zstd-compressed by default
    (``LOSSLESS_NONE`` stores them raw), and the metadata records the
    stored sizes so that requests price planes by their bytes."""
    v = _as_tensor(v, _device(device))
    dtype = np.dtype(str(v.dtype).replace("torch.", ""))
    with table_scope():
        flats = _level_flat(hier, transform.decompose(hier, v))
    del v
    sizes = _level_sizes(hier)
    levels_md, streams = [], []
    for l in range(hier.L + 1):
        e, sign_words, planes, sq, mx = encode_level(flats[l], B, encoding)
        flats[l] = None
        sign_np = sign_words.cpu().numpy()
        planes_np = planes.cpu().numpy()
        del sign_words, planes
        s = [_stream_pack(sign_np.astype("<i4").tobytes(), lossless)]
        for b in range(B):
            s.append(_stream_pack(planes_np[b].astype("<i4").tobytes(),
                                  lossless))
        streams.append(s)
        levels_md.append(LevelMetadata(
            n=sizes[l], exponent=int(e),
            sq_errors=sq.cpu().numpy().astype(np.float64)
            * _level_max_volume(hier, l),
            max_errors=mx.cpu().numpy().astype(np.float64),
            stream_sizes=np.array([len(x) for x in s], dtype=np.uint32)))
    md = MDRMetadata(shape=hier.shape, dtype=dtype, num_bitplanes=B,
                     levels=levels_md, lossless=lossless, encoding=encoding)
    return MDRefactorResult(md, streams)


def mdr_request(md: MDRMetadata, tol: float, s: float = math.inf,
                strategy: str = "greedy") -> List[int]:
    """Per-level plane counts for a target tolerance (reference
    SizeInterpreter family): ``"greedy"`` takes the next plane of the
    level with the largest remaining error per byte; ``"inorder"`` fetches
    levels coarsest first, each to exhaustion; ``"roundrobin"`` one plane
    a level in turn.  All stop at the same error target."""
    L = len(md.levels) - 1
    counts = [0] * (L + 1)
    B = md.num_bitplanes

    def plane_cost(l: int, b: int) -> float:
        sz = md.levels[l].stream_sizes
        if sz[1 + b] > 0:
            return float(sz[1 + b])
        return 4.0 * (-(-md.levels[l].n // GROUP))

    if strategy == "inorder":
        l = 0
        while estimate_error(md, counts, s) > tol:
            while l <= L and counts[l] >= B:
                l += 1
            if l > L:
                break
            counts[l] += 1
        return counts
    if strategy == "roundrobin":
        l = 0
        while estimate_error(md, counts, s) > tol:
            if all(c >= B for c in counts):
                break
            while counts[l] >= B:
                l = (l + 1) % (L + 1)
            counts[l] += 1
            l = (l + 1) % (L + 1)
        return counts
    if strategy != "greedy":
        raise ValueError(f"unknown size-interpreter strategy {strategy!r}")
    # Ranking by the remaining error (not by the next plane's own gain)
    # cannot starve a level whose largest value has a 0 in the next plane.
    while estimate_error(md, counts, s) > tol:
        best = None
        for l in range(L + 1):
            b = counts[l]
            if b >= B:
                continue
            if math.isinf(s):
                remaining = md.levels[l].max_errors[b]
            else:
                remaining = (2.0 ** (2.0 * s * l)) * md.levels[l].sq_errors[b]
            rate = remaining / plane_cost(l, b)
            if best is None or rate > best[0]:
                best = (rate, l)
        if best is None:
            break  # everything fetched
        counts[best[1]] += 1
    return counts


class MDReconstructor:
    """Progressive reconstructor that keeps what it has fetched
    (reference ComposedReconstructor), on ``device`` (None: the card)."""

    def __init__(self, hier: Hierarchy, md: MDRMetadata, device=None):
        self.hier = hier
        self.md = md
        self.device = _device(device)
        self.fetched: List[List[Optional[bytes]]] = [
            [None] * (md.num_bitplanes + 1) for _ in md.levels]
        self.counts = [0] * len(md.levels)

    def add_streams(self, level: int, streams: Dict[int, bytes]):
        """Feed retrieved streams as stored: index 0 the signs, 1 + b
        plane b."""
        for idx, data in streams.items():
            self.fetched[level][idx] = data

    def reconstruct(self, counts: Optional[List[int]] = None,
                    target_level: Optional[int] = None) -> np.ndarray:
        """Reconstruct from the fetched planes; ``target_level`` < L gives
        the dense grid of that level (adaptive resolution)."""
        hier, md = self.hier, self.md
        if counts is not None:
            self.counts = list(counts)
        B = md.num_bitplanes
        counts = self.counts
        lmax = hier.L if target_level is None else int(target_level)
        flats = []
        for l, lm in enumerate(md.levels):
            ngroups = _mdr_layout(lm.n)[2]
            sign = self.fetched[l][0]
            b_kept = counts[l]
            if sign is not None:
                raw = _stream_unpack(sign, md.lossless, 4 * ngroups)
                sign_w = np.frombuffer(raw, "<i4")
            else:
                sign_w = np.zeros(ngroups, np.int32)
            planes = np.zeros((max(b_kept, 1), ngroups), np.int32)
            for b in range(b_kept):
                data = self.fetched[l][1 + b]
                if data is None:
                    raise ValueError(
                        f"bitplane {b} of level {l} not retrieved")
                raw = _stream_unpack(data, md.lossless, 4 * ngroups)
                planes[b] = np.frombuffer(raw, "<i4")
            flats.append(decode_level(
                torch.from_numpy(sign_w.copy()).to(self.device),
                torch.from_numpy(planes).to(self.device), lm.exponent, B,
                b_kept, lm.n, md.dtype, md.encoding))
        with table_scope():
            pyr = _level_unflat(hier, flats)
            del flats
            out = transform.recompose_to_level(hier, pyr, lmax)
        return out.cpu().numpy()


def mdr_reconstruct(hier: Hierarchy, result: MDRefactorResult,
                    tol: float, s: float = math.inf,
                    target_level: Optional[int] = None,
                    device=None) -> np.ndarray:
    """One shot: request, feed and reconstruct."""
    counts = mdr_request(result.metadata, tol, s)
    rec = MDReconstructor(hier, result.metadata, device=device)
    for l, c in enumerate(counts):
        streams = {0: result.streams[l][0]}
        for b in range(c):
            streams[1 + b] = result.streams[l][1 + b]
        rec.add_streams(l, streams)
    return rec.reconstruct(counts, target_level=target_level)


# ---------------------------------------------------------------------------
# Domain-decomposed MDR (reference MDRHighLevel)
# ---------------------------------------------------------------------------

class MDRDataset:
    """A refactored dataset cut into independent slabs, each with its own
    metadata and streams.  L-infinity requests give each slab the whole
    budget; finite-s ones ``tol / sqrt(nblocks)``."""

    def __init__(self, shape, dd_dim: int, edges, results, device=None):
        self.shape = tuple(shape)
        self.dd_dim = dd_dim
        self.edges = list(edges)
        self.results = results  # List[MDRefactorResult]
        self.device = device

    def _block_tol(self, tol: float, s: float) -> float:
        if math.isinf(s) or len(self.results) <= 1:
            return tol
        return tol / math.sqrt(len(self.results))

    def request(self, tol: float, s: float = math.inf):
        bt = self._block_tol(tol, s)
        return [mdr_request(r.metadata, bt, s) for r in self.results]

    def reconstruct(self, tol: float, s: float = math.inf) -> np.ndarray:
        from .compressor import _cached_hierarchy
        bt = self._block_tol(tol, s)
        outs = []
        for r in self.results:
            hier = _cached_hierarchy(tuple(r.metadata.shape), None)
            outs.append(mdr_reconstruct(hier, r, bt, s, device=self.device))
        return np.concatenate(outs, axis=self.dd_dim)

    def retrieved_bytes(self, tol: float, s: float = math.inf) -> int:
        total = 0
        for r, counts in zip(self.results, self.request(tol, s)):
            for l, c in enumerate(counts):
                total += len(r.streams[l][0])
                total += sum(len(r.streams[l][1 + b]) for b in range(c))
        return total


def mdr_refactor_dd(data, max_block_bytes: int = 2 << 30,
                    B: int = NUM_BITPLANES,
                    lossless: int = LOSSLESS_ZSTD,
                    encoding: int = ENC_SIGN_MAGNITUDE,
                    device=None) -> MDRDataset:
    """Refactor in slabs of the largest dim, each at most
    ``max_block_bytes``."""
    from .compressor import _cached_hierarchy
    arr = np.asarray(data)
    dd_dim = int(np.argmax(arr.shape))
    nblocks = max(1, int(-(-arr.nbytes // max_block_bytes)))
    edges = np.linspace(0, arr.shape[dd_dim], nblocks + 1).astype(int)
    results = []
    for i in range(nblocks):
        sl = [slice(None)] * arr.ndim
        sl[dd_dim] = slice(edges[i], edges[i + 1])
        block = np.ascontiguousarray(arr[tuple(sl)])
        hier = _cached_hierarchy(block.shape, None)
        results.append(mdr_refactor(hier, block, B=B, lossless=lossless,
                                    encoding=encoding, device=device))
    return MDRDataset(arr.shape, dd_dim, edges, results, device=device)

"""Fixed-rate transform codec (ZFP-style), the alternate compressor type:
the port of ``mgard_tpu/models/zfp.py``.

Counterpart of the reference's external ZFP compressor
(include/mgard-x/ExternalCompressionLowLevel/ZFP/,
``compressor_type::ZFP``): 4^d blocks, block-local exponent alignment, an
integer decorrelating lifting transform per dimension, negabinary mapping,
and bitplane truncation at a fixed rate.  Every block emits exactly
``rate`` bitplanes, so the output is statically shaped (a dense
(rate, ngroups) plane matrix plus one exponent byte per block and one
MSB byte per coding unit) and needs no condense.  Streams are the JAX
package's byte for byte; they are not upstream zfp's
(``models/zfp_stream.py`` writes those).

Everything runs as torch ops on the device: uint32 words as int32 bit
patterns (``+ NBMASK`` wraps), arithmetic ``>>`` on int32, the shared
32x32 bit transpose ``ops/bitplane.transpose32``.  The block exponent
``ceil(log2(max|v|))`` and the scale ``exp2(25 - e)`` are XLA's CPU
answers, as in ``models/mdr.py``: XLA computes ``log2`` as a polynomial
times ``1 / log(2)`` and ``exp2(k)`` as ``exp(log(2) k)``, exact at no
power of two.  ``e`` comes from ``torch.frexp`` on the device, and only
the block maxima within 2^-10 of a power of two (where the two can
differ) are recomputed on the host with :func:`mdr.ceil_log2`; the
scales are :func:`mdr.exp2` of the few hundred distinct ``25 - e``,
gathered on the device; the decode divides by them.  The int32 exponent is
stored as int8 and wraps for float64 blocks beyond +-127, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import itertools
import struct
from typing import Tuple

import numpy as np
import torch

from ..api import resolve_device
from ..ops.bitplane import transpose32
from ..ops.quantize import TORCH_DTYPE
from .mdr import ceil_log2, exp2

__all__ = ["ZfpMeta", "compress_zfp", "decompress_zfp", "BLOCK"]

BLOCK = 4
NBMASK = -0x55555556          # 0xAAAAAAAA as an int32 bit pattern
# Fixed-point headroom: the per-dim lifting gain is < 2, so 3 transforms
# need ~3 guard bits on top of the sign bit and rounding slack.
_GUARD = 5
# Relative distance from a power of two within which the block exponent
# is recomputed on the host (XLA's log2 errs by a few ulps).
_NEAR_POW2 = 2.0 ** -10


def _degree_perm(ndim: int) -> np.ndarray:
    """Coefficient ordering by total degree (low-frequency first)."""
    idx = list(itertools.product(range(BLOCK), repeat=ndim))
    order = sorted(range(len(idx)), key=lambda k: (sum(idx[k]), idx[k]))
    return np.asarray(order, dtype=np.int64)


def _fwd_lift(x: torch.Tensor, axis: int) -> torch.Tensor:
    """zfp forward decorrelating lift along a length-4 axis (integer,
    exactly invertible)."""
    a, b, c, d = x.unbind(axis)
    a = a + d
    a = a >> 1
    d = d - a
    c = c + b
    c = c >> 1
    b = b - c
    a = a + c
    a = a >> 1
    c = c - a
    d = d + b
    d = d >> 1
    b = b - d
    d = d + (b >> 1)
    b = b - (d >> 1)
    return torch.stack([a, b, c, d], dim=axis)


def _inv_lift(x: torch.Tensor, axis: int) -> torch.Tensor:
    a, b, c, d = x.unbind(axis)
    b = b + (d >> 1)
    d = d - (b >> 1)
    b = b + d
    d = d << 1
    d = d - b
    c = c + a
    a = a << 1
    a = a - c
    b = b + c
    c = c << 1
    c = c - b
    d = d + a
    a = a << 1
    a = a - d
    return torch.stack([a, b, c, d], dim=axis)


@dataclasses.dataclass(frozen=True)
class ZfpMeta:
    shape: Tuple[int, ...]
    dtype: str
    rate: int  # bits per value == bitplanes kept

    def pack(self) -> bytes:
        out = struct.pack("<4sBB", b"ZFPT", len(self.shape), self.rate)
        out += struct.pack(f"<{len(self.shape)}Q", *self.shape)
        out += struct.pack("<B", 0 if self.dtype == "float32" else 1)
        return out

    @classmethod
    def unpack(cls, buf: bytes):
        magic, ndim, rate = struct.unpack_from("<4sBB", buf, 0)
        if magic != b"ZFPT":
            raise ValueError("not a ZFPT stream")
        shape = struct.unpack_from(f"<{ndim}Q", buf, 6)
        (dt,) = struct.unpack_from("<B", buf, 6 + 8 * ndim)
        return cls(tuple(int(s) for s in shape),
                   "float32" if dt == 0 else "float64", rate), 7 + 8 * ndim


def _blocked(shape):
    return tuple(-(-s // BLOCK) for s in shape)


def _wrap32(k: torch.Tensor) -> torch.Tensor:
    """int64 values as an int32 computation would leave them."""
    return ((k + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """A float tensor to int32 as XLA converts: NaN to 0, saturating
    outside the int32 range (an all-zero block scales 0 by an infinite
    scale)."""
    return torch.nan_to_num(x.to(torch.float64), nan=0.0).clamp(
        -2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def _exp2_table(k: torch.Tensor, dtype) -> torch.Tensor:
    """``exp2(k)`` in ``dtype`` for an int32 tensor ``k``, as XLA
    computes it (:func:`mdr.exp2`): one host value per distinct k,
    gathered on the device."""
    uniq, inv = torch.unique(k, return_inverse=True)
    with np.errstate(over="ignore"):     # an all-zero block's scale is inf
        table = [exp2(int(u), dtype) for u in uniq.cpu().tolist()]
    return torch.tensor(table, dtype=TORCH_DTYPE[np.dtype(dtype)],
                        device=k.device)[inv]


def _block_exponent(amax: torch.Tensor, dtype) -> torch.Tensor:
    """``ceil(log2(max(amax, tiny)))`` as int32, XLA's answer; -128 for
    an all-zero block."""
    x = amax.clamp_min(float(np.finfo(dtype).tiny))
    m, ex = torch.frexp(x)
    e = ex.to(torch.int32) - (m == 0.5).to(torch.int32)
    near = ((m < 0.5 * (1 + _NEAR_POW2)) | (m > 1 - _NEAR_POW2 / 2)
            | ~torch.isfinite(x)).nonzero().reshape(-1)
    if near.numel():
        vals, inv = np.unique(x[near].cpu().numpy(), return_inverse=True)
        fixed = np.asarray([ceil_log2(float(u), dtype) for u in vals],
                           dtype=np.int64)
        e[near] = _wrap32(torch.from_numpy(fixed[inv.reshape(-1)]).to(
            e.device))
    return torch.where(amax == 0, torch.full_like(e, -128), e)


def _encode_impl(v: torch.Tensor, rate: int):
    shape = tuple(v.shape)
    ndim = v.dim()
    dtype = np.dtype(str(v.dtype).replace("torch.", ""))
    nb = _blocked(shape)
    pad = []
    for d in range(ndim - 1, -1, -1):
        pad += [0, nb[d] * BLOCK - shape[d]]
    vp = torch.nn.functional.pad(v, pad)
    # gather into (nblocks, 4^d)
    resh = []
    for d in range(ndim):
        resh += [nb[d], BLOCK]
    order = list(range(0, 2 * ndim, 2)) + list(range(1, 2 * ndim, 2))
    nblocks = int(np.prod(nb))
    flat = vp.reshape(resh).permute(order).reshape(
        (nblocks,) + (BLOCK,) * ndim)
    del vp

    # per-block exponent and scale
    amax = flat.abs().reshape(nblocks, -1).amax(1)
    e = _block_exponent(amax, dtype)
    scale = _exp2_table(_wrap32(30 - _GUARD - e.to(torch.int64)), dtype)
    shp = (nblocks,) + (1,) * ndim
    q = _to_int32(torch.round(flat * scale.reshape(shp)))
    del flat

    for d in range(ndim):
        q = _fwd_lift(q, 1 + d)

    # degree ordering, negabinary, bit-transpose
    perm = torch.from_numpy(_degree_perm(ndim)).to(v.device)
    qf = q.reshape(nblocks, BLOCK ** ndim)[:, perm]
    u = (qf + NBMASK) ^ NBMASK
    vals = u.reshape(-1)  # block-major, degree-ordered
    ngroups = -(-vals.numel() // 32)
    vals = torch.nn.functional.pad(vals, (0, ngroups * 32 - vals.numel()))
    gpb = (BLOCK ** ndim) // 32 if ndim >= 3 else 1  # groups per block
    planes = transpose32(vals.reshape(ngroups, 32).T.contiguous())

    # Block floating point: planes are taken from each unit's own most
    # significant occupied bitplane downward.  2-D/1-D blocks are 16/4
    # values, so there a unit is a 32-value group.
    if gpb > 1:
        pb = planes.reshape(32, nblocks, gpb)
    else:
        pb = planes.reshape(32, ngroups, 1)
    nunits = pb.shape[1]
    occ = (pb != 0).any(2)                                   # (32, units)
    bit_idx = torch.arange(1, 33, dtype=torch.int32,
                           device=v.device)[:, None]
    m = torch.where(occ, bit_idx, 0).amax(0)                 # MSB count
    k = torch.arange(rate, dtype=torch.int32, device=v.device)[:, None,
                                                              None]
    src = m[None, :, None] - 1 - k                           # MSB first
    kept = torch.where(src >= 0, torch.gather(
        pb, 0, src.clamp(0, 31).expand(rate, nunits, pb.shape[2]).to(
            torch.int64)), 0)
    return e.to(torch.int8), m.to(torch.uint8), \
        kept.reshape(rate, nunits * pb.shape[2])


def _decode_impl(e: torch.Tensor, m: torch.Tensor, kept: torch.Tensor,
                 shape, rate: int, dtype) -> torch.Tensor:
    ndim = len(shape)
    nb = _blocked(shape)
    nblocks = int(np.prod(nb))
    nunits = m.shape[0]
    width = kept.shape[1] // nunits
    kb = kept.reshape(rate, nunits, width)
    mm = m.to(torch.int32)
    # scatter planes back to their absolute positions: plane row b holds
    # window slot (m-1-b); invert via gather over all 32 rows
    b = torch.arange(32, dtype=torch.int32, device=kept.device)[:, None,
                                                               None]
    slot = mm[None, :, None] - 1 - b
    full = torch.where((slot >= 0) & (slot < rate), torch.gather(
        kb, 0, slot.clamp(0, rate - 1).expand(32, nunits, width).to(
            torch.int64)), 0)
    total = nblocks * (BLOCK ** ndim)
    ngroups = -(-total // 32)
    vals = transpose32(full.reshape(32, ngroups)).T.reshape(-1)[:total]
    q = (vals ^ NBMASK) - NBMASK
    inv = np.empty(BLOCK ** ndim, dtype=np.int64)
    inv[_degree_perm(ndim)] = np.arange(BLOCK ** ndim)
    qb = q.reshape(nblocks, BLOCK ** ndim)[:, torch.from_numpy(inv).to(
        kept.device)].reshape((nblocks,) + (BLOCK,) * ndim)
    for d in range(ndim - 1, -1, -1):
        qb = _inv_lift(qb, 1 + d)
    scale = _exp2_table(_wrap32((30 - _GUARD) - e.to(torch.int64)), dtype)
    out = qb.to(TORCH_DTYPE[np.dtype(dtype)]) / scale.reshape(
        (nblocks,) + (1,) * ndim)
    # un-block
    out = out.reshape(tuple(nb) + (BLOCK,) * ndim)
    perm = []
    for d in range(ndim):
        perm += [d, ndim + d]
    out = out.permute(perm).reshape(tuple(n * BLOCK for n in nb))
    return out[tuple(slice(0, s) for s in shape)]


def _num_groups(shape) -> int:
    nblocks = int(np.prod(_blocked(shape)))
    return -(-nblocks * (BLOCK ** len(shape)) // 32)


def _num_units(shape) -> int:
    ndim = len(shape)
    nblocks = int(np.prod(_blocked(shape)))
    return nblocks if ndim >= 3 else _num_groups(shape)


def compress_zfp(data, rate: int = 8, device=None) -> bytes:
    """Fixed-rate compress: exactly ``rate`` bits per value plus the side
    bytes (scale exponent per block, MSB position per coding unit)."""
    arr = np.asarray(data)
    if arr.dtype not in (np.float32, np.float64):
        raise TypeError("float32/float64 only")
    if not 1 <= rate <= 32:
        raise ValueError("rate must be in [1, 32]")
    dev = resolve_device(device)
    e, m, kept = _encode_impl(torch.from_numpy(np.ascontiguousarray(arr)
                                               ).to(dev), rate)
    meta = ZfpMeta(arr.shape, str(arr.dtype), rate)
    return meta.pack() + e.cpu().numpy().tobytes() + \
        m.cpu().numpy().tobytes() + kept.cpu().numpy().astype("<i4").tobytes()


def decompress_zfp(buf: bytes, device=None) -> np.ndarray:
    meta, off = ZfpMeta.unpack(bytes(buf))
    dev = resolve_device(device)
    shape = meta.shape
    nblocks = int(np.prod(_blocked(shape)))
    ngroups = _num_groups(shape)
    nunits = _num_units(shape)
    e = np.frombuffer(buf, dtype=np.int8, count=nblocks, offset=off)
    m = np.frombuffer(buf, dtype=np.uint8, count=nunits,
                      offset=off + nblocks)
    kept = np.frombuffer(
        buf, dtype="<i4", count=meta.rate * ngroups,
        offset=off + nblocks + nunits).reshape(meta.rate, ngroups)
    out = _decode_impl(torch.from_numpy(e.copy()).to(dev),
                       torch.from_numpy(m.copy()).to(dev),
                       torch.from_numpy(kept.copy()).to(dev), shape,
                       meta.rate, meta.dtype)
    return out.cpu().numpy()

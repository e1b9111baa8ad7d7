"""Reader for refactored datasets written by the reference `mdr-x` tool
(the port of ``mgard_tpu/io/mdrx_compat.py``).

The reference's MDR-X executable persists a refactoring as a DIRECTORY
(src/mgard-x/Executables/mdr-x.cpp:185-220 write_mdr):

* ``header``   — the standard Metadata container (signature + proto);
* ``metadata`` — RefactoredMetadata flat little-endian struct
  (MDRHighLevel/MDRDataHighLevel.hpp:43-63): u64 num_subdomains, then
  per subdomain |u64 size| + MDRMetadata
  (RuntimeX/DataStructures/MDRMetadata.hpp:148-163): u64 num_levels,
  u64 num_bitplanes, f64 level_error_bounds[L+1], f64
  level_squared_errors[L+1][B+1], u64 level_sizes[L+1][B], u64
  level_num_elems[L+1];
* ``component_<subdomain>_<level>_<bitplane>`` — one RAW bitplane
  stream each (ComposedRefactor uses NullLevelCompressor, so no
  second-stage codec).

Stream format (GroupedBPEncoderGPU.hpp, T_bitplane = uint32,
num_batches_per_TB = 2): per 64-element thread-block the stream holds
4 u32 words — [plane word of batch 0, plane word of batch 1, slot, slot]
where the two extra slots carry the per-batch SIGN words in bitplane
component 0 only (every component has the same ``buffer_size(n) = 4 *
ceil(n/64)`` words).  A plane word's bit ``31 - j`` is element ``j``'s
bit of the MSB-first fixed-point magnitude ``fp = (uint)|ldexp(coeff, B
- exp)|`` with ``exp`` from ``frexp(max|coeff| of the level)``; a sign
word's bit ``31 - j`` is element ``j``'s sign bit.

Level coefficient order is the level linearization of the compressed
format's reorder=1, so reconstruction reuses
:func:`mgard_compat._x_linearized_to_corner` and the corner-layout
recompose, in float64 on the device, as the JAX package recomposes.  The
planes are unpacked as torch integer ops on the device.
"""

from __future__ import annotations

import math
import pathlib
import struct
from typing import List, Optional

import numpy as np
import torch

from ..api import resolve_device
from . import mgard_compat as mc

__all__ = ["read_mdrx_metadata", "mdrx_reconstruct"]


class MDRXLevel:
    def __init__(self, error_bound, squared_errors, sizes, num_elems):
        self.error_bound = float(error_bound)
        self.squared_errors = squared_errors
        self.sizes = sizes
        self.num_elems = int(num_elems)
        _, e = math.frexp(self.error_bound)
        self.exp = e                       # frexp exponent, refactor-side


class MDRXMetadata:
    def __init__(self, header, subdomains):
        self.header = header               # parsed proto header dict
        self.subdomains = subdomains       # list of list[MDRXLevel]


def read_mdrx_metadata(directory) -> MDRXMetadata:
    d = pathlib.Path(directory)
    header, _ = mc.read_container((d / "header").read_bytes())
    raw = (d / "metadata").read_bytes()
    off = 0
    (num_sub,) = struct.unpack_from("<Q", raw, off)
    off += 8
    subs = []
    for _ in range(int(num_sub)):
        (sz,) = struct.unpack_from("<Q", raw, off)
        off += 8
        blob = raw[off:off + int(sz)]
        off += int(sz)
        p = 0
        (L, B) = struct.unpack_from("<QQ", blob, p)
        p += 16
        L, B = int(L), int(B)
        bounds = np.frombuffer(blob, "<f8", L, p)
        p += 8 * L
        sqerr = np.frombuffer(blob, "<f8", L * (B + 1), p).reshape(L, B + 1)
        p += 8 * L * (B + 1)
        sizes = np.frombuffer(blob, "<u8", L * B, p).reshape(L, B)
        p += 8 * L * B
        nelems = np.frombuffer(blob, "<u8", L, p)
        subs.append([MDRXLevel(bounds[l], sqerr[l], sizes[l], nelems[l])
                     for l in range(L)])
    return MDRXMetadata(header, subs)


def _element_bits(words: torch.Tensor) -> torch.Tensor:
    """Bits of (ntb, 2) int32 words, element j of a word at bit 31 - j,
    in element order (big-endian ``unpackbits``)."""
    shifts = torch.arange(31, -1, -1, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shifts) & 1).reshape(-1)


def _decode_level(d: pathlib.Path, sub: int, level: int, lv: MDRXLevel,
                  B: int, k: int, device) -> torch.Tensor:
    """Decode the first ``k`` bitplanes of one level -> float64 coeffs.
    The fixed-point magnitude is kept as two 32-bit halves, so that its
    conversion to float64 rounds once, as numpy's uint64 conversion
    does."""
    n = lv.num_elems
    ntb = -(-n // 64)
    hi = torch.zeros(ntb * 64, dtype=torch.int64, device=device)
    lo = torch.zeros_like(hi)
    sign = torch.zeros(ntb * 64, dtype=torch.bool, device=device)
    for b in range(k):
        raw = np.frombuffer((d / f"component_{sub}_{level}_{b}"
                             ).read_bytes(), "<i4").reshape(ntb, 4)
        words = torch.from_numpy(raw.copy()).to(device)
        shift = B - 1 - b
        plane = _element_bits(words[:, 0:2]).to(torch.int64)
        if shift >= 32:
            hi |= plane << (shift - 32)
        else:
            lo |= plane << shift
        if b == 0:
            sign = _element_bits(words[:, 2:4]).bool()
    vals = (hi.to(torch.float64) * 2.0 ** 32 + lo.to(torch.float64)) \
        * math.ldexp(1.0, lv.exp - B)
    return torch.where(sign, -vals, vals)[:n]


def mdrx_reconstruct(directory, tol: Optional[float] = None,
                     num_bitplanes: Optional[List[int]] = None,
                     device=None) -> np.ndarray:
    """Reconstruct an `mdr-x`-written refactoring.

    ``tol``: L-inf target — per-level plane counts are chosen greedily
    from the recorded level error bounds (plane k of a level leaves at
    most ``ldexp(error_bound, -k)`` per coefficient, the MaxError
    estimator's model); ``num_bitplanes`` overrides with explicit
    per-level counts; both None loads every stored plane.
    Support matrix: uniform grids, MultiDim, MaxDim/Block domain
    decomposition, 2^k+1-compatible (sub)domain shapes (same hierarchy
    constraint as the compressed-buffer reader).
    """
    dev = resolve_device(device)
    d = pathlib.Path(directory)
    md = read_mdrx_metadata(d)
    header = md.header
    topo = header["domain"]["cartesian_grid_topology"]
    shape = tuple(int(x) for x in topo["shape"])
    dtype = (np.float32
             if header["dataset"]["type"] == mc.DATASET_FLOAT
             else np.float64)
    dd = header.get("domain_decomposition", {})
    subs = mc._x_subdomains(shape, dd)
    if len(subs) != len(md.subdomains):
        raise ValueError(
            f"metadata holds {len(md.subdomains)} subdomains but the "
            f"header's decomposition implies {len(subs)}")

    out = np.empty(shape, dtype=dtype)
    for sub_id, ((bshape, origin), levels) in enumerate(
            zip(subs, md.subdomains)):
        hier, l_target = mc._x_hierarchy(bshape)
        B = len(levels[0].sizes)
        counts = _plane_counts(levels, B, tol, num_bitplanes)
        flat = torch.cat([_decode_level(d, sub_id, l, lv, B, counts[l], dev)
                          for l, lv in enumerate(levels)])
        fine = mc._x_linearized_to_corner(flat, bshape, l_target)
        sl_out = tuple(slice(o, o + e) for o, e in zip(origin, bshape))
        out[sl_out] = mc._x_recompose(hier, fine).cpu().numpy().astype(
            dtype)
    return out


def _plane_counts(levels, B: int, tol, num_bitplanes) -> List[int]:
    if num_bitplanes is not None:
        if len(num_bitplanes) != len(levels):
            raise ValueError("one plane count per level required")
        return [min(int(k), B) for k in num_bitplanes]
    if tol is None:
        return [B] * len(levels)
    # Greedy (MaxErrorEstimator model): after k planes a level's
    # per-coefficient residual is < ldexp(error_bound, -k); L-inf
    # errors add across levels through the recomposition, so split the
    # budget evenly.
    per_level = float(tol) / max(len(levels), 1)
    counts = []
    for lv in levels:
        k = 0
        while k < B and math.ldexp(lv.error_bound, -k) > per_level:
            k += 1
        counts.append(k)
    return counts

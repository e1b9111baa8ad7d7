"""Self-describing container format (the port's own copy of
``mgard_tpu/io/format.py``; both packages read and write the same bytes).

A compressed buffer carries everything needed to decompress it — magic,
version, CRC32-protected header with dtype/shape/coords/error-control/
codec parameters, followed by the payload sections.  See doc/FORMAT.md.

Layout (little-endian):

    magic     : 8 bytes  b"MGARDTPU"
    version   : u16 major, u16 minor
    hdr_crc32 : u32      (CRC of the header block)
    hdr_size  : u64
    header    : hdr_size bytes (struct-packed, see below)
    payload   : sections, sizes recorded in header
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

MAGIC = b"MGARDTPU"
VERSION = (1, 0)

_DTYPES = {0: np.float32, 1: np.float64}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}


@dataclasses.dataclass
class Header:
    dtype: np.dtype
    shape: Tuple[int, ...]
    uniform: bool
    coordinates: Optional[List[np.ndarray]]  # None if uniform
    error_mode: int          # ErrorMode
    s: float                 # inf for L-infinity control
    tolerance: float         # the *absolute* tolerance used for quanta
    norm: float              # original-data norm (for REL bookkeeping)
    lossless: int            # Lossless
    n_levels: int
    section_sizes: Tuple[int, ...]  # payload section byte sizes
    # ROI-adaptive quantization parameters (0 block => no ROI).  The tile
    # map itself travels as an extra payload section.
    roi_block: int = 0
    roi_l_th: int = 0
    roi_scalar: int = 0
    # Domain decomposition (reference DomainDecomposer/Metadata):
    # 0 blocks => single domain.  Blocks split `dd_dim` into `dd_nblocks`
    # near-equal slabs (np.linspace edges — deterministic), each with its
    # own [exponents, words] section pair.
    dd_dim: int = 0
    dd_nblocks: int = 0
    # Decomposition type (config.Decomposition): 0 MultiDim, 1 SingleDim
    decomposition: int = 0
    # Coefficient stream layout: 0 = fine-grid physical order (reference
    # reorder=0; decode-friendly), 1 = region-blocked level-major.
    layout: int = 0
    # CRC32 of each payload section (integrity check on decode, same role
    # as the reference's header CRC but extended to the payload).
    section_crcs: Tuple[int, ...] = ()
    # Original shape before config.adjust_shape reinterpretation
    # (reference ShapeAdjustment.hpp); None when no adjustment was made.
    orig_shape: Optional[Tuple[int, ...]] = None
    # Explicit block edges along dd_dim for Variable domain decomposition
    # (reference domain_decomposition_type::Variable, Types.h:50 +
    # config.domain_decomposition_sizes); None = uniform np.linspace
    # slabs.
    dd_edges: Optional[Tuple[int, ...]] = None
    # Block (N-D) domain decomposition (reference
    # domain_decomposition_type::Block, DomainDecomposer.hpp:91-170):
    # per-dim block counts; blocks iterate in raster order, each dim
    # split at np.linspace(0, n, g+1).astype(int) edges.  None = not a
    # Block decomposition (dd_dim/dd_nblocks slab form applies).
    dd_grid: Optional[Tuple[int, ...]] = None
    # Codec chunk width (bitplane.CHUNK_GROUPS) used at encode time; the
    # stream layout depends on it, so decode must run with the same
    # value.  0 = the 2048 default (containers written before the knob
    # became tunable carry no field).
    chunk_groups: int = 0

    def pack(self) -> bytes:
        out = bytearray()
        out += struct.pack("<BB", _DTYPE_CODES[np.dtype(self.dtype)],
                           len(self.shape))
        out += struct.pack(f"<{len(self.shape)}Q", *self.shape)
        out += struct.pack("<B", 1 if self.uniform else 0)
        if not self.uniform:
            for c in self.coordinates:
                c = np.asarray(c, dtype=np.float64)
                out += struct.pack("<Q", len(c))
                out += c.tobytes()
        out += struct.pack("<Bddd", self.error_mode, self.s, self.tolerance,
                           self.norm)
        out += struct.pack("<BB", self.lossless, self.n_levels)
        out += struct.pack("<HBH", self.roi_block, self.roi_l_th,
                           self.roi_scalar)
        out += struct.pack("<BI", self.dd_dim, self.dd_nblocks)
        out += struct.pack("<BB", self.decomposition, self.layout)
        out += struct.pack("<H", len(self.section_sizes))
        out += struct.pack(f"<{len(self.section_sizes)}Q",
                           *self.section_sizes)
        crcs = self.section_crcs or (0,) * len(self.section_sizes)
        out += struct.pack(f"<{len(crcs)}I", *crcs)
        flags = ((1 if self.orig_shape is not None else 0)
                 | (2 if self.dd_edges is not None else 0)
                 | (4 if self.dd_grid is not None else 0)
                 | (8 if self.chunk_groups not in (0, 2048) else 0))
        out += struct.pack("<B", flags)
        if self.orig_shape is not None:
            out += struct.pack("<B", len(self.orig_shape))
            out += struct.pack(f"<{len(self.orig_shape)}Q",
                               *self.orig_shape)
        if self.dd_edges is not None:
            out += struct.pack("<I", len(self.dd_edges))
            out += struct.pack(f"<{len(self.dd_edges)}Q", *self.dd_edges)
        if self.dd_grid is not None:
            out += struct.pack("<B", len(self.dd_grid))
            out += struct.pack(f"<{len(self.dd_grid)}I", *self.dd_grid)
        if flags & 8:
            out += struct.pack("<I", self.chunk_groups)
        return bytes(out)

    @classmethod
    def unpack(cls, buf: bytes) -> "Header":
        off = 0

        def take(fmt):
            nonlocal off
            vals = struct.unpack_from(fmt, buf, off)
            off += struct.calcsize(fmt)
            return vals

        dtype_code, ndim = take("<BB")
        shape = take(f"<{ndim}Q")
        (uniform,) = take("<B")
        coordinates = None
        if not uniform:
            coordinates = []
            for _ in range(ndim):
                (n,) = take("<Q")
                c = np.frombuffer(buf, dtype="<f8", count=n, offset=off)
                off += 8 * n
                coordinates.append(np.asarray(c))
        error_mode, s, tolerance, norm = take("<Bddd")
        lossless, n_levels = take("<BB")
        roi_block, roi_l_th, roi_scalar = take("<HBH")
        dd_dim, dd_nblocks = take("<BI")
        decomposition, layout = take("<BB")
        (nsec,) = take("<H")
        section_sizes = take(f"<{nsec}Q")
        section_crcs = take(f"<{nsec}I")
        orig_shape = None
        dd_edges = None
        dd_grid = None
        chunk_groups = 0
        if off < len(buf):
            (flags,) = take("<B")
            if flags & 1:
                (ondim,) = take("<B")
                orig_shape = tuple(take(f"<{ondim}Q"))
            if flags & 2:
                (ne,) = take("<I")
                dd_edges = tuple(take(f"<{ne}Q"))
            if flags & 4:
                (gd,) = take("<B")
                dd_grid = tuple(take(f"<{gd}I"))
            if flags & 8:
                (chunk_groups,) = take("<I")
        return cls(orig_shape=orig_shape, dd_edges=dd_edges,
                   dd_grid=dd_grid, chunk_groups=chunk_groups,
                   dtype=np.dtype(_DTYPES[dtype_code]), shape=tuple(shape),
                   uniform=bool(uniform), coordinates=coordinates,
                   error_mode=error_mode, s=s, tolerance=tolerance,
                   norm=norm, lossless=lossless, n_levels=n_levels,
                   section_sizes=tuple(section_sizes),
                   roi_block=roi_block, roi_l_th=roi_l_th,
                   roi_scalar=roi_scalar, dd_dim=dd_dim,
                   dd_nblocks=dd_nblocks, decomposition=decomposition,
                   layout=layout, section_crcs=tuple(section_crcs))


def write_container(header: Header, sections: List[bytes]) -> bytes:
    header = dataclasses.replace(
        header, section_sizes=tuple(len(s) for s in sections),
        section_crcs=tuple(zlib.crc32(s) & 0xFFFFFFFF for s in sections))
    hdr = header.pack()
    out = bytearray()
    out += MAGIC
    out += struct.pack("<HH", *VERSION)
    out += struct.pack("<I", zlib.crc32(hdr) & 0xFFFFFFFF)
    out += struct.pack("<Q", len(hdr))
    out += hdr
    for s in sections:
        out += s
    return bytes(out)


def read_container(buf: bytes) -> Tuple[Header, List[bytes]]:
    if buf[:8] != MAGIC:
        raise ValueError("not an MGARDTPU container (bad magic)")
    major, minor = struct.unpack_from("<HH", buf, 8)
    if major > VERSION[0]:
        raise ValueError(f"unsupported container version {major}.{minor}")
    (crc,) = struct.unpack_from("<I", buf, 12)
    (hdr_size,) = struct.unpack_from("<Q", buf, 16)
    hdr = buf[24:24 + hdr_size]
    if (zlib.crc32(hdr) & 0xFFFFFFFF) != crc:
        raise ValueError("header CRC mismatch — corrupted buffer")
    header = Header.unpack(hdr)
    off = 24 + hdr_size
    if off + sum(header.section_sizes) > len(buf):
        raise ValueError("truncated buffer: payload shorter than header "
                         "declares")
    sections = []
    for i, size in enumerate(header.section_sizes):
        sec = buf[off:off + size]
        if header.section_crcs and header.section_crcs[i] != (
                zlib.crc32(sec) & 0xFFFFFFFF):
            raise ValueError(f"payload section {i} CRC mismatch — "
                             "corrupted buffer")
        sections.append(sec)
        off += size
    return header, sections

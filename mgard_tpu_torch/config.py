"""Configuration knobs of the compressor (the port's own copy of
``mgard_tpu/config.py``).

The enum values are wire values: the container header stores them as
bytes, so they must stay equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import enum


class Lossless(enum.IntEnum):
    """Lossless back end for the quantized coefficient stream."""
    BITPLANE = 0        # chunked bitplane codec (per-chunk exponents)
    BITPLANE_ZSTD = 1   # chunked bitplane + host zstd second stage
    HUFFMAN_ZLIB = 2    # reference-compatible CPU Huffman + zlib (host)
    HUFFMAN_ZSTD = 3    # reference-compatible CPU Huffman + zstd (host)
    NONE = 4            # raw quantized int32 stream
    BITPLANE_GROUP = 5  # per-32-value-group exponents
    BITPLANE_GROUP_ZSTD = 6  # per-group + host zstd second stage
    BITPLANE_LZ4 = 7    # chunked bitplane + host LZ4 second stage
    BITPLANE_GROUP_LZ4 = 8   # per-group + host LZ4 second stage

    @property
    def grouped(self) -> bool:
        """Per-32-value-group exponent variants."""
        return self in (Lossless.BITPLANE_GROUP,
                        Lossless.BITPLANE_GROUP_ZSTD,
                        Lossless.BITPLANE_GROUP_LZ4)

    @property
    def chunked(self) -> bool:
        """Per-chunk exponent variants (PYRAMID_SEG-capable)."""
        return self in (Lossless.BITPLANE, Lossless.BITPLANE_ZSTD,
                        Lossless.BITPLANE_LZ4)

    @property
    def second_stage(self):
        """Host second-stage codec applied to the bitplane sections:
        'zstd', 'lz4', or None."""
        if self in (Lossless.BITPLANE_ZSTD, Lossless.BITPLANE_GROUP_ZSTD):
            return "zstd"
        if self in (Lossless.BITPLANE_LZ4, Lossless.BITPLANE_GROUP_LZ4):
            return "lz4"
        return None


class Decomposition(enum.IntEnum):
    MULTIDIM = 0        # all dims per level
    SINGLEDIM = 1       # one dim at a time
    HYBRID = 2          # block-local levels then global; on the wire
    #                     values >= 2 encode 1 + num_local_levels


class Layout(enum.IntEnum):
    """Quantized-coefficient stream layout."""
    FINE = 0          # fine-grid physical order
    LEVEL_BLOCKS = 1  # region-blocked level-major
    PYRAMID = 2       # dense level arrays concatenated coarsest-first
    PYRAMID_SEG = 3   # PYRAMID with each level padded to whole codec
    #                   chunks (zero tails emit no stream rows); default


class ErrorMode(enum.IntEnum):
    ABS = 0
    REL = 1


@dataclasses.dataclass
class Config:
    lossless: Lossless = Lossless.BITPLANE
    decomposition: Decomposition = Decomposition.MULTIDIM
    num_local_levels: int = 1
    layout: Layout = Layout.PYRAMID_SEG
    # Domains under 2^22 values upgrade BITPLANE to its per-group
    # variant for ratio.
    adapt_lossless: bool = True
    zstd_level: int = 1
    adjust_shape: bool = False
    # Device-memory cap driving domain decomposition; 0 = the device's
    # free memory.
    max_memory_footprint: int = 0
    dd_sizes: object = None
    dd_dim: int = 0
    dd_method: str = "maxdim"
    # Bytes of input above which compress() splits the domain.
    max_block_bytes: int = 2 << 30
    block_edge: int = 256
    # Codec chunk width (groups per chunk) for new containers; 0 = the
    # default.  Containers record it, and decode honours the recorded one.
    chunk_groups: int = 0
    # Log bitmask of utils/log.py (INFO 1, TIME 2, DBG 4, WARN 8, ERR 16);
    # a nonzero value sets the process's level.
    log_level: int = 0

    def __post_init__(self):
        if self.log_level:
            from .utils import log as _log
            _log.level = self.log_level

    def replace(self, **kw) -> "Config":
        """A copy with the fields ``kw`` changed."""
        return dataclasses.replace(self, **kw)

    @classmethod
    def tuned(cls, shape, dtype, device=None) -> "Config":
        """The Config of the autotune table for this (device, dtype,
        size), ``device`` None meaning the card; the defaults where the
        table has no entry.  The knobs read at import are applied
        separately, by ``utils.autotune.apply_tuned``."""
        from .utils import autotune
        cfg = autotune.lookup(shape, dtype, device=device)
        return cfg if cfg is not None else cls()

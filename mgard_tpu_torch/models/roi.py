"""Region-of-interest adaptive compression (MGARD-ROI), the port of
``mgard_tpu/models/roi.py`` (reference ``include/adaptive_roi.hpp``,
``compress_roi`` in ``include/compress.tpp:84-236``).

A node map in {ROI, BUFFER_ZONE, BACKGROUND} gives BACKGROUND nodes a
``scalar`` times looser error budget.  The map is built from
block-pooled magnitudes and a one-tile dilation; the tile map travels in
the container (a byte per ``block``^d values) and background
coefficients are stored at their coarser quantum.  The container is the
JAX package's: three sections (per-group exponents, words, tiles) and
the header's ``roi_block``, ``roi_l_th`` and ``roi_scalar``.

The transform runs on the device with its kernels; the pooling, the
node map and the per-group codec are plain PyTorch on the device, as the
JAX package's are XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import ErrorMode, Lossless
from ..hierarchy import Hierarchy
from ..io import format as fmt
from ..ops import bitplane, transform
from ..ops.quantize import (TORCH_DTYPE, dequantize_blocks, round_quantize,
                            scale_blocks)
from ..ops.tridiag import table_scope

__all__ = ["ROI", "BUFFER_ZONE", "BACKGROUND", "default_scalar",
           "roi_tile_map", "node_map_from_tiles", "build_roi_map",
           "quantize_blocks_roi", "dequantize_blocks_roi", "compress_roi",
           "decompress_roi"]

ROI = 0
BUFFER_ZONE = 125
BACKGROUND = 255


def default_scalar(ndim: int) -> int:
    """Background error amplification (reference compress.tpp:219-226)."""
    return 25 if ndim >= 3 else 23


def _windows(hier: Hierarchy, block: int):
    return [block if hier.shape[d] > 1 else 1 for d in range(hier.ndim)]


def roi_tile_map(hier: Hierarchy, v: torch.Tensor, threshold: float,
                 block: int) -> torch.Tensor:
    """Tile map (uint8): a tile whose max |v| is at least ``threshold``
    times the whole max is ROI, its neighbours (a 3-wide window in each
    non-flat dim) BUFFER_ZONE, the rest BACKGROUND.  As the JAX package's
    ``reduce_window``, the pooling pads the high end only, with -inf."""
    absv = v.abs()
    window = _windows(hier, block)
    pads = []
    for d in reversed(range(hier.ndim)):
        pads += [0, (window[d] - hier.shape[d] % window[d]) % window[d]]
    padded = torch.nn.functional.pad(absv, pads, value=-math.inf)
    split = []
    for n, w in zip(padded.shape, window):
        split += [n // w, w]
    pooled = padded.reshape(split).amax(
        dim=tuple(range(1, 2 * hier.ndim, 2)))
    del padded
    roi_tiles = pooled >= absv.max() * threshold
    dil = roi_tiles
    for d in range(hier.ndim):
        if window[d] > 1:
            z = torch.zeros_like(dil.narrow(d, 0, 1))
            p = torch.cat([z, dil, z], d)
            n = dil.shape[d]
            dil = p.narrow(d, 0, n) | p.narrow(d, 1, n) | p.narrow(d, 2, n)
    tiles = torch.full(roi_tiles.shape, BACKGROUND, dtype=torch.uint8,
                       device=v.device)
    tiles[dil] = BUFFER_ZONE
    tiles[roi_tiles] = ROI
    return tiles


def node_map_from_tiles(hier: Hierarchy, tiles: torch.Tensor, block: int,
                        l_th: int) -> torch.Tensor:
    """Fine-grid node map from the tile map, with the nodes of levels
    below ``l_th`` raised from BACKGROUND to BUFFER_ZONE (the decoder
    rebuilds it from the stored tiles).  A node's date of birth
    (:meth:`Hierarchy.date_of_birth_grid`) is the max over dims of its
    per-dim ones, so it is below ``l_th`` where each per-dim one is."""
    out = tiles
    for d, w in enumerate(_windows(hier, block)):
        if w > 1:
            out = out.repeat_interleave(w, dim=d)
    umap = out[tuple(slice(0, s) for s in hier.shape)]
    young = None
    for d, dob in enumerate(hier.dates_of_birth):
        shp = [1] * hier.ndim
        shp[d] = len(dob)
        m = torch.from_numpy(dob < l_th).to(tiles.device).reshape(shp)
        young = m if young is None else young & m
    return torch.where(young & (umap == BACKGROUND),
                       torch.tensor(BUFFER_ZONE, dtype=torch.uint8,
                                    device=tiles.device), umap)


def build_roi_map(hier: Hierarchy, v: torch.Tensor, threshold: float,
                  block: int = 8, l_th: int = 2) -> torch.Tensor:
    """Fine-grid node map in {ROI, BUFFER_ZONE, BACKGROUND} (uint8)."""
    tiles = roi_tile_map(hier, v, threshold, block)
    return node_map_from_tiles(hier, tiles, block, l_th)


def _map_blocks(hier: Hierarchy, umap: torch.Tensor):
    """The node map restricted to each (level, region) block."""
    out = []
    for (l, _, _, pos) in transform.block_specs(hier):
        blk = umap
        for d in range(hier.ndim):
            fine = hier.level_indices(l, d)[np.asarray(pos[d])]
            blk = blk.index_select(d, torch.from_numpy(
                np.ascontiguousarray(fine, dtype=np.int64)).to(umap.device))
        out.append(blk)
    return out


def _background_scale(mb: torch.Tensor, scalar: int, dtype: torch.dtype):
    one = torch.ones((), dtype=dtype, device=mb.device)
    return torch.where(mb == BACKGROUND, one * scalar, one)


def quantize_blocks_roi(hier: Hierarchy, blocks, map_blocks, s: float,
                        tol: float, scalar: int, int_dtype=torch.int32):
    """The blocks' quantized coefficients, background ones at ``scalar``
    times the quantum (``roi.py:129``)."""
    return [round_quantize(x / _background_scale(mb, scalar, x.dtype),
                           int_dtype)
            for x, mb in zip(scale_blocks(hier, blocks, s, tol),
                             map_blocks)]


def dequantize_blocks_roi(hier: Hierarchy, qblocks, map_blocks, s: float,
                          tol: float, scalar: int, dtype):
    """Inverse of :func:`quantize_blocks_roi` (``roi.py:142``): each
    integer times its background scale, then its quanta."""
    tdt = TORCH_DTYPE[np.dtype(dtype)]
    return dequantize_blocks(
        hier, [q.to(tdt) * _background_scale(mb, scalar, tdt)
               for q, mb in zip(qblocks, map_blocks)], s, tol, dtype)


def compress_roi(data, tolerance: float, s: float = math.inf,
                 threshold: float = 0.5, block: int = 8, l_th: int = 2,
                 scalar: Optional[int] = None, coordinates=None,
                 device=None) -> bytes:
    """ROI-adaptive compress on ``device`` (None: the card): inside the
    detected regions the bound is ``tolerance``, outside it ``scalar *
    tolerance``.  The buffer decodes with :func:`mgard_tpu_torch.decompress`
    and with the JAX package's."""
    from ..api import resolve_device
    from .compressor import Compressor, _cached_hierarchy, coords_key
    dev = resolve_device(device)
    dtype = np.dtype(str(data.dtype).replace("torch.", "")) \
        if isinstance(data, torch.Tensor) else np.asarray(data).dtype
    v = Compressor.to_device(data, dtype, dev)
    hier = _cached_hierarchy(tuple(v.shape), coords_key(coordinates))
    scalar = scalar or default_scalar(hier.effective_ndim)
    tol = float(tolerance)
    with table_scope():
        tiles = roi_tile_map(hier, v, threshold, block)
        umap = node_map_from_tiles(hier, tiles, block, l_th)
        blocks = transform.pyramid_to_blocks(hier,
                                             transform.decompose(hier, v))
        del v
        qblocks = quantize_blocks_roi(hier, blocks, _map_blocks(hier, umap),
                                      s, tol, scalar)
    del blocks, umap
    flat = torch.cat([q.reshape(-1) for q in qblocks])
    del qblocks
    exponents, words, count = bitplane.encode_pergroup(flat)
    count = int(count)
    header = fmt.Header(
        chunk_groups=bitplane.CHUNK_GROUPS,
        dtype=dtype, shape=hier.shape, uniform=hier.uniform,
        coordinates=None if hier.uniform else hier.coordinates,
        error_mode=int(ErrorMode.ABS), s=float(s), tolerance=tol, norm=1.0,
        lossless=int(Lossless.BITPLANE_GROUP), n_levels=hier.L,
        section_sizes=(), roi_block=block, roi_l_th=l_th,
        roi_scalar=scalar)
    return fmt.write_container(header, [
        exponents.cpu().numpy().tobytes(),
        np.ascontiguousarray(words[:count].cpu().numpy(), "<i4").tobytes(),
        tiles.cpu().numpy().tobytes()])


def decompress_roi(header: fmt.Header, sections, device=None) -> np.ndarray:
    """Decode an ROI container (dispatched from ``decompress``)."""
    from ..api import resolve_device
    from .compressor import _cached_hierarchy, _corrupted, coords_key
    dev = resolve_device(device)
    hier = _cached_hierarchy(tuple(header.shape),
                             coords_key(header.coordinates))
    ndof = hier.ndof()
    if len(sections) != 3:
        raise _corrupted(f"an ROI container holds 3 sections, not "
                         f"{len(sections)}")
    exponents = np.frombuffer(sections[0], dtype=np.uint8)
    e = exponents.astype(np.int64)
    if len(exponents) * bitplane.GROUP < ndof or e.max(initial=0) > 32 \
            or 4 * int((e + (e > 0)).sum()) != len(sections[1]):
        raise _corrupted("ROI stream sizes do not match the header")
    words = np.frombuffer(sections[1], dtype="<i4").astype(np.int32)
    tile_shape = tuple(-(-n // w) for n, w in
                       zip(hier.shape, _windows(hier, header.roi_block)))
    if len(sections[2]) != math.prod(tile_shape):
        raise _corrupted("ROI tile map size does not match the header")
    tiles = torch.from_numpy(np.frombuffer(sections[2], dtype=np.uint8)
                             .reshape(tile_shape).copy()).to(dev)
    flat = bitplane.decode_pergroup(torch.from_numpy(exponents.copy()).to(dev),
                                    torch.from_numpy(words).to(dev), ndof)
    qblocks, off = [], 0
    for (_, _, bs, _) in transform.block_specs(hier):
        size = math.prod(bs)
        qblocks.append(flat[off:off + size].reshape(bs))
        off += size
    with table_scope():
        umap = node_map_from_tiles(hier, tiles, header.roi_block,
                                   header.roi_l_th)
        blocks = dequantize_blocks_roi(hier, qblocks, _map_blocks(hier, umap),
                                       header.s, header.tolerance,
                                       header.roi_scalar, header.dtype)
        del qblocks, umap
        out = transform.recompose(hier,
                                  transform.blocks_to_pyramid(hier, blocks))
    return out.cpu().numpy()

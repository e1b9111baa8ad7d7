"""High-level API: ``compress`` an array to a self-describing buffer and
``decompress`` it again (the port of ``mgard_tpu/api.py``).

An input is compressed as one domain or, as the JAX package decides, as
blocks: slabs of its largest dim when it is over
``Config.max_block_bytes`` or the device memory's estimate, the slabs of
``Config.dd_sizes`` (Variable decomposition), or the N-D blocks of
``Config(dd_method="block")``.  ``Config(adjust_shape=True)`` reshapes a
lopsided input first and records its shape in the container.

Both run on the GPU (``device=None`` means ``"cuda"``: every visible
card, blocks cycling over them) unless the caller asks for the CPU or
one device; without a card and without ``device="cpu"`` they raise.
Containers are the JAX package's: each package decodes the other's.
``decompress`` also reads the reference MGARD formats (the buffers of the
reference ``mgard`` and ``mgard-x`` tools, ``io/mgard_compat.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from .config import Config, Decomposition, ErrorMode, Layout, Lossless
from .io import format as fmt
from .models.compressor import (_HOST_LOSSLESS, Compressor,
                                _cached_compressor, _cached_hierarchy,
                                _corrupted, get_compressor,
                                norm_of)
from .parallel.domain import block_grid_blocks, local_abs_tol

__all__ = ["compress", "decompress", "release_cache", "resolve_device",
           "block_devices", "estimate_memory_footprint", "footprint_per_byte",
           "adjust_shape", "plan_blocks"]

# Blocks in flight in the multi-block pipeline (``mgard_tpu/api.py:181``):
# block i + 1's device work is queued before block i is read back.
_PIPELINE_DEPTH = int(os.environ.get("MGARD_TPU_PIPELINE_DEPTH", "2"))


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA, which must be present; otherwise as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mgard_tpu_torch runs on a CUDA device and none "
                           "is available; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def block_devices(device=None) -> list:
    """The devices that the blocks of one call cycle over (block i on
    ``devices[i % len(devices)]``, as ``_dev(i)`` in the JAX package):
    every visible card when ``device`` is None, else the one device."""
    if device is None and torch.cuda.device_count() > 1:
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [resolve_device(device)]


def _pipeline_depth(ndev: int) -> int:
    """Blocks in flight over ``ndev`` devices, as the JAX package counts
    them (``mgard_tpu/api.py:273``): at least one more than the devices,
    so that each stays busy while a block is read back."""
    return max(_PIPELINE_DEPTH, ndev + 1)


def _pipeline(blocks, start, finish, depth: int) -> None:
    """``finish(*start(i, origin, shape))`` for each block, in order, with
    up to ``depth`` blocks started and not yet finished: block i + 1's
    device work is queued before block i is read back."""
    pending = deque()
    for i, (origin, bshape) in enumerate(blocks):
        pending.append(start(i, origin, bshape))
        if len(pending) >= depth:
            finish(*pending.popleft())
    while pending:
        finish(*pending.popleft())


def _free_pinned() -> None:
    """Return the pinned host buffers that read-backs left in PyTorch's
    host cache to the system (a no-op before CUDA is initialized, and on
    a PyTorch that has no call for it)."""
    if not torch.cuda.is_initialized():
        return
    empty = getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                    None) or getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def release_cache() -> None:
    """Drop the cached compressors with their device tables, and release
    the device memory and pinned host memory that PyTorch's allocators
    cache (reference mgard_x::release_cache,
    include/compress_x.hpp:159-166)."""
    from .io import mgard_compat
    _cached_compressor.cache_clear()
    _cached_hierarchy.cache_clear()
    mgard_compat._reference_hierarchy.cache_clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
        _free_pinned()


# The JAX package's device bytes a compress needs, over the input's:
# input, pyramid, stream capacity, temporaries (3.9x, with a 1.15 safety
# factor).
FOOTPRINT_PER_BYTE = 3.9 * 1.15
# The port's encode peaks over the input's bytes where they pass that
# estimate, each measured on an H100 by chip_smoke.py (PERF.md section
# 6) on one shape and applied to every shape of its kind: a shape with a
# level in the per-dim form (a dim over MGARD_TPU_MATMUL_MAX_N nodes, or
# MGARD_TPU_SOLVER=scan), at the peak of the 1-D series of 280,953,867
# values, the highest of the long-dim shapes measured (an upper bound
# for the others); float64 data (512^3, the wide codec); and float32 at
# 512^3 on each flat stream: the SINGLEDIM and HYBRID decompositions
# (HYBRID at the higher of its peaks with one and two local levels) and
# the PYRAMID, FINE and LEVEL_BLOCKS layouts; and a host lossless's
# integer stream (HUFFMAN_*, NONE: the PYRAMID stream of PYRAMID_SEG).
# The planner counts the highest that applies with the JAX package's
# 1.15 margin.
PEAK_PER_BYTE = {"per_dim": 10.1215, "wide": 9.1495, "singledim": 5.5039,
                 "hybrid": 7.5251, "pyramid": 6.7386, "fine": 5.2500,
                 "level_blocks": 5.5327, "host": 5.8655}
_LAYOUT_PEAK = {Layout.PYRAMID: "pyramid", Layout.FINE: "fine",
                Layout.LEVEL_BLOCKS: "level_blocks"}


def footprint_per_byte(shape, dtype=np.float32,
                       config: Optional[Config] = None) -> float:
    """The planner's device bytes per input byte for this shape, dtype
    and configuration: the JAX package's factor for the segmented float32
    stream of the matmul-form transform, else 1.15 times the highest
    measured peak (:data:`PEAK_PER_BYTE`) that applies."""
    from .ops import transform
    cfg = config or Config()
    peaks = []
    if transform._SOLVER != "matmul" \
            or any(int(n) > transform._MATMUL_MAX_N for n in shape):
        peaks.append(PEAK_PER_BYTE["per_dim"])
    if np.dtype(dtype) == np.float64:
        peaks.append(PEAK_PER_BYTE["wide"])
    if cfg.decomposition == Decomposition.SINGLEDIM:
        peaks.append(PEAK_PER_BYTE["singledim"])
    elif cfg.decomposition == Decomposition.HYBRID:
        peaks.append(PEAK_PER_BYTE["hybrid"])
    elif cfg.layout in _LAYOUT_PEAK:
        peaks.append(PEAK_PER_BYTE[_LAYOUT_PEAK[cfg.layout]])
    if cfg.lossless in _HOST_LOSSLESS:
        peaks.append(PEAK_PER_BYTE["host"])
    return 1.15 * max(peaks) if peaks else FOOTPRINT_PER_BYTE


def estimate_memory_footprint(shape, dtype=np.float32,
                              config: Optional[Config] = None) -> int:
    """Device bytes needed to compress an array of this shape: the JAX
    package's estimate (:data:`FOOTPRINT_PER_BYTE` of the input's
    bytes), so that both packages make the same domain-decomposition
    decision, except where the port's measured peak is higher
    (:func:`footprint_per_byte`)."""
    n = int(np.prod([int(s) for s in shape]))
    item = np.dtype(dtype).itemsize
    factor = footprint_per_byte(shape, dtype, config)
    if factor == FOOTPRINT_PER_BYTE:    # in the JAX package's order
        return int(n * item * 3.9 * 1.15) + (32 << 20)
    return int(n * item * factor) + (32 << 20)


def _device_memory_budget(device: torch.device) -> int:
    """Bytes the device can give a compress: on CUDA the free bytes of
    ``mem_get_info`` plus those that PyTorch's allocator holds unused (so
    that the plan does not depend on what an earlier call left cached);
    on the CPU the JAX package's fallback of 12 GiB."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        cached = torch.cuda.memory_reserved(device) \
            - torch.cuda.memory_allocated(device)
        return int(free + cached)
    return 12 << 30


def plan_blocks(shape, dtype, cfg: Config, device=None) -> int:
    """Number of domain-decomposition slabs (``mgard_tpu/api.py:68``):
    split when the footprint estimate exceeds the device's memory (or
    ``cfg.max_memory_footprint``) or the input exceeds
    ``cfg.max_block_bytes``, into slabs that each fit."""
    nbytes = int(np.prod([int(x) for x in shape])) * np.dtype(dtype).itemsize
    budget = cfg.max_memory_footprint \
        or _device_memory_budget(resolve_device(device))
    est = estimate_memory_footprint(shape, dtype, cfg)
    nb = 1
    if est > budget:
        nb = max(2, int(-(-est // budget)))
    nb = max(nb, int(-(-nbytes // cfg.max_block_bytes)))
    return min(nb, int(shape[int(np.argmax(shape))]))


def adjust_shape(shape) -> tuple:
    """Rebalance a lopsided shape by moving the largest dim's prime
    factors onto the smallest dims (``mgard_tpu/api.py:148``); the
    element count and row-major order are unchanged."""
    shape = [int(x) for x in shape]
    max_d = int(np.argmax(shape))
    n = shape[max_d]
    factors = []
    z = 2
    while z * z <= n:
        if n % z == 0:
            factors.append(z)
            n //= z
        else:
            z += 1
    if n > 1:
        factors.append(n)
    shape[max_d] = 1
    for f in reversed(factors):
        shape[int(np.argmin(shape))] *= f
    return tuple(shape)


def compress(data, tolerance: float, s: float = math.inf,
             mode: str = "abs",
             coordinates: Optional[Sequence[np.ndarray]] = None,
             config: Optional[Config] = None, device=None) -> bytes:
    """Compress a float32 or float64 array (numpy or torch) with a
    guaranteed error bound ``tolerance``: ``max|data - out|`` for ``s =
    inf``, else the s-norm ``||data - out||_s`` (``s = 0`` the L2 norm on
    the grid, see ``ops/norms.py``).  ``mode="rel"`` scales the
    tolerance by ``max|data|`` (``s = inf``) or by ``sqrt(sum data^2)``
    (finite ``s``).  ``device``: None for every visible card, or one
    device ("cuda:1", "cpu").  The pinned host buffers that the call
    read back through are freed before it returns."""
    try:
        return _compress(data, tolerance, s, mode, coordinates, config,
                         device)
    finally:
        _free_pinned()


def _compress(data, tolerance, s, mode, coordinates, config, device
              ) -> bytes:
    devices = block_devices(device)
    if isinstance(data, torch.Tensor):
        dtype = np.dtype(str(data.dtype).replace("torch.", ""))
    else:
        data = np.asarray(data)
        dtype = data.dtype
    if dtype not in (np.float32, np.float64):
        raise TypeError("only float32/float64 data is supported")
    emode = ErrorMode.REL if mode == "rel" else ErrorMode.ABS
    cfg = config or Config()
    orig_shape = None
    if cfg.adjust_shape and coordinates is None:
        new_shape = adjust_shape(data.shape)
        if new_shape != tuple(data.shape):
            orig_shape = tuple(data.shape)
            data = data.reshape(new_shape)
    shape = tuple(int(x) for x in data.shape)
    args = (data, dtype, tolerance, s, emode, coordinates, cfg, devices)
    if cfg.dd_method == "block":
        grid = tuple(1 if n == 1 else max(1, -(-n // cfg.block_edge))
                     for n in shape)
        if int(np.prod(grid)) > 1:
            return _finish_adjust(_compress_blocknd(*args, grid), orig_shape)
    if cfg.dd_sizes is not None:
        sizes = [int(x) for x in cfg.dd_sizes]
        if sum(sizes) != shape[cfg.dd_dim]:
            raise ValueError("dd_sizes must sum to the dd_dim extent")
        edges = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        return _finish_adjust(_compress_multiblock(
            *args, len(sizes), dd_dim=cfg.dd_dim, edges=edges), orig_shape)
    nblocks = plan_blocks(shape, dtype, cfg, devices[0])
    if nblocks > 1:
        buf = _compress_multiblock(*args, nblocks)
    else:
        comp = get_compressor(shape, dtype, s=s, coordinates=coordinates,
                              config=cfg, device=devices[0])
        buf = comp.compress(data, tolerance, mode=emode)
    return _finish_adjust(buf, orig_shape)


def _finish_adjust(buf: bytes, orig_shape) -> bytes:
    """Record the shape that ``adjust_shape`` changed in the header."""
    if orig_shape is not None:
        header, sections = fmt.read_container(buf)
        header = dataclasses.replace(header, orig_shape=orig_shape)
        buf = fmt.write_container(header, sections)
    return buf


def _block_edges(n: int, nblocks: int) -> np.ndarray:
    return np.linspace(0, n, nblocks + 1).astype(int)


def _slabs(shape, dd_dim: int, edges) -> list:
    """(origin, shape) of each slab between ``edges`` along ``dd_dim``."""
    blocks = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        origin, bshape = [0] * len(shape), list(shape)
        origin[dd_dim], bshape[dd_dim] = int(lo), int(hi - lo)
        blocks.append((tuple(origin), tuple(bshape)))
    return blocks


def _blocknd_coords(coordinates, origin, bshape):
    if coordinates is None:
        return None
    return [np.asarray(c)[o:o + n]
            for c, o, n in zip(coordinates, origin, bshape)]


def _slices(origin, bshape) -> tuple:
    return tuple(slice(o, o + n) for o, n in zip(origin, bshape))


def _take(arr, origin, bshape):
    """One block of ``arr`` (numpy or torch), contiguous."""
    blk = arr[_slices(origin, bshape)]
    if isinstance(blk, torch.Tensor):
        return blk.contiguous()
    return np.ascontiguousarray(blk)


def _compress_multiblock(arr, dtype, tolerance, s, emode, coordinates, cfg,
                         devices, nblocks, dd_dim=None, edges=None) -> bytes:
    """Slab decomposition (``mgard_tpu/api.py:192``, reference
    DomainDecomposer MaxDim and Variable): the largest dim (or
    ``dd_dim``) cut at even ``edges`` (or the given ones, which the header
    then records)."""
    if dd_dim is None:
        dd_dim = int(np.argmax(arr.shape))
    if edges is None:
        edges = _block_edges(arr.shape[dd_dim], nblocks)
        dd_edges = None
    else:
        dd_edges = tuple(int(x) for x in edges)
    return _encode_blocks(arr, dtype, tolerance, s, emode, coordinates, cfg,
                          devices, _slabs(arr.shape, dd_dim, edges),
                          dd_dim=dd_dim, dd_edges=dd_edges)


def _compress_blocknd(arr, dtype, tolerance, s, emode, coordinates, cfg,
                      devices, grid) -> bytes:
    """Block (N-D) decomposition (``mgard_tpu/api.py:313``, reference
    domain_decomposition_type::Block): ``grid`` blocks in raster order;
    the header records the grid."""
    return _encode_blocks(arr, dtype, tolerance, s, emode, coordinates, cfg,
                          devices, block_grid_blocks(arr.shape, grid),
                          dd_grid=tuple(grid))


def _encode_blocks(arr, dtype, tolerance, s, emode, coordinates, cfg,
                   devices, blocks, **dd_fields) -> bytes:
    """Compress each (origin, shape) block on its own and write one
    container, as the JAX package does:

    * REL: each block's norm on its device, in the data's dtype, combined
      on the host (the max for s = inf, else the root of the sum of
      squares) -- no norm over the whole array on the host;
    * the error budget split by :func:`local_abs_tol`;
    * one lossless id (and codec width) for the container, block 0's;
    * pipelined (:func:`_pipeline`, ``Compressor.encode_async``).
    """
    nblocks, ndev = len(blocks), len(devices)
    abs_tol = float(tolerance)
    norm = 1.0
    if emode == ErrorMode.REL:
        vals = []
        for i, (origin, bshape) in enumerate(blocks):
            v = Compressor.to_device(_take(arr, origin, bshape), dtype,
                                     devices[i % ndev])
            vals.append(float(norm_of(v, s)))
            del v   # before the next block is copied in
        norm = (max(vals) if math.isinf(s)
                else float(np.sqrt(np.sum(np.square(vals)))))
        abs_tol *= norm
    block_tol = local_abs_tol(abs_tol, s, nblocks)

    origin0, bshape0 = blocks[0]
    probe = get_compressor(bshape0, dtype, s=s,
                           coordinates=_blocknd_coords(coordinates, origin0,
                                                       bshape0),
                           config=cfg, device=devices[0])
    bcfg = cfg.replace(lossless=probe.lossless, adapt_lossless=False)

    def start(i, origin, bshape):
        comp = get_compressor(
            bshape, dtype, s=s,
            coordinates=_blocknd_coords(coordinates, origin, bshape),
            config=bcfg, device=devices[i % ndev])
        return comp, comp.encode_async(_take(arr, origin, bshape),
                                       block_tol)

    sections = []
    _pipeline(blocks, start,
              lambda comp, handle: sections.extend(
                  comp.finalize_sections(handle)), _pipeline_depth(ndev))

    header = fmt.Header(
        chunk_groups=probe.chunk_groups, dtype=dtype,
        shape=tuple(int(x) for x in arr.shape),
        uniform=coordinates is None,
        coordinates=None if coordinates is None else [
            np.asarray(c) for c in coordinates],
        error_mode=int(emode), s=float(s), tolerance=block_tol, norm=norm,
        lossless=int(probe.lossless), n_levels=0, section_sizes=(),
        dd_nblocks=nblocks, decomposition=_wire_decomposition(cfg),
        layout=int(cfg.layout), **dd_fields)
    return fmt.write_container(header, sections)


def _wire_decomposition(cfg: Config) -> int:
    """The header's decomposition byte (``mgard_tpu/api.py:290``):
    HYBRID is written as 1 + its local level count."""
    if cfg.decomposition == Decomposition.HYBRID:
        return 1 + max(1, int(cfg.num_local_levels))
    return int(cfg.decomposition)


def _config_from_header(header: fmt.Header) -> Config:
    """The configuration a container's decomposition, layout and lossless
    bytes name (``mgard_tpu/api.py:540``): 2 and above are HYBRID with the
    byte less one local levels."""
    lossless = Lossless(header.lossless)
    if header.decomposition >= 2:
        return Config(decomposition=Decomposition.HYBRID,
                      num_local_levels=header.decomposition - 1,
                      layout=Layout(header.layout), lossless=lossless)
    return Config(decomposition=Decomposition(header.decomposition),
                  layout=Layout(header.layout), lossless=lossless)


def compressor_for(header: fmt.Header, device=None) -> Compressor:
    """The compressor that decodes a parsed single-domain container."""
    if header.dd_grid is not None or header.dd_nblocks:
        raise ValueError("a multi-block container has a compressor per "
                         "block; decode it with decompress()")
    if header.roi_block:
        raise ValueError("an ROI container has no compressor of its own; "
                         "decode it with decompress()")
    return get_compressor(header.shape, header.dtype, s=header.s,
                          coordinates=header.coordinates,
                          config=_config_from_header(header),
                          chunk_groups=header.chunk_groups or 2048,
                          device=resolve_device(device))


def _decompress_multiblock(header: fmt.Header, sections, device):
    """Mirror of :func:`_compress_multiblock`."""
    dd_dim, nblocks = header.dd_dim, header.dd_nblocks
    if dd_dim >= len(header.shape):
        raise _corrupted(f"slab dim {dd_dim} of a {len(header.shape)}-D "
                         "array")
    edges = (np.asarray(header.dd_edges, dtype=int)
             if header.dd_edges is not None else
             _block_edges(header.shape[dd_dim], nblocks))
    if len(edges) != nblocks + 1 or edges[0] != 0 \
            or edges[-1] != header.shape[dd_dim] \
            or np.any(np.diff(edges) <= 0):
        raise _corrupted(f"slab edges {tuple(edges)} do not cut dim "
                         f"{dd_dim} of {header.shape} into {nblocks}")
    return _decode_blocks(header, sections,
                          _slabs(header.shape, dd_dim, edges), device)


def _decompress_blocknd(header: fmt.Header, sections, device):
    """Mirror of :func:`_compress_blocknd`."""
    if len(header.dd_grid) != len(header.shape):
        raise _corrupted(f"block grid {header.dd_grid} of a "
                         f"{len(header.shape)}-D array")
    return _decode_blocks(header, sections,
                          block_grid_blocks(header.shape, header.dd_grid),
                          device)


def _decode_blocks(header: fmt.Header, sections, blocks, device
                   ) -> np.ndarray:
    """Decode each block into its place in one output array, pipelined as
    the encode is (``Compressor.decode_async``)."""
    if len(sections) % len(blocks):
        raise ValueError(
            f"block container holds {len(sections)} sections, not a "
            f"multiple of its {len(blocks)} blocks")
    per_block = len(sections) // len(blocks)
    bcfg = _config_from_header(header)
    devices = block_devices(device)
    ndev = len(devices)
    out = np.empty(header.shape, dtype=header.dtype)

    def start(i, origin, bshape):
        bcoords = _blocknd_coords(header.coordinates, origin, bshape)
        comp = get_compressor(bshape, header.dtype, s=header.s,
                              coordinates=bcoords, config=bcfg,
                              chunk_groups=header.chunk_groups or 2048,
                              device=devices[i % ndev])
        bh = dataclasses.replace(header, shape=bshape, coordinates=bcoords,
                                 dd_nblocks=0, dd_grid=None, dd_edges=None,
                                 orig_shape=None, section_sizes=())
        secs = sections[per_block * i:per_block * (i + 1)]
        return _slices(origin, bshape), comp.decode_async(bh, secs)

    def finish(sl, handle):
        (host,) = handle.wait()
        out[sl] = host.numpy()

    _pipeline(blocks, start, finish, _pipeline_depth(ndev))
    return out


def decompress(buf: bytes, device=None) -> np.ndarray:
    """Decompress a self-describing buffer written by either package, in
    its original shape.  ``device`` as in :func:`compress`; the pinned
    host buffers that the call read back through are freed before it
    returns."""
    try:
        return _decompress(buf, device)
    finally:
        _free_pinned()


def _decompress(buf, device) -> np.ndarray:
    buf = bytes(buf)
    if buf[:8] != fmt.MAGIC and buf[:5] == b"MGARD":
        from .io.mgard_compat import decompress_mgard
        return decompress_mgard(buf, device=device)
    header, sections = fmt.read_container(buf)
    if header.dd_grid is not None:
        out = _decompress_blocknd(header, sections, device)
    elif header.dd_nblocks:
        out = _decompress_multiblock(header, sections, device)
    elif header.roi_block:
        from .models.roi import decompress_roi
        out = decompress_roi(header, sections, device=device)
    else:
        out = compressor_for(header, device).decompress_parsed(header,
                                                              sections)
    if header.orig_shape is not None:
        out = out.reshape(header.orig_shape)
    return out

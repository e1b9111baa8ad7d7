"""Data-parallel compression over a list of devices (the port of
``mgard_tpu/parallel/sharded.py``).

The reference scales by domain decomposition: independent blocks per
GPU/rank, MPI only at the application layer (SURVEY.md section 2,
"Parallelism strategies"; doc/MGARD-X.md:285-288).  The JAX class is
single-controller: one process drives a mesh axis of devices with
``shard_map``.  Its counterpart here is one process that drives a list of
devices given by the caller: the blocks are split over them in contiguous
runs (block b on device ``b // (num_blocks / num_devices)``, as
``P(axis)`` places them), and each device runs the single-device
pipeline (``Compressor.encode_device`` / ``decode_device``) on its own
blocks.  The only cross-device steps are

  * the REL-mode global norm: each device's partial (the max of |v|, or
    the sum of squares in float64) reduced on the first device, as the
    JAX ``pmax``/``psum``, and
  * gathering the (tiny) per-block compressed sizes on the host.

Per-block sections go through the same ``finalize_sections`` as the
single-device compressor (second stages and host losslesses included),
so the container :meth:`ShardedCompressor.compress` writes is the
single-device multi-block one, byte for byte, decodable by the public
``decompress``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, ErrorMode
from ..models.compressor import get_compressor
from ..ops.quantize import TORCH_DTYPE
from .domain import local_abs_tol

__all__ = ["ShardedCompressor"]


class ShardedCompressor:
    """Data-parallel compressor: blocks on a leading axis, split over
    ``devices`` in contiguous runs, each block running the full
    single-device pipeline.

    ``devices``: the devices to use (None: every visible card).  The
    global array must be reshaped host-side (or via ``DomainDecomposer``)
    into ``(num_blocks, *block_shape)`` with ``num_blocks`` a multiple of
    the device count.
    """

    def __init__(self, devices: Optional[Sequence], block_shape:
                 Tuple[int, ...], dtype, s: float = math.inf,
                 config: Optional[Config] = None, coordinates=None):
        from ..api import block_devices, resolve_device
        devs = block_devices(None) if devices is None \
            else [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("ShardedCompressor needs at least one device")
        self.devices = devs
        self.config = config or Config()
        # The same cached compressors the single-device path would use
        # for one block, one a device.
        self.comps = [get_compressor(block_shape, dtype, s=s,
                                     coordinates=coordinates,
                                     config=self.config, device=d)
                      for d in devs]
        self.comp = self.comps[0]
        self.hier = self.comp.hier
        self.dtype = self.comp.dtype
        self.s = float(s)
        self.lossless = self.comp.lossless

    # ------------------------------------------------------------------
    def _placement(self, nblocks: int) -> List[int]:
        """The device index of each block: contiguous runs."""
        ndev = len(self.devices)
        if nblocks % ndev:
            raise ValueError(f"{nblocks} blocks do not split evenly over "
                             f"{ndev} devices")
        per = nblocks // ndev
        return [b // per for b in range(nblocks)]

    def shard_blocks(self, blocks_array) -> List[torch.Tensor]:
        """Place a (num_blocks, *block) array (numpy, torch or a sequence
        of blocks) on the devices: one tensor a block, on its device."""
        nblocks = len(blocks_array)
        tdt = TORCH_DTYPE[self.dtype]
        out = []
        for b, k in enumerate(self._placement(nblocks)):
            blk = blocks_array[b]
            t = blk.to(device=self.devices[k], dtype=tdt) \
                if isinstance(blk, torch.Tensor) else torch.from_numpy(
                    np.ascontiguousarray(blk, dtype=self.dtype)
                ).to(self.devices[k])
            if tuple(t.shape) != self.hier.shape:
                raise ValueError(f"expected blocks of {self.hier.shape}, "
                                 f"got {tuple(t.shape)}")
            out.append(t)
        return out

    def _norm(self, blocks: List[torch.Tensor]) -> float:
        """The REL norm: each device's partial over its blocks, reduced on
        the first device (``pmax`` of max|v| for s = inf, else the root of
        the ``psum`` of float64 sums of squares, cast to the data's
        dtype)."""
        place = self._placement(len(blocks))
        dev0 = self.devices[0]
        parts = []
        for k in range(len(self.devices)):
            mine = [v for v, d in zip(blocks, place) if d == k]
            if math.isinf(self.s):
                part = torch.stack([v.abs().max() for v in mine]).max()
            else:
                part = torch.stack([torch.sum(v.double() ** 2)
                                    for v in mine]).sum()
            parts.append(part.to(dev0))
        if math.isinf(self.s):
            return float(torch.stack(parts).max())
        total = torch.stack(parts).sum()
        return float(torch.sqrt(total).to(TORCH_DTYPE[self.dtype]))

    def _block_tol(self, blocks, tolerance: float, mode: ErrorMode):
        """(norm, absolute tolerance of each block)."""
        norm, abs_tol = 1.0, float(tolerance)
        if mode == ErrorMode.REL:
            norm = self._norm(blocks)
            abs_tol *= norm
        return norm, local_abs_tol(abs_tol, self.s, len(blocks))

    def encode(self, blocks_array, tolerance: float,
               mode: ErrorMode = ErrorMode.ABS):
        """Returns ``(exponents, words, counts, statuses, abs block
        tolerance)``: lists with one tensor a block, each on its block's
        device (for a host lossless, exponents are the flat integer
        streams and words the statuses, as ``encode_device`` gives
        them)."""
        v = self.shard_blocks(blocks_array)
        _, block_tol = self._block_tol(v, tolerance, mode)
        outs = [self.comps[k].encode_device(vb, block_tol)
                for vb, k in zip(v, self._placement(len(v)))]
        return (*(list(x) for x in zip(*outs)), block_tol)

    def decode(self, exponents, words, block_tol: float
               ) -> List[torch.Tensor]:
        """The blocks, one tensor a block on its device."""
        return [self.comps[k].decode_device(e, w, block_tol)
                for e, w, k in zip(exponents, words,
                                   self._placement(len(exponents)))]

    # ------------------------------------------------------------------
    # Container-producing high-level path (reference general_compress
    # over subdomains, CompressionHighLevel.hpp:79-136): every block's
    # encode is queued on its device first, then the host reads the
    # blocks back in order and assembles the same multi-block container
    # that the public ``decompress`` reads.
    # ------------------------------------------------------------------
    @classmethod
    def for_global(cls, devices: Optional[Sequence], global_shape, dtype,
                   s: float = math.inf, config: Optional[Config] = None,
                   nblocks: Optional[int] = None, coordinates=None):
        """Build a compressor for a global array split into equal slabs
        along its largest dim -- one (or more) per device.

        Nonuniform coordinates are supported when every slab sees the
        same spacing pattern along the split dim (the operator tables
        depend only on spacings); otherwise use the multi-block path
        (``mgard_tpu_torch.compress`` with ``config.dd_sizes``).
        """
        from ..api import block_devices
        global_shape = tuple(int(x) for x in global_shape)
        n_dev = len(block_devices(None) if devices is None else devices)
        nblocks = nblocks or n_dev
        dd_dim = int(np.argmax(global_shape))
        if global_shape[dd_dim] % nblocks:
            raise ValueError(
                f"dim {dd_dim} of {global_shape} not divisible into "
                f"{nblocks} equal slabs")
        block_shape = list(global_shape)
        block_shape[dd_dim] = global_shape[dd_dim] // nblocks
        bcoords = None
        if coordinates is not None:
            bcoords = [np.asarray(c, dtype=np.float64)
                       for c in coordinates]
            cs = bcoords[dd_dim]
            n_b = block_shape[dd_dim]
            h0 = np.diff(cs[:n_b])
            for b in range(1, nblocks):
                hb = np.diff(cs[b * n_b:(b + 1) * n_b])
                if not np.allclose(h0, hb, rtol=1e-12, atol=0.0):
                    raise ValueError(
                        "slabs see different spacing patterns along the "
                        "split dim; use mgard_tpu_torch.compress with "
                        "config.dd_sizes (multi-block) instead")
            bcoords[dd_dim] = cs[:n_b]
        sc = cls(devices, tuple(block_shape), dtype, s=s, config=config,
                 coordinates=bcoords)
        sc._placement(nblocks)
        sc.global_shape = global_shape
        sc.global_coordinates = coordinates
        sc.dd_dim = dd_dim
        sc.nblocks = nblocks
        return sc

    def compress(self, data, tolerance: float,
                 mode: ErrorMode = ErrorMode.ABS) -> bytes:
        """Compress a global array (numpy or torch) into a self-describing
        multi-block container decodable by ``mgard_tpu_torch.decompress``:
        the one ``mgard_tpu_torch.compress`` writes for the same slabs."""
        from ..api import _wire_decomposition
        from ..io import format as fmt

        if not hasattr(self, "global_shape"):
            raise ValueError("use ShardedCompressor.for_global(...) for "
                             "the container-producing path")
        if tuple(data.shape) != self.global_shape:
            raise ValueError(f"expected {self.global_shape}, got "
                             f"{tuple(data.shape)}")
        n_b = self.hier.shape[self.dd_dim]
        index = [slice(None)] * len(self.global_shape)
        slabs = []
        for b in range(self.nblocks):
            index[self.dd_dim] = slice(b * n_b, (b + 1) * n_b)
            slabs.append(data[tuple(index)])
        v = self.shard_blocks(slabs)
        del slabs
        norm, block_tol = self._block_tol(v, tolerance, mode)
        handles = []
        for b, k in enumerate(self._placement(self.nblocks)):
            comp = self.comps[k]
            handles.append((comp, comp.read_back_outputs(
                *comp.encode_device(v[b], block_tol))))
            v[b] = None     # the block's device copy goes with its encode
        sections: List[bytes] = []
        for comp, handle in handles:
            sections.extend(comp.finalize_sections(handle))

        coords = self.global_coordinates
        # n_levels = 0 as every multi-block container records it (the
        # JAX class writes the block hierarchy's L there, which no reader
        # reads)
        header = fmt.Header(
            chunk_groups=self.comp.chunk_groups,
            dtype=self.dtype, shape=self.global_shape,
            uniform=coords is None,
            coordinates=None if coords is None else [
                np.asarray(c) for c in coords],
            error_mode=int(mode), s=self.s,
            tolerance=block_tol, norm=norm,
            lossless=int(self.lossless), n_levels=0,
            section_sizes=(),
            dd_dim=self.dd_dim, dd_nblocks=self.nblocks,
            decomposition=_wire_decomposition(self.config),
            layout=int(self.config.layout))
        return fmt.write_container(header, sections)

    def roundtrip_step(self):
        """One encode + decode + error step over the devices (the JAX
        class's multi-chip dry run and scaling inner loop): ``step(blocks,
        block_tol)`` on :meth:`shard_blocks`' output returns (max |out -
        v| over all blocks, the total stream words), each a tensor on the
        first device."""
        dev0 = self.devices[0]

        def step(blocks: List[torch.Tensor], tol: float):
            place = self._placement(len(blocks))
            errs, words = [], []
            for vb, k in zip(blocks, place):
                comp = self.comps[k]
                e, w, c, _ = comp.encode_device(vb, tol)
                out = comp.decode_device(e, w, tol)
                errs.append((out - vb).abs().max().to(dev0))
                words.append(c.to(dev0))
            return torch.stack(errs).max(), torch.stack(words).sum()

        return step

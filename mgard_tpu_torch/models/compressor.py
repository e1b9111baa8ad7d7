"""The low-level compressor pipeline for one device and one domain: the
port of the MULTIDIM branches of ``mgard_tpu/models/compressor.py``,
with L-infinity (``s = inf``) or s-norm (finite ``s``) error control.

    decompose -> quantize + bitplane encode -> container sections

Two routes, chosen as the JAX package chooses them:

* **segmented** (the PYRAMID_SEG layout with a chunked lossless on
  float32 data): ``bitplane.encode_segments`` quantizes each pyramid
  level inside the codec kernels (K2-K4).  With finite s the levels are
  scaled by their per-node inverse quanta first (``scale_pyramid``) and
  the kernels multiply by 1.0; the decode returns int32 levels (K11 per
  level), which ``dequantize_pyramid`` scales back;
* **flat** (everything else the port has): ``_quantized_flat`` scales
  and rounds the coefficients into one integer stream, which one of
  three codecs encodes: the chunked ``bitplane.encode`` (K12, K11), the
  per-group ``encode_pergroup`` (the default under 2^22 values) or, for
  float64 data, the wide ``encode64``.  The stream is laid out as the
  configuration says: the MULTIDIM pyramid's levels one after the other
  (PYRAMID), in fine-grid order (FINE, ``transform.pyramid_to_fine``)
  or as (level, region) blocks (LEVEL_BLOCKS,
  ``transform.pyramid_to_blocks``); the SINGLEDIM decomposition's
  (level, dim) slabs (``ops/transform_singledim.py``); or the HYBRID
  decomposition's global part in fine order and then its block-local
  detail slabs (``ops/transform_hybrid.py``).

Device work is :meth:`Compressor.encode_device` and
:meth:`Compressor.decode_device`; host code reads back the variable-length
stream and assembles the container.  Read-backs run on a copy stream of
their own, into pinned host buffers, each after an event recorded behind
the work that made its tensors (:class:`ReadBack`), so that
:meth:`Compressor.encode_async` and :meth:`Compressor.decode_async`
return at once and the multi-block pipeline (``api.py``) reads block i
back while block i + 1 runs, one block's pinned buffers at a time.  A
one-domain decode reads its array back with a plain ``.cpu()`` into the
array it returns.  A round trip waits on the device three times: the
status, word count and exponents, the stream's words, and the decoded
array.

Every lossless of ``Config.Lossless`` runs.  The host losslesses
(``HUFFMAN_ZLIB``, ``HUFFMAN_ZSTD``, ``NONE``; ``compressor.py:495-553``)
take the flat integer stream of ``_quantized_flat`` read back through
:class:`ReadBack` and code it on the host (the Huffman codec of
``io/huffman_native.py``, then zlib or zstd; or the raw integers at the
narrowest width that holds them); the PYRAMID_SEG layout writes them the
identical-bytes PYRAMID stream.  The zstd and LZ4 second stages
(``compressor.py:453-463``, ``:600-611``) code the two bitplane sections
on the host after the read-back.  ``zstandard`` is imported where a zstd
stage runs, so that a machine without it raises ``ModuleNotFoundError``
there and nowhere else; no stage ever falls back to another.

Tables that the operators copy to the card (``tridiag.cached_tensor``,
S1's coefficients) stay there for the life of the hierarchy where they
fit the card beside a call's planned peak (:meth:`Compressor._resident`:
copied once, then read by every call); elsewhere they live for one
encode or decode (``tridiag.table_scope``), so that none stays on the
card after the call.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, Decomposition, ErrorMode, Layout, Lossless
from ..hierarchy import Hierarchy
from ..io import format as fmt
from ..ops import bitplane, transform, tridiag
from ..ops import transform_hybrid as th
from ..ops import transform_singledim as sd
from ..ops.quantize import (TORCH_DTYPE, dequantize_blocks,
                            dequantize_pyramid, inverse_quantum,
                            round_quantize, scale_blocks, scale_pyramid,
                            supremum_quantum)
from ..ops.tridiag import along_axis, table_scope
from ..utils import debug
from ..utils.log import count, span

_F64 = np.dtype(np.float64)
# Small domains get per-group exponents (compressor.py:79-86) ...
_TO_GROUPED = {Lossless.BITPLANE: Lossless.BITPLANE_GROUP,
               Lossless.BITPLANE_ZSTD: Lossless.BITPLANE_GROUP_ZSTD,
               Lossless.BITPLANE_LZ4: Lossless.BITPLANE_GROUP_LZ4}
# ... and float64 always rides the wide chunked codec (:87-95).
_TO_CHUNKED = {v: k for k, v in _TO_GROUPED.items()}
_HOST_LOSSLESS = (Lossless.HUFFMAN_ZLIB, Lossless.HUFFMAN_ZSTD,
                  Lossless.NONE)


def _raise_status(status: int) -> None:
    """Map device-side failure flags to typed errors."""
    if status == 1:
        raise OverflowError(
            "quantized coefficients exceed the integer range — the "
            "tolerance is too small for this data's dynamic range")
    if status == 2:
        raise ValueError("input contains NaN or Inf values")


def _corrupted(what: str):
    return ValueError(f"corrupted buffer: {what}")


@functools.lru_cache(maxsize=None)
def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream that reads results back from ``device``, one a device."""
    return torch.cuda.Stream(device)


class ReadBack:
    """Host copies of device tensors, read on the device's copy stream
    into pinned buffers after the event ``ready`` (by default one
    recorded now on the device's current stream, behind the work that
    made them), so that they wait for that work alone and not for work
    queued after it.  The copies are queued by the first :meth:`wait`,
    which then waits for them: a pipeline thus holds one block's pinned
    buffers at a time, and the caching host allocator hands the next
    block the same ones.  On the CPU the tensors are their own host
    copies."""

    def __init__(self, device: torch.device, tensors, ready=None):
        self.device, self.tensors, self.host = device, list(tensors), None
        if device.type != "cuda":
            self.ready, self.host = None, self.tensors
            return
        if ready is None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        self.ready = ready

    def wait(self) -> list:
        if self.host is None:
            stream = _copy_stream(self.device)
            stream.wait_event(self.ready)
            with torch.cuda.stream(stream):
                host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in self.tensors]
                for h, t in zip(host, self.tensors):
                    h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            done.synchronize()
            # the device tensors were held until their copies had read them
            self.host, self.tensors = host, None
        return self.host


class HostStream(ReadBack):
    """A host lossless's read-back handle: the flat integer stream and
    its status, which :meth:`Compressor.finalize_sections` codes on the
    host."""


def norm_of(v: torch.Tensor, s: float) -> torch.Tensor:
    """The norm that REL mode scales the tolerance by
    (``compressor.py:389``): max|v| for L-infinity control, else the root
    of the sum of squares, summed in float64 and cast to the data's
    dtype."""
    if math.isinf(s):
        return v.abs().max()
    return torch.sqrt(torch.sum(v.double() ** 2)).to(v.dtype)


class Compressor:
    """Error-bounded compressor for one fixed (shape, dtype, grid) on one
    device."""

    def __init__(self, hier: Hierarchy, dtype, s: float = math.inf,
                 config: Optional[Config] = None, chunk_groups: int = 0,
                 device="cuda"):
        self.hier = hier
        self.dtype = np.dtype(dtype)
        if self.dtype not in TORCH_DTYPE:
            raise TypeError("only float32/float64 data is supported")
        self.s = float(s)
        self.config = config or Config()
        self.device = torch.device(device)
        wide = self.dtype == _F64
        # Codec chunk width: a wire parameter the header records.
        self.chunk_groups = int(chunk_groups) \
            or int(self.config.chunk_groups) \
            or (bitplane.WIDE_CHUNK_GROUPS if wide else bitplane.CHUNK_GROUPS)
        lossless = self.config.lossless
        if self.config.adapt_lossless and hier.ndof() < (1 << 22) \
                and not wide:
            lossless = _TO_GROUPED.get(lossless, lossless)
        if wide:
            lossless = _TO_CHUNKED.get(lossless, lossless)
        self.lossless = lossless
        self._tables_resident = None    # decided at the first call
        self._seg_capable = (
            self.config.decomposition == Decomposition.MULTIDIM
            and self.config.layout == Layout.PYRAMID_SEG
            and not wide)
        self._seg_sizes = tuple(
            int(np.prod(hier.shapes[l])) for l in range(hier.L + 1))
        # Values in the flat stream: the pyramid's for the MULTIDIM
        # PYRAMID layouts, the hybrid stream's, else one a node.
        decomposition = self.config.decomposition
        self._nstream = sum(self._seg_sizes) \
            if decomposition == Decomposition.MULTIDIM \
            and self.config.layout in (Layout.PYRAMID, Layout.PYRAMID_SEG) \
            else hier.ndof()
        # HYBRID: block-local levels on a packed coarse grid, whose
        # hierarchy has explicit coordinates ({0, 2, 4, 6, 7} of each
        # block are not evenly spaced) (compressor.py:120-137)
        self._hybrid_k = 0
        if decomposition == Decomposition.HYBRID:
            k = self._hybrid_k = max(1, int(self.config.num_local_levels))
            coords = hier.coordinates
            self._hybrid_hc = Hierarchy(
                th.coarse_shape(hier.shape, k),
                coordinates=th.hybrid_coords(hier.shape, k, coords)[-1])
            self._hybrid_ops = None if hier.uniform \
                else th.hybrid_operators(hier.shape, k, coords)
            self._hybrid_vols = th.hybrid_volume_weights(hier.shape, k,
                                                         coords)
            self._nstream = th.hybrid_stream_size(hier.shape, k)

    def _codec(self, lossless: Lossless) -> str:
        """Which stream a lossless id means here (the order of
        ``_decode_impl_fn``): 'segmented', 'wide', 'grouped' or
        'chunked'."""
        if self._seg_capable and lossless.chunked:
            return "segmented"
        if self.dtype == _F64:
            return "wide"
        return "grouped" if lossless.grouped else "chunked"

    # ------------------------------------------------------------------
    # the flat stream
    # ------------------------------------------------------------------
    def _hybrid_quantum(self, tol: float) -> float:
        """The HYBRID L-infinity quantum, with the total (local + global)
        level count in the denominator (``compressor.py:151``), in float64
        as the JAX package forms it from its float64 tolerance (the
        division by the constant folded into a multiplication by its
        reciprocal, as ``flat_quantum`` folds it)."""
        d = self.hier.effective_ndim
        L_total = self._hybrid_hc.L + self._hybrid_k
        return np.float64(2.0 * float(tol)) \
            * (1.0 / ((L_total + 1) * (1 + 3.0 ** d)))

    def _hybrid_scale(self, pyr, details, tol: float, inverse: bool):
        """(De)scale the hybrid stream (``compressor.py:159``).  L-infinity:
        one quantum, its inverse (or itself) taken in float64 and cast to
        the data's dtype.  Finite s: the levelwise quanta of the coarse
        hierarchy at a tolerance scaled to the whole stream's count, and
        on the detail slab of local level i the scalar of total level
        ``Lc + k - i`` and the slab's per-dim volume vectors."""
        hc, k = self._hybrid_hc, self._hybrid_k
        cast = self.dtype.type       # pyr and details are in this dtype
        device = pyr[0].device
        if math.isinf(self.s):
            q = self._hybrid_quantum(tol)
            f = torch.tensor(cast(q if inverse else 1.0 / q), device=device)
            return [p * f for p in pyr], [x * f for x in details]
        n_total = float(self._nstream)
        tol_eff = float(tol) * math.sqrt(hc.ndof() / n_total)
        if inverse:
            pyr = dequantize_pyramid(hc, pyr, self.s, tol_eff, self.dtype)
        else:
            pyr = scale_pyramid(hc, pyr, self.s, tol_eff)
        out = []
        for i, x in enumerate(details):
            base = (2.0 ** (self.s * (hc.L + k - i))) * math.sqrt(n_total) \
                / (2.0 * float(tol))
            factor = torch.tensor(cast(base), device=device)
            x = x / factor if inverse else x * factor
            for dim, w in enumerate(self._hybrid_vols[i]):
                wt = along_axis(w, x, dim)
                x = x / wt if inverse else x * wt
            out.append(x)
        return pyr, out

    def _scaled_stream(self, v: torch.Tensor, tol: float) -> torch.Tensor:
        """Decompose and scale into the float stream of the configuration
        (``compressor.py:202-233``), not rounded."""
        hier, cfg = self.hier, self.config
        if cfg.decomposition == Decomposition.HYBRID:
            pyr, details = th.decompose_hybrid(
                self._hybrid_hc, v, self._hybrid_k, ops=self._hybrid_ops)
            pyr, details = self._hybrid_scale(pyr, details, tol, False)
            return th.flatten_hybrid(self._hybrid_hc, pyr, details)
        if cfg.decomposition == Decomposition.SINGLEDIM:
            coarse, slabs = sd.decompose_sd(hier, v)
            coarse, slabs = sd.scale_slabs(hier, coarse, slabs, self.s, tol)
            return sd.flatten_slabs(hier, coarse, slabs)
        pyr = transform.decompose(hier, v)
        if cfg.layout == Layout.LEVEL_BLOCKS:
            blocks = transform.pyramid_to_blocks(hier, pyr)
            del pyr
            return torch.cat([b.reshape(-1) for b in
                              scale_blocks(hier, blocks, self.s, tol)])
        spyr = scale_pyramid(hier, pyr, self.s, tol)
        del pyr
        if cfg.layout == Layout.FINE:
            return transform.pyramid_to_fine(hier, spyr).reshape(-1)
        return torch.cat([p.reshape(-1) for p in spyr])

    def _quantized_flat(self, v: torch.Tensor, tol: float):
        """Decompose + quantize -> (flat int32 stream, or int64 for
        float64 data; status int32 scalar) (``compressor.py:202``).

        The status guards read the float stream before the integer cast
        (which would saturate or wrap silently): 1 when max|scaled| is not
        below the ceiling (2^31 - 1, or 2^62 for float64; a NaN fails the
        test too), 2 when the input holds a NaN or an Inf."""
        scaledf = self._scaled_stream(v, tol)
        wide = scaledf.dtype == torch.float64
        flat = round_quantize(scaledf, torch.int64 if wide else torch.int32)
        limit = 2.0 ** 62 if wide else 2.0 ** 31 - 1
        amax = scaledf.abs().max().double()
        overflow = torch.logical_not(amax < limit).to(torch.int32)
        nonfinite = torch.logical_not(torch.isfinite(v).all()
                                      ).to(torch.int32) * 2
        return flat, torch.maximum(overflow, nonfinite)

    def _flat_to_array(self, flat: torch.Tensor, tol: float) -> torch.Tensor:
        """Dequantize + recompose a flat integer stream (inverse of
        :meth:`_quantized_flat`; ``compressor.py:258``)."""
        hier, cfg = self.hier, self.config
        if cfg.decomposition == Decomposition.HYBRID:
            # the global part is split in fine order after the cast to
            # the data's dtype, as the JAX package splits it
            pyr, details = th.unflatten_hybrid(
                self._hybrid_hc, flat.to(TORCH_DTYPE[self.dtype]),
                hier.shape, self._hybrid_k)
            pyr, details = self._hybrid_scale(pyr, details, tol, True)
            return th.recompose_hybrid(self._hybrid_hc, pyr, details,
                                       hier.shape, ops=self._hybrid_ops)
        if cfg.decomposition == Decomposition.SINGLEDIM:
            coarse, slabs = sd.unflatten_slabs(hier, flat)
            coarse, slabs = sd.unscale_slabs(hier, coarse, slabs, self.s,
                                             tol, self.dtype)
            return sd.recompose_sd(hier, coarse, slabs)
        if cfg.layout == Layout.FINE:
            # the integer stream is split with slices (K1 is float32 only)
            qpyr = transform.fine_to_pyramid(hier, flat.reshape(hier.shape))
        elif cfg.layout == Layout.LEVEL_BLOCKS:
            qblocks, off = [], 0
            for (_, _, bshape, _) in transform.block_specs(hier):
                size = math.prod(bshape)
                qblocks.append(flat[off:off + size].reshape(bshape))
                off += size
            blocks = dequantize_blocks(hier, qblocks, self.s, tol,
                                       self.dtype)
            return transform.recompose(
                hier, transform.blocks_to_pyramid(hier, blocks))
        else:
            qpyr, off = [], 0
            for shp, size in zip(hier.shapes, self._seg_sizes):
                qpyr.append(flat[off:off + size].reshape(shp))
                off += size
        pyr = dequantize_pyramid(hier, qpyr, self.s, tol, self.dtype)
        return transform.recompose(hier, pyr)

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _table_scope(self):
        """The table scope of one encode or decode: resident where this
        hierarchy's tables are admitted to the card (:meth:`_resident`;
        each such call adds one to the counter ``tables.resident``), else
        the call's own."""
        resident = self._resident()
        if resident:
            count("tables.resident")
        return table_scope(resident=resident)

    def _resident(self) -> bool:
        """Whether the tables that the transform copies to the card stay
        there for the life of the hierarchy, decided once per hierarchy
        (the HYBRID decomposition's coarse one), dtype and device, at the
        first call: where their bytes (``transform.table_bytes``), with
        a call's planned peak (``api.footprint_per_byte`` of the input's
        bytes), fit the memory the card has free, as the planner reads it.
        A hierarchy with no such tables never reads it."""
        if self._tables_resident is not None:
            return self._tables_resident
        hier = self._hybrid_hc if self._hybrid_k else self.hier
        every = self.config.decomposition == Decomposition.SINGLEDIM
        key = (self.dtype.str, str(self.device), every)
        cache = hier.__dict__.setdefault("_tables_resident", {})
        hit = cache.get(key)
        if hit is None:
            from .. import api
            tables = transform.table_bytes(hier, self.dtype.itemsize, every)
            hit = bool(tables) and tridiag._on_card(self.device)
            if hit:
                nbytes = self.hier.ndof() * self.dtype.itemsize
                peak = api.footprint_per_byte(self.hier.shape, self.dtype,
                                              self.config) * nbytes
                hit = tables + peak <= api._device_memory_budget(
                    self.device)
            cache[key] = hit
        self._tables_resident = hit
        return hit

    def encode_device(self, v: torch.Tensor, abs_tol: float):
        """decompose + quantize + encode on the device: ``(exponents,
        words, count, status)`` tensors, not yet read back; for a host
        lossless ``(flat integer stream, status)``."""
        with span("mgard.encode"), self._table_scope():
            if self.lossless in _HOST_LOSSLESS:
                return self._quantized_flat(v, abs_tol)
            return self._encode_device(v, abs_tol)

    def _encode_device(self, v: torch.Tensor, abs_tol: float):
        codec = self._codec(self.lossless)
        C = self.chunk_groups
        if codec == "segmented":
            pyr = transform.decompose(self.hier, v)
            if math.isinf(self.s):
                return bitplane.encode_segments(
                    pyr, float(inverse_quantum(self.hier, abs_tol)), C=C)
            return bitplane.encode_segments(
                scale_pyramid(self.hier, pyr, self.s, abs_tol), 1.0, C=C)
        flat, status = self._quantized_flat(v, abs_tol)
        if codec == "wide":
            out = bitplane.encode64(flat, C=C)
        elif codec == "grouped":
            out = bitplane.encode_pergroup(flat)
        else:
            out = bitplane.encode(flat, C=C)
        return (*out, status)

    def decode_device(self, exponents: torch.Tensor, words: torch.Tensor,
                      abs_tol: float, lossless: Optional[Lossless] = None
                      ) -> torch.Tensor:
        """Decode + dequantize + recompose on the device; ``lossless`` is
        the container's (default: this compressor's)."""
        lossless = self.lossless if lossless is None else lossless
        with span("mgard.decode"), self._table_scope():
            return self._decode_device(exponents, words, abs_tol, lossless)

    def _decode_device(self, exponents, words, abs_tol, lossless):
        codec = self._codec(lossless)
        C = self.chunk_groups
        if codec == "segmented":
            finite = not math.isinf(self.s)
            q = None if finite \
                else float(supremum_quantum(self.hier, abs_tol))
            segs = bitplane.decode_segments(exponents, words,
                                            self._seg_sizes, quantum=q, C=C)
            pyr = [seg.reshape(self.hier.shapes[l])
                   for l, seg in enumerate(segs)]
            if finite:
                pyr = dequantize_pyramid(self.hier, pyr, self.s, abs_tol,
                                         self.dtype)
            return transform.recompose(self.hier, pyr)
        if codec == "wide":
            flat = bitplane.decode64(exponents, words, self._nstream, C=C)
        elif codec == "grouped":
            flat = bitplane.decode_pergroup(exponents, words, self._nstream)
        else:
            flat = bitplane.decode(exponents, words, self._nstream, C=C)
        return self._flat_to_array(flat, abs_tol)

    def device_encode_fn(self):
        """The device encode pipeline ``(v, tol) -> (exponents, words,
        count, status)`` (``compressor.py:331``): the segmented, grouped,
        chunked or wide stream this compressor's lossless picks, the
        bitplane words also for a host lossless (its stages run after
        them)."""
        def encode(v: torch.Tensor, tol) -> Tuple[torch.Tensor, ...]:
            with self._table_scope():
                return self._encode_device(v, float(tol))
        return encode

    def device_decode_fn(self):
        """The device decode pipeline ``(exponents, words, tol) ->
        array`` (``compressor.py:338``) of this compressor's lossless."""
        def decode(exponents: torch.Tensor, words: torch.Tensor, tol
                   ) -> torch.Tensor:
            return self.decode_device(exponents, words, float(tol))
        return decode

    # ------------------------------------------------------------------
    # host-facing API
    # ------------------------------------------------------------------
    def read_back_outputs(self, *outputs):
        """The handle that :meth:`finalize_sections` takes, from the
        outputs of :meth:`encode_device`: the read-back of the exponents,
        word count and status, behind an event recorded now, and the
        words, whose length is the count; for a host lossless a
        :class:`HostStream`."""
        if self.lossless in _HOST_LOSSLESS:
            return HostStream(self.device, outputs)
        exponents, words, count, status = outputs
        small = torch.stack([count.to(torch.int64), status.to(torch.int64)])
        return words, ReadBack(self.device, [exponents, small])

    def finalize_sections(self, handle) -> List[bytes]:
        """Wait for a handle's read-back and build the container sections:
        [exponent bytes, word bytes], each through the second stage if the
        lossless has one; for a host lossless the one host-coded section.
        Waits on the handle's copies, not on the device."""
        if isinstance(handle, HostStream):
            flat, status = handle.wait()
            _raise_status(int(status))
            return [self._host_lossless_encode(flat.numpy())]
        words, small = handle
        exp_host, count_status = small.wait()
        count, status = (int(x) for x in count_status.tolist())
        _raise_status(status)
        debug.check(0 <= count <= words.numel(),
                    f"encode word count {count} exceeds capacity "
                    f"{words.numel()}")
        if not 0 <= count <= words.numel():
            raise RuntimeError(f"encode word count {count} exceeds capacity "
                               f"{words.numel()}")
        (words_host,) = ReadBack(self.device, [words[:count]],
                                 small.ready).wait()
        exp_np = exp_host.numpy()
        # Trailing all-zero chunks (groups) carry no stream words; drop
        # their exponent bytes (the decoder zero-fills back to the full
        # count).
        nz = np.nonzero(exp_np)[0]
        exp_np = exp_np[:int(nz[-1]) + 1] if len(nz) else exp_np[:0]
        exp_bytes = exp_np.tobytes()
        word_bytes = np.ascontiguousarray(words_host.numpy(), "<i4").tobytes()
        stage = self.lossless.second_stage
        if stage == "zstd":
            import zstandard
            cctx = zstandard.ZstdCompressor(level=self.config.zstd_level)
            exp_bytes = cctx.compress(exp_bytes)
            word_bytes = cctx.compress(word_bytes)
        elif stage == "lz4":
            from ..io.lz4_native import lz4_compress
            exp_bytes = lz4_compress(exp_bytes)
            word_bytes = lz4_compress(word_bytes)
        return [exp_bytes, word_bytes]

    def sections_from_outputs(self, *outputs) -> List[bytes]:
        """Read back the outputs of :meth:`encode_device` and build the
        container sections, at once."""
        return self.finalize_sections(self.read_back_outputs(*outputs))

    def encode_async(self, v, abs_tol: float):
        """Queue the device encode of ``v`` (numpy or torch) and return
        at once: the handle that :meth:`finalize_sections` takes."""
        return self.read_back_outputs(
            *self.encode_device(self._as_tensor(v), abs_tol))

    @staticmethod
    def to_device(v, dtype, device) -> torch.Tensor:
        """``v`` (numpy or torch) as a tensor of ``dtype`` on ``device``."""
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=TORCH_DTYPE[np.dtype(dtype)])
        return torch.from_numpy(np.ascontiguousarray(v, dtype=dtype)
                                ).to(device)

    def _as_tensor(self, v) -> torch.Tensor:
        t = self.to_device(v, self.dtype, self.device)
        if tuple(t.shape) != self.hier.shape:
            raise ValueError(f"expected shape {self.hier.shape}, got "
                             f"{tuple(t.shape)}")
        return t

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        """:func:`norm_of` at this compressor's ``s``."""
        return norm_of(v, self.s)

    def compress(self, v, tolerance: float,
                 mode: ErrorMode = ErrorMode.ABS) -> bytes:
        v = self._as_tensor(v)
        norm = 1.0
        abs_tol = float(tolerance)
        if mode == ErrorMode.REL:
            norm = float(self.norm(v))
            abs_tol = float(tolerance) * norm
        with span("compress (device)", v.numel() * v.element_size()):
            sections = self.sections_from_outputs(
                *self.encode_device(v, abs_tol))
        header = fmt.Header(
            chunk_groups=self.chunk_groups,
            dtype=self.dtype, shape=self.hier.shape,
            uniform=self.hier.uniform,
            coordinates=None if self.hier.uniform else self.hier.coordinates,
            error_mode=int(mode), s=self.s, tolerance=abs_tol, norm=norm,
            lossless=int(self.lossless), n_levels=self.hier.L,
            section_sizes=(),
            decomposition=(1 + self._hybrid_k if self._hybrid_k
                           else int(self.config.decomposition)),
            layout=int(self.config.layout))
        return fmt.write_container(header, sections)

    # ------------------------------------------------------------------
    # host losslesses (compressor.py:495-553)
    # ------------------------------------------------------------------
    def _host_lossless_encode(self, flat_np: np.ndarray) -> bytes:
        """Code the read-back integer stream with the host lossless.
        HUFFMAN_ZLIB / HUFFMAN_ZSTD: the reference CPU back end's Huffman
        codec, then zlib (level 6) or zstd (``zstd_level``) of {tree,
        hit words, misses}, behind ``<QQQ>`` (tree size, hit bits, miss
        size).  NONE: the raw little-endian integers at the narrowest
        width that holds the stream, behind its code byte (2, 1, 0, 3 for
        i1, i2, i4, i8), so each block of a multi-block container picks
        its own."""
        if self.lossless == Lossless.NONE:
            amax = int(np.abs(flat_np).max()) if flat_np.size else 0
            for code, dt, top in ((2, "<i1", 127), (1, "<i2", 32767),
                                  (0, "<i4", 2 ** 31 - 1)):
                if amax <= top:
                    break
            else:
                code, dt = 3, "<i8"
            return bytes([code]) + flat_np.astype(dt).tobytes()
        if self.lossless == Lossless.HUFFMAN_ZSTD:
            import zstandard    # before the Huffman pass, which needs it
            pack = zstandard.ZstdCompressor(
                level=self.config.zstd_level).compress
        else:
            pack = functools.partial(zlib.compress, level=6)
        from ..io.huffman_native import huffman_encode
        tree, hit, hit_bits, miss = huffman_encode(flat_np.astype(np.int64))
        return struct.pack("<QQQ", len(tree), hit_bits, len(miss)) \
            + pack(tree + hit + miss)

    def _host_lossless_decode(self, payload: bytes,
                              lossless: Lossless) -> np.ndarray:
        """The integer stream of a host-lossless section: int32 for
        float32 data, int64 for float64."""
        n = self._nstream
        int_dt = np.int64 if self.dtype == _F64 else np.int32
        if lossless == Lossless.NONE:
            widths = {0: "<i4", 1: "<i2", 2: "<i1", 3: "<i8"}
            if not payload or payload[0] not in widths:
                raise _corrupted("unknown integer width code")
            dt = np.dtype(widths[payload[0]])
            if len(payload) - 1 != n * dt.itemsize:
                raise _corrupted("stream size does not match the header")
            return np.frombuffer(payload, dtype=dt, offset=1).astype(int_dt)
        if len(payload) < 24:
            raise _corrupted("truncated Huffman preamble")
        tree_size, hit_bits, miss_size = struct.unpack_from("<QQQ", payload)
        hit_size = hit_bits // 8 + 4
        inner_size = tree_size + hit_size + miss_size
        if lossless == Lossless.HUFFMAN_ZSTD:
            import zstandard
            inner = zstandard.ZstdDecompressor().decompress(
                payload[24:], max_output_size=inner_size)
        else:
            inner = zlib.decompress(payload[24:])
        if len(inner) != inner_size:
            raise _corrupted("Huffman sections do not match their sizes")
        from ..io.huffman_native import huffman_decode
        q = huffman_decode(inner[:tree_size],
                           inner[tree_size:tree_size + hit_size], hit_bits,
                           inner[tree_size + hit_size:], n)
        return q.astype(int_dt)

    def _decode_parsed(self, header: fmt.Header, sections: List[bytes]
                       ) -> torch.Tensor:
        """Queue the device decode of a parsed container: the bitplane
        sections through :meth:`stream_tensors` and
        :meth:`decode_device`, a host-lossless section through the host
        decode and ``_flat_to_array``."""
        lossless = Lossless(header.lossless)
        if lossless not in _HOST_LOSSLESS:
            exponents, words = self.stream_tensors(header, sections)
            return self.decode_device(exponents, words, header.tolerance,
                                      lossless)
        if tuple(header.shape) != self.hier.shape:
            raise ValueError("container shape mismatch")
        flat = torch.from_numpy(self._host_lossless_decode(
            sections[0], lossless)).to(self.device)
        with self._table_scope():
            return self._flat_to_array(flat, header.tolerance)

    def decompress(self, buf: bytes) -> np.ndarray:
        """Read the container ``buf``, then :meth:`decompress_parsed`
        (``mgard_tpu/models/compressor.py:555-557``)."""
        header, sections = fmt.read_container(buf)
        return self.decompress_parsed(header, sections)

    def decompress_parsed(self, header: fmt.Header,
                          sections: List[bytes]) -> np.ndarray:
        out = self._decode_parsed(header, sections).cpu().numpy()
        if debug.enabled():
            debug.check(bool(np.isfinite(out).all()),
                        "decoded output contains non-finite values")
        return out

    def _stream_geometry(self, codec: str) -> Tuple[int, int, int, int]:
        """(exponent count, words per exponent unit, most planes a unit,
        word capacity) of a stream (``compressor.py:587-604``)."""
        C, n = self.chunk_groups, self._nstream
        if codec == "segmented":
            return (sum(bitplane.num_chunks_tiled(sz, C)
                        for sz in self._seg_sizes), C, 32,
                    bitplane.max_words_segments(self._seg_sizes, C))
        if codec == "grouped":
            # per-group exponents are padded to whole chunks of the
            # container's width
            return bitplane.num_chunks(n, C) * C, 1, 32, \
                bitplane.max_words(n, C)
        if codec == "wide":
            return bitplane.num_chunks64_tiled(n, C), C, 64, \
                bitplane.max_words64(n, C)
        return bitplane.num_chunks_tiled(n, C), C, 32, \
            bitplane.max_words(n, C)

    def stream_tensors(self, header: fmt.Header, sections: List[bytes]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The container's exponents (zero-filled to the full count,
        uint8) and stream words (int32) on the device, after checking
        that their sizes agree with the header and with each other."""
        if tuple(header.shape) != self.hier.shape:
            raise ValueError("container shape mismatch")
        hls = Lossless(header.lossless)
        codec = self._codec(hls)
        n_exp, unit, max_planes, cap = self._stream_geometry(codec)
        exp_bytes, word_bytes = sections[0], sections[1]
        if hls.second_stage == "zstd":
            import zstandard
            dctx = zstandard.ZstdDecompressor()
            exp_bytes = dctx.decompress(exp_bytes, max_output_size=n_exp)
            word_bytes = dctx.decompress(word_bytes, max_output_size=4 * cap)
        elif hls.second_stage == "lz4":
            from ..io.lz4_native import lz4_decompress
            exp_bytes = lz4_decompress(exp_bytes, max_output_size=n_exp)
            word_bytes = lz4_decompress(word_bytes, max_output_size=4 * cap)
        stored = np.frombuffer(exp_bytes, dtype=np.uint8)
        if len(stored) > n_exp or len(word_bytes) % (4 * unit):
            raise _corrupted("stream sizes do not match the header")
        exponents = np.zeros(n_exp, dtype=np.uint8)
        exponents[:len(stored)] = stored
        if len(stored) and int(stored.max()) > max_planes:
            raise _corrupted(f"an exponent exceeds {max_planes} planes")
        e = exponents.astype(np.int64)
        # words a unit stores: e rows of C words (chunked codecs), or a
        # sign word and e planes (per-group)
        nwords = int(((e + (e > 0)) if codec == "grouped" else e).sum()) \
            * unit
        if nwords * 4 != len(word_bytes):
            raise _corrupted("exponents and word count disagree")
        words = np.frombuffer(word_bytes, dtype="<i4").astype(np.int32)
        return (torch.from_numpy(exponents).to(self.device),
                torch.from_numpy(words).to(self.device))

    def decode_async(self, header: fmt.Header, sections: List[bytes]
                     ) -> ReadBack:
        """Queue the device decode of a parsed container and return at
        once: a :class:`ReadBack` of the array."""
        return ReadBack(self.device, [self._decode_parsed(header, sections)])


@functools.lru_cache(maxsize=32)
def _cached_hierarchy(shape: Tuple[int, ...], coords_key) -> Hierarchy:
    """One hierarchy per grid, shared by the compressors of that grid (an
    encode's and a decode's differ in their chunk width and config): at
    10^8 nodes a dim its tables take tens of GB of host memory."""
    coords = None if coords_key is None else [
        np.asarray(c) for c in coords_key]
    return Hierarchy(shape, coordinates=coords)


@functools.lru_cache(maxsize=32)
def _cached_compressor(shape: Tuple[int, ...], dtype_str: str, s: float,
                       coords_key, config_key, chunk_groups: int,
                       device: str) -> Compressor:
    hier = _cached_hierarchy(shape, coords_key)
    (lossless, zstd_level, decomposition, layout, num_local, adapt,
     cfg_cg) = config_key
    cfg = Config(lossless=Lossless(lossless), zstd_level=zstd_level,
                 decomposition=Decomposition(decomposition),
                 layout=Layout(layout), num_local_levels=num_local,
                 adapt_lossless=adapt, chunk_groups=cfg_cg)
    return Compressor(hier, np.dtype(dtype_str), s=s, config=cfg,
                      chunk_groups=chunk_groups, device=device)


def coords_key(coordinates):
    """The hashable key of a grid's coordinates (None for a uniform
    grid), as the caches take it."""
    if coordinates is None:
        return None
    return tuple(tuple(float(x) for x in c) for c in coordinates)


def get_compressor(shape, dtype, s: float = math.inf, coordinates=None,
                   config: Optional[Config] = None, chunk_groups: int = 0,
                   device="cuda") -> Compressor:
    """Cached compressor lookup, one per (shape, dtype, grid, config,
    chunk width, device)."""
    cfg = config or Config()
    return _cached_compressor(
        tuple(int(x) for x in shape), np.dtype(dtype).str, float(s),
        coords_key(coordinates),
        (int(cfg.lossless), cfg.zstd_level, int(cfg.decomposition),
         int(cfg.layout), int(cfg.num_local_levels), cfg.adapt_lossless,
         int(cfg.chunk_groups)),
        int(chunk_groups), str(torch.device(device)))

"""The low-level compressor pipeline for one device and one domain: the
port of the segmented float32 L-infinity branch of
``mgard_tpu/models/compressor.py``.

    decompose -> quantize + bitplane encode -> container sections

Device work is :meth:`Compressor.encode_device` and
:meth:`Compressor.decode_device`; host code reads back the variable-length
stream and assembles the container.  The main path syncs with the device
three times: the status and word count, the stream's read-back, and the
decoded array's ``.cpu()``.

Branches of the JAX package that the port does not have yet (finite s,
the per-group codec, float64, the zstd/LZ4 second stages, the
non-segmented layouts) raise ``NotImplementedError`` naming their
ROADMAP entry.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, Decomposition, ErrorMode, Layout, Lossless
from ..hierarchy import Hierarchy
from ..io import format as fmt
from ..ops import bitplane, transform
from ..ops.quantize import inverse_quantum, supremum_quantum


def _raise_status(status: int) -> None:
    """Map device-side failure flags to typed errors."""
    if status == 1:
        raise OverflowError(
            "quantized coefficients exceed the int32 range — the "
            "tolerance is too small for this data's dynamic range")
    if status == 2:
        raise ValueError("input contains NaN or Inf values")


def _not_ported(what: str, entry: str):
    return NotImplementedError(
        f"{what} is not ported to mgard_tpu_torch yet (ROADMAP {entry})")


class Compressor:
    """Error-bounded compressor for one fixed (shape, dtype, grid) on one
    device."""

    def __init__(self, hier: Hierarchy, dtype, s: float = math.inf,
                 config: Optional[Config] = None, chunk_groups: int = 0,
                 device="cuda"):
        self.hier = hier
        self.dtype = np.dtype(dtype)
        self.s = float(s)
        self.config = config or Config()
        self.device = torch.device(device)
        # Codec chunk width: a wire parameter the header records.
        self.chunk_groups = int(chunk_groups) \
            or int(self.config.chunk_groups) or bitplane.CHUNK_GROUPS
        # Small domains get per-group exponents (compressor.py:79-86).
        lossless = self.config.lossless
        if self.config.adapt_lossless and hier.ndof() < (1 << 22) \
                and self.dtype != np.dtype(np.float64):
            lossless = {
                Lossless.BITPLANE: Lossless.BITPLANE_GROUP,
                Lossless.BITPLANE_ZSTD: Lossless.BITPLANE_GROUP_ZSTD,
                Lossless.BITPLANE_LZ4: Lossless.BITPLANE_GROUP_LZ4,
            }.get(lossless, lossless)
        self.lossless = lossless
        self._seg_capable = (
            self.config.decomposition == Decomposition.MULTIDIM
            and self.config.layout == Layout.PYRAMID_SEG
            and self.dtype == np.dtype(np.float32))
        self._segmented = self._seg_capable and lossless.chunked
        self._seg_sizes = tuple(
            int(np.prod(hier.shapes[l])) for l in range(hier.L + 1))

    def _check_ported(self, lossless: Lossless, segmented: bool) -> None:
        if self.dtype != np.dtype(np.float32):
            raise _not_ported("float64 data (the 64-bitplane codec)",
                              "queue A, item 5")
        if not math.isinf(self.s):
            raise _not_ported("s-norm error control (finite s)",
                              "queue A, item 6")
        if lossless.grouped:
            raise _not_ported(
                "the per-group codec (BITPLANE_GROUP; the default under "
                "2^22 values, pass Config(adapt_lossless=False))",
                "queue A, item 5")
        if not segmented:
            raise _not_ported(f"lossless {lossless.name} with layout "
                              f"{self.config.layout.name}",
                              "queue A, items 5 and 7")
        if lossless.second_stage is not None:
            raise _not_ported(f"the {lossless.second_stage} second stage",
                              "queue A, item 7")

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def encode_device(self, v: torch.Tensor, abs_tol: float):
        """decompose + quantize + encode on the device: ``(exponents,
        words, count, status)`` tensors, not yet read back."""
        self._check_ported(self.lossless, self._segmented)
        pyr = transform.decompose(self.hier, v)
        return bitplane.encode_segments(
            pyr, float(inverse_quantum(self.hier, abs_tol)),
            C=self.chunk_groups)

    def decode_device(self, exponents: torch.Tensor, words: torch.Tensor,
                      abs_tol: float) -> torch.Tensor:
        """Decode + dequantize + recompose on the device."""
        q = float(supremum_quantum(self.hier, abs_tol))
        segs = bitplane.decode_segments(exponents, words, self._seg_sizes,
                                        quantum=q, C=self.chunk_groups)
        pyr = [s.reshape(self.hier.shapes[l]) for l, s in enumerate(segs)]
        return transform.recompose(self.hier, pyr)

    # ------------------------------------------------------------------
    # host-facing API
    # ------------------------------------------------------------------
    def sections_from_outputs(self, exponents, words, count,
                              status) -> List[bytes]:
        """Read back the device encode outputs and build the container
        sections: [exponent bytes, word bytes]."""
        count, status = (int(x) for x in torch.stack(
            [count.to(torch.int64), status.to(torch.int64)]).tolist())
        _raise_status(status)
        if not 0 <= count <= words.numel():
            raise RuntimeError(f"encode word count {count} exceeds capacity "
                               f"{words.numel()}")
        exp_np = exponents.cpu().numpy()
        words_np = words[:count].cpu().numpy()
        # Trailing all-zero chunks carry no stream rows; drop their
        # exponent bytes (the decoder zero-fills back to the full count).
        nz = np.nonzero(exp_np)[0]
        exp_np = exp_np[:int(nz[-1]) + 1] if len(nz) else exp_np[:0]
        return [exp_np.tobytes(), words_np.astype("<i4").tobytes()]

    def _as_tensor(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            t = v.to(device=self.device, dtype=torch.float32)
        else:
            t = torch.from_numpy(np.ascontiguousarray(
                v, dtype=self.dtype)).to(self.device)
        if tuple(t.shape) != self.hier.shape:
            raise ValueError(f"expected shape {self.hier.shape}, got "
                             f"{tuple(t.shape)}")
        return t

    def compress(self, v, tolerance: float,
                 mode: ErrorMode = ErrorMode.ABS) -> bytes:
        self._check_ported(self.lossless, self._segmented)
        v = self._as_tensor(v)
        norm = 1.0
        abs_tol = float(tolerance)
        if mode == ErrorMode.REL:
            norm = float(v.abs().max())
            abs_tol = float(tolerance) * norm
        sections = self.sections_from_outputs(
            *self.encode_device(v, abs_tol))
        header = fmt.Header(
            chunk_groups=self.chunk_groups,
            dtype=self.dtype, shape=self.hier.shape,
            uniform=self.hier.uniform,
            coordinates=None if self.hier.uniform else self.hier.coordinates,
            error_mode=int(mode), s=self.s, tolerance=abs_tol, norm=norm,
            lossless=int(self.lossless), n_levels=self.hier.L,
            section_sizes=(), decomposition=int(self.config.decomposition),
            layout=int(self.config.layout))
        return fmt.write_container(header, sections)

    def decompress_parsed(self, header: fmt.Header,
                          sections: List[bytes]) -> np.ndarray:
        return self.decode_async(header, sections).cpu().numpy()

    def stream_tensors(self, header: fmt.Header, sections: List[bytes]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The container's exponents (zero-filled to the full chunk
        count, uint8) and stream words (int32) on the device."""
        if tuple(header.shape) != self.hier.shape:
            raise ValueError("container shape mismatch")
        hls = Lossless(header.lossless)
        self._check_ported(hls, self._seg_capable and hls.chunked)
        exp_bytes, word_bytes = sections[0], sections[1]
        C = self.chunk_groups
        n_exp = sum(bitplane.num_chunks_tiled(sz, C)
                    for sz in self._seg_sizes)
        stored = np.frombuffer(exp_bytes, dtype=np.uint8)
        if len(stored) > n_exp or len(word_bytes) % (4 * C):
            raise ValueError("corrupted buffer: stream sizes do not match "
                             "the header")
        exponents = np.zeros(n_exp, dtype=np.uint8)
        exponents[:len(stored)] = stored
        if int(exponents.sum(dtype=np.int64)) * C * 4 != len(word_bytes):
            raise ValueError("corrupted buffer: exponents and word count "
                             "disagree")
        words = np.frombuffer(word_bytes, dtype="<i4").astype(np.int32)
        return (torch.from_numpy(exponents).to(self.device),
                torch.from_numpy(words).to(self.device))

    def decode_async(self, header: fmt.Header, sections: List[bytes]
                     ) -> torch.Tensor:
        """Decode a parsed container to a tensor on the device, without
        reading it back."""
        exponents, words = self.stream_tensors(header, sections)
        return self.decode_device(exponents, words, header.tolerance)


@functools.lru_cache(maxsize=32)
def _cached_compressor(shape: Tuple[int, ...], dtype_str: str, s: float,
                       coords_key, config_key, chunk_groups: int,
                       device: str) -> Compressor:
    coords = None if coords_key is None else [
        np.asarray(c) for c in coords_key]
    hier = Hierarchy(shape, coordinates=coords)
    (lossless, zstd_level, decomposition, layout, num_local, adapt,
     cfg_cg) = config_key
    cfg = Config(lossless=Lossless(lossless), zstd_level=zstd_level,
                 decomposition=Decomposition(decomposition),
                 layout=Layout(layout), num_local_levels=num_local,
                 adapt_lossless=adapt, chunk_groups=cfg_cg)
    return Compressor(hier, np.dtype(dtype_str), s=s, config=cfg,
                      chunk_groups=chunk_groups, device=device)


def get_compressor(shape, dtype, s: float = math.inf, coordinates=None,
                   config: Optional[Config] = None, chunk_groups: int = 0,
                   device="cuda") -> Compressor:
    """Cached compressor lookup, one per (shape, dtype, grid, config,
    chunk width, device)."""
    cfg = config or Config()
    coords_key = None
    if coordinates is not None:
        coords_key = tuple(tuple(float(x) for x in c) for c in coordinates)
    return _cached_compressor(
        tuple(int(x) for x in shape), np.dtype(dtype).str, float(s),
        coords_key,
        (int(cfg.lossless), cfg.zstd_level, int(cfg.decomposition),
         int(cfg.layout), int(cfg.num_local_levels), cfg.adapt_lossless,
         int(cfg.chunk_groups)),
        int(chunk_groups), str(torch.device(device)))

"""Interoperability with the reference MGARD self-describing formats (the
port of ``mgard_tpu/io/mgard_compat.py``).

Two containers share the ``MGARD`` magic and a proto3 ``mgard.pb.Header``
(src/mgard.proto):

* the **CPU** format (include/format.hpp:28-63): big-endian header size
  and CRC32, then the Huffman+zstd or zlib payload of
  ``compress_memory_huffman`` (src/compressors.cpp:421-512) over the
  quantized coefficients in the reference's shuffled order;
* the **MGARD-X** format (src/mgard-x/Metadata/Metadata.cpp):
  little-endian size and CRC, then one ``|u64 size|stream|`` record per
  subdomain, each an X-Huffman stream (optionally zstd-packed) over the
  quantized coefficients in the Mallat corner layout.

``decompress_mgard`` reads both (buffers of the reference ``mgard`` and
``mgard-x`` tools); ``compress_mgard`` and ``compress_mgard_x`` write
them.  Each package decodes the other's buffers.

Where the work runs: the transform is the port's (``ops/transform.py``,
with its kernels on float32 data); quantization, the shuffled and
corner-layout maps, the X stream's frequency count, bit assembly and
lockstep chunk decode run as torch integer ops on the device, bit for
bit the JAX package's numpy.  The Huffman code lengths and codebook
(a heap over at most ``dict_size`` symbols), the container, zlib, zstd
and the CPU format's Huffman codec (``io/huffman_native.py``) run on the
host.  The X reader recomposes in float64 and casts, as the JAX
package's does.  ``zstandard`` is imported only where a zstd stage runs.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from ..api import resolve_device
from ..hierarchy import Hierarchy
from ..models.compressor import coords_key
from ..ops import transform
from ..ops.quantize import TORCH_DTYPE
from . import protowire

__all__ = ["compress_mgard", "compress_mgard_x", "decompress_mgard",
           "read_container", "write_container"]

MAGIC = b"MGARD"

# --- mgard.pb schema (field numbers from src/mgard.proto) -----------------

SCHEMAS: Dict[str, Dict] = {
    "VersionNumber": {
        "major_": (1, "varint"), "minor_": (2, "varint"),
        "patch_": (3, "varint"),
    },
    "CartesianGridTopology": {
        "dimension": (1, "varint"), "shape": (2, "repeated_varint"),
    },
    "ExplicitCubeGeometry": {"coordinates": (2, "repeated_double")},
    "Domain": {
        "topology": (1, "varint"),
        "cartesian_grid_topology": (2, "message:CartesianGridTopology"),
        "geometry": (3, "varint"),
        "explicit_cube_geometry": (4, "message:ExplicitCubeGeometry"),
        "explicit_cube_filename": (5, "string"),
    },
    "Dataset": {"type": (1, "varint"), "dimension": (2, "varint")},
    "ErrorControl": {
        "mode": (1, "varint"), "norm": (2, "varint"), "s": (3, "double"),
        "norm_of_original_data": (4, "double"), "tolerance": (5, "double"),
    },
    "DomainDecomposition": {
        "method": (1, "varint"), "decomposition_dimension": (2, "varint"),
        "decomposition_size": (3, "varint"),
    },
    "FunctionDecomposition": {
        "transform": (1, "varint"), "hierarchy": (2, "varint"),
        "L_target": (3, "varint"),
    },
    "Quantization": {
        "method": (1, "varint"), "bin_widths": (2, "varint"),
        "type": (3, "varint"), "big_endian": (4, "varint"),
    },
    "BitplaneEncoding": {
        "method": (1, "varint"), "type": (2, "varint"),
        "number_bitplanes": (3, "varint"), "big_endian": (4, "varint"),
    },
    "Encoding": {
        "preprocessor": (1, "varint"), "compressor": (2, "varint"),
        "huffman_dictionary_size": (3, "varint"),
        "huffman_block_size": (4, "varint"),
    },
    "Device": {"backend": (1, "varint")},
    "Header": {
        "mgard_version": (2, "message:VersionNumber"),
        "file_format_version": (3, "message:VersionNumber"),
        "domain": (4, "message:Domain"),
        "dataset": (5, "message:Dataset"),
        "error_control": (6, "message:ErrorControl"),
        "domain_decomposition": (7, "message:DomainDecomposition"),
        "function_decomposition": (8, "message:FunctionDecomposition"),
        "quantization": (9, "message:Quantization"),
        "bitplane_encoding": (10, "message:BitplaneEncoding"),
        "encoding": (11, "message:Encoding"),
        "device": (12, "message:Device"),
    },
}

# enum values (mgard.proto)
CPU_HUFFMAN_ZLIB = 1
CPU_HUFFMAN_ZSTD = 2
X_HUFFMAN = 3
X_HUFFMAN_LZ4 = 4
X_HUFFMAN_ZSTD = 5
DATASET_FLOAT, DATASET_DOUBLE = 0, 1
NORM_L_INFINITY, NORM_S_NORM = 0, 1
# FunctionDecomposition.hierarchy of the X tool's uniform MultiDim grids
X_MULTIDIM_HIERARCHY = 1

_MAX63 = (1 << 63) - 1
_U64_MAX = np.iinfo(np.uint64).max


def read_container(buf: bytes) -> Tuple[Dict, bytes]:
    """Parse an MGARD buffer -> (header message dict, payload bytes).

    The CPU stack writes the size/CRC preamble big-endian
    (include/format.hpp serialization); MGARD-X's Metadata writes the
    same signature + protobuf header but with LITTLE-endian preamble
    ints (src/mgard-x/Metadata/Metadata.cpp Serialize<T> emits
    LSB-first).  Both are accepted here; the CRC arbitrates.
    """
    if buf[:5] != MAGIC:
        raise ValueError("not an MGARD buffer (bad magic)")
    for order in (">", "<"):
        (hdr_size,) = struct.unpack_from(order + "Q", buf, 5)
        if hdr_size > len(buf):
            continue
        (crc,) = struct.unpack_from(order + "I", buf, 13)
        hdr = buf[17:17 + hdr_size]
        if (zlib.crc32(hdr) & 0xFFFFFFFF) == crc:
            header = protowire.decode_message(SCHEMAS["Header"], SCHEMAS,
                                              hdr)
            return header, buf[17 + hdr_size:]
    raise ValueError("MGARD header CRC mismatch")


def write_container(header: Dict, payload: bytes,
                    little_endian: bool = False) -> bytes:
    """Serialize MAGIC + preamble + proto header + payload; the CPU
    stack's preamble is big-endian, MGARD-X's (``little_endian=True``)
    little-endian."""
    order = "<" if little_endian else ">"
    hdr = protowire.encode_message(SCHEMAS["Header"], SCHEMAS, header)
    out = bytearray()
    out += MAGIC
    out += struct.pack(order + "Q", len(hdr))
    out += struct.pack(order + "I", zlib.crc32(hdr) & 0xFFFFFFFF)
    out += hdr
    out += payload
    return bytes(out)


def _need(msg: Dict, name: str, where: str = "header"):
    """``msg[name]``, or a ValueError naming the missing field (the JAX
    package raises KeyError here)."""
    if name not in msg:
        raise ValueError(f"MGARD {where} has no {name!r} field")
    return msg[name]


@functools.lru_cache(maxsize=8)
def _reference_hierarchy(shape: Tuple[int, ...], coords) -> Hierarchy:
    """One hierarchy with the reference node placement per grid, with its
    host tables (:func:`_shuffled_maps`) cached on it."""
    return Hierarchy(shape, coordinates=None if coords is None else [
        np.asarray(c) for c in coords], placement="reference")


def _device_tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    """A host array (a read-only buffer view too) as a tensor on
    ``device``."""
    arr = np.asarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.as_tensor(arr, dtype=dtype).to(device)


def _round_half_away(scaled: torch.Tensor) -> torch.Tensor:
    """``trunc(copysign(0.5 + |x|, x))`` to int64 (``mgard_compat.py:239``),
    in float64."""
    return torch.trunc(torch.copysign(0.5 + scaled.abs(), scaled)).to(
        torch.int64)


# --- shuffled-order quantization bridge (the CPU format) -------------------

def _shuffled_maps(hier: Hierarchy):
    """Host tables bridging the pyramid's block order and the reference's
    shuffled vector (``mgard_compat.py:146-187``), built once per
    hierarchy: (block-order position of each shuffled node, its level,
    its volume weight)."""
    cache = hier.__dict__.setdefault("_shuffled_maps", [])
    if cache:
        return cache[0]
    ours, levels, vol_parts = [], [], []
    for (l, r, bs, pos) in transform.block_specs(hier):
        fine_pos, volw = [], []
        for d in range(hier.ndim):
            fine_pos.append(hier.level_indices(l, d)[np.asarray(pos[d])])
            if hier.shape[d] > 1:
                volw.append(hier.dims[d][l].volumes[np.asarray(pos[d])])
            else:
                volw.append(np.ones(len(pos[d])))
        grid = np.meshgrid(*fine_pos, indexing="ij")
        flat = np.zeros(bs, dtype=np.int64)
        for d in range(hier.ndim):
            flat = flat * hier.shape[d] + grid[d]
        ours.append(flat.ravel())
        levels.append(np.full(flat.size, l, dtype=np.int64))
        vol = np.ones(bs)
        for d in range(hier.ndim):
            shp = [1] * hier.ndim
            shp[d] = len(volw[d])
            vol = vol * volw[d].reshape(shp)
        vol_parts.append(vol.ravel())
    ours_fine = np.concatenate(ours)
    shuffled_fine = hier.shuffle_permutation()  # shuffled[i] = fine idx
    pos_of_fine = np.empty(hier.ndof(), dtype=np.int64)
    pos_of_fine[ours_fine] = np.arange(hier.ndof())
    perm = pos_of_fine[shuffled_fine]
    cache.append((perm, np.concatenate(levels)[perm],
                  np.concatenate(vol_parts)[perm]))
    return cache[0]


def _quanta_shuffled(hier: Hierarchy, s: float, tol: float):
    """Per-node quantum in shuffled order (reference
    TensorMultilevelCoefficientQuantizer.tpp:12-55): one value at
    s = inf, else an ndof-long array."""
    perm, lvl, vol = _shuffled_maps(hier)
    if math.isinf(s):
        d = hier.effective_ndim
        return perm, np.full(1, (2.0 * tol) / ((hier.L + 1)
                                               * (1 + 3.0 ** d)))
    return perm, (2.0 * tol) / (np.exp2(s * lvl)
                                * np.sqrt(hier.ndof() * vol))


def _cpu_quantized(data: np.ndarray, tolerance: float, s: float,
                   coordinates, dev) -> np.ndarray:
    """The CPU format's int64 stream of ``data``: its pyramid in block
    order, in float64, divided by the shuffled quanta and rounded half
    away from zero, on ``dev``; returned on the host."""
    if data.dtype not in (np.float32, np.float64):
        raise TypeError("MGARD CPU write path: float32/float64 only")
    hier = _reference_hierarchy(data.shape, coords_key(coordinates))
    v = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    flat = transform.flatten_pyramid(hier, transform.decompose(hier, v)
                                     ).to(torch.float64)
    del v
    perm, quanta = _quanta_shuffled(hier, s, tolerance)
    # divide by a tensor on the device: a host scalar divisor may become a
    # multiply by its rounded reciprocal
    return _round_half_away(
        flat[_device_tensor(perm, torch.int64, dev)]
        / _device_tensor(quanta, torch.float64, dev)).cpu().numpy()


def compress_mgard(data: np.ndarray, tolerance: float, s: float = math.inf,
                   coordinates=None, zstd: bool = True,
                   device=None) -> bytes:
    """Compress into the reference CPU format (decodable by `mgard`):
    CPU_HUFFMAN_ZSTD (Huffman, then zstd level 1) or, with ``zstd`` off,
    CPU_HUFFMAN_ZLIB (zlib level 9 over the raw int64 stream)."""
    from .huffman_native import huffman_encode
    if zstd:
        import zstandard
    data = np.asarray(data)
    q = _cpu_quantized(data, tolerance, s, coordinates,
                       resolve_device(device))

    if zstd:
        # CPU_HUFFMAN_ZSTD: Huffman stream, zstd-packed, 3-size preamble
        # (reference compress_memory_huffman, src/compressors.cpp:421-512)
        tree, hit, hit_bits, miss = huffman_encode(q)
        packed = zstandard.ZstdCompressor(level=1).compress(tree + hit
                                                            + miss)
        payload = struct.pack("<QQQ", len(tree), hit_bits,
                              len(miss)) + packed
        compressor = CPU_HUFFMAN_ZSTD
    else:
        # CPU_HUFFMAN_ZLIB: despite the name, plain zlib over the raw
        # int64 stream (reference compress(), src/compressors.cpp:664-665)
        payload = zlib.compress(q.tobytes(), 9)
        compressor = CPU_HUFFMAN_ZLIB

    header = {
        "mgard_version": {"major_": 1, "minor_": 6, "patch_": 0},
        "file_format_version": {"major_": 1, "minor_": 0, "patch_": 0},
        "domain": {
            "topology": 0,
            "cartesian_grid_topology": {
                "dimension": data.ndim,
                "shape": list(data.shape),
            },
            "geometry": 0 if coordinates is None else 1,
            **({"explicit_cube_geometry": {
                "coordinates": list(np.concatenate(coordinates))}}
               if coordinates is not None else {}),
        },
        "dataset": {
            "type": DATASET_FLOAT if data.dtype == np.float32
            else DATASET_DOUBLE,
            "dimension": 1,
        },
        "error_control": {
            "mode": 0,
            "norm": NORM_L_INFINITY if math.isinf(s) else NORM_S_NORM,
            **({} if math.isinf(s) else {"s": s}),
            "tolerance": tolerance,
        },
        "function_decomposition": {"transform": 0, "hierarchy": 0},
        "quantization": {"method": 1, "bin_widths": 0, "type": 3,
                         "big_endian": 0},
        "encoding": {"preprocessor": 1, "compressor": compressor},
        "device": {"backend": 0},
    }
    return write_container(header, payload)


# --- the MGARD-X Huffman stream ---------------------------------------------

def _huffman_code_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code length per symbol from frequencies (0 where absent)."""
    import heapq

    sym = np.nonzero(freq)[0]
    lengths = np.zeros(len(freq), dtype=np.int64)
    if len(sym) == 0:
        return lengths
    if len(sym) == 1:
        lengths[sym[0]] = 1
        return lengths
    # heap of (freq, tiebreak, [symbols...]); merging two nodes adds one
    # bit to every symbol under them.
    heap = [(int(freq[s]), int(s), [int(s)]) for s in sym]
    heapq.heapify(heap)
    tick = len(freq)
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa:
            lengths[s] += 1
        for s in sb:
            lengths[s] += 1
        tick += 1
        heapq.heappush(heap, (fa + fb, tick, sa + sb))
    return lengths


def _x_codebook(lengths: np.ndarray):
    """Canonical codebook in the X decoder's convention
    (Lossless/ParallelHuffman/Decode.hpp:63-85): codes of length l
    occupy consecutive values [first[l], first[l]+count[l]) and every
    longer code's l-bit prefix is < first[l], so `v < first[l]` means
    "shift in another bit".  Unused lengths get first[l]=2^64-1
    (GenerateCW.hpp:79-82).  Returns (first[64] u64, entry[64] u64,
    keys u64, code_of_symbol u64)."""
    dict_size = len(lengths)
    used = lengths > 0
    maxlen = int(lengths.max())
    assert maxlen < 64
    count = np.bincount(lengths[used], minlength=maxlen + 2)
    first_calc = np.zeros(maxlen + 1, dtype=np.uint64)
    first_calc[maxlen] = 0
    for l in range(maxlen - 1, 0, -1):
        tot = int(first_calc[l + 1]) + int(count[l + 1])
        assert tot % 2 == 0 or len(np.nonzero(used)[0]) == 1
        first_calc[l] = (tot + 1) // 2
    first = np.full(64, _U64_MAX, dtype=np.uint64)
    entry = np.zeros(64, dtype=np.uint64)
    keys = []
    codes = np.zeros(dict_size, dtype=np.uint64)
    pos = 0
    for l in range(1, maxlen + 1):
        syms = np.nonzero(lengths == l)[0]
        if len(syms) == 0:
            continue
        first[l] = first_calc[l]
        entry[l] = pos
        codes[syms] = first_calc[l] + np.arange(len(syms), dtype=np.uint64)
        keys.extend(int(s) for s in syms)
        pos += len(syms)
    return first, entry, np.asarray(keys, dtype=np.uint64), codes


def _chunk_bits(sym_len: torch.Tensor, chunk_size: int):
    """Per chunk of ``chunk_size`` symbols: its bit count, and each
    symbol's bit offset within its chunk."""
    pc = sym_len.numel()
    nchunk = (pc - 1) // chunk_size + 1
    rows = torch.nn.functional.pad(sym_len, (0, nchunk * chunk_size - pc)
                                   ).view(nchunk, chunk_size)
    cum = rows.cumsum(1)
    return cum[:, -1], (cum - rows).view(-1)[:pc]


def _encode_x_huffman(q: torch.Tensor, dict_size: int = 8192,
                      chunk_size: int = 20480) -> bytes:
    """Serialize a signed int64 quantized stream (a tensor on any device)
    as an MGARD-X Huffman blob, byte for byte the JAX package's
    (``mgard_compat.py:574-650``; layout:
    Lossless/ParallelHuffman/Huffman.hpp:130-266, every field aligned to
    its own size).  Out-of-dictionary values ride the outlier channel
    with the *shifted* value, symbol 0 in the stream
    (Quantization/LinearQuantization.hpp:213-240).

    The frequency count and the bit assembly run on ``q``'s device: each
    symbol's code lands in the u64 word (or two) that its bit offset
    names, MSB first; codes never overlap, so summing the words'
    contributions (``index_add_``) writes the same bits as the JAX
    package's per-bit scatter and ``packbits``."""
    dev = q.device
    pc = q.numel()
    shifted = q.reshape(-1) + dict_size // 2
    outlier = (shifted < 0) | (shifted >= dict_size)
    out_idx = outlier.nonzero().reshape(-1)
    out_vals = shifted[out_idx].cpu().numpy()
    out_idx = out_idx.cpu().numpy()
    sym = torch.where(outlier, 0, shifted)
    del shifted, outlier

    freq = torch.bincount(sym, minlength=dict_size).cpu().numpy()
    lengths = _huffman_code_lengths(freq)
    first, entry, keys, codes = _x_codebook(lengths)

    # chunked bitstream: each chunk starts at a u64 word boundary,
    # MSB-first within each word
    nchunk = (pc - 1) // chunk_size + 1 if pc else 0
    if pc:
        sym_len = _device_tensor(lengths, torch.int64, dev)[sym]
        sym_code = _device_tensor(codes.view(np.int64), torch.int64,
                                  dev)[sym]
        del sym
        bits_per_chunk, within = _chunk_bits(sym_len, chunk_size)
        words_per_chunk = (bits_per_chunk - 1).div(
            64, rounding_mode="floor") + 1
        word_entry = torch.cumsum(words_per_chunk, 0) - words_per_chunk
        total_words = int(words_per_chunk.sum())
        start = within + (word_entry * 64).repeat_interleave(
            chunk_size)[:pc]
        del within
        word = start >> 6
        spill = (start & 63) + sym_len - 64   # bits past the first word
        del start, sym_len
        words = torch.zeros(total_words + 1, dtype=torch.int64, device=dev)
        words.index_add_(0, word, torch.where(
            spill <= 0, sym_code << (-spill).clamp_min(0),
            sym_code >> spill.clamp_min(0)))
        two = (spill > 0).nonzero().reshape(-1)
        words.index_add_(0, word[two] + 1,
                         sym_code[two] << (64 - spill[two]))
        del word, spill, sym_code, two
        ddata = words[:total_words].cpu().numpy().view(np.uint64)
        bits_per_chunk = bits_per_chunk.cpu().numpy()
        word_entry = word_entry.cpu().numpy()
    else:
        ddata = np.zeros(0, np.uint64)
        bits_per_chunk = word_entry = np.zeros(0, np.int64)

    # decodebook: first[64] | entry[64] | keys (u64 each), padded to
    # dict_size keys (decode only reads the used prefix via entry[])
    keys_full = np.zeros(dict_size, dtype=np.uint64)
    keys_full[:len(keys)] = keys
    db = first.tobytes() + entry.tobytes() + keys_full.tobytes()

    out = bytearray()

    def put(arr, size):
        while len(out) % size:
            out.append(0)
        out.extend(arr if isinstance(arr, (bytes, bytearray))
                   else np.ascontiguousarray(arr).tobytes())

    put(struct.pack("<Q", pc), 8)
    put(struct.pack("<i", dict_size), 4)
    put(struct.pack("<i", chunk_size), 4)
    put(struct.pack("<Q", 2 * nchunk), 8)
    put(np.concatenate([bits_per_chunk, word_entry]).astype("<u8"), 8)
    put(struct.pack("<Q", len(db)), 8)
    put(db, 1)
    put(struct.pack("<Q", len(ddata)), 8)
    put(ddata.astype("<u8"), 8)
    put(struct.pack("<Q", len(out_idx)), 8)
    put(out_idx.astype("<u8"), 8)
    put(out_vals.astype("<i8"), 8)
    return bytes(out)


def _decode_x_huffman(blob: bytes, device) -> torch.Tensor:
    """Parse and decode an MGARD-X serialized Huffman stream
    (include/mgard-x/Lossless/ParallelHuffman/Huffman.hpp:130-266):

        |primary_count u64|dict_size i32|chunk_size i32|huffmeta_size u64|
        |huffmeta u64 x (bits-per-chunk, word-entry-per-chunk)|
        |decodebook_size u64|decodebook bytes|ddata_size u64|ddata u64 x|
        |outlier_count u64|outlier idx u64 x|outlier values i64 x|

    every field aligned to its own size (RuntimeX Serializer.hpp).  The
    decodebook is the canonical first/entry/keys triple (64 first + 64
    entry words, then dict_size u64 keys); chunk bitstreams are MSB-first
    within each u64 word.  Returns the signed quantized stream (outliers
    restored, dict offset removed) as an int64 tensor on ``device``."""

    def align(o, t):
        return o if o % t == 0 else ((o - 1) // t + 1) * t

    def take(dtype, size, count, o):
        o = align(o, size)
        arr = np.frombuffer(blob, dtype=dtype, count=int(count), offset=o)
        return arr, o + int(count) * size

    off = 0
    (pc,), off = take("<u8", 8, 1, off)
    (dict_size,), off = take("<i4", 4, 1, off)
    (chunk_size,), off = take("<i4", 4, 1, off)
    (hm_size,), off = take("<u8", 8, 1, off)
    huffmeta, off = take("<u8", 8, hm_size, off)
    (db_size,), off = take("<u8", 8, 1, off)
    db, off = take("u1", 1, db_size, off)
    (ddata_size,), off = take("<u8", 8, 1, off)
    ddata, off = take("<u8", 8, ddata_size, off)
    (outlier_count,), off = take("<u8", 8, 1, off)
    out_idx, off = take("<u8", 8, outlier_count, off)
    out_vals, off = take("<i8", 8, outlier_count, off)

    pc = int(pc)
    dict_size = int(dict_size)
    chunk_size = int(chunk_size)
    nchunk = (pc - 1) // chunk_size + 1
    bits = huffmeta[:nchunk].astype(np.int64)
    entries = huffmeta[nchunk:2 * nchunk].astype(np.int64)
    first = np.frombuffer(db, "<u8", 64, 0)
    entry = np.frombuffer(db, "<u8", 64, 512).astype(np.int64)
    keys = np.frombuffer(db, "<u8", dict_size, 1024)

    out = _x_huffman_decode_chunks(ddata, bits, entries, first, entry,
                                   keys, pc, chunk_size, device)
    if int(outlier_count):
        out[_device_tensor(out_idx.astype(np.int64), torch.int64,
                           device)] = _device_tensor(out_vals, torch.int64,
                                                     device)
    return out - dict_size // 2


# The decode's root table covers windows of the longest code's length up
# to this many bits; longer codes (rare) compare their prefixes.
_X_TABLE_BITS = 20
# Bit positions whose codes are looked up at once (bounds the temporaries).
_X_POSITIONS = 1 << 24
# Lockstep steps captured in one CUDA graph on the card.
_X_GRAPH_STEPS = 256
# Bits of the stream whose codes are tabled at once (5 bytes a bit): the
# chunks are decoded in groups that fit (2.7 GB of table).
_X_GROUP_BITS = 1 << 29


def _x_code_table(first, entry, T: int, escape: bool, device):
    """(length, key index) of every T-bit window by the serial decoder's
    accept rule (length = the FIRST l whose l-bit prefix is >= first[l]).
    A window no code of at most T bits matches gets length 0 where
    ``escape`` (a longer code starts there), else 1 (a corrupt stream;
    the JAX package forces such progress too)."""
    wv = torch.arange(1 << T, dtype=torch.int64, device=device)
    tbl_len = torch.full((1 << T,), 0 if escape else 1, dtype=torch.uint8,
                         device=device)
    tbl_idx = torch.zeros(1 << T, dtype=torch.int32, device=device)
    done = torch.zeros(1 << T, dtype=torch.bool, device=device)
    for lng in range(1, T + 1):
        if int(first[lng]) == _U64_MAX:
            continue
        top = wv >> (T - lng)
        ok = (top >= int(first[lng])) & ~done
        tbl_len[ok] = lng
        tbl_idx[ok] = (int(entry[lng]) + top[ok] - int(first[lng])).to(
            torch.int32)
        done |= ok
    return tbl_len, tbl_idx


def _x_codes_at(words: torch.Tensor, nbits: int, first, entry, maxlen: int,
                tail: int = 0):
    """The code length (uint8) and key index (int32) of the code that
    starts at each bit position 0..nbits of the stream ``words``, and
    position nbits's again at ``tail`` positions after it (u64
    words as int64, MSB first, two zero words of padding).  The 64 bits
    at a position come from two words; a table over the first
    min(maxlen, ``_X_TABLE_BITS``) bits gives length and index, and
    where it escapes (a longer code) the prefixes of every longer length
    are compared with first[l] at once.  Prefixes are below 2^63 and an
    unused length's first[l] = 2^64 - 1 is clamped to 2^63 - 1, so int64
    compares keep the unsigned order."""
    dev = words.device
    T = min(maxlen, _X_TABLE_BITS)
    tbl_len, tbl_idx = _x_code_table(first, entry, T, maxlen > T, dev)
    if maxlen > T:
        lens = torch.arange(T + 1, maxlen + 1, device=dev)
        firstc = _device_tensor(np.minimum(first[T + 1:maxlen + 1], _MAX63
                                           ).astype(np.int64),
                                torch.int64, dev)
        entryt = _device_tensor(entry[T + 1:maxlen + 1], torch.int64, dev)
    len_at = torch.empty(nbits + 1 + tail, dtype=torch.uint8, device=dev)
    idx_at = torch.empty(nbits + 1 + tail, dtype=torch.int32, device=dev)
    for a in range(0, nbits + 1, _X_POSITIONS):
        p = torch.arange(a, min(a + _X_POSITIONS, nbits + 1), device=dev)
        o = p & 63
        w = p >> 6
        win = (words[w] << o) | (((words[w + 1] >> 1) & _MAX63) >> (63 - o))
        top = (win >> 1) & _MAX63                 # the first 63 bits
        del p, o, w, win
        ln = tbl_len[top >> (63 - T)]
        ix = tbl_idx[top >> (63 - T)]
        if maxlen > T:
            esc = (ln == 0).nonzero().reshape(-1)
            pref = top[esc, None] >> (63 - lens)
            ok = pref >= firstc
            lidx = ok.to(torch.uint8).argmax(1)
            found = ok.any(1)
            ln[esc] = torch.where(found, lidx + T + 1, 1).to(torch.uint8)
            ix[esc] = torch.where(found, entryt[lidx] + pref.gather(
                1, lidx[:, None])[:, 0] - firstc[lidx], 0).to(torch.int32)
            del esc, pref, ok, lidx, found
        len_at[a:a + top.numel()] = ln
        idx_at[a:a + top.numel()] = ix
    len_at[nbits + 1:] = len_at[nbits]
    idx_at[nbits + 1:] = idx_at[nbits]
    return len_at, idx_at


def _x_chunk_groups(bits, entries, budget: int):
    """Consecutive chunk ranges [c0, c1) whose bit range (chunk c reads
    bits ``entries[c]·64`` to ``+ bits[c]``) spans at most ``budget``
    bits, or one chunk where a chunk alone spans more."""
    lo = (entries * 64).tolist()
    hi = (entries * 64 + bits).tolist()
    groups, c0 = [], 0
    first, last = lo[0], hi[0]
    for c in range(1, len(lo)):
        first, last = min(first, lo[c]), max(last, hi[c])
        if last - first > budget:
            groups.append((c0, c))
            c0, first, last = c, lo[c], hi[c]
    groups.append((c0, len(lo)))
    return groups


def _x_walk_group(ddata, bits, entries, first, entry, maxlen: int,
                  nsteps: int, dev) -> torch.Tensor:
    """The key index of each symbol of the chunks of one group, each of
    ``nsteps`` symbols, (nsteps, chunks): every bit position of the
    group's words gets its code at once (:func:`_x_codes_at`); then every
    chunk follows its chain of codes in lockstep, one symbol a step (a
    gather of the key index and of the length at its cursor).  On a card
    the steps run as CUDA graphs of ``_X_GRAPH_STEPS`` steps."""
    nchunk = bits.shape[0]
    w_lo = int(entries.min())
    w_hi = int((entries + (bits + 63) // 64).max())
    words = torch.zeros(w_hi - w_lo + 2, dtype=torch.int64, device=dev)
    stream = ddata[w_lo:w_hi].view(np.int64)     # shorter if corrupt
    words[:len(stream)] = _device_tensor(stream, torch.int64, dev)
    nbits = 64 * (w_hi - w_lo)
    # a cursor advances at most max(maxlen, 1) bits a step, and from
    # nbits on (a corrupt stream) meets position nbits's code again
    len_at, idx_at = _x_codes_at(words, nbits, first, entry, maxlen,
                                 tail=nsteps * max(maxlen, 1))
    del words

    start = _device_tensor((entries - w_lo) * 64, torch.int64, dev)
    pos = start.clone()

    def step(out_row):
        torch.index_select(idx_at, 0, pos, out=out_row)
        pos.add_(len_at[pos])

    if dev.type == "cuda" and nsteps > _X_GRAPH_STEPS:
        G = _X_GRAPH_STEPS
        rounds = -(-nsteps // G)
        sym_idx = torch.empty((rounds * G, nchunk), dtype=torch.int32,
                              device=dev)
        stage = torch.empty((G, nchunk), dtype=torch.int32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):      # warm-up before the capture
            for j in range(3):
                step(stage[j])
        torch.cuda.current_stream(dev).wait_stream(side)
        pos.copy_(start)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for j in range(G):
                step(stage[j])
        for r in range(rounds):
            if r == rounds - 1 and nsteps % G:
                # the last round's steps alone: a cursor must stop at its
                # chunk's end for the bit count below
                del graph
                for j in range(nsteps % G):
                    step(sym_idx[r * G + j])
                break
            graph.replay()
            sym_idx[r * G:(r + 1) * G].copy_(stage)
        else:
            del graph
        sym_idx = sym_idx[:nsteps]
    else:
        sym_idx = torch.empty((nsteps, nchunk), dtype=torch.int32,
                              device=dev)
        for k in range(nsteps):
            step(sym_idx[k])
    del len_at, idx_at
    if not torch.equal(pos - start, _device_tensor(bits, torch.int64, dev)):
        raise ValueError("X-Huffman stream decoded wrong bit count")
    return sym_idx


def _x_huffman_decode_chunks(ddata, bits, entries, first, entry, keys,
                             pc: int, chunk_size: int, device
                             ) -> torch.Tensor:
    """Canonical-Huffman decode of the chunked X bitstream
    (``mgard_compat.py:374-452``), bit for bit the JAX package's.  The
    chunks are independent, so they are decoded in groups whose bit
    range fits ``_X_GROUP_BITS`` (:func:`_x_chunk_groups`), one group's
    code table on the device at a time (:func:`_x_walk_group`): the
    table's memory is bounded by that budget, not by the stream.  Every
    chunk holds ``chunk_size`` symbols but a short last one, which walks
    alone for its own count."""
    dev = torch.device(device)
    nchunk = bits.shape[0]
    used = np.nonzero(first[1:] != _U64_MAX)[0] + 1
    maxlen = int(used.max()) if used.size else 1
    last = pc - (nchunk - 1) * chunk_size
    full = nchunk if last == chunk_size else nchunk - 1
    groups = [(c0, c1, chunk_size) for c0, c1 in
              (_x_chunk_groups(bits[:full], entries[:full], _X_GROUP_BITS)
               if full else [])]
    if full < nchunk:
        groups.append((full, nchunk, last))
    sym_idx = torch.cat([
        _x_walk_group(ddata, bits[c0:c1], entries[c0:c1], first, entry,
                      maxlen, steps, dev).T.reshape(-1)
        for c0, c1, steps in groups])
    keyt = _device_tensor(keys.view(np.int64), torch.int64, dev)
    return keyt[sym_idx.clamp(0, len(keys) - 1).to(torch.int64)]


# --- the MGARD-X format ------------------------------------------------------

def _x_levels(n: int):
    """MGARD-X per-dim level walk: n -> n/2+1 down to 2
    (include/mgard-x/Hierarchy/Hierarchy.hpp:199-216)."""
    out = []
    while n > 2:
        out.append(n)
        n = n // 2 + 1
    out.append(2)
    return out


def _x_hierarchy(shape) -> Tuple[Hierarchy, int]:
    """The dyadic hierarchy of an MGARD-X buffer's grid, checked to
    coincide with the X ghost-node level walk (else the transform is not
    the inverse of the X refactoring).  Returns (hierarchy, l_target)."""
    shape = tuple(int(n) for n in shape)
    l_target = min(len(_x_levels(n)) for n in shape if n > 1) - 1
    hier = _reference_hierarchy(shape, None)
    if hier.L != l_target or any(
            _x_levels(n)[:l_target + 1] !=
            [lev.n for lev in hier.dims[d][::-1]][:l_target + 1]
            for d, n in enumerate(shape) if n > 1):
        raise NotImplementedError(
            "MGARD-X buffers: shape's ghost-node hierarchy differs from "
            "the dyadic reference hierarchy (use 2^k+1 dims)")
    return hier, l_target


def _x_corner_slices(hier: Hierarchy):
    """Mallat corner-layout slices for each (level, region) block, in
    block_specs serialization order.  The X refactoring front-packs each
    level's coarse block in place (gpk_reo, GridProcessingKernel3D.hpp
    Operation3: coarse node (2i,2j,2k) -> (i,j,k)), so level-l detail
    region r occupies, along dim d, [nc_d, n_d) if r refines d else
    [0, nc_d), inside the recursively packed block."""
    slices = []
    for (l, r, bshape, pos) in transform.block_specs(hier):
        idx = []
        for d in range(hier.ndim):
            if hier.shape[d] == 1:
                idx.append(slice(0, 1))
                continue
            lev = hier.dims[d][l] if l > 0 else None
            if l == 0:
                idx.append(slice(0, hier.shapes[0][d]))
            elif r & (1 << d):
                nc = len(lev.coarse_pos)
                idx.append(slice(nc, lev.n))
            else:
                idx.append(slice(0, len(lev.coarse_pos)))
        slices.append(tuple(idx))
    return slices


def _x_level_shapes(shape, l_target: int):
    """Per-level shapes of the X ghost-node hierarchy, coarsest first:
    level l_target = ``shape``, level l-1 = level l // 2 + 1 per dim
    (include/mgard-x/Hierarchy/Hierarchy.hpp:199-216 _level_shape)."""
    walks = []
    for n in shape:
        w = [int(n)]
        for _ in range(l_target):
            w.append(w[-1] // 2 + 1)
        walks.append(w[::-1])
    return [tuple(w[l] for w in walks) for l in range(l_target + 1)]


def _x_level_factors(shape, l_target: int, tol: float, s: float):
    """The finite-s dequantization factor of each level: quantizer[l] *
    volume[l] with quantizer[l] = 2*tol / (2^(s l) sqrt(dof))
    (LinearQuantization.hpp:495-545 CalcQuantizers) and the
    levelwise-uniform volume sqrt(prod_d 1/(n_l[d]-1))
    (Hierarchy.hpp:165-189 calc_volume).  Flat dims contribute no volume
    (the reference's calc_volume leaves a dof=1 dim's volume at 0 —
    degenerate upstream; factor 1 is the only usable reading)."""
    shapes = _x_level_shapes(shape, l_target)
    dof = float(np.prod(shape))
    factors = []
    for l in range(l_target + 1):
        quantizer = 2.0 * tol / (np.exp2(s * l) * math.sqrt(dof))
        vol = math.sqrt(np.prod([1.0 / (n - 1) for n in shapes[l]
                                 if n > 1]))
        factors.append(quantizer * vol)
    return factors


def _x_linear_order(shape, l_target: int, device) -> torch.Tensor:
    """The corner-layout flat index of each position of the
    level-linearized (reorder=1) stream: per level, the detail nodes in
    row-major order of the level's natural grid with coarser nodes
    removed, levels coarsest first (reference LevelLinearizer;
    LinearQuantization.hpp calc_level_offset)."""
    shapes = _x_level_shapes(shape, l_target)
    strides = torch.tensor([int(np.prod(shape[d + 1:]))
                            for d in range(len(shape))], device=device)
    parts = []
    for l in range(l_target + 1):
        g = torch.stack(torch.meshgrid(
            *[torch.arange(n, device=device) for n in shapes[l]],
            indexing="ij")).reshape(len(shape), -1)
        if l > 0:
            nc = torch.tensor(shapes[l - 1], device=device)[:, None]
            g = g[:, (g % 2 == 1).any(0)]
            g = torch.where(g % 2 == 1, nc + (g - 1) // 2, g // 2)
        parts.append((g * strides[:, None]).sum(0))
    return torch.cat(parts)


def _x_linearized_to_corner(q: torch.Tensor, shape, l_target: int
                            ) -> torch.Tensor:
    """Scatter a reorder=1 (level-linearized) stream into the Mallat
    corner layout (``mgard_compat.py:799-823``)."""
    F = torch.empty(int(np.prod(shape)), dtype=q.dtype, device=q.device)
    F[_x_linear_order(shape, l_target, q.device)] = q
    return F.reshape(tuple(shape))


def _x_corner_to_linearized(F: torch.Tensor, l_target: int) -> torch.Tensor:
    """Inverse of :func:`_x_linearized_to_corner`."""
    return F.reshape(-1)[_x_linear_order(tuple(F.shape), l_target,
                                         F.device)]


def _x_dequant_corner(q_corner: torch.Tensor, hier, l_target: int,
                      tol: float, s: float, snorm: bool) -> torch.Tensor:
    """Dequantize a corner-layout int64 tensor to float64: one scalar
    quantum at L-inf, :func:`_x_level_factors` by level at finite s."""
    shape = hier.shape
    if not snorm:
        d_eff = sum(1 for n in shape if n > 1)
        quantum = 2.0 * tol / ((l_target + 1) * (1 + 3.0 ** d_eff))
        return q_corner.to(torch.float64) * quantum
    factors = _x_level_factors(shape, l_target, tol, s)
    fine = torch.empty(shape, dtype=torch.float64, device=q_corner.device)
    for (l, _, _, _), sl in zip(transform.block_specs(hier),
                                _x_corner_slices(hier)):
        fine[sl] = q_corner[sl].to(torch.float64) * float(factors[l])
    return fine


def _x_recompose(hier: Hierarchy, fine: torch.Tensor) -> torch.Tensor:
    """Recompose a corner-layout coefficient array in its dtype (float64
    in the X readers, as in the JAX package): its (level, region) blocks
    interleaved back into the pyramid."""
    return transform.recompose(hier, transform.blocks_to_pyramid(
        hier, [fine[sl] for sl in _x_corner_slices(hier)]))


def _decode_x_subdomain(shape, dtype, compressor, blob: bytes, tol: float,
                        s: float, snorm: bool, reorder: bool, device
                        ) -> torch.Tensor:
    """Decode one subdomain's compressed stream (reference
    CompressionLowLevel Compressor::Decompress)."""
    hier, l_target = _x_hierarchy(shape)
    itemsize = np.dtype(dtype).itemsize
    # CR < 1 fallback: raw subdomain bytes (CPUPipelines.hpp:115-134),
    # detectable by exact size.
    if len(blob) == int(np.prod(shape)) * itemsize:
        return torch.from_numpy(np.frombuffer(blob, dtype=dtype).reshape(
            shape).copy()).to(device)
    if compressor == X_HUFFMAN_ZSTD:
        import zstandard
        blob = zstandard.ZstdDecompressor().decompress(
            blob[8:], max_output_size=int(
                struct.unpack_from("<Q", blob, 0)[0]))
    elif compressor != X_HUFFMAN:
        raise NotImplementedError(f"MGARD-X compressor {compressor}")
    q = _decode_x_huffman(blob, device)
    if reorder:
        q_corner = _x_linearized_to_corner(q, shape, l_target)
    else:
        q_corner = q.reshape(shape)
    fine = _x_dequant_corner(q_corner, hier, l_target, tol, s, snorm)
    del q, q_corner
    return _x_recompose(hier, fine).to(TORCH_DTYPE[np.dtype(dtype)])


def _x_subdomains(shape, dd: dict):
    """Subdomain (shape, origin) list in serialization order (reference
    DomainDecomposer.hpp:124-160 subdomain_shape / dim_subdomain_id:
    MaxDim = slabs of decomposition_size along decomposition_dimension,
    Block = an N-D grid of decomposition_size cubes in raster order with
    the last dim fastest; last chunks carry the remainders)."""
    method = int(dd.get("method", 0))
    if method == 0:
        return [(tuple(shape), tuple(0 for _ in shape))]
    if method == 1:   # MAX_DIMENSION
        dim = int(dd.get("decomposition_dimension", 0))
        size = int(dd["decomposition_size"])
        subs = []
        for lo in range(0, shape[dim], size):
            bshape = list(shape)
            bshape[dim] = min(size, shape[dim] - lo)
            origin = [0] * len(shape)
            origin[dim] = lo
            subs.append((tuple(bshape), tuple(origin)))
        return subs
    if method == 2:   # BLOCK
        size = int(dd["decomposition_size"])
        counts = [(n - 1) // size + 1 for n in shape]
        subs = []
        for flat in range(int(np.prod(counts))):
            idx, rem = [], flat
            for c in reversed(counts):
                idx.append(rem % c)
                rem //= c
            idx = idx[::-1]
            bshape = tuple(size if i < n // size else n % size
                           for i, n in zip(idx, shape))
            origin = tuple(i * size for i in idx)
            subs.append((bshape, origin))
        return subs
    raise NotImplementedError(
        "MGARD-X buffers: VARIABLE domain decomposition is not decodable "
        "from the header alone (the reference does not serialize the "
        "per-subdomain sizes; its own decompressor needs them from "
        "config too)")


def _decompress_mgard_x(header, payload: bytes, device) -> np.ndarray:
    """Decode an MGARD-X (mgard-x executable) buffer — reference
    Metadata.hpp:20-160 preamble + per-subdomain Compressor streams.

    Supported: MultiDim uniform grids (``function_decomposition.hierarchy``
    1, ``domain.geometry`` 0), reorder 0 and 1 (level-linearized), L-inf
    and s-norm error control, ABS/REL, X_HUFFMAN / X_HUFFMAN_ZSTD,
    MaxDim/Block domain decomposition, 2^k+1 level-compatible
    (sub)domain shapes.  A buffer with explicit coordinates or another
    hierarchy raises NotImplementedError (the JAX package decodes both
    with the uniform MultiDim math, which is not their inverse)."""
    domain = _need(header, "domain")
    if domain.get("geometry", 0) == 1:
        raise NotImplementedError(
            "MGARD-X buffers with explicit coordinates (domain.geometry = "
            "1): the reader implements the uniform MultiDim grid only")
    hierarchy = header.get("function_decomposition", {}).get("hierarchy", 0)
    if hierarchy != X_MULTIDIM_HIERARCHY:
        raise NotImplementedError(
            f"MGARD-X buffers with function_decomposition.hierarchy = "
            f"{hierarchy}: the reader implements the MultiDim hierarchy "
            f"({X_MULTIDIM_HIERARCHY}) only")
    topo = _need(domain, "cartesian_grid_topology", "domain")
    shape = tuple(int(x) for x in topo["shape"])
    dtype = (np.float32 if _need(header, "dataset")["type"] == DATASET_FLOAT
             else np.float64)
    ec = _need(header, "error_control")
    snorm = ec["norm"] != NORM_L_INFINITY
    s = float(ec.get("s", math.inf)) if snorm else math.inf
    tol = ec["tolerance"]
    dd = header.get("domain_decomposition", {})
    subs = _x_subdomains(shape, dd)
    # local per-subdomain ABS tolerance (reference calc_local_abs_tol,
    # ErrorToleranceCalculator.hpp:135-154)
    if ec["mode"] == 1:   # RELATIVE
        tol = tol * ec["norm_of_original_data"]
    if snorm:
        tol = math.sqrt(tol * tol / len(subs))
    encoding = _need(header, "encoding")
    reorder = encoding.get("preprocessor", 0) != 0
    compressor = encoding["compressor"]

    out = np.empty(shape, dtype=dtype)
    off = 0
    for bshape, origin in subs:
        (sub_size,) = struct.unpack_from("<Q", payload, off)
        off += 8
        blob = payload[off:off + sub_size]
        off += int(sub_size)
        sl = tuple(slice(o, o + n) for o, n in zip(origin, bshape))
        out[sl] = _decode_x_subdomain(bshape, dtype, compressor, blob, tol,
                                      s, snorm, reorder, device
                                      ).cpu().numpy()
    return out


def _x_quantized(data: np.ndarray, tolerance: float, s: float, mode: str,
                 dev):
    """The MGARD-X int64 stream of ``data`` in the Mallat corner layout
    (a tensor of ``data``'s shape on ``dev``), with the header's T-typed
    tolerance and the REL norm (1.0 in ABS mode)."""
    if data.dtype not in (np.float32, np.float64):
        raise TypeError("MGARD-X write path: float32/float64 only")
    hier, l_target = _x_hierarchy(data.shape)
    v = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    blocks = transform.pyramid_to_blocks(hier, transform.decompose(hier, v))
    del v
    F = torch.zeros(data.shape, dtype=torch.float64, device=dev)
    for sl, blk in zip(_x_corner_slices(hier), blocks):
        F[sl] = blk.reshape(F[sl].shape).to(torch.float64)
    del blocks

    d_eff = sum(1 for n in data.shape if n > 1)
    # T-typed tol (Metadata stores the T cast; mirror for header parity)
    tol_t = float(np.asarray(tolerance, dtype=data.dtype))
    snorm = not math.isinf(s)
    # REL -> ABS via the X NormCalculator's norm (L-inf for s=inf, the
    # RMS otherwise: ErrorToleranceCalculator.hpp calc_norm_decomposed
    # with normalize_coordinates=true), in host numpy as the JAX package
    # computes it, so that the headers are byte for byte the same
    norm = 1.0
    abs_tol = tol_t
    if mode == "rel":
        norm = float(np.abs(data).max()) if not snorm \
            else float(np.sqrt(np.mean(data.astype(np.float64) ** 2)))
        abs_tol = tol_t * norm
    if not snorm:
        quantum = 2.0 * abs_tol / ((l_target + 1) * (1 + 3.0 ** d_eff))
        F /= _device_tensor(np.full(1, quantum), torch.float64, dev)
    else:
        # levelwise quantizers * uniform level volumes, the exact
        # inverse of _x_dequant_corner (LinearQuantization.hpp:495-545)
        factors = _device_tensor(np.asarray(_x_level_factors(
            data.shape, l_target, abs_tol, s), np.float64), torch.float64,
            dev)
        for (l, _, _, _), sl in zip(transform.block_specs(hier),
                                    _x_corner_slices(hier)):
            F[sl] /= factors[l:l + 1]
    return _round_half_away(F), tol_t, norm


def compress_mgard_x(data: np.ndarray, tolerance: float,
                     zstd: bool = True, dict_size: int = 8192,
                     chunk_size: int = 20480, s: float = math.inf,
                     mode: str = "abs", device=None) -> bytes:
    """Compress into the MGARD-X container format (decodable by
    `mgard-x -d`): Metadata preamble (little-endian ints) + proto header
    + |u64 sub_size| + X-Huffman stream over the Mallat corner-layout
    quantization.  The encode mirror of the X reader.  Support matrix:
    uniform grids, MultiDim, reorder=0, 2^k+1-compatible shapes, L-inf
    and finite-s error control, ABS and REL modes.  CR<1 falls back to
    raw subdomain bytes (CPUPipelines.hpp:115-134)."""
    if zstd:
        import zstandard
    data = np.asarray(data)
    q, tol_t, norm = _x_quantized(data, tolerance, s, mode,
                                  resolve_device(device))
    snorm = not math.isinf(s)

    blob = _encode_x_huffman(q.reshape(-1), dict_size, chunk_size)
    del q
    raw = data.tobytes()
    # Match the reference's EFFECTIVE raw-fallback boundary at the
    # pre-zstd blob size: its Huffman blob carries a ~66 KB decodebook
    # that zstd barely helps in its pipeline, so small inputs always
    # take its CR<1 raw path — and its serial decoder dies with SIGFPE
    # on Huffman-coded buffers below that boundary.  Falling back at the
    # same boundary keeps every buffer written inside the set the binary
    # actually decodes.
    small = len(blob) >= len(raw)
    compressor = X_HUFFMAN
    if zstd:
        blob = struct.pack("<Q", len(blob)) + \
            zstandard.ZstdCompressor(level=3).compress(blob)
        compressor = X_HUFFMAN_ZSTD
    if small or len(blob) >= len(raw):  # CR < 1: store the subdomain raw
        blob = raw
        compressor = X_HUFFMAN_ZSTD if zstd else X_HUFFMAN
    payload = struct.pack("<Q", len(blob)) + blob

    header = {
        "mgard_version": {"major_": 1, "minor_": 0, "patch_": 0},
        "file_format_version": {"major_": 0, "minor_": 0, "patch_": 0},
        "domain": {
            "topology": 0,
            "cartesian_grid_topology": {
                "dimension": data.ndim,
                "shape": list(data.shape),
            },
            "geometry": 0,
        },
        "dataset": {
            "type": DATASET_FLOAT if data.dtype == np.float32
            else DATASET_DOUBLE,
            "dimension": 1,
        },
        "error_control": {
            "mode": 1 if mode == "rel" else 0,
            "norm": NORM_S_NORM if snorm else NORM_L_INFINITY,
            "s": s,
            "tolerance": tol_t,
            **({"norm_of_original_data": norm}
               if mode == "rel" else {}),
        },
        "domain_decomposition": {
            "method": 0,
            "decomposition_size": data.shape[0],
        },
        "function_decomposition": {
            "transform": 0, "hierarchy": X_MULTIDIM_HIERARCHY,
            "L_target": 0,
        },
        "quantization": {"method": 1, "bin_widths": 0, "type": 3,
                         "big_endian": 0},
        "encoding": {
            "preprocessor": 0,
            "compressor": compressor,
            "huffman_dictionary_size": dict_size,
            "huffman_block_size": chunk_size,
        },
        "device": {"backend": 1},
    }
    return write_container(header, payload, little_endian=True)


# --- the CPU-format reader ---------------------------------------------------

def decompress_mgard(buf: bytes, device=None) -> np.ndarray:
    """Decompress a reference MGARD buffer: the CPU format
    (CPU_HUFFMAN_ZLIB, CPU_HUFFMAN_ZSTD) or the MGARD-X one."""
    from .huffman_native import huffman_decode

    dev = resolve_device(device)
    header, payload = read_container(bytes(buf))

    domain = _need(header, "domain")
    compressor = _need(header, "encoding")["compressor"]
    if compressor in (X_HUFFMAN, X_HUFFMAN_LZ4, X_HUFFMAN_ZSTD):
        return _decompress_mgard_x(header, payload, dev)
    topo = _need(domain, "cartesian_grid_topology", "domain")
    shape = tuple(int(x) for x in topo["shape"])
    coordinates = None
    if domain.get("geometry") == 1:
        coords_flat = np.asarray(
            domain["explicit_cube_geometry"]["coordinates"])
        coordinates, off = [], 0
        for n in shape:
            coordinates.append(coords_flat[off:off + n])
            off += n
    dtype = (np.float32 if _need(header, "dataset")["type"] == DATASET_FLOAT
             else np.float64)
    ec = _need(header, "error_control")
    s = math.inf if ec["norm"] == NORM_L_INFINITY else ec["s"]
    tol = ec["tolerance"]
    if ec["mode"] == 1:  # RELATIVE
        tol = tol * ec["norm_of_original_data"]
    if _need(header, "quantization").get("type", 3) != 3:
        raise NotImplementedError("only INT64_T quantization supported")

    hier = _reference_hierarchy(shape, coords_key(coordinates))
    ndof = hier.ndof()
    if compressor == CPU_HUFFMAN_ZSTD:
        import zstandard
        tree_size, hit_bits, miss_size = struct.unpack_from(
            "<QQQ", payload, 0)
        inner_size = tree_size + hit_bits // 8 + 4 + miss_size
        inner = zstandard.ZstdDecompressor().decompress(
            payload[24:], max_output_size=inner_size)
        tree = inner[:tree_size]
        hit = inner[tree_size:tree_size + hit_bits // 8 + 4]
        miss = inner[tree_size + hit_bits // 8 + 4:]
        q = huffman_decode(tree, hit, hit_bits, miss, ndof)
    elif compressor == CPU_HUFFMAN_ZLIB:
        # plain zlib over raw int64 (src/compressors.cpp:686-688)
        q = np.frombuffer(zlib.decompress(payload), dtype="<i8")
    else:
        raise NotImplementedError(f"compressor {compressor}")
    if q.size != ndof:
        raise ValueError(f"corrupted buffer: {q.size} quantized values for "
                         f"{ndof} nodes")

    perm, quanta = _quanta_shuffled(hier, s, tol)
    flat = torch.empty(ndof, dtype=torch.float64, device=dev)
    flat[_device_tensor(perm, torch.int64, dev)] = _device_tensor(
        q, torch.int64, dev).to(torch.float64) * _device_tensor(
            quanta, torch.float64, dev)
    # the recompose runs in the data's dtype, as the JAX package's does
    tdtype = TORCH_DTYPE[np.dtype(dtype)]
    out = transform.recompose(hier, transform.unflatten_pyramid(
        hier, flat.to(tdtype)))
    return out.cpu().numpy().astype(dtype)

"""High-level API: ``compress`` an array to a self-describing buffer and
``decompress`` it again (the port of the single-domain path of
``mgard_tpu/api.py``).

Both run on the GPU (``device=None`` means ``"cuda"``) unless the caller
asks for the CPU; without a card and without ``device="cpu"`` they raise.
Containers are the JAX package's: each package decodes the other's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from .config import Config, Decomposition, ErrorMode, Layout
from .io import format as fmt
from .models.compressor import _not_ported, get_compressor

__all__ = ["compress", "decompress", "resolve_device",
           "estimate_memory_footprint", "adjust_shape"]


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


def estimate_memory_footprint(shape, dtype=np.float32) -> int:
    """Device bytes needed to compress an array of this shape: the JAX
    package's estimate (input, pyramid, stream capacity, temporaries;
    3.9x the input bytes with a 1.15 safety factor), kept so that both
    packages make the same domain-decomposition decision."""
    n = int(np.prod([int(s) for s in shape]))
    item = np.dtype(dtype).itemsize
    return int(n * item * 3.9 * 1.15) + (32 << 20)


def _device_memory_budget(device: torch.device) -> int:
    """Free bytes of the CUDA device; on the CPU the JAX package's
    fallback of 12 GiB."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    return 12 << 30


def plan_blocks(shape, dtype, cfg: Config, device: torch.device) -> int:
    """Number of domain-decomposition slabs (``mgard_tpu/api.py:68``)."""
    nbytes = int(np.prod([int(x) for x in shape])) * np.dtype(dtype).itemsize
    budget = cfg.max_memory_footprint or _device_memory_budget(device)
    est = estimate_memory_footprint(shape, dtype)
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


def _needs_blocks(shape, dtype, coordinates, cfg: Config,
                  dev: torch.device) -> bool:
    """Whether the JAX package would reshape the input or split it into
    blocks (``mgard_tpu/api.py:105-133``) rather than write one
    single-domain container."""
    if cfg.adjust_shape and coordinates is None \
            and adjust_shape(shape) != tuple(shape):
        return True
    if cfg.dd_method == "block":
        grid = [1 if s == 1 else max(1, -(-s // cfg.block_edge))
                for s in shape]
        if int(np.prod(grid)) > 1:
            return True
    return cfg.dd_sizes is not None \
        or plan_blocks(shape, dtype, cfg, dev) > 1


def compress(data, tolerance: float, s: float = math.inf,
             mode: str = "abs",
             coordinates: Optional[Sequence[np.ndarray]] = None,
             config: Optional[Config] = None, device=None) -> bytes:
    """Compress a float32 or float64 array (numpy or torch) with a
    guaranteed error bound ``tolerance``: ``max|data - out|`` for ``s =
    inf``, else the s-norm ``||data - out||_s`` (``s = 0`` the L2 norm on
    the grid, see ``ops/norms.py``).  ``mode="rel"`` scales the
    tolerance by ``max|data|`` (``s = inf``) or by ``sqrt(sum data^2)``
    (finite ``s``)."""
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        shape, dtype = tuple(data.shape), np.dtype(
            str(data.dtype).replace("torch.", ""))
    else:
        data = np.asarray(data)
        shape, dtype = data.shape, data.dtype
    if dtype not in (np.float32, np.float64):
        raise TypeError("only float32/float64 data is supported")
    emode = ErrorMode.REL if mode == "rel" else ErrorMode.ABS
    cfg = config or Config()
    if _needs_blocks(tuple(int(x) for x in shape), dtype, coordinates, cfg,
                     dev):
        raise _not_ported("multi-block compression (domain decomposition, "
                          "a reshaping adjust_shape)", "queue A, item 2")
    comp = get_compressor(shape, dtype, s=s, coordinates=coordinates,
                          config=cfg, device=dev)
    return comp.compress(data, tolerance, mode=emode)


def _config_from_header(header: fmt.Header) -> Config:
    if header.decomposition >= 2:
        raise _not_ported("the hybrid decomposition", "queue A, item 1")
    return Config(decomposition=Decomposition(header.decomposition),
                  layout=Layout(header.layout))


def compressor_for(header: fmt.Header, device=None):
    """The compressor that decodes a parsed container."""
    if header.dd_grid is not None or header.dd_nblocks:
        raise _not_ported("multi-block containers", "queue A, item 2")
    if header.roi_block:
        raise _not_ported("ROI containers", "queue A, item 6")
    if header.orig_shape is not None:
        raise _not_ported("adjust_shape containers", "queue A, item 2")
    return get_compressor(header.shape, header.dtype, s=header.s,
                          coordinates=header.coordinates,
                          config=_config_from_header(header),
                          chunk_groups=header.chunk_groups or 2048,
                          device=resolve_device(device))


def decompress(buf: bytes, device=None) -> np.ndarray:
    """Decompress a self-describing buffer written by either package."""
    buf = bytes(buf)
    if buf[:8] != fmt.MAGIC and buf[:5] == b"MGARD":
        raise _not_ported("reference MGARD buffers", "queue A, item 7")
    header, sections = fmt.read_container(buf)
    return compressor_for(header, device).decompress_parsed(header,
                                                            sections)

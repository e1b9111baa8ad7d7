"""Domain decomposition: split oversized inputs into independent blocks
(the port's own copy of ``mgard_tpu/parallel/domain.py``, numpy only).

Counterpart of mgard_x::DomainDecomposer
(include/mgard-x/DomainDecomposer/DomainDecomposer.hpp:72-170): blocks are
compressed independently (the reference's data-parallel axis), and the
error budget is split so the global bound still holds:

  * L-infinity: every block gets the full tolerance;
  * L2 / s-norm: tol_block = sqrt(tol^2 / num_blocks)
    (reference calc_local_abs_tol,
    include/mgard-x/CompressionHighLevel/ErrorToleranceCalculator.hpp:135).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["DomainDecomposer", "local_abs_tol", "block_grid_blocks"]


def local_abs_tol(tol: float, s: float, num_blocks: int) -> float:
    if math.isinf(s):
        return tol
    return math.sqrt(tol * tol / num_blocks)


def block_grid_blocks(shape: Sequence[int], grid: Sequence[int]):
    """Deterministic raster-order (origin, block_shape) list for a Block
    (N-D) decomposition: dim d splits at
    ``np.linspace(0, shape[d], grid[d]+1).astype(int)`` — the same rule
    on the compress and decompress sides, so only the per-dim counts
    travel in the container header (``Header.dd_grid``)."""
    import itertools

    shape = tuple(int(x) for x in shape)
    grid = tuple(int(g) for g in grid)
    edges = [np.linspace(0, s, g + 1).astype(int)
             for s, g in zip(shape, grid)]
    out = []
    for idx in itertools.product(*[range(g) for g in grid]):
        origin = tuple(int(edges[d][i]) for d, i in enumerate(idx))
        bshape = tuple(int(edges[d][i + 1] - edges[d][i])
                       for d, i in enumerate(idx))
        out.append((origin, bshape))
    return out


class DomainDecomposer:
    """Split an N-D shape into blocks.

    ``method="max_dim"`` splits only the largest dimension (reference
    MaxDim); ``method="block"`` produces uniform N-D blocks of edge
    ``block_edge`` (reference Block).
    """

    def __init__(self, shape: Sequence[int], max_block_bytes: int,
                 itemsize: int, method: str = "max_dim",
                 block_edge: int = 256):
        self.shape = tuple(int(x) for x in shape)
        self.method = method
        nbytes = int(np.prod(self.shape)) * itemsize
        self.blocks: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
        if nbytes <= max_block_bytes:
            self.blocks.append((tuple([0] * len(self.shape)), self.shape))
            return
        if method == "block":
            self.grid = tuple(
                1 if s == 1 else max(1, -(-s // block_edge))
                for s in self.shape)
            for origin, bshape in block_grid_blocks(self.shape, self.grid):
                self.blocks.append((origin, bshape))
            return
        # max_dim: split the largest dim into the fewest equal-ish chunks
        # that fit the byte budget.
        d = int(np.argmax(self.shape))
        nsplit = max(2, -(-nbytes // max_block_bytes))
        edges = np.linspace(0, self.shape[d], nsplit + 1).astype(int)
        for a, b in zip(edges[:-1], edges[1:]):
            if b <= a:
                continue
            origin = [0] * len(self.shape)
            origin[d] = int(a)
            bshape = list(self.shape)
            bshape[d] = int(b - a)
            self.blocks.append((tuple(origin), tuple(bshape)))

    def __len__(self):
        return len(self.blocks)

    def slices(self, i: int):
        origin, bshape = self.blocks[i]
        return tuple(slice(o, o + n) for o, n in zip(origin, bshape))

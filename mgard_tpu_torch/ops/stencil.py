"""Shift-stencil forms of the interpolation operators (the counterpart of
``mgard_tpu/ops/stencil.py``).

When every non-flat dim of a level is stride-2 or front-interleaved, the
parents of a new node sit at positions +-1, so the multilinear
interpolation of the parent grid is a composition of per-dim rolls and
parity masks, in any number of dims and in either dtype:

    B_d(V)[x] = V[x]                                   x_d parental
              = (1-r)*V[x - e_d] + r*V[x + e_d]        x_d new

    P(C)  at every node  =  (B_{D-1} o ... o B_0)(A)          [encode]
    detail = A - P(C)   (exact zeros at all-parent nodes)

Each B_d only reads positions that are parental in dims d..D-1, which
already carry the right partial interpolation; a value rolled in across
an edge is never selected, since the first and the last position of a
dim are always parental.

This is plain PyTorch on any device: the reference the GPK kernels
(``ops/stencil_kernels.py``, K5-K10) derive from, with no gate on the
rank, the dtype or the sizes.  The lerp is ``(1 - w) * left + w *
right`` in the data's dtype, then a select on the mask, the order of
the JAX module's operations, so that each product and the sum round as
they do there.  The composition order is dim 0, 1, ..., D-1; K5/K6 run
dim 2, 0, 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hierarchy import Hierarchy

__all__ = ["supported", "interp_all", "detail_stencil"]


def supported(hier: Hierarchy, l: int) -> bool:
    """True when every non-flat dim of level ``l`` is stride-2 or
    front-interleaved (parents of new nodes at +-1)."""
    for d in range(hier.ndim):
        if hier.shape[d] == 1:
            continue
        lev = hier.dims[d][l]
        if lev.coarse_pos is None:
            continue
        if not (lev.coarse_is_stride2 or lev.front_nc is not None):
            return False
    return True


def _interp_vectors(hier: Hierarchy, l: int):
    """Per-dim (mask, weight) float64 vectors over the level-l grid:
    mask = 1 at new nodes, weight = interpolation ratio there (host,
    cached on the hierarchy); None for a dim with nothing to lerp."""
    cache = hier.__dict__.setdefault("_stencil_vecs", {})
    if l not in cache:
        vecs = []
        for d in range(hier.ndim):
            if hier.shape[d] == 1:
                vecs.append(None)
                continue
            lev = hier.dims[d][l]
            if lev.coarse_pos is None or lev.new_pos is None \
                    or len(lev.new_pos) == 0:
                vecs.append(None)
                continue
            m = np.zeros(lev.n, dtype=np.float64)
            w = np.zeros(lev.n, dtype=np.float64)
            m[lev.new_pos] = 1.0
            w[lev.new_pos] = lev.new_ratio
            vecs.append((m, w))
        cache[l] = vecs
    return cache[l]


def _interp_dim(V: torch.Tensor, m: np.ndarray, w: np.ndarray,
                axis: int) -> torch.Tensor:
    """Apply B_d along ``axis``: lerp new positions from their +-1
    parental neighbours, keep parental positions bit-exactly."""
    shp = [1] * V.ndim
    shp[axis] = V.shape[axis]
    mt = torch.from_numpy(m).to(device=V.device, dtype=V.dtype).reshape(shp)
    wt = torch.from_numpy(w).to(device=V.device, dtype=V.dtype).reshape(shp)
    left = torch.roll(V, 1, dims=axis)
    right = torch.roll(V, -1, dims=axis)
    lerp = (1 - wt) * left + wt * right
    return torch.where(mt != 0, lerp, V)


def interp_all(hier: Hierarchy, V: torch.Tensor, l: int) -> torch.Tensor:
    """(B_{D-1} o ... o B_0)(V): multilinear interpolation of the
    parental sub-grid onto every node of the level-l grid.  Parental
    values pass through untouched."""
    for d, mv in enumerate(_interp_vectors(hier, l)):
        if mv is not None:
            V = _interp_dim(V, mv[0], mv[1], d)
    return V


def detail_stencil(hier: Hierarchy, A: torch.Tensor, l: int
                   ) -> torch.Tensor:
    """detail = A - P(extract(A)) without materializing the coarse
    array or the prolongation: exact zeros at all-parent nodes."""
    return A - interp_all(hier, A, l)

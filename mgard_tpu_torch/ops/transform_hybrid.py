"""Hybrid decomposition: block-local levels, then the global transform
(the port of ``mgard_tpu/ops/transform_hybrid.py``; reference
HybridHierarchyCompressor, IndexTable8x8x8).

The finest level(s) are decomposed block by block: each 8-node span of
a dim keeps 5 coarse nodes ({0, 2, 4, 6, 7}) and gets 3 detail
coefficients ({1, 3, 5}), by interpolation and an L2 projection inside
the block.  The standard transform (``ops/transform.py``) then runs on
the packed coarse grid, whose hierarchy carries explicit coordinates.

Each per-dim operator is a small dense (8 -> 5 or 5 -> 8) product over
the blocks of a dim: one matrix on a uniform grid, one a block on a
nonuniform one (:func:`hybrid_operators`).  The JAX package computes
them with ``dot_general`` at ``Precision.HIGHEST`` outside any Pallas
kernel; here they are ``torch.tensordot`` / ``torch.bmm`` in the data's
dtype (full float32: the package turns TF32 off at import).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..hierarchy import Hierarchy
from . import transform
from .tridiag import cached_tensor

BLOCK = 8
COARSE = 5  # nodes {0, 2, 4, 6, 7} of each 8-node block
_COARSE_POS = np.array([0, 2, 4, 6, 7])
_NEW_POS = np.array([1, 3, 5])

__all__ = [
    "coarse_shape", "padded_shape", "decompose_hybrid", "recompose_hybrid",
    "flatten_hybrid", "unflatten_hybrid", "hybrid_stream_size",
    "hybrid_coords", "hybrid_operators", "hybrid_volume_weights",
]


def _local_mats():
    """(E, P, K): the extract (5, 8), prolong (8, 5) and correction (5,
    8) operators of one uniform 8-node block."""
    h = np.ones(BLOCK - 1)
    E = np.zeros((COARSE, BLOCK))
    E[np.arange(COARSE), _COARSE_POS] = 1.0
    # coarse nodes keep their values; new node 2j+1 lerps 2j and 2j+2
    P = np.zeros((BLOCK, COARSE))
    P[_COARSE_POS, np.arange(COARSE)] = 1.0
    for k, pos in enumerate(_NEW_POS):
        P[pos, k] = 0.5
        P[pos, k + 1] = 0.5
    # correction: M5^{-1} R M8 with the block's mass matrices
    M8 = transform._mass_matrix_np(h)
    R = P.T
    M5 = transform._mass_matrix_np(np.array([2.0, 2.0, 2.0, 1.0]))
    K = np.linalg.solve(M5, R @ M8)
    return E, P, K


_E, _P, _K = _local_mats()


def _apply_blocked(M: np.ndarray, B: torch.Tensor, axis: int,
                   bsz: int) -> torch.Tensor:
    """Contract each length-``bsz`` block along ``axis`` with ``M`` (out,
    bsz)."""
    shp = tuple(B.shape)
    nb = shp[axis] // bsz
    B2 = B.reshape(shp[:axis] + (nb, bsz) + shp[axis + 1:])
    Mt = cached_tensor(M, B.dtype, B.device)
    out = torch.tensordot(Mt, B2, dims=([1], [axis + 1]))
    out = out.movedim(0, axis + 1)
    return out.reshape(shp[:axis] + (nb * M.shape[0],) + shp[axis + 1:])


def _apply_blocked_batched(Ms: np.ndarray, B: torch.Tensor, axis: int,
                           bsz: int) -> torch.Tensor:
    """Block b along ``axis`` contracted with its own ``Ms[b]`` ((out,
    bsz) each), one batched product."""
    shp = tuple(B.shape)
    nb = shp[axis] // bsz
    B3 = B.reshape(shp[:axis] + (nb, bsz) + shp[axis + 1:]).movedim(
        (axis, axis + 1), (0, 1))
    rest = B3.shape[2:]
    Mt = cached_tensor(Ms, B.dtype, B.device)
    out = torch.bmm(Mt, B3.reshape(nb, bsz, -1))
    out = out.reshape((nb, Ms.shape[1]) + tuple(rest)).movedim(
        (0, 1), (axis, axis + 1))
    return out.reshape(shp[:axis] + (nb * Ms.shape[1],) + shp[axis + 1:])


def _pad8(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _pad_coords(c: np.ndarray, target: int) -> np.ndarray:
    """A coordinate vector extended to ``target`` entries by repeating
    its last spacing (edge-padded values are synthetic; zero spacings
    would make the block mass matrices singular)."""
    if len(c) >= target:
        return c[:target]
    step = c[-1] - c[-2] if len(c) > 1 else 1.0
    extra = c[-1] + step * np.arange(1, target - len(c) + 1)
    return np.concatenate([c, extra])


def hybrid_coords(shape: Sequence[int], levels: int, coordinates):
    """Per local level, the padded coordinate vectors (finest first),
    then the packed coarse grid's: ``levels + 1`` lists."""
    cur = [np.asarray(c, dtype=np.float64) for c in coordinates]
    out = []
    shapes = padded_shape(shape, levels)
    for lvl in range(levels):
        cur = [(_pad_coords(c, t) if t > 1 else c)
               for c, t in zip(cur, shapes[lvl])]
        out.append(cur)
        cur = [(c.reshape(-1, BLOCK)[:, _COARSE_POS].reshape(-1)
                if len(c) > 1 else c) for c in cur]
    out.append(cur)
    return out


def hybrid_operators(shape: Sequence[int], levels: int, coordinates):
    """Per (local level, dim), the blocks' own operators from the node
    coordinates: ``(E, P, K)`` of shapes (nb, 5, 8), (nb, 8, 5), (nb, 5,
    8), or None for a flat dim."""
    ops = []
    for lvl_coords in hybrid_coords(shape, levels, coordinates)[:levels]:
        per_dim = []
        for c in lvl_coords:
            if len(c) <= 1:
                per_dim.append(None)
                continue
            nb = len(c) // BLOCK
            E = np.zeros((nb, COARSE, BLOCK))
            E[:, np.arange(COARSE), _COARSE_POS] = 1.0
            P = np.zeros((nb, BLOCK, COARSE))
            P[:, _COARSE_POS, np.arange(COARSE)] = 1.0
            K = np.zeros((nb, COARSE, BLOCK))
            xb = c.reshape(nb, BLOCK)
            for b in range(nb):
                x = xb[b]
                for k, pos in enumerate(_NEW_POS):
                    xl, xr = x[pos - 1], x[pos + 1]
                    r = (x[pos] - xl) / (xr - xl)
                    P[b, pos, k] = 1.0 - r
                    P[b, pos, k + 1] = r
                M8 = transform._mass_matrix_np(np.diff(x))
                M5 = transform._mass_matrix_np(np.diff(x[_COARSE_POS]))
                K[b] = np.linalg.solve(M5, P[b].T @ M8)
            per_dim.append((E, P, K))
        ops.append(per_dim)
    return ops


def hybrid_volume_weights(shape: Sequence[int], levels: int, coordinates):
    """Per (local level, dim), ``sqrt(vol)`` over the padded slab grid
    (half the distance between a node's neighbours in that level's
    mesh), for the s-norm quanta of the detail slabs."""
    out = []
    for lvl_coords in hybrid_coords(shape, levels, coordinates)[:levels]:
        per_dim = []
        for c in lvl_coords:
            if len(c) <= 1:
                per_dim.append(np.ones(1))
                continue
            vol = np.empty(len(c))
            vol[1:-1] = (c[2:] - c[:-2]) / 2
            vol[0] = (c[1] - c[0]) / 2
            vol[-1] = (c[-1] - c[-2]) / 2
            per_dim.append(np.sqrt(vol))
        out.append(per_dim)
    return out


def padded_shape(shape: Sequence[int], levels: int
                 ) -> List[Tuple[int, ...]]:
    """The padded shape of each local level, finest first."""
    out = []
    cur = list(shape)
    for _ in range(levels):
        cur = [_pad8(n) if n > 1 else 1 for n in cur]
        out.append(tuple(cur))
        cur = [n // BLOCK * COARSE if n > 1 else 1 for n in cur]
    return out


def coarse_shape(shape: Sequence[int], levels: int) -> Tuple[int, ...]:
    """The packed coarse grid after ``levels`` local levels."""
    cur = list(shape)
    for _ in range(levels):
        cur = [_pad8(n) // BLOCK * COARSE if n > 1 else 1 for n in cur]
    return tuple(cur)


def _edge_pad(v: torch.Tensor, target: Sequence[int]) -> torch.Tensor:
    """``v`` padded at the end of each dim to ``target`` by repeating its
    last entry there (``jnp.pad(mode="edge")`` on any number of dims)."""
    for d, t in enumerate(target):
        n = v.shape[d]
        if t > n:
            shp = list(v.shape)
            shp[d] = t - n
            v = torch.cat([v, v.narrow(d, n - 1, 1).expand(shp)], dim=d)
    return v


def _local_decompose_level(v: torch.Tensor, ops=None):
    """One block-local level over every non-flat dim: ``(coarse,
    detail)``, the detail of the padded level shape with exact zeros at
    the blocks' coarse nodes.  ``ops``: the per-dim (E, P, K) of
    :func:`hybrid_operators` (nonuniform grids), or None."""
    dims = [d for d in range(v.dim()) if v.shape[d] > 1]

    def apply(X, which, d, bsz):
        if ops is None:
            return _apply_blocked((_E, _P, _K)[which], X, d, bsz)
        return _apply_blocked_batched(ops[d][which], X, d, bsz)

    C = v
    for d in dims:
        C = apply(C, 0, d, BLOCK)
    P = C
    for d in dims:
        P = apply(P, 1, d, COARSE)
    detail = v - P
    del P
    corr = detail
    for d in dims:
        corr = apply(corr, 2, d, BLOCK)
    return C + corr, detail


def _local_recompose_level(coarse: torch.Tensor, detail: torch.Tensor,
                           ops=None) -> torch.Tensor:
    dims = [d for d in range(detail.dim()) if detail.shape[d] > 1]

    def apply(X, which, d, bsz):
        if ops is None:
            return _apply_blocked((_E, _P, _K)[which], X, d, bsz)
        return _apply_blocked_batched(ops[d][which], X, d, bsz)

    corr = detail
    for d in dims:
        corr = apply(corr, 2, d, BLOCK)
    P = coarse - corr
    del corr
    for d in dims:
        P = apply(P, 1, d, COARSE)
    return P + detail


def decompose_hybrid(hier_coarse: Hierarchy, v: torch.Tensor, levels: int,
                     ops=None):
    """``levels`` block-local levels, then the standard transform on the
    packed coarse grid (``hier_coarse``, of :func:`coarse_shape`):
    ``(global pyramid, details finest first)``."""
    shapes = padded_shape(v.shape, levels)
    details = []
    A = v
    for lvl in range(levels):
        A = _edge_pad(A, shapes[lvl])
        A, detail = _local_decompose_level(
            A, None if ops is None else ops[lvl])
        details.append(detail)
    if tuple(A.shape) != hier_coarse.shape:
        raise ValueError(f"coarse grid {tuple(A.shape)} is not the "
                         f"hierarchy's {hier_coarse.shape}")
    return transform.decompose(hier_coarse, A), details


def recompose_hybrid(hier_coarse: Hierarchy, pyramid, details,
                     out_shape: Sequence[int], ops=None) -> torch.Tensor:
    """Exact inverse of :func:`decompose_hybrid`, cut to ``out_shape``."""
    shapes = padded_shape(out_shape, len(details))
    # each local level's input shape before its padding
    pre = [tuple(out_shape)]
    for lvl in range(1, len(details)):
        pre.append(tuple(n // BLOCK * COARSE if n > 1 else 1
                         for n in shapes[lvl - 1]))
    A = transform.recompose(hier_coarse, pyramid)
    for lvl in range(len(details) - 1, -1, -1):
        A = _local_recompose_level(A, details[lvl],
                                   None if ops is None else ops[lvl])
        A = A[tuple(slice(0, n) for n in pre[lvl])]
    return A


def hybrid_stream_size(shape: Sequence[int], levels: int) -> int:
    """Values in the serialized hybrid stream."""
    n = int(np.prod(coarse_shape(shape, levels)))
    for s in padded_shape(shape, levels):
        n += int(np.prod(s))
    return n


def flatten_hybrid(hier_coarse: Hierarchy, pyramid, details
                   ) -> torch.Tensor:
    """The global part in fine order (:func:`transform.pyramid_to_fine`),
    then the detail slabs finest first, each whole (its zeros at block
    coarse nodes cost the codec nothing)."""
    fine = transform.pyramid_to_fine(hier_coarse, pyramid).reshape(-1)
    return torch.cat([fine] + [d.reshape(-1) for d in details])


def unflatten_hybrid(hier_coarse: Hierarchy, flat: torch.Tensor,
                     shape: Sequence[int], levels: int):
    """Inverse of :func:`flatten_hybrid`: ``(pyramid, details)``."""
    n0 = hier_coarse.ndof()
    pyramid = transform.fine_to_pyramid(
        hier_coarse, flat[:n0].reshape(hier_coarse.shape))
    details, off = [], n0
    for s in padded_shape(shape, levels):
        size = int(np.prod(s))
        details.append(flat[off:off + size].reshape(s))
        off += size
    return pyramid, details

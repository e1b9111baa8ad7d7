"""Single-dimension-at-a-time decomposition (the port of
``mgard_tpu/ops/transform_singledim.py``; reference
``decomposition_type::SingleDim``).

Per level, the dims are split one after the other: splitting along dim
d gives that dim's detail coefficients (the 1-D interpolation residual
against the d-coarsened grid) and an L2 correction along d alone; the
next dims are split on the d-coarsened grid.  The correction is
``mass_apply`` and ``restrict`` along d, then the Thomas solve of the
level below along d: S1 (``csrc/tridiag.cu``) at every level and dim on
the card, as the JAX package runs its ``lax.scan`` there whatever
``MGARD_TPU_MATMUL_MAX_N`` says.

The coefficients are (level, dim) slabs, each a dense array: new along
d, parent nodes along the dims before d, every node along the dims after
it.  A level's tables leave the card after the level
(``tridiag.table_scope``).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..hierarchy import Hierarchy
from .quantize import TORCH_DTYPE, _NUMPY_DTYPE, _scalar, flat_quantum
from .transform import (_interleave_dim, _level_dims, _slice_axis,
                        extract_old, prolong, restrict)
from .tridiag import along_axis, cached_tensor, mass_apply, mass_solve, \
    table_scope

__all__ = ["decompose_sd", "recompose_sd", "slab_specs", "scale_slabs",
           "unscale_slabs", "flatten_slabs", "unflatten_slabs"]


def _extract_new(v: torch.Tensor, lev, axis: int) -> torch.Tensor:
    """The level's new nodes along ``axis``."""
    if lev.coarse_is_stride2:
        return _slice_axis(v, 1, lev.n, 2, axis)
    if lev.front_nc is not None:
        return _slice_axis(v, 1, 2 * lev.front_nc - 1, 2, axis)
    return v.index_select(axis, cached_tensor(lev.new_pos, torch.int64,
                                              v.device))


def _correct(hier: Hierarchy, detail: torch.Tensor, l: int, d: int):
    """The L2 correction of a dense detail along dim ``d`` alone."""
    lev = hier.dims[d][l]
    B = mass_apply(detail, lev.h, d)
    B = restrict(B, lev, d)
    clev = hier.dims[d][l - 1]
    return mass_solve(B, clev.offdiag, clev.divisors, d)


def decompose_sd(hier: Hierarchy, v: torch.Tensor):
    """``(coarse, slabs)`` with ``slabs[l][d]`` the level-l dim-d detail
    (``transform_singledim.py:42``)."""
    A = v
    slabs: List[dict] = [None] * (hier.L + 1)
    for l in range(hier.L, 0, -1):
        per_dim = {}
        with table_scope():
            for d in _level_dims(hier, l):
                lev = hier.dims[d][l]
                old = extract_old(A, lev, d)
                detail = A - prolong(old, lev, d)   # zero at parent nodes
                per_dim[d] = _extract_new(detail, lev, d)
                A = old + _correct(hier, detail, l, d)
                del detail, old
        slabs[l] = per_dim
    return A, slabs


def recompose_sd(hier: Hierarchy, coarse: torch.Tensor, slabs
                 ) -> torch.Tensor:
    """Exact inverse of :func:`decompose_sd`."""
    A = coarse
    for l in range(1, hier.L + 1):
        with table_scope():
            for d in reversed(_level_dims(hier, l)):
                lev = hier.dims[d][l]
                zshape = list(A.shape)
                zshape[d] = len(lev.coarse_pos) \
                    if lev.coarse_pos is not None else 1
                detail = _interleave_dim(A.new_zeros(zshape), slabs[l][d],
                                         lev, d)
                old = A - _correct(hier, detail, l, d)
                A = prolong(old, lev, d) + detail
                del detail, old
    return A


def slab_specs(hier: Hierarchy):
    """The serialized slabs, in order: ``(level, dim, shape)``, the
    coarse array first as ``(0, -1, shape)``."""
    specs = [(0, -1, hier.shapes[0])]
    for l in range(1, hier.L + 1):
        shape = list(hier.shapes[l])
        for d in _level_dims(hier, l):
            lev = hier.dims[d][l]
            s = list(shape)
            s[d] = len(lev.new_pos)
            specs.append((l, d, tuple(s)))
            shape[d] = len(lev.coarse_pos)
    return specs


def _slab_volume_vectors(hier: Hierarchy, l: int, d: int):
    """Per-axis ``sqrt(vol)`` vectors of slab (l, d): axis d at the
    level's new nodes, the axes before d at its parent nodes, the axes
    after d over the whole level grid (``transform_singledim.py:95``)."""
    vecs = []
    for a in range(hier.ndim):
        if hier.shape[a] == 1:
            vecs.append(np.ones(1))
            continue
        lev = hier.dims[a][l]
        vol = lev.volumes
        if a == d:
            vol = vol[np.asarray(lev.new_pos)]
        elif a < d and lev.coarse_pos is not None:
            vol = vol[np.asarray(lev.coarse_pos)]
        vecs.append(np.sqrt(vol))
    return vecs


def _coarse_vectors(hier: Hierarchy):
    return [np.ones(1) if hier.shape[a] == 1
            else np.sqrt(hier.dims[a][0].volumes) for a in range(hier.ndim)]


def _weigh(blk: torch.Tensor, vecs, scale: float, inverse: bool):
    """``blk`` times ``scale`` (cast to its dtype once), then times (or,
    ``inverse``, divided by) each axis's vector in axis order."""
    out = blk * _scalar(scale, blk)
    for a, w in enumerate(vecs):
        wt = along_axis(w, out, a)
        out = out / wt if inverse else out * wt
    return out


def scale_slabs(hier: Hierarchy, coarse, slabs, s: float, tol: float):
    """The slabs times their inverse quanta, not rounded
    (``transform_singledim.py:116``): the L-infinity quantum of the flat
    stream, or the levelwise s-norm quanta."""
    if math.isinf(s):
        _, inv = flat_quantum(hier, tol, _NUMPY_DTYPE[coarse.dtype])
        inv = torch.tensor(inv, device=coarse.device)
        return coarse * inv, [None if sl is None else
                              {d: b * inv for d, b in sl.items()}
                              for sl in slabs]
    sq_ndof = math.sqrt(hier.ndof())
    tol = float(tol)
    out_c = _weigh(coarse, _coarse_vectors(hier), sq_ndof / (2.0 * tol),
                   False)
    out_slabs: List[dict] = [None] * (hier.L + 1)
    for l in range(1, hier.L + 1):
        if slabs[l] is not None:
            scale = (2.0 ** (s * l)) * sq_ndof / (2.0 * tol)
            out_slabs[l] = {d: _weigh(b, _slab_volume_vectors(hier, l, d),
                                      scale, False)
                            for d, b in slabs[l].items()}
    return out_c, out_slabs


def unscale_slabs(hier: Hierarchy, coarse, slabs, s: float, tol: float,
                  dtype):
    """Inverse of :func:`scale_slabs` on the integer slabs, in
    ``dtype``."""
    tdt = TORCH_DTYPE[np.dtype(dtype)]
    if math.isinf(s):
        q, _ = flat_quantum(hier, tol, dtype)
        q = torch.tensor(q, device=coarse.device)
        return coarse.to(tdt) * q, [None if sl is None else
                                    {d: b.to(tdt) * q for d, b in sl.items()}
                                    for sl in slabs]
    sq_ndof = math.sqrt(hier.ndof())
    tol = float(tol)
    out_c = _weigh(coarse.to(tdt), _coarse_vectors(hier),
                   (2.0 * tol) / sq_ndof, True)
    out_slabs: List[dict] = [None] * (hier.L + 1)
    for l in range(1, hier.L + 1):
        if slabs[l] is not None:
            scale = (2.0 * tol) / ((2.0 ** (s * l)) * sq_ndof)
            out_slabs[l] = {d: _weigh(b.to(tdt),
                                      _slab_volume_vectors(hier, l, d),
                                      scale, True)
                            for d, b in slabs[l].items()}
    return out_c, out_slabs


def flatten_slabs(hier: Hierarchy, coarse, slabs) -> torch.Tensor:
    """The coarse array, then each level's slabs in dim order."""
    parts = [coarse.reshape(-1)]
    for l in range(1, hier.L + 1):
        for d in _level_dims(hier, l):
            parts.append(slabs[l][d].reshape(-1))
    return torch.cat(parts)


def unflatten_slabs(hier: Hierarchy, flat: torch.Tensor):
    """Inverse of :func:`flatten_slabs`."""
    coarse = None
    slabs: List[dict] = [None] * (hier.L + 1)
    off = 0
    for (l, d, shape) in slab_specs(hier):
        size = math.prod(shape)
        blk = flat[off:off + size].reshape(shape)
        off += size
        if l == 0:
            coarse = blk
        else:
            if slabs[l] is None:
                slabs[l] = {}
            slabs[l][d] = blk
    return coarse, slabs

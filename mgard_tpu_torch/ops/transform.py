"""Multilevel decompose/recompose (the port of ``mgard_tpu/ops/transform.py``
on its dense-matrix path, the one every dim up to 4096 nodes takes).

Per level ``l`` (finest to coarsest), with ``A`` the dense level-``l``
values:

    C       = A restricted to parent nodes         (K1, or gathers)
    P       = multilinear interpolation of C        (K5, K7+K8, or one
                                                     matmul per dim)
    detail  = A - P          # zero at parent nodes, coefficients elsewhere
    A_{l-1} = C + K(detail)  # K = M_{l-1}^{-1} R_l M_l, one matmul per dim

``recompose`` runs the exact inverse, with K6, K9+K10 or the matmuls
for ``P + detail``.  The per-dim operators are small dense float64 matrices
built on the host from the hierarchy's tables, cast to the data's dtype
and applied as tensordots in it: full float32 (no TF32; the package
turns it off at import), or float64 for float64 data, as the JAX package
runs it.  As in the JAX package, the interpolation goes through the
GPK stencil kernels (``ops/stencil_kernels.py``) at every level their
gate admits: the one-pass K5/K6 by default, the two-pass K7-K10 under
``MGARD_TPU_GPK_FUSED=0`` (the JAX package's switch).  The gate admits
only float32 CUDA tensors, so off the card the transform takes the
matmul form, as the JAX package does off the TPU, and float64 data
takes it everywhere (K1 is float32 only too, as in the JAX package).
Under ``MGARD_TPU_LPK=1`` (the JAX package's switch, read at import) the
correction of a level that ``lpk_kernels.rm0_supported`` admits applies
its dim-0 ``R_l M_l`` with K13 (``ops/lpk_kernels.py``) and finishes
with the matmuls ``[M_{l-1}^{-1}, K1, K2]``; decompose and recompose
take the same branch, so both run the same arithmetic.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch

from ..hierarchy import DimLevel, Hierarchy
from . import extract_kernels as xk
from . import lpk_kernels as lk
from . import stencil_kernels as sk
from .tridiag import along_axis, pad_axis

__all__ = ["decompose", "recompose", "recompose_to_level", "restrict"]

# Dims up to this size use the dense-matrix operators; longer dims need
# the per-dim transform (prolong, and the correction through
# ops/tridiag.py's solves), which is not ported yet.
_MATMUL_MAX_N = 4096

# The JAX package's switch, read at import as it reads it: "1" applies
# the dim-0 half of the correction with K13 where its gate admits the
# level.
_LPK = os.environ.get("MGARD_TPU_LPK", "0") == "1"


# ---------------------------------------------------------------------------
# Host operator builders (float64 numpy, cached per hierarchy)
# ---------------------------------------------------------------------------

def _level_dims(hier: Hierarchy, l: int) -> List[int]:
    return [d for d in range(hier.ndim) if hier.shape[d] > 1]


def _mass_matrix_np(h: np.ndarray) -> np.ndarray:
    n = len(h) + 1
    M = np.zeros((n, n), dtype=np.float64)
    idx = np.arange(n - 1)
    M[idx, idx] += h / 3
    M[idx + 1, idx + 1] += h / 3
    M[idx, idx + 1] = h / 6
    M[idx + 1, idx] = h / 6
    return M


def _restriction_matrix_np(lev: DimLevel) -> np.ndarray:
    nc = len(lev.coarse_pos)
    R = np.zeros((nc, lev.n), dtype=np.float64)
    R[np.arange(nc), lev.coarse_pos] = 1.0
    if lev.new_pos is not None and len(lev.new_pos):
        seg = np.searchsorted(lev.coarse_pos, lev.new_pos)  # right parent
        np.add.at(R, (seg - 1, lev.new_pos), 1.0 - lev.new_ratio)
        np.add.at(R, (seg, lev.new_pos), lev.new_ratio)
    return R


def _thomas_np(lev: DimLevel, B: np.ndarray) -> np.ndarray:
    """Columnwise Thomas solve M_lev X = B with the precomputed divisors."""
    n = B.shape[0]
    off, div = lev.offdiag, lev.divisors
    D = B.copy()
    for i in range(1, n):
        D[i] -= (off[i - 1] / div[i - 1]) * D[i - 1]
    X = np.empty_like(D)
    X[n - 1] = D[n - 1] / div[n - 1]
    for i in range(n - 2, -1, -1):
        X[i] = (D[i] - off[i] * X[i + 1]) / div[i]
    return X


def _cached(hier: Hierarchy, name: str, l: int, build):
    cache = hier.__dict__.setdefault(name, {})
    if l not in cache:
        cache[l] = build()
    return cache[l]


def _correction_matrices(hier: Hierarchy, l: int):
    """Per-dim dense (nc, n) correction matrices M_{l-1}^{-1} R_l M_l,
    aligned with ``_level_dims``; None where the dim is not refined."""
    def build():
        mats = []
        for d in _level_dims(hier, l):
            lev = hier.dims[d][l]
            levc = hier.dims[d][l - 1]
            if lev.new_pos is None or len(lev.new_pos) == 0:
                mats.append(None)
                continue
            A = _restriction_matrix_np(lev) @ _mass_matrix_np(lev.h)
            mats.append(np.ascontiguousarray(_thomas_np(levc, A)))
        return mats
    return _cached(hier, "_corr_mats", l, build)


def _prolong_matrices(hier: Hierarchy, l: int):
    """Per-dim (n, nc) prolongation matrices (the restriction's
    transpose); None for unrefined dims."""
    def build():
        mats = []
        for d in _level_dims(hier, l):
            lev = hier.dims[d][l]
            if lev.coarse_pos is None or lev.new_pos is None \
                    or len(lev.new_pos) == 0:
                mats.append(None)
                continue
            mats.append(np.ascontiguousarray(_restriction_matrix_np(lev).T))
        return mats
    return _cached(hier, "_prolong_mats", l, build)


def _device_mats(hier: Hierarchy, name: str, l: int, mats, like):
    """Copies of host operator matrices in the dtype and on the device
    of the tensor ``like`` (cached per dtype and device)."""
    return _cached(hier, f"{name}@{like.device}@{like.dtype}", l, lambda: [
        None if M is None else torch.as_tensor(M, dtype=like.dtype,
                                               device=like.device)
        for M in mats])


# ---------------------------------------------------------------------------
# Whole-level operators
# ---------------------------------------------------------------------------

def _apply_matrix_chain(B: torch.Tensor, mats, dims) -> torch.Tensor:
    """Contract axis ``dims[i]`` of B with ``mats[i]`` ((out, in) each,
    None entries skipped), in the JAX package's order: a contraction of
    the leading axis keeps it in front, any other moves the new axis to
    the end, and one permute restores the order at the end."""
    order = list(range(B.dim()))
    for d, M in zip(dims, mats):
        if M is None:
            continue
        p = order.index(d)
        if p == 0:
            B = torch.tensordot(M, B, dims=([1], [0]))
        else:
            B = torch.tensordot(B, M, dims=([p], [1]))
            order = order[:p] + order[p + 1:] + [d]
    ident = list(range(B.dim()))
    if order != ident:
        B = B.permute([order.index(i) for i in ident]).contiguous()
    return B


def _check_matmul(hier: Hierarchy, l: int) -> None:
    if any(hier.dims[d][l].n > _MATMUL_MAX_N for d in _level_dims(hier, l)):
        raise NotImplementedError(
            f"dims over {_MATMUL_MAX_N} nodes need the tridiagonal-scan "
            "transform (ROADMAP queue A, item 2), not ported yet")


def extract_old(v: torch.Tensor, lev: DimLevel, axis: int) -> torch.Tensor:
    """Restrict a dense level array to the parent level's nodes along
    ``axis``."""
    if lev.coarse_pos is None:
        return v
    idx = torch.as_tensor(np.asarray(lev.coarse_pos), device=v.device)
    return v.index_select(axis, idx)


def _slice_axis(v: torch.Tensor, start: int, stop: int, step: int,
                axis: int) -> torch.Tensor:
    idx = [slice(None)] * v.dim()
    idx[axis] = slice(start, stop, step)
    return v[tuple(idx)]


def restrict(v: torch.Tensor, lev: DimLevel, axis: int) -> torch.Tensor:
    """Adjoint of prolongation along ``axis`` (``transform.py:127``): each
    new node's value goes to its parents, ``(1 - r)`` of it to the left
    and ``r`` to the right (reference ConstituentRestriction,
    include/TensorRestriction.tpp:24-71).  The hierarchy puts at most one
    new node in a parent interval."""
    if lev.coarse_pos is None:
        return v
    nc = len(lev.coarse_pos)
    old = extract_old(v, lev, axis)
    if lev.new_pos is None or len(lev.new_pos) == 0:
        return old
    if lev.coarse_is_stride2:
        new = _slice_axis(v, 1, lev.n, 2, axis)
        r = lev.new_ratio
    elif lev.front_nc is not None:
        # front-interleaved: new nodes at odd positions 1 .. 2*fc-3,
        # between front parents j and j+1; the tail parents get nothing
        fc = lev.front_nc
        new = _slice_axis(v, 1, 2 * fc - 1, 2, axis)
        rj = along_axis(lev.new_ratio, v, axis)
        return old + pad_axis((1 - rj) * new, 0, nc - fc + 1, axis) \
            + pad_axis(rj * new, 1, nc - fc, axis)
    else:
        # general: each parent interval's new node (or none, masked to 0)
        seg = np.searchsorted(lev.coarse_pos, lev.new_pos) - 1
        dense_new = np.full(nc - 1, -1, dtype=np.int64)
        r = np.zeros(nc - 1, dtype=np.float64)
        dense_new[seg] = lev.new_pos
        r[seg] = lev.new_ratio
        has = dense_new >= 0
        newv = v.index_select(axis, torch.as_tensor(
            np.where(has, dense_new, 0), device=v.device))
        new = newv * along_axis(has.astype(np.float64), v, axis)
    rj = along_axis(r, v, axis)
    return old + pad_axis((1 - rj) * new, 0, 1, axis) \
        + pad_axis(rj * new, 1, 0, axis)


def _extract_old_all(hier: Hierarchy, A: torch.Tensor, l: int):
    if xk.extract_supported(hier, l, A):
        return xk.extract_coarse_3d(hier, A, l)
    for d in _level_dims(hier, l):
        A = extract_old(A, hier.dims[d][l], d)
    return A


def _prolong_all(hier: Hierarchy, C: torch.Tensor, l: int):
    mats = _device_mats(hier, "_prolong_mats", l, _prolong_matrices(hier, l),
                        C)
    return _apply_matrix_chain(C, mats, _level_dims(hier, l))


def _correction(hier: Hierarchy, detail: torch.Tensor, l: int):
    """M_{l-1}^{-1} R_l M_l applied to a dense level-l detail array:
    one dense matmul per dim, or under ``_LPK`` K13 along dim 0 and then
    the matmuls of ``correction_matrices_fast``."""
    dims = _level_dims(hier, l)
    if _LPK and dims == [0, 1, 2] and lk.rm0_supported(hier, l, detail):
        Y = lk.rm_dim0(hier, detail, l)
        mats = _device_mats(hier, "_corr_fast_mats", l,
                            lk.correction_matrices_fast(hier, l), Y)
        return _apply_matrix_chain(Y, mats, dims)
    mats = _device_mats(hier, "_corr_mats", l,
                        _correction_matrices(hier, l), detail)
    return _apply_matrix_chain(detail, mats, dims)


# ---------------------------------------------------------------------------
# Public transform
# ---------------------------------------------------------------------------

def decompose(hier: Hierarchy, v: torch.Tensor) -> List[torch.Tensor]:
    """Multilevel decomposition of ``v`` (shape == hier.shape).

    Returns a list of L+1 dense float tensors: ``pyramid[0]`` holds the
    coarsest-level values, ``pyramid[l]`` (l >= 1) the level-l
    coefficients at new nodes and zeros at parent nodes.
    """
    if tuple(v.shape) != hier.shape:
        raise ValueError(f"expected shape {hier.shape}, got "
                         f"{tuple(v.shape)}")
    pyramid: List[torch.Tensor] = [None] * (hier.L + 1)
    A = v
    for l in range(hier.L, 0, -1):
        _check_matmul(hier, l)
        C = _extract_old_all(hier, A, l)
        if sk.gpk_supported(hier, l, A):
            detail = sk.gpk_detail(hier, A, l)
        else:
            detail = A - _prolong_all(hier, C, l)
        pyramid[l] = detail
        A = C + _correction(hier, detail, l)
    pyramid[0] = A
    return pyramid


def recompose(hier: Hierarchy, pyramid: Sequence[torch.Tensor]
              ) -> torch.Tensor:
    """Exact inverse of :func:`decompose`."""
    return recompose_to_level(hier, pyramid, hier.L)


def recompose_to_level(hier: Hierarchy, pyramid: Sequence[torch.Tensor],
                       lmax: int) -> torch.Tensor:
    """Recompose up to level ``lmax``: the dense level-``lmax`` grid
    (shape ``hier.shapes[lmax]``)."""
    A = pyramid[0]
    for l in range(1, lmax + 1):
        _check_matmul(hier, l)
        detail = pyramid[l]
        C = A - _correction(hier, detail, l)
        if sk.gpk_supported(hier, l, detail):
            A = sk.gpk_prolong_add(hier, C, detail, l)
        else:
            A = _prolong_all(hier, C, l) + detail
    return A

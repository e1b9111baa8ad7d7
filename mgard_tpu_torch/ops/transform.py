"""Multilevel decompose/recompose (the port of
``mgard_tpu/ops/transform.py``).

Per level ``l`` (finest to coarsest), with ``A`` the dense level-``l``
values:

    C       = A restricted to parent nodes         (K1, or gathers)
    P       = multilinear interpolation of C        (K5, K7+K8, one
                                                     matmul or lerp per dim)
    detail  = A - P          # zero at parent nodes, coefficients elsewhere
    A_{l-1} = C + K(detail)  # K = M_{l-1}^{-1} R_l M_l

``recompose`` runs the exact inverse, with K6, K9+K10, the matmuls or the
lerps for ``P + detail``.  Two forms, chosen per level as the JAX package
chooses them (:func:`_use_matmul`):

* **dense matrices** (the default, every dim of the level at most
  ``MGARD_TPU_MATMUL_MAX_N`` = 4096 nodes): the per-dim operators are
  small dense float64 matrices built on the host from the hierarchy's
  tables, cast to the data's dtype and applied as tensordots in it:
  full float32 (no TF32; the package turns it off at import), or float64
  for float64 data, as the JAX package runs it;
* **per dim** (a longer dim, or ``MGARD_TPU_SOLVER=scan``): the
  interpolation is the lerp of :func:`prolong` along each dim, and the
  correction is ``mass_apply`` and :func:`restrict` along each dim, then
  the Thomas solve of the level below along each dim (``ops/tridiag.py``,
  S1 on the card).

Both switches are the JAX package's, read at import.  As in the JAX
package, the interpolation goes through the
GPK stencil kernels (``ops/stencil_kernels.py``) at every level their
gate admits: the one-pass K5/K6 by default, the two-pass K7-K10 under
``MGARD_TPU_GPK_FUSED=0`` (the JAX package's switch).  The gate admits
only float32 CUDA tensors, so off the card the transform takes the
matmul or per-dim form, as the JAX package does off the TPU, and float64
data takes it everywhere (K1 is float32 only too, as in the JAX
package); the GPK and K1 gates do not depend on the form.  Under
``MGARD_TPU_LPK=1`` (the JAX package's switch, read at import) the
correction of a dense-matrix level that ``lpk_kernels.rm0_supported``
admits applies
its dim-0 ``R_l M_l`` with K13 (``ops/lpk_kernels.py``) and finishes
with the matmuls ``[M_{l-1}^{-1}, K1, K2]``; decompose and recompose
take the same branch, so both run the same arithmetic.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import List, Sequence

import numpy as np
import torch

from ..hierarchy import DimLevel, Hierarchy
from ..utils.log import span
from . import extract_kernels as xk
from . import lpk_kernels as lk
from . import stencil_kernels as sk
from .tridiag import (along_axis, cached_tensor, mass_apply, mass_solve,
                      pad_fold, table_scope)

__all__ = ["decompose", "recompose", "recompose_to_level", "prolong",
           "restrict", "extract_old", "block_specs", "pyramid_to_fine",
           "fine_to_pyramid", "pyramid_to_blocks", "blocks_to_pyramid",
           "flatten_pyramid", "unflatten_pyramid"]

# The JAX package's switches, read at import as it reads them: a level
# whose dims are all at most _MATMUL_MAX_N nodes takes the dense matrices
# unless _SOLVER is "scan"; any other level takes the per-dim transform.
_MATMUL_MAX_N = int(os.environ.get("MGARD_TPU_MATMUL_MAX_N", "4096"))
_SOLVER = os.environ.get("MGARD_TPU_SOLVER", "matmul")

# The JAX package's switch, read at import as it reads it: "1" applies
# the dim-0 half of the correction with K13 where its gate admits the
# level.
_LPK = os.environ.get("MGARD_TPU_LPK", "0") == "1"
# The JAX package's switches, read at import as it reads them: "0" turns
# off the GPK stencil kernels (K5/K6, K7-K10) at every level, so the
# interpolation takes the matmul or per-dim form; "0" turns off K1, so
# the coarse nodes are taken by slices.  Not read, as they set TPU or XLA
# forms the port does not have: MGARD_TPU_PALLAS_CODEC and
# MGARD_TPU_DB_CONDENSE (the Pallas codec forms),
# MGARD_TPU_MATMUL_PRECISION and MGARD_TPU_CORR_PRECISION (every matmul
# stays full float32, TF32 off).  MGARD_TPU_CACHE_DIR is read by
# utils/cache.py, where it names the directory of the built libraries.
_GPK = os.environ.get("MGARD_TPU_GPK", "1") == "1"
_XK = os.environ.get("MGARD_TPU_XK", "1") == "1"


# ---------------------------------------------------------------------------
# Host operator builders (float64 numpy, cached per hierarchy)
# ---------------------------------------------------------------------------

def _level_dims(hier: Hierarchy, l: int) -> List[int]:
    return [d for d in range(hier.ndim) if hier.shape[d] > 1]


def _use_matmul(hier: Hierarchy, l: int) -> bool:
    """The JAX package's predicate: level ``l`` takes the dense
    matrices."""
    return _SOLVER == "matmul" and all(
        hier.dims[d][l].n <= _MATMUL_MAX_N for d in _level_dims(hier, l))


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


def _slice_axis(v: torch.Tensor, start: int, stop: int, step: int,
                axis: int) -> torch.Tensor:
    idx = [slice(None)] * v.dim()
    idx[axis] = slice(start, stop, step)
    return v[tuple(idx)]


def extract_old(v: torch.Tensor, lev: DimLevel, axis: int) -> torch.Tensor:
    """Restrict a dense level array to the parent level's nodes along
    ``axis`` (``transform.py:59``): a strided view on a stride-2 level,
    the strided front and the tail on a front-interleaved one, a gather
    of ``coarse_pos`` on any other."""
    if lev.coarse_pos is None:
        return v
    if lev.coarse_is_stride2:
        return _slice_axis(v, 0, lev.n, 2, axis)
    if lev.front_nc is not None:
        f = 2 * lev.front_nc - 1
        return torch.cat([_slice_axis(v, 0, f, 2, axis),
                          v.narrow(axis, f, lev.n - f)], dim=axis)
    idx = cached_tensor(lev.coarse_pos, torch.int64, v.device)
    return v.index_select(axis, idx)


def _lerp_tables(lev: DimLevel):
    """``(la, ra, w)`` over the level's n nodes (``transform.py:103-115``):
    each node's left and right parent (their indices among the parents)
    and its weight; a parent is its own left and right, weight 0."""
    cache = lev.__dict__.setdefault("_lerp_tables", {})
    if not cache:
        nc = len(lev.coarse_pos)
        la = np.zeros(lev.n, dtype=np.int64)
        ra = np.zeros(lev.n, dtype=np.int64)
        w = np.zeros(lev.n, dtype=np.float64)
        la[lev.coarse_pos] = ra[lev.coarse_pos] = np.arange(nc)
        la[lev.new_pos] = np.searchsorted(lev.coarse_pos, lev.new_left)
        ra[lev.new_pos] = np.searchsorted(lev.coarse_pos, lev.new_right)
        w[lev.new_pos] = lev.new_ratio
        cache.update(la=la, ra=ra, w=w)
    return cache["la"], cache["ra"], cache["w"]


def prolong(c: torch.Tensor, lev: DimLevel, axis: int) -> torch.Tensor:
    """Interpolate parent-level values to this level's grid along ``axis``
    (``transform.py:73``): parents keep their value, each new node gets
    the lerp ``(1 - r) * left + r * right`` of its two parents (reference
    ConstituentProlongationAddition, include/TensorProlongation.tpp:22-69).
    Three branches, as in the JAX package: stride 2, front-interleaved
    (both lerp neighbouring parents and interleave) and general (one
    gather of each node's parents)."""
    if lev.coarse_pos is None:
        return c
    nc = c.shape[axis]
    if lev.coarse_is_stride2 or lev.front_nc is not None:
        fc = nc if lev.coarse_is_stride2 else lev.front_nc
        r = along_axis(lev.new_ratio, c, axis)
        lo = c.narrow(axis, 0, fc - 1)
        hi = c.narrow(axis, 1, fc - 1)
        mid = (1 - r) * lo + r * hi
        shape = list(c.shape)
        shape[axis] = lev.n
        out = c.new_empty(shape)
        _slice_axis(out, 0, 2 * fc - 1, 2, axis).copy_(c.narrow(axis, 0, fc))
        _slice_axis(out, 1, 2 * fc - 2, 2, axis).copy_(mid)
        if fc < nc:
            _slice_axis(out, 2 * fc - 1, lev.n, 1, axis).copy_(
                c.narrow(axis, fc, nc - fc))
        return out
    la, ra, w = _lerp_tables(lev)
    wl = along_axis(w, c, axis)
    left = c.index_select(axis, cached_tensor(la, torch.int64, c.device))
    right = c.index_select(axis, cached_tensor(ra, torch.int64, c.device))
    return (1 - wl) * left + wl * right


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
    if lev.coarse_is_stride2 or lev.front_nc is not None:
        # new nodes at odd positions 1 .. 2*fc - 3, between parents j and
        # j+1; on a front-interleaved level the tail parents get nothing
        fc = nc if lev.coarse_is_stride2 else lev.front_nc
        new = _slice_axis(v, 1, 2 * fc - 1, 2, axis)
        r = lev.new_ratio
    else:
        # general: each parent interval's new node (or none, masked to 0)
        fc = nc
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
    # old + pad((1 - r) * new) to parents j + pad(r * new) to parents j+1
    return pad_fold(old, lambda: (1 - rj) * new, lambda: rj * new, fc - 1,
                    axis)


def _extract_old_all(hier: Hierarchy, A: torch.Tensor, l: int):
    if _XK and xk.extract_supported(hier, l, A):
        return xk.extract_coarse_3d(hier, A, l)
    for d in _level_dims(hier, l):
        A = extract_old(A, hier.dims[d][l], d)
    return A


def _prolong_all(hier: Hierarchy, C: torch.Tensor, l: int):
    if not _use_matmul(hier, l):
        for d in _level_dims(hier, l):
            C = prolong(C, hier.dims[d][l], d)
        return C
    mats = _device_mats(hier, "_prolong_mats", l, _prolong_matrices(hier, l),
                        C)
    return _apply_matrix_chain(C, mats, _level_dims(hier, l))


def _correction(hier: Hierarchy, detail: torch.Tensor, l: int):
    """M_{l-1}^{-1} R_l M_l applied to a dense level-l detail array
    (``transform.py:508``).  Where the level takes the dense matrices: one
    matmul per dim, or under ``_LPK`` K13 along dim 0 and then the
    matmuls of ``correction_matrices_fast``.  Elsewhere: ``mass_apply`` and
    ``restrict`` along each dim, then the Thomas solve of level l-1 along
    each dim (S1 on the card).  Decompose and recompose take the same
    branch, so both run the same arithmetic."""
    with span("mgard.correction"):
        dims = _level_dims(hier, l)
        if not _use_matmul(hier, l):
            B = detail
            for d in dims:
                B = mass_apply(B, hier.dims[d][l].h, d)
                B = restrict(B, hier.dims[d][l], d)
            for d in dims:
                lev = hier.dims[d][l - 1]
                B = mass_solve(B, lev.offdiag, lev.divisors, d)
            return B
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
    with span("mgard.decompose"):
        for l in range(hier.L, 0, -1):
            # the level's tables leave the card after it
            with span(f"mgard.level.{l}"), table_scope():
                C = _extract_old_all(hier, A, l)
                if _GPK and sk.gpk_supported(hier, l, A):
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
    with span("mgard.recompose"):
        for l in range(1, lmax + 1):
            detail = pyramid[l]
            with span(f"mgard.level.{l}"), table_scope():
                C = A - _correction(hier, detail, l)
                if _GPK and sk.gpk_supported(hier, l, detail):
                    A = sk.gpk_prolong_add(hier, C, detail, l)
                else:
                    A = _prolong_all(hier, C, l) + detail
    return A


# ---------------------------------------------------------------------------
# Pyramid <-> flat coefficient stream (``transform.py:599-829``)
# ---------------------------------------------------------------------------
#
# The JAX package writes these maps as 0/1 selection matmuls and interior
# pads, which suit a TPU; here they are slices, strided writes and
# ``index_copy_``.  Selection is exact either way; where the JAX package
# adds a zero pad, a zero is added here too (it turns a -0 into +0).

def block_specs(hier: Hierarchy):
    """The serialized coefficient blocks, in order: ``(level, region_id,
    block_shape, positions)``, the coarse block first (level 0, region 0,
    every node), then for each level 1..L its regions
    (:meth:`Hierarchy.regions`); ``positions[d]`` selects the block along
    dim d of the dense level array.  Cached on the hierarchy."""
    cache = hier.__dict__.setdefault("_block_specs", [])
    if cache:
        return cache[0]
    specs = [(0, 0, hier.shapes[0], tuple(
        np.arange(hier.shapes[0][d], dtype=np.int64)
        for d in range(hier.ndim)))]
    for l in range(1, hier.L + 1):
        for r, bshape, sel in hier.regions(l):
            pos = []
            for kind, lev in sel:
                if kind == "new":
                    pos.append(lev.new_pos)
                else:
                    pos.append(lev.coarse_pos if lev.coarse_pos is not None
                               else np.arange(lev.n, dtype=np.int64))
            specs.append((l, r, bshape, tuple(pos)))
    cache.append(specs)
    return specs


def _region_slice(A: torch.Tensor, positions) -> torch.Tensor:
    """``A[np.ix_(*positions)]``: a strided slice where a dim's positions
    step evenly, else a gather."""
    out = A
    for d, pos in enumerate(positions):
        n = out.shape[d]
        pos = np.asarray(pos)
        if len(pos) == n and np.array_equal(pos, np.arange(n)):
            continue
        step = int(pos[1] - pos[0]) if len(pos) > 1 else 1
        if step > 0 and np.array_equal(
                pos, np.arange(pos[0], pos[0] + step * len(pos), step)):
            out = _slice_axis(out, int(pos[0]), int(pos[-1]) + 1, step, d)
        else:
            out = out.index_select(d, cached_tensor(pos, torch.int64,
                                                    A.device))
    return out


def _parent_pieces(lev: DimLevel):
    """Where the parent level's nodes sit along a dim of the level grid:
    ``(grid slice, parent slice)`` pairs, or None for a general level
    (a gather of ``coarse_pos``)."""
    if lev.coarse_pos is None or len(lev.coarse_pos) == lev.n:
        return [(slice(None), slice(None))]
    if lev.coarse_is_stride2:
        return [(slice(0, lev.n, 2), slice(None))]
    if lev.front_nc is not None:
        f = lev.front_nc
        return [(slice(0, 2 * f - 1, 2), slice(0, f)),
                (slice(2 * f - 1, lev.n), slice(f, None))]
    return None


def _parent_blocks(hier: Hierarchy, l: int):
    """``(grid index, parent index)`` pairs that tile the parent nodes of
    the level-``l`` grid (one a combination of each dim's pieces), or None
    where a dim is general."""
    pieces = [_parent_pieces(hier.dims[d][l]) for d in range(hier.ndim)]
    if any(p is None for p in pieces):
        return None
    return [tuple(zip(*combo)) for combo in itertools.product(*pieces)]


def _embed_dim(A: torch.Tensor, lev: DimLevel, axis: int) -> torch.Tensor:
    """``A`` along ``axis`` at the level's parent positions, zeros at its
    new ones (the JAX ``_embed_old``'s step for one dim)."""
    shp = list(A.shape)
    shp[axis] = lev.n
    out = A.new_zeros(shp)
    pieces = _parent_pieces(lev)
    if pieces is None:
        return out.index_copy_(axis, cached_tensor(
            lev.coarse_pos, torch.int64, A.device), A)
    for dst, src in pieces:
        idx = [slice(None)] * A.dim()
        sidx = list(idx)
        idx[axis], sidx[axis] = dst, src
        out[tuple(idx)] = A[tuple(sidx)]
    return out


def pyramid_to_fine(hier: Hierarchy, pyramid: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """The pyramid as one fine-grid array in physical order: every node
    holds its own multilevel coefficient (``transform.py:681``).  Each
    level's detail plus the coarser levels' array at its parent nodes."""
    A = pyramid[0]
    for l in range(1, hier.L + 1):
        blocks = _parent_blocks(hier, l)
        if blocks is None:
            for d in _level_dims(hier, l):
                A = _embed_dim(A, hier.dims[d][l], d)
            A = pyramid[l] + A
            continue
        # detail + 0 everywhere (the embedding's zeros at new nodes),
        # then + the coarser values at the parent nodes
        out = pyramid[l] + 0
        for dst, src in blocks:
            out[dst] += A[src]
        A = out
    return A


def _zero_old(hier: Hierarchy, D: torch.Tensor, l: int) -> torch.Tensor:
    """``D`` with its parent positions zeroed: multiplied by 0 there and
    kept elsewhere, as the JAX package's ``D * (1 - parents)`` does
    (``transform.py:692``; a negative float gives -0)."""
    blocks = _parent_blocks(hier, l)
    if blocks is None:
        keep = None
        for d in range(hier.ndim):
            lev = hier.dims[d][l]
            m = np.zeros(lev.n) if lev.coarse_pos is not None \
                else np.ones(lev.n)
            if lev.coarse_pos is not None:
                m[lev.coarse_pos] = 1.0
            shp = [1] * D.dim()
            shp[d] = lev.n
            mv = torch.as_tensor(m, dtype=D.dtype,
                                 device=D.device).reshape(shp)
            keep = mv if keep is None else keep * mv
        return D * (1 - keep)
    out = D.clone()
    for dst, _ in blocks:
        out[dst] *= 0
    return out


def fine_to_pyramid(hier: Hierarchy, fine: torch.Tensor
                    ) -> List[torch.Tensor]:
    """Inverse of :func:`pyramid_to_fine`; integer streams too (their
    coarse extraction takes the slices, K1 being float32 only)."""
    out: List[torch.Tensor] = [None] * (hier.L + 1)
    A = fine
    for l in range(hier.L, 0, -1):
        out[l] = _zero_old(hier, A, l)
        A = _extract_old_all(hier, A, l)
    out[0] = A
    return out


def pyramid_to_blocks(hier: Hierarchy, pyramid: Sequence[torch.Tensor]):
    """The dense (level, region) coefficient blocks in serialization order
    (:func:`block_specs`)."""
    return [_region_slice(pyramid[l], pos)
            for (l, _, _, pos) in block_specs(hier)]


def _interleave_dim(old: torch.Tensor, new: torch.Tensor, lev: DimLevel,
                    axis: int) -> torch.Tensor:
    """Merge parent values (nc) and new-node values (nn) along ``axis``
    into the dense level grid (n) (``transform.py:728``).  On a stride-2
    or front-interleaved level the JAX package sums two zero-padded
    arrays (each value plus a zero) and appends the tail parents; on any
    other it scatters both into zeros."""
    nc = old.shape[axis]
    shp = list(old.shape)
    shp[axis] = lev.n
    if lev.coarse_is_stride2 or lev.front_nc is not None:
        fc = nc if lev.coarse_is_stride2 else lev.front_nc
        out = old.new_empty(shp)
        torch.add(old.narrow(axis, 0, fc), 0,
                  out=_slice_axis(out, 0, 2 * fc - 1, 2, axis))
        torch.add(new, 0, out=_slice_axis(out, 1, 2 * fc - 2, 2, axis))
        if fc < nc:
            out.narrow(axis, 2 * fc - 1, nc - fc).copy_(
                old.narrow(axis, fc, nc - fc))
        return out
    out = old.new_zeros(shp)
    out.index_copy_(axis, cached_tensor(lev.coarse_pos, torch.int64,
                                        old.device), old)
    return out.index_copy_(axis, cached_tensor(lev.new_pos, torch.int64,
                                               old.device), new)


def blocks_to_pyramid(hier: Hierarchy, blocks) -> List[torch.Tensor]:
    """Reassemble the dense level arrays from their (level, region)
    blocks, merging one dim at a time (``transform.py:771``)."""
    specs = block_specs(hier)
    per_level = {l: {} for l in range(hier.L + 1)}
    for (l, r, bshape, _), blk in zip(specs, blocks):
        per_level[l][r] = blk.reshape(bshape)
    out: List[torch.Tensor] = [None] * (hier.L + 1)
    out[0] = per_level[0][0]
    for l in range(1, hier.L + 1):
        cur = dict(per_level[l])
        # the all-parent region of a detail level is zero
        coarse_shape = tuple(
            len(hier.dims[d][l].coarse_pos)
            if hier.dims[d][l].coarse_pos is not None else 1
            for d in range(hier.ndim))
        cur[0] = blocks[0].new_zeros(coarse_shape)
        for d in range(hier.ndim):
            lev = hier.dims[d][l]
            if lev.new_pos is None or len(lev.new_pos) == 0:
                continue
            cur = {mask: _interleave_dim(blk, cur[mask | (1 << d)], lev, d)
                   for mask, blk in cur.items() if not mask & (1 << d)}
        out[l] = cur[0]
    return out


def flatten_pyramid(hier: Hierarchy, pyramid: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """The pyramid as one level-major, region-blocked vector (the
    LEVEL_BLOCKS stream)."""
    return torch.cat([b.reshape(-1)
                      for b in pyramid_to_blocks(hier, pyramid)])


def unflatten_pyramid(hier: Hierarchy, flat: torch.Tensor
                      ) -> List[torch.Tensor]:
    """Inverse of :func:`flatten_pyramid`."""
    blocks, off = [], 0
    for (_, _, bshape, _) in block_specs(hier):
        size = math.prod(bshape)
        blocks.append(flat[off:off + size])
        off += size
    return blocks_to_pyramid(hier, blocks)

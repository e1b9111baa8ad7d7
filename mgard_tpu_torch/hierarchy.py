"""Tensor mesh hierarchy: the geometric core of the MGARD transform.

A dyadic hierarchy of tensor-product grids over an arbitrary N-D shape.
Shapes that are not of the form ``2^k + 1`` get one extra non-dyadic level on
top (reference semantics: ``include/TensorMeshHierarchy.tpp:40-140`` in
CODARcode/MGARD).

Everything here is *host-side precomputation* producing small per-dimension
NumPy arrays (level index sets, interpolation ratios, mass-matrix bands,
Thomas-factorization divisors, quantization volume weights).  The heavy
N-D data never touches this module.  This is the PyTorch port's own copy of
``mgard_tpu/hierarchy.py``: the level structure is part of the wire format,
so the two must build identical tables.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["Hierarchy", "DimLevel", "dyadic_num_levels"]


def _log2_floor(n: int) -> int:
    return n.bit_length() - 1


def dyadic_num_levels(size: int) -> int:
    """Number of dyadic levels supported by a 1-D mesh of ``size`` nodes.

    ``log2(size - 1)`` rounded down (reference ``nlevel_from_size``,
    TensorMeshHierarchy.tpp:25-30).
    """
    if size < 2:
        raise ValueError("size must be >= 2")
    return _log2_floor(size - 1)


@dataclasses.dataclass(frozen=True)
class DimLevel:
    """Per-dimension, per-level precomputed tables.

    All arrays are small 1-D float64/int64 NumPy arrays over the nodes of
    *this* level's 1-D grid (length ``n``), except where noted.
    """

    # Number of nodes of this level's 1-D grid.
    n: int
    # Indices of this level's nodes within the finest 1-D grid.
    fine_indices: np.ndarray  # (n,) int64
    # Position of the parent (next-coarser) level's nodes within THIS level's
    # grid.  For dyadic levels this is simply 2*j; for the non-dyadic top
    # level it is a general monotone index vector.  None at level 0.
    coarse_pos: Optional[np.ndarray]  # (n_coarse,) int64
    # True iff coarse_pos == 2*arange(n_coarse) and n == 2*n_coarse - 1
    # (enables the strided fast path in the transform kernels).
    coarse_is_stride2: bool
    # Front-interleaved non-dyadic structure: the first 2*(front_nc-1)+1
    # positions alternate coarse/new (starting and ending coarse) and the
    # remaining tail positions are all coarse.  Set when coarse_pos matches
    # [0, 2, ..., 2*nn, 2*nn+1, ..., n-1] with nn = n - n_coarse new nodes;
    # None otherwise.  Enables slice+concat fast paths (no gathers) in the
    # transform kernels for arbitrary (non 2^k+1) sizes.
    front_nc: Optional[int]
    # Coordinates of this level's nodes (subset of the finest coordinates).
    x: np.ndarray  # (n,) float64
    # Spacings h[j] = x[j+1] - x[j].  (n-1,)
    h: np.ndarray
    # Interpolation ratios for "new" nodes of this level: for each new node k
    # (a node of this level not in the parent level) lying between parent
    # nodes at positions pl[k] < pos[k] < pr[k] (positions within this grid):
    #     r[k] = (x[pos[k]] - x[pl[k]]) / (x[pr[k]] - x[pl[k]])
    # new value = (1-r)*v[left parent] + r*v[right parent].  None at level 0.
    new_pos: Optional[np.ndarray]  # (n_new,) positions of new nodes here
    new_left: Optional[np.ndarray]  # (n_new,) positions of left parents here
    new_right: Optional[np.ndarray]  # (n_new,) positions of right parents
    new_ratio: Optional[np.ndarray]  # (n_new,) float64
    # Thomas-factorization divisors of this level's 1-D mass matrix
    # (reference ConstituentMassMatrixInverse ctor, TensorMassMatrix.tpp:123).
    divisors: np.ndarray  # (n,)
    # Off-diagonal band of the mass matrix: offdiag[j] = h[j] / 6.  (n-1,)
    offdiag: np.ndarray
    # Quantization volume weights: w[j] = (x[succ] - x[pred]) / 2 with
    # boundary clamping (reference s_quantum,
    # TensorMultilevelCoefficientQuantizer.tpp:37-55).
    volumes: np.ndarray  # (n,)


def _build_dim_level(x_fine: np.ndarray, fine_indices: np.ndarray,
                     coarse_fine_indices: Optional[np.ndarray]) -> DimLevel:
    n = len(fine_indices)
    x = x_fine[fine_indices].astype(np.float64)
    h = np.diff(x)

    coarse_pos = None
    coarse_is_stride2 = False
    front_nc = None
    new_pos = new_left = new_right = new_ratio = None
    if coarse_fine_indices is not None:
        nc = len(coarse_fine_indices)
        # Position of parent nodes within this level's index list.
        coarse_pos = np.searchsorted(fine_indices, coarse_fine_indices)
        if not np.array_equal(fine_indices[coarse_pos], coarse_fine_indices):
            raise AssertionError("hierarchy levels are not nested")
        coarse_is_stride2 = (n == 2 * nc - 1) and np.array_equal(
            coarse_pos, 2 * np.arange(nc))
        if not coarse_is_stride2:
            nn = n - nc
            if 0 < nn and 2 * nn + 1 <= n:
                pattern = np.concatenate([
                    np.arange(0, 2 * nn + 1, 2),
                    np.arange(2 * nn + 1, n)])
                if np.array_equal(coarse_pos, pattern):
                    front_nc = nn + 1
        is_old = np.zeros(n, dtype=bool)
        is_old[coarse_pos] = True
        new_pos = np.nonzero(~is_old)[0].astype(np.int64)
        # Left/right parent for each new node.
        seg = np.searchsorted(coarse_pos, new_pos)  # index of right parent
        new_left = coarse_pos[seg - 1]
        new_right = coarse_pos[seg]
        new_ratio = (x[new_pos] - x[new_left]) / (x[new_right] - x[new_left])

    # Mass-matrix Thomas divisors (symmetric tridiagonal with
    # diag = [h0/3, (h0+h1)/3, ..., h_{n-2}/3], offdiag = h/6).
    if n >= 2:
        diag = np.empty(n, dtype=np.float64)
        diag[0] = h[0] / 3
        diag[-1] = h[-1] / 3
        if n > 2:
            diag[1:-1] = (h[:-1] + h[1:]) / 3
        offdiag = h / 6
        divisors = np.empty(n, dtype=np.float64)
        divisors[0] = diag[0]
        for j in range(1, n):
            w = offdiag[j - 1] / divisors[j - 1]
            divisors[j] = diag[j] - w * offdiag[j - 1]
    else:
        offdiag = np.zeros(0, dtype=np.float64)
        divisors = np.ones(n, dtype=np.float64)

    # Volume weights with boundary clamping: (x[min(j+1,n-1)]-x[max(j-1,0)])/2
    if n >= 2:
        xl = x[np.maximum(np.arange(n) - 1, 0)]
        xr = x[np.minimum(np.arange(n) + 1, n - 1)]
        volumes = (xr - xl) / 2
    else:
        volumes = np.ones(n, dtype=np.float64)

    return DimLevel(
        n=n, fine_indices=fine_indices, coarse_pos=coarse_pos,
        coarse_is_stride2=coarse_is_stride2, front_nc=front_nc, x=x, h=h,
        new_pos=new_pos, new_left=new_left, new_right=new_right,
        new_ratio=new_ratio, divisors=divisors, offdiag=offdiag,
        volumes=volumes)


class Hierarchy:
    """Mesh hierarchy over an N-D tensor grid with optional explicit coords.

    Mirrors the level structure of the reference
    ``mgard::TensorMeshHierarchy`` (TensorMeshHierarchy.tpp:40-140): the
    number of levels is ``L = min_i log2(n_i - 1)`` over non-flat dims, plus
    one extra level when any dim size is not of the form ``2^k + 1``.
    Dims of size 1 ("flat" dims) are carried along untouched.
    """

    def __init__(self, shape: Sequence[int],
                 coordinates: Optional[Sequence[np.ndarray]] = None,
                 placement: str = "tpu"):
        """``placement`` picks which nodes the non-dyadic level refines:

        * ``"tpu"`` (default): new nodes at odd positions ``1..2*nn-1``
          ("front-interleaved"), the placement the container format
          assumes.  Level shapes and error bounds are identical.
        * ``"reference"``: the reference node sets
          ``j*(n_fine-1)//(n_l-1)`` (TensorMeshHierarchy.tpp:99-119),
          needed for bit-exact interop with reference-produced streams.
        """
        if placement not in ("tpu", "reference"):
            raise ValueError(f"unknown placement {placement!r}")
        self.placement = placement
        shape = tuple(int(s) for s in shape)
        if any(s < 1 for s in shape):
            raise ValueError("every dimension must have size >= 1")
        if all(s == 1 for s in shape):
            raise ValueError("some dimension must have size > 1")
        self.shape = shape
        self.ndim = len(shape)

        if coordinates is None:
            self.uniform = True
            coordinates = [
                np.linspace(0.0, 1.0, s) if s > 1 else np.zeros(1)
                for s in shape
            ]
        else:
            self.uniform = False
            coordinates = [np.asarray(c, dtype=np.float64) for c in coordinates]
            for c, s in zip(coordinates, shape):
                if len(c) != s:
                    raise ValueError("coordinate array length mismatch")
        self.coordinates = [c.astype(np.float64) for c in coordinates]

        # --- level count (reference TensorMeshHierarchy.tpp:50-78) ---
        L_dyadic = None
        any_nondyadic = False
        for s in shape:
            if s == 1:
                continue
            l = dyadic_num_levels(s)
            L_dyadic = l if L_dyadic is None else min(L_dyadic, l)
            any_nondyadic = any_nondyadic or ((1 << l) + 1 != s)
        assert L_dyadic is not None
        self.L = L_dyadic + 1 if any_nondyadic else L_dyadic

        # --- per-level shapes (reference :79-97) ---
        shapes = [None] * (self.L + 1)
        shapes[self.L] = shape
        cur = []
        for s in shape:
            if s == 1:
                cur.append(1)
            else:
                l = dyadic_num_levels(s)
                nd = (1 << l) + 1  # dyadic floor
                cur.append(((nd - 1) >> L_dyadic) + 1)
        for i in range(self.L):
            shapes[i] = tuple(cur)
            cur = [1 if n == 1 else (n - 1) * 2 + 1 for n in cur]
        self.shapes: Tuple[Tuple[int, ...], ...] = tuple(shapes)

        # --- per-dim per-level fine-grid index sets ---
        # reference placement: indices[d][l][j] = j * (SHAPE[d]-1) // (n_l-1)
        # tpu placement: derived finest->coarsest; the non-dyadic step keeps
        # [0, 2, .., 2*nn, 2*nn+1, .., n-1] (front-interleaved), dyadic
        # steps keep every other node.
        self._fine_indices = []
        for d in range(self.ndim):
            numerator = shape[d] - 1
            if placement == "reference":
                per_level = []
                for l in range(self.L + 1):
                    n = self.shapes[l][d]
                    if numerator == 0 or n == 1:
                        idx = np.zeros(max(n, 1), dtype=np.int64)[:n]
                        if n == 0:
                            idx = np.zeros(1, dtype=np.int64)
                    else:
                        j = np.arange(n, dtype=np.int64)
                        idx = (j * numerator) // (n - 1)
                    per_level.append(idx)
            else:
                per_level = [None] * (self.L + 1)
                per_level[self.L] = np.arange(shape[d], dtype=np.int64)
                for l in range(self.L, 0, -1):
                    cur = per_level[l]
                    ncur = len(cur)
                    ntgt = self.shapes[l - 1][d]
                    if ncur == ntgt:
                        per_level[l - 1] = cur
                    elif 2 * ntgt - 1 == ncur:
                        per_level[l - 1] = cur[::2]
                    else:
                        nn = ncur - ntgt
                        pos = np.concatenate([
                            np.arange(0, 2 * nn + 1, 2),
                            np.arange(2 * nn + 1, ncur)])
                        per_level[l - 1] = cur[pos]
            self._fine_indices.append(per_level)

        # --- per-dim per-level operator tables ---
        self.dims: Tuple[Tuple[DimLevel, ...], ...] = tuple(
            tuple(
                _build_dim_level(
                    self.coordinates[d],
                    self._fine_indices[d][l],
                    self._fine_indices[d][l - 1] if l > 0 else None,
                )
                for l in range(self.L + 1)
            )
            for d in range(self.ndim)
        )

    # ------------------------------------------------------------------
    def ndof(self, l: Optional[int] = None) -> int:
        l = self.L if l is None else l
        return int(np.prod(self.shapes[l]))

    @property
    def nonflat_dims(self) -> Tuple[int, ...]:
        return tuple(d for d in range(self.ndim) if self.shape[d] > 1)

    @property
    def effective_ndim(self) -> int:
        """Number of non-flat dims (reference 'effective dimension')."""
        return len(self.nonflat_dims)

    def level_indices(self, l: int, d: int) -> np.ndarray:
        """Fine-grid indices of level-``l`` nodes in dim ``d``."""
        return self._fine_indices[d][l]

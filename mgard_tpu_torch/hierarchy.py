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

import concurrent.futures
import dataclasses
import functools
import os
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


# Lengths over which _thomas_divisors runs the recurrence in chunks side
# by side, each chunk started _DIV_OVERLAP steps early from a guess.
_DIV_SERIAL_MAX = 4096
_DIV_CHUNK = 2048
_DIV_OVERLAP = 64
_DIV_BLOCK = 64
# Grids of at least this many nodes in all build their levels in threads.
_PARALLEL_NODES = 1 << 22


def _thomas_divisors(diag: np.ndarray, offdiag: np.ndarray) -> np.ndarray:
    """The Thomas divisors of the mass matrix, bit for bit those of the
    loop ``d[0] = diag[0]; d[j] = diag[j] - (off[j-1] / d[j-1]) * off[j-1]``
    (reference TensorMassMatrix.tpp:123-140), which the JAX package runs
    in Python: minutes at 10^8 nodes.

    Each step maps the previous divisor monotonically and contracts by
    ``(off / d)^2 <= 1/4`` on any grid (about 0.07 on a uniform one), so
    two runs of the recurrence from different starts meet, bit for bit,
    within a few dozen steps and agree from there on.  So the nodes are
    cut into chunks that run side by side, one step at a time across all
    chunks (numpy, the loop's float64 operations in its order), each
    started ``_DIV_OVERLAP`` steps before its first node from a guess.  A
    chunk whose run holds, at the node before its first one, the bits of
    the previous chunk's exact divisor there repeats the loop's operations
    on the loop's value, so it is exact.  A chunk whose run does not is
    walked again from that exact divisor until the walk meets its stored
    values.  The result is the loop's on every grid, uniform or not; only
    the time depends on how soon the runs meet.
    """
    n = len(diag)
    d = np.empty(n, dtype=np.float64)
    d[0] = diag[0]
    if n <= _DIV_SERIAL_MAX:
        for j in range(1, n):
            d[j] = diag[j] - (offdiag[j - 1] / d[j - 1]) * offdiag[j - 1]
        return d
    # step k computes node k + 1 from node k; chunk c takes steps
    # c*C .. c*C + C - 1: row c of (nchunks, C) views, walked a block of
    # _DIV_BLOCK columns at a time through transposed copies that stay in
    # cache; the steps past the last whole chunk follow the walks
    C, K = _DIV_CHUNK, _DIV_OVERLAP
    nchunks = (n - 1) // C
    dg = diag[1:1 + nchunks * C].reshape(nchunks, C)
    og = offdiag[:nchunks * C].reshape(nchunks, C)
    out = d[1:1 + nchunks * C].reshape(nchunks, C)
    # chunks 1.. start at step c*C - K from half the diagonal of node
    # c*C - K: below every divisor, as the loop's own start is, so that
    # both runs climb from the same side
    cur = np.empty(nchunks, dtype=np.float64)
    cur[0] = d[0]
    cur[1:] = 0.5 * diag[np.arange(1, nchunks) * C - K]
    for k in range(C - K, C):
        dk, ok = dg[:-1, k], og[:-1, k]
        cur[1:] = dk - (ok / cur[1:]) * ok
    probe = cur.copy()          # chunk c's value at node c*C
    for k0 in range(0, C, _DIV_BLOCK):
        db = dg[:, k0:k0 + _DIV_BLOCK].T.copy()
        ob = og[:, k0:k0 + _DIV_BLOCK].T.copy()
        for k in range(len(db)):
            cur = db[k] - (ob[k] / cur) * ob[k]
            db[k] = cur
        out[:, k0:k0 + _DIV_BLOCK] = db.T
    # a chunk is exact where its run meets the exact node c*C
    first = np.arange(1, nchunks) * C + 1
    bad = first[probe[1:].view(np.int64) != d[first - 1].view(np.int64)]
    walked = 0
    end = 1 + nchunks * C
    for j in bad.tolist():
        if j <= walked:
            continue    # an earlier walk passed through this chunk
        while j < end:
            val = diag[j] - (offdiag[j - 1] / d[j - 1]) * offdiag[j - 1]
            if val.view(np.int64) == d[j].view(np.int64):
                break
            d[j] = val
            j += 1
        walked = j
    for j in range(end, n):
        d[j] = diag[j] - (offdiag[j - 1] / d[j - 1]) * offdiag[j - 1]
    return d


def _parent_positions(fine_indices: np.ndarray,
                      coarse_fine_indices: np.ndarray):
    """``(coarse_pos, coarse_is_stride2, front_nc)``: where the parent
    level's nodes sit in this level's grid.  The stride-2 and
    front-interleaved patterns are tested by slicing, without the
    ``searchsorted`` of the general case (same arrays, no log factor)."""
    n, nc = len(fine_indices), len(coarse_fine_indices)
    if n == 2 * nc - 1 and np.array_equal(fine_indices[::2],
                                          coarse_fine_indices):
        return 2 * np.arange(nc), True, None
    nn = n - nc
    if 0 < nn and 2 * nn + 1 <= n and np.array_equal(
            fine_indices[:2 * nn + 1:2], coarse_fine_indices[:nn + 1]) \
            and np.array_equal(fine_indices[2 * nn + 1:],
                               coarse_fine_indices[nn + 1:]):
        return np.concatenate([np.arange(0, 2 * nn + 1, 2),
                               np.arange(2 * nn + 1, n)]), False, nn + 1
    coarse_pos = np.searchsorted(fine_indices, coarse_fine_indices)
    if not np.array_equal(fine_indices[coarse_pos], coarse_fine_indices):
        raise AssertionError("hierarchy levels are not nested")
    return coarse_pos, False, None


def _build_dim_level(x: np.ndarray, fine_indices: np.ndarray,
                     coarse_fine_indices: Optional[np.ndarray]) -> DimLevel:
    """The tables of one level of one dim; ``x``: the float64 coordinates
    of its nodes, ``coordinates[fine_indices]``."""
    n = len(fine_indices)
    h = np.diff(x)

    coarse_pos = None
    coarse_is_stride2 = False
    front_nc = None
    new_pos = new_left = new_right = new_ratio = None
    if coarse_fine_indices is not None:
        coarse_pos, coarse_is_stride2, front_nc = _parent_positions(
            fine_indices, coarse_fine_indices)
        if coarse_is_stride2 or front_nc is not None:
            # new nodes at 1, 3, .., 2*nn - 1 between parents 2k and 2k+2
            nn = n - len(coarse_pos)
            new_pos = np.arange(1, 2 * nn, 2)
            new_left = coarse_pos[:nn]
            new_right = coarse_pos[1:nn + 1]
            xl, xm, xr = x[0:2 * nn - 1:2], x[1:2 * nn:2], x[2:2 * nn + 1:2]
        else:
            is_old = np.zeros(n, dtype=bool)
            is_old[coarse_pos] = True
            new_pos = np.nonzero(~is_old)[0].astype(np.int64)
            # Left/right parent for each new node.
            seg = np.searchsorted(coarse_pos, new_pos)  # right parent
            new_left = coarse_pos[seg - 1]
            new_right = coarse_pos[seg]
            xl, xm, xr = x[new_left], x[new_pos], x[new_right]
        new_ratio = (xm - xl) / (xr - xl)

    # Mass-matrix Thomas divisors (symmetric tridiagonal with
    # diag = [h0/3, (h0+h1)/3, ..., h_{n-2}/3], offdiag = h/6).
    if n >= 2:
        diag = np.empty(n, dtype=np.float64)
        diag[0] = h[0] / 3
        diag[-1] = h[-1] / 3
        if n > 2:
            np.add(h[:-1], h[1:], out=diag[1:-1])
            diag[1:-1] /= 3
        offdiag = h / 6
        divisors = _thomas_divisors(diag, offdiag)
        del diag
    else:
        offdiag = np.zeros(0, dtype=np.float64)
        divisors = np.ones(n, dtype=np.float64)

    # Volume weights with boundary clamping: (x[min(j+1,n-1)]-x[max(j-1,0)])/2
    if n >= 2:
        volumes = np.empty(n, dtype=np.float64)
        np.subtract(x[2:], x[:-2], out=volumes[1:-1])
        volumes[0] = x[1] - x[0]
        volumes[-1] = x[-1] - x[-2]
        volumes /= 2
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
        # steps keep every other node.  Each level's coordinates are taken
        # the same way, as views where the step is a slice.
        self._fine_indices = []
        level_x = []
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
                xs = [self.coordinates[d][idx] for idx in per_level]
            else:
                per_level = [None] * (self.L + 1)
                per_level[self.L] = np.arange(shape[d], dtype=np.int64)
                xs = [None] * (self.L + 1)
                xs[self.L] = self.coordinates[d]
                for l in range(self.L, 0, -1):
                    ncur = len(per_level[l])
                    ntgt = self.shapes[l - 1][d]
                    for lv in (per_level, xs):
                        cur = lv[l]
                        if ncur == ntgt:
                            lv[l - 1] = cur
                        elif 2 * ntgt - 1 == ncur:
                            lv[l - 1] = cur[::2]
                        else:
                            nn = ncur - ntgt
                            lv[l - 1] = np.concatenate(
                                [cur[:2 * nn + 1:2], cur[2 * nn + 1:]])
            self._fine_indices.append(per_level)
            level_x.append(xs)

        # --- per-dim per-level operator tables ---
        # (numpy lets go of the GIL in its array loops, so the levels of a
        # long dim, each a few passes over its nodes, build side by side)
        def build(d, l):
            return _build_dim_level(
                level_x[d][l], self._fine_indices[d][l],
                self._fine_indices[d][l - 1] if l > 0 else None)

        jobs = [(d, l) for d in range(self.ndim) for l in range(self.L + 1)]
        if sum(len(level_x[d][l]) for d, l in jobs) < _PARALLEL_NODES:
            built = [build(d, l) for d, l in jobs]
        else:
            with concurrent.futures.ThreadPoolExecutor(
                    min(len(jobs), os.cpu_count() or 1)) as pool:
                built = list(pool.map(lambda job: build(*job), jobs))
        levels = iter(built)
        self.dims: Tuple[Tuple[DimLevel, ...], ...] = tuple(
            tuple(next(levels) for _ in range(self.L + 1))
            for _ in range(self.ndim))

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

    # ------------------------------------------------------------------
    @functools.cached_property
    def dates_of_birth(self):
        """Per dim, the level that introduced each finest-grid node
        (``mgard_tpu/hierarchy.py:276``).  Built at first use: the
        transform never reads it, and on a 10^8-node dim it is a table
        of that many int64."""
        out = []
        for d in range(self.ndim):
            dob = np.zeros(self.shape[d], dtype=np.int64)
            for l in range(self.L, -1, -1):
                dob[self._fine_indices[d][l]] = l
            out.append(dob)
        return out

    def date_of_birth_grid(self) -> np.ndarray:
        """N-D int array: the level that introduced each finest-grid
        node."""
        grids = np.meshgrid(*self.dates_of_birth, indexing="ij")
        return functools.reduce(np.maximum, grids)

    def shuffle_permutation(self) -> np.ndarray:
        """Permutation p with ``shuffled.flat[i] = v.flat[p[i]]``: the
        reference's shuffled order (level-major, raster order within a
        level; ``shuffle.tpp:7-22``)."""
        dob = self.date_of_birth_grid().ravel()
        return np.argsort(dob, kind="stable").astype(np.int64)

    def level_counts(self) -> np.ndarray:
        """Number of nodes introduced at each level, shape (L+1,)."""
        return np.bincount(self.date_of_birth_grid().ravel(),
                           minlength=self.L + 1)

    # ------------------------------------------------------------------
    def regions(self, l: int):
        """The dense coefficient blocks that level ``l >= 1`` introduces
        (``mgard_tpu/hierarchy.py:338``): ``(region_id, block_shape,
        per_dim_selector)`` with ``per_dim_selector[d]`` ``("new",
        DimLevel)`` where the region takes the level's new nodes and
        ``("old", DimLevel)`` where it takes parent nodes.  Bit ``d`` of
        ``region_id`` (1 .. 2^D - 1) is set iff dim ``d`` is "new"; flat
        dims are always "old"; regions with an empty extent are
        skipped."""
        for r in range(1, 1 << self.ndim):
            sel, bshape = [], []
            for d in range(self.ndim):
                lev = self.dims[d][l]
                if (r >> d) & 1:
                    if lev.new_pos is None or len(lev.new_pos) == 0:
                        break
                    sel.append(("new", lev))
                    bshape.append(len(lev.new_pos))
                else:
                    sel.append(("old", lev))
                    bshape.append(len(lev.coarse_pos)
                                  if lev.coarse_pos is not None else lev.n)
            else:
                yield r, tuple(bshape), tuple(sel)

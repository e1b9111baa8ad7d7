"""The GPK stencil kernels, multilinear interpolation of a level's
parent grid as per-dim +-1 lerps (the counterpart of
``mgard_tpu/ops/stencil_kernels.py``, whose math spec is
``mgard_tpu/ops/stencil.py``).

When every dim of a level is stride-2 or front-interleaved, the parents
of a new node sit at positions +-1, so the interpolation is a
composition of per-dim 3-point lerps:

    B_d(V)[x] = V[x]                                   x_d parental
              = (1-r)*V[x - e_d] + r*V[x + e_d]        x_d new

    gpk_detail:       detail = A - (B1 o B0 o B2)(A)
    gpk_prolong_add:  A = (B1 o B0 o B2)(embed C) + detail

Each runs in one pass by default (K5, K6), or, under
``MGARD_TPU_GPK_FUSED=0`` as in the JAX package, in two passes through
an intermediate ``V0`` in device memory, the arithmetic reference the
one-pass kernels are held bit-identical to:

    K7  run_b20:        V0 = B0(B2(A))                  (n0, n1, n2)
    K8  run_b1sub:      detail = A - B1(V0)
    K9  run_dec_b20:    V0 = B0(B2(C embedded in dims 0 and 2))
                                                        (n0, nc1, n2)
    K10 run_dec_b1add:  A = B1(V0 embedded in dim 1) + detail

Each B_d only reads positions that are parental in the dims not yet
processed, which already carry the right partial interpolation; the
first and the last position of a dim are always parental, so no lerp
reads across an edge.  The composition order (dim 2, then dim 0, then
dim 1) is the JAX kernels', on both sides, so that encode and decode
run the same lerps.
The kernels (``csrc/stencil.cu``) read the coarse array ``C`` at its
coarse indices (K6, K9), so no embedded array is formed.  K5, K7, K8
and K10 evaluate the lerp tree per output element; K6 builds
``K6_TILE`` output tiles in shared memory, each B_d value computed once
(stage B2 over the tile's parent rows and their halo, then B0, then B1
plus ``detail``, 16 bytes a thread), and K9 builds ``K9_TILE`` tiles of
V0 the same way without the B1 stage; both take only the levels the
gate admits.  Each wrapper takes its plain PyTorch version for a CPU
tensor, launches its kernel for a CUDA tensor and raises for anything
else.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..hierarchy import Hierarchy
from . import _build

__all__ = ["gpk_structure_ok", "gpk_supported", "gpk_detail",
           "gpk_prolong_add", "gpk_detail_plain", "gpk_prolong_add_plain",
           "run_b20", "run_b1sub", "run_dec_b20", "run_dec_b1add",
           "run_b20_plain", "run_b1sub_plain", "run_dec_b20_plain",
           "run_dec_b1add_plain"]

# The JAX gate's Mosaic tiling (rows of 8 along dim 0, 128 along dim 1
# and dim 2).  The CUDA kernels need none of it; the port keeps it so
# that it engages GPK on exactly the levels the TPU does.
_B0 = 8
_B1 = 128

# K6's output tile (dims 0, 1, 2), csrc/stencil.cu kT0, kT1, kT2; K9's
# (fine dim 0, coarse dim 1, dim 2), kT0, kJ9, kT2.
K6_TILE = (8, 8, 128)
K9_TILE = (8, 8, 128)

# The JAX package's switch, read at import as it reads it: "0" selects the
# two-pass form (K7-K10) in gpk_detail / gpk_prolong_add.
_FUSED = os.environ.get("MGARD_TPU_GPK_FUSED", "1") == "1"


def _dim_ok_encode(lev) -> bool:
    if lev.coarse_pos is None or lev.new_pos is None or not len(lev.new_pos):
        return False
    return lev.coarse_is_stride2 or lev.front_nc is not None


def _dim_ok_decode(lev) -> bool:
    # even n, front-interleaved, single trailing coarse node: 2^k sizes
    return lev.front_nc is not None and lev.n == 2 * lev.front_nc


def gpk_structure_ok(hier: Hierarchy, l: int) -> bool:
    """``mgard_tpu``'s ``gpk_supported(hier, l, decode=True)`` without its
    backend test: 3 non-flat dims, block-tileable sizes, parents at +-1
    in every dim and the 2^k decode structure in dims 0 and 1."""
    if hier.ndim != 3 or any(s == 1 for s in hier.shape):
        return False
    n0, n1, n2 = (hier.dims[d][l].n for d in range(3))
    if n0 % _B0 or n1 % _B1 or n2 % 128:
        return False
    for d in range(3):
        lev = hier.dims[d][l]
        if not _dim_ok_encode(lev):
            return False
        if d < 2 and not _dim_ok_decode(lev):
            return False
    return True


def gpk_supported(hier: Hierarchy, l: int, A: torch.Tensor) -> bool:
    """The gate of the transform: a float32 tensor on CUDA at a level of
    the right structure.  Off the card the transform takes the matmul
    form, as the JAX package does off the TPU."""
    return A.is_cuda and A.dtype == torch.float32 \
        and gpk_structure_ok(hier, l)


# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------

def _mw_arrays(hier: Hierarchy, l: int):
    """Per-dim host tables of a 3-D level, cached on the hierarchy:
    float32 mask (1 at new positions) and weight (the interpolation ratio
    there), and the int32 coarse index of each parent position (-1 at new
    positions).  Checks that the lerps read inside the grid: the first
    and last positions are parents, and so are both neighbours of every
    new position."""
    cache = hier.__dict__.setdefault("_torch_gpk_mw", {})
    if l not in cache:
        if hier.ndim != 3:
            raise ValueError("the GPK kernels take 3-D hierarchies")
        out = []
        for d in range(3):
            lev = hier.dims[d][l]
            if not _dim_ok_encode(lev):
                raise ValueError(f"dim {d} of level {l} is not refined with "
                                 "parents at +-1")
            m = np.zeros(lev.n, dtype=np.float32)
            w = np.zeros(lev.n, dtype=np.float32)
            m[lev.new_pos] = 1.0
            w[lev.new_pos] = lev.new_ratio.astype(np.float32)
            cidx = np.full(lev.n, -1, dtype=np.int32)
            cidx[lev.coarse_pos] = np.arange(len(lev.coarse_pos))
            new = np.asarray(lev.new_pos)
            if cidx[0] < 0 or cidx[-1] < 0 or (cidx[new - 1] < 0).any() \
                    or (cidx[new + 1] < 0).any():
                raise AssertionError(f"dim {d} of level {l}: a lerp would "
                                     "read a non-parent position")
            out.append((m, w, cidx))
        cache[l] = out
    return cache[l]


def _device_tables(hier: Hierarchy, l: int, device):
    """The kernels' arguments per dim, (weight float32, coarse index
    int32), on ``device`` (cached)."""
    cache = hier.__dict__.setdefault("_torch_gpk_dev", {})
    key = (l, str(device))
    if key not in cache:
        cache[key] = [(torch.as_tensor(w, device=device),
                       torch.as_tensor(c, device=device))
                      for _m, w, c in _mw_arrays(hier, l)]
    return cache[key]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _interp_dim(V: torch.Tensor, m: np.ndarray, w: np.ndarray,
                axis: int) -> torch.Tensor:
    """Apply B_d along ``axis``: lerp new positions from their +-1
    parental neighbours, keep parental positions bit-exactly.  The lerp
    is separate float32 multiplies, a subtract and an add (never
    ``torch.lerp`` or ``addcmul``, which round differently), the same
    expression as the kernels' ``_rn`` intrinsics."""
    shp = [1] * V.dim()
    shp[axis] = V.shape[axis]
    mt = torch.as_tensor(m, dtype=V.dtype, device=V.device).reshape(shp)
    wt = torch.as_tensor(w, dtype=V.dtype, device=V.device).reshape(shp)
    left = torch.roll(V, 1, dims=axis)
    right = torch.roll(V, -1, dims=axis)
    lerp = (1 - wt) * left + wt * right
    return torch.where(mt != 0, lerp, V)


def _interp_dims(hier: Hierarchy, V: torch.Tensor, l: int, dims
                 ) -> torch.Tensor:
    mw = _mw_arrays(hier, l)
    for d in dims:
        V = _interp_dim(V, mw[d][0], mw[d][1], d)
    return V


def _embed(hier: Hierarchy, C: torch.Tensor, l: int, dims) -> torch.Tensor:
    """``C`` placed at the parent positions of ``dims`` (the other dims
    kept as they are) in an array of zeros."""
    shape, index = list(C.shape), []
    for d in range(3):
        if d in dims:
            shape[d] = hier.dims[d][l].n
            i = np.asarray(hier.dims[d][l].coarse_pos)
        else:
            i = np.arange(C.shape[d])
        index.append(torch.as_tensor(i, device=C.device).reshape(
            [-1 if e == d else 1 for e in range(3)]))
    V = torch.zeros(shape, dtype=C.dtype, device=C.device)
    V[tuple(index)] = C
    return V


def gpk_detail_plain(hier: Hierarchy, A: torch.Tensor, l: int
                     ) -> torch.Tensor:
    """Plain PyTorch K5: ``A - B1(B0(B2(A)))``."""
    return A - _interp_dims(hier, A, l, (2, 0, 1))


def gpk_prolong_add_plain(hier: Hierarchy, C: torch.Tensor,
                          detail: torch.Tensor, l: int) -> torch.Tensor:
    """Plain PyTorch K6: ``C`` placed at the all-parent positions of a
    zero array, ``B1(B0(B2(.)))``, plus ``detail``."""
    return _interp_dims(hier, _embed(hier, C, l, (0, 1, 2)), l,
                        (2, 0, 1)) + detail


def run_b20_plain(hier: Hierarchy, A: torch.Tensor, l: int) -> torch.Tensor:
    """Plain PyTorch K7: ``V0 = B0(B2(A))``."""
    return _interp_dims(hier, A, l, (2, 0))


def run_b1sub_plain(hier: Hierarchy, V0: torch.Tensor, A: torch.Tensor,
                    l: int) -> torch.Tensor:
    """Plain PyTorch K8: ``A - B1(V0)``."""
    return A - _interp_dims(hier, V0, l, (1,))


def run_dec_b20_plain(hier: Hierarchy, C: torch.Tensor, l: int
                      ) -> torch.Tensor:
    """Plain PyTorch K9: ``C`` placed at the parent positions of dims 0
    and 2, then ``B0(B2(.))``; dim 1 stays coarse: (n0, nc1, n2)."""
    return _interp_dims(hier, _embed(hier, C, l, (0, 2)), l, (2, 0))


def run_dec_b1add_plain(hier: Hierarchy, V0: torch.Tensor,
                        detail: torch.Tensor, l: int) -> torch.Tensor:
    """Plain PyTorch K10: ``V0`` placed at the parent positions of dim 1,
    then ``B1(.)``, plus ``detail``."""
    return _interp_dims(hier, _embed(hier, V0, l, (1,)), l, (1,)) + detail


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda(name: str, **tensors) -> torch.device:
    """The one CUDA device of the tensors, each a contiguous float32
    tensor of its shape."""
    device = _build.device_of(name, *(t for t, _ in tensors.values()))
    for arg, (t, shape) in tensors.items():
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous float32 "
                             f"tensor of shape {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return device


def _table_ptrs(hier: Hierarchy, l: int, device, dims=(0, 1, 2)):
    """Pointers to the (weight, coarse index) tables of ``dims``."""
    tables = _device_tables(hier, l, device)
    return [t.data_ptr() for d in dims for t in tables[d]]


def _v0_shape(hier: Hierarchy, l: int):
    """The shape of K9's output: the fine dims 0 and 2, the coarse dim 1."""
    n0, _, n2 = hier.shapes[l]
    return (n0, hier.shapes[l - 1][1], n2)


@_build.counted
def gpk_detail(hier: Hierarchy, A: torch.Tensor, l: int) -> torch.Tensor:
    """detail = A - multilinear interpolation of the parents of the dense
    level-``l`` array ``A``: exact zeros at all-parent nodes.  K5 in one
    pass; under ``MGARD_TPU_GPK_FUSED=0``, K7 then K8."""
    if not _FUSED:
        return run_b1sub(hier, run_b20(hier, A, l), A, l)
    if _on_cpu(A):
        return gpk_detail_plain(hier, A, l)
    shape = hier.shapes[l]
    device = _check_cuda("gpk_detail", A=(A, shape))
    out = torch.empty_like(A)
    _build.launch("mgard_gpk_detail", A.data_ptr(), out.data_ptr(),
                  *_table_ptrs(hier, l, device), *shape, device=device)
    gpk_detail.launches += 1
    return out


@_build.counted
def gpk_prolong_add(hier: Hierarchy, C: torch.Tensor, detail: torch.Tensor,
                    l: int) -> torch.Tensor:
    """A = multilinear interpolation of the coarse array ``C`` (the parent
    level's grid) onto level ``l``, plus ``detail``.  K6 in one pass;
    under ``MGARD_TPU_GPK_FUSED=0``, K9 then K10."""
    if not _FUSED:
        return run_dec_b1add(hier, run_dec_b20(hier, C, l), detail, l)
    if _on_cpu(C, detail):
        return gpk_prolong_add_plain(hier, C, detail, l)
    shape, cshape = hier.shapes[l], hier.shapes[l - 1]
    device = _check_cuda("gpk_prolong_add", C=(C, cshape),
                         detail=(detail, shape))
    if not gpk_structure_ok(hier, l):
        raise ValueError(f"gpk_prolong_add: level {l} of {hier.shape} is "
                         "not of the structure the GPK gate admits")
    out = torch.empty_like(detail)
    _build.launch("mgard_gpk_prolong_add", C.data_ptr(), detail.data_ptr(),
                  out.data_ptr(), *_table_ptrs(hier, l, device), *shape,
                  cshape[1], cshape[2], device=device)
    gpk_prolong_add.launches += 1
    return out


@_build.counted
def run_b20(hier: Hierarchy, A: torch.Tensor, l: int) -> torch.Tensor:
    """K7: ``V0 = B0(B2(A))``, the first pass of the two-pass detail."""
    if _on_cpu(A):
        return run_b20_plain(hier, A, l)
    shape = hier.shapes[l]
    device = _check_cuda("run_b20", A=(A, shape))
    V0 = torch.empty_like(A)
    _build.launch("mgard_b20", A.data_ptr(), V0.data_ptr(),
                  *_table_ptrs(hier, l, device, (0, 2)), *shape,
                  device=device)
    run_b20.launches += 1
    return V0


@_build.counted
def run_b1sub(hier: Hierarchy, V0: torch.Tensor, A: torch.Tensor, l: int
              ) -> torch.Tensor:
    """K8: ``detail = A - B1(V0)``, the second pass of the two-pass
    detail."""
    if _on_cpu(V0, A):
        return run_b1sub_plain(hier, V0, A, l)
    shape = hier.shapes[l]
    device = _check_cuda("run_b1sub", V0=(V0, shape), A=(A, shape))
    out = torch.empty_like(A)
    _build.launch("mgard_b1sub", V0.data_ptr(), A.data_ptr(), out.data_ptr(),
                  *_table_ptrs(hier, l, device, (1,)), *shape, device=device)
    run_b1sub.launches += 1
    return out


@_build.counted
def run_dec_b20(hier: Hierarchy, C: torch.Tensor, l: int) -> torch.Tensor:
    """K9: ``V0 = B0(B2(C embedded in dims 0 and 2))``, (n0, nc1, n2), the
    first pass of the two-pass prolongation."""
    if _on_cpu(C):
        return run_dec_b20_plain(hier, C, l)
    cshape = hier.shapes[l - 1]
    device = _check_cuda("run_dec_b20", C=(C, cshape))
    if not gpk_structure_ok(hier, l):
        raise ValueError(f"run_dec_b20: level {l} of {hier.shape} is not "
                         "of the structure the GPK gate admits")
    vshape = _v0_shape(hier, l)
    V0 = torch.empty(vshape, dtype=C.dtype, device=C.device)
    _build.launch("mgard_dec_b20", C.data_ptr(), V0.data_ptr(),
                  *_table_ptrs(hier, l, device, (0, 2)), *vshape,
                  cshape[2], device=device)
    run_dec_b20.launches += 1
    return V0


@_build.counted
def run_dec_b1add(hier: Hierarchy, V0: torch.Tensor, detail: torch.Tensor,
                  l: int) -> torch.Tensor:
    """K10: ``A = B1(V0 embedded in dim 1) + detail``, the second pass of
    the two-pass prolongation."""
    if _on_cpu(V0, detail):
        return run_dec_b1add_plain(hier, V0, detail, l)
    shape, vshape = hier.shapes[l], _v0_shape(hier, l)
    device = _check_cuda("run_dec_b1add", V0=(V0, vshape),
                         detail=(detail, shape))
    out = torch.empty_like(detail)
    _build.launch("mgard_dec_b1add", V0.data_ptr(), detail.data_ptr(),
                  out.data_ptr(), *_table_ptrs(hier, l, device, (1,)),
                  *shape, vshape[1], device=device)
    run_dec_b1add.launches += 1
    return out

"""K13 ``rm_dim0``: the mass apply and restriction half of the correction
along dim 0 (the counterpart of ``mgard_tpu/ops/lpk_kernels.py``, the
reference's LPK stage of CalcCorrection).

The correction of a level is ``K = M_{l-1}^{-1} R_l M_l`` per dim.  Along
dim 0 the array is still at its full fine size, and the dense (nc0, n0)
matmul there is the largest of the chain.  On a front-interleaved dim 0
(n0 = 2 * front_nc, every 2^k size) the combined ``A = R_l M_l`` is a
5-tap banded operator over the even/odd dim-0 planes, which K13
(``csrc/lpk.cu``) applies as a stencil; the dense (nc0, pad8(nc0))
``M_{l-1}^{-1}`` and the dim-1/2 correction matmuls of
:func:`correction_matrices_fast` finish the correction at half the size.
The transform takes this branch under ``MGARD_TPU_LPK=1`` (the JAX
package's switch, read at import in ``ops/transform.py``) where
:func:`rm0_supported` admits the level; float64 data never takes it.

The output keeps the JAX kernel's pad8(nc0) rows, so that the chain
mirrors the reference; its pad rows are zeros (finite, as the zero
columns of the padded ``M^-1`` need).  The wrapper takes the plain
version for a CPU tensor, launches the kernel for a CUDA tensor and
raises for anything else.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hierarchy import Hierarchy
from . import _build

__all__ = ["rm0_structure_ok", "rm0_supported", "rm0_tables", "rm_dim0",
           "rm_dim0_plain", "minv_dense_np", "correction_matrices_fast"]

# The JAX gate's Mosaic tiling (16 input rows a block along dim 0, 64
# sublanes along dim 1, 128 lanes along dim 2).  The CUDA kernel needs
# only n2 % 4; the port keeps the tiling so that it engages LPK on exactly
# the levels the TPU does.
_B1 = 64
_TABLE_COLS = 128


def _pad8(x: int) -> int:
    return -(-x // 8) * 8


def rm0_structure_ok(hier: Hierarchy, l: int) -> bool:
    """``mgard_tpu``'s ``rm0_supported`` without its backend test: 3 dims,
    dim 0 refined and front-interleaved with n0 == 2 * front_nc, and the
    block-tileable sizes n0 % 16, n1 % 64, n2 % 128."""
    if hier.ndim != 3:
        return False
    lev = hier.dims[0][l]
    if lev.coarse_pos is None or lev.new_pos is None or not len(lev.new_pos):
        return False
    if not (lev.front_nc is not None and lev.n == 2 * lev.front_nc):
        return False
    n0, n1, n2 = (hier.dims[d][l].n for d in range(3))
    return n0 % 16 == 0 and n1 % _B1 == 0 and n2 % 128 == 0


def rm0_supported(hier: Hierarchy, l: int, B: torch.Tensor) -> bool:
    """The gate of the transform: a float32 tensor on CUDA at a level of
    the right structure.  Off the card the correction stays the matmul
    chain, as the JAX package's does off the TPU."""
    return B.is_cuda and B.dtype == torch.float32 \
        and rm0_structure_ok(hier, l)


def rm0_tables(hier: Hierarchy, l: int) -> np.ndarray:
    """(pad8(nc0), 128) float32 tap table, cached on the hierarchy.

    Rows j < fc: cols 0..4 hold the taps of ``A = R M`` at columns
    ``2j - 2 .. 2j + 2`` (0 where a column is outside the grid).  Row fc
    (the trailing coarse node of the front-interleaved dim): cols 0..3
    hold its taps at columns ``n-4 .. n-1``.  Pad rows are zero.  Built
    in float64 and cast, as the JAX package builds it.
    """
    cache = hier.__dict__.setdefault("_rm0_tab", {})
    if l not in cache:
        from .transform import _mass_matrix_np, _restriction_matrix_np
        lev = hier.dims[0][l]
        A = _restriction_matrix_np(lev) @ _mass_matrix_np(lev.h)
        nc, n = A.shape
        fc = lev.front_nc
        assert n == 2 * fc and nc == fc + 1
        meta = np.zeros((_pad8(nc), _TABLE_COLS), dtype=np.float32)
        chk = np.zeros_like(A)
        for j in range(fc):
            for k in range(-2, 3):
                col = 2 * j + k
                if 0 <= col < n:
                    meta[j, k + 2] = A[j, col]
                    chk[j, col] = A[j, col]
        meta[fc, 0:4] = A[nc - 1, n - 4:]
        chk[nc - 1, n - 4:] = A[nc - 1, n - 4:]
        # the structural zero pattern must hold or the stencil is wrong
        assert np.array_equal(chk, A), "RM operator is not 5-banded"
        cache[l] = meta
    return cache[l]


def _device_table(hier: Hierarchy, l: int, device) -> torch.Tensor:
    cache = hier.__dict__.setdefault("_torch_rm0_tab", {})
    key = (l, str(device))
    if key not in cache:
        cache[key] = torch.as_tensor(rm0_tables(hier, l), device=device)
    return cache[key]


def rm_dim0_plain(hier: Hierarchy, B: torch.Tensor, l: int) -> torch.Tensor:
    """Plain PyTorch K13: the kernel's sums, term by term in its order,
    over the even/odd planes (the missing neighbours of rows 0 and fc-1
    read as the clamped rows times a zero tap); the tail row fc; zeros
    in the pad rows."""
    n0, n1, n2 = B.shape
    fc = hier.dims[0][l].front_nc
    tab = _device_table(hier, l, B.device)
    w = tab[:fc, :5].T.reshape(5, fc, 1, 1)
    t = tab[fc, :4]
    E, O = B[0::2], B[1::2]
    Em1 = torch.cat([E[:1], E[:-1]])
    Om1 = torch.cat([O[:1], O[:-1]])
    Ep1 = torch.cat([E[1:], E[-1:]])
    acc = w[0] * Em1
    acc = acc + w[1] * Om1
    acc = acc + w[2] * E
    acc = acc + w[3] * O
    acc = acc + w[4] * Ep1
    tail = t[0] * B[n0 - 4]
    tail = tail + t[1] * B[n0 - 3]
    tail = tail + t[2] * B[n0 - 2]
    tail = tail + t[3] * B[n0 - 1]
    pad = B.new_zeros(tab.shape[0] - fc - 1, n1, n2)
    return torch.cat([acc, tail[None], pad])


@_build.counted
def rm_dim0(hier: Hierarchy, B: torch.Tensor, l: int) -> torch.Tensor:
    """Apply ``R_l M_l`` along dim 0 of a dense level-``l`` float32 array
    (n0, n1, n2): (pad8(nc0), n1, n2), the rows past nc0 zero."""
    shape = tuple(hier.shapes[l])
    if B.device.type == "cpu":
        return rm_dim0_plain(hier, B, l)
    device = _build.device_of("rm_dim0", B)
    if B.dtype != torch.float32 or tuple(B.shape) != shape \
            or not B.is_contiguous() or B.data_ptr() % 16:
        raise ValueError(f"rm_dim0: B must be a contiguous, 16-byte aligned "
                         f"float32 tensor of shape {shape}, got {B.dtype} "
                         f"{tuple(B.shape)}")
    if not rm0_structure_ok(hier, l):
        raise ValueError(f"rm_dim0: level {l} of {hier.shape} is not a "
                         "front-interleaved, block-tileable level")
    tab = _device_table(hier, l, device)
    fc = hier.dims[0][l].front_nc
    out = torch.empty((tab.shape[0],) + shape[1:], dtype=B.dtype,
                      device=B.device)
    _build.launch("mgard_rm_dim0", B.data_ptr(), tab.data_ptr(),
                  out.data_ptr(), fc, tab.shape[0], shape[1] * shape[2],
                  device=device)
    rm_dim0.launches += 1
    return out


def minv_dense_np(lev) -> np.ndarray:
    """Dense inverse of the level's 1-D mass matrix (host, float64)."""
    from .transform import _thomas_np
    return _thomas_np(lev, np.eye(lev.n))


def correction_matrices_fast(hier: Hierarchy, l: int):
    """Matrices completing :func:`rm_dim0` into the full correction:
    ``[Minv0_pad (nc0, pad8(nc0)), K1 (nc1, n1), K2 (nc2, n2)]``, float64,
    cached on the hierarchy."""
    cache = hier.__dict__.setdefault("_corr_fast_mats", {})
    if l not in cache:
        from .transform import _correction_matrices
        K = _correction_matrices(hier, l)
        levc0 = hier.dims[0][l - 1]
        nc0 = levc0.n
        Minv_pad = np.zeros((nc0, _pad8(nc0)), dtype=np.float64)
        Minv_pad[:, :nc0] = minv_dense_np(levc0)
        cache[l] = [np.ascontiguousarray(Minv_pad), K[1], K[2]]
    return cache[l]

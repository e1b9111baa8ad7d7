"""Batched tridiagonal (mass-matrix) apply and solve along one axis (the
port of ``mgard_tpu/ops/tridiag.py``).

The 1-D mass matrix on a grid with spacings ``h`` is symmetric tridiagonal:

    diag    = [h0/3, (h0+h1)/3, ..., (h_{n-3}+h_{n-2})/3, h_{n-2}/3]
    offdiag = h/6

(reference ``ConstituentMassMatrix``, include/TensorMassMatrix.tpp:14-90).
The inverse is the Thomas algorithm with the divisors the hierarchy
precomputes per level (``ConstituentMassMatrixInverse``,
TensorMassMatrix.tpp:123-290).

The solve is sequential along its axis and parallel across the others.
The JAX package writes it as a ``lax.scan`` over planes of the solve
axis; here it is a Python loop over the same planes, a few elementwise
launches each.  The JAX package has no kernel for it and neither does the
port: the norms (``ops/norms.py``) are its only caller, and the transform
uses dense matrices up to 4096 nodes a dim.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mass_apply", "mass_solve", "pad_axis", "along_axis"]


def pad_axis(x: torch.Tensor, before: int, after: int, axis: int
              ) -> torch.Tensor:
    """Zeros before and after ``x`` along ``axis`` (``lax.pad``)."""
    parts = []
    for k in (before, after):
        shp = list(x.shape)
        shp[axis] = k
        parts.append(x.new_zeros(shp))
    return torch.cat([parts[0], x, parts[1]], dim=axis)


def along_axis(vec, like: torch.Tensor, axis: int) -> torch.Tensor:
    """A float64 vector in ``like``'s dtype and device, shaped to
    broadcast along ``axis`` of ``like``."""
    shp = [1] * like.dim()
    shp[axis] = len(vec)
    return torch.as_tensor(np.asarray(vec), dtype=like.dtype,
                           device=like.device).reshape(shp)


def mass_apply(v: torch.Tensor, h: np.ndarray, axis: int) -> torch.Tensor:
    """Apply the 1-D mass matrix along ``axis`` of ``v``; ``h``: the
    (n-1,) spacings of this level's grid in that dim."""
    n = v.shape[axis]
    if n < 2:
        raise ValueError("mass_apply requires >= 2 nodes along axis")
    hb = along_axis(h, v, axis)
    lo = v.narrow(axis, 0, n - 1)
    hi = v.narrow(axis, 1, n - 1)
    # each interval [x_j, x_{j+1}] adds h/3 * its own end + h/6 * the
    # other to each of its two nodes
    third = hb / 3
    sixth = hb / 6
    left = third * lo + sixth * hi     # to node j
    right = sixth * lo + third * hi    # to node j+1
    return pad_axis(left, 0, 1, axis) + pad_axis(right, 1, 0, axis)


def mass_solve(b: torch.Tensor, offdiag: np.ndarray, divisors: np.ndarray,
               axis: int) -> torch.Tensor:
    """Solve ``M x = b`` along ``axis`` (Thomas, with the precomputed
    divisors: the pre-eliminated diagonal).  ``offdiag``: the (n-1,)
    off-diagonal ``h/6``; ``divisors``: (n,)."""
    n = b.shape[axis]
    if n < 2:
        raise ValueError("mass_solve requires >= 2 nodes along axis")
    # the coefficients in b's dtype, as the JAX package casts them; as
    # Python floats they convert back to that dtype exactly
    npdt = {torch.float32: np.float32, torch.float64: np.float64}[b.dtype]
    off = np.asarray(offdiag).astype(npdt)
    div = np.asarray(divisors).astype(npdt)
    w = off / div[:-1]
    bm = b.movedim(axis, 0)
    # forward sweep: d'_i = d_i - (off[i-1] / div[i-1]) * d'_{i-1}
    d = [bm[0]]
    for i in range(1, n):
        d.append(bm[i] - float(w[i - 1]) * d[-1])
    # backward sweep: x_{n-1} = d'_{n-1} / div[n-1];
    # x_i = (d'_i - off[i] * x_{i+1}) / div[i]
    x = [None] * n
    x[n - 1] = d[n - 1] / float(div[n - 1])
    for i in range(n - 2, -1, -1):
        x[i] = (d[i] - float(off[i]) * x[i + 1]) / float(div[i])
    return torch.stack(x).movedim(0, axis)

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
axis, which XLA runs as a loop on the device.  Here :func:`mass_solve`
launches S1, a hand-written CUDA Thomas solve (``csrc/tridiag.cu``), for a
CUDA tensor, and runs :func:`mass_solve_plain`, a Python loop over the
same planes, for a CPU tensor.  Two callers: the transform's correction
wherever a level does not take the dense matrices (a dim over
``MGARD_TPU_MATMUL_MAX_N`` nodes, or ``MGARD_TPU_SOLVER=scan``;
``ops/transform.py``), and the s-norms (``ops/norms.py``) at every level.
:func:`mass_apply` stays plain torch, as it is plain XLA in JAX.

Host tables that the operators read (spacings, ratios, indices, the
solve's coefficients) are copied to a device once and kept there as long
as the host array they come from lives (:func:`cached_tensor`).
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from . import _build

__all__ = ["mass_apply", "mass_solve", "mass_solve_plain", "solve_tables",
           "chunk_length", "cached_tensor", "pad_axis", "along_axis"]

# S1 cuts each line into chunks that run side by side (csrc/tridiag.cu):
# enough chunks a line for about _SOLVE_THREADS threads in all, none
# shorter than _SOLVE_MIN_CHUNK nodes, each started _SOLVE_OVERLAP nodes
# early.
_SOLVE_THREADS = 1 << 17
_SOLVE_MIN_CHUNK = 256
_SOLVE_OVERLAP = 64

_TENSORS = {}


def _kept(arr: np.ndarray, key: tuple, build):
    """``build()``, made once per ``key`` and host array ``arr`` and
    dropped with the array."""
    key = (id(arr),) + key
    hit = _TENSORS.get(key)
    if hit is None:
        hit = _TENSORS[key] = build()
        weakref.finalize(arr, _TENSORS.pop, key, None)
    return hit


def cached_tensor(arr: np.ndarray, dtype: torch.dtype, device
                  ) -> torch.Tensor:
    """``torch.as_tensor(arr, dtype, device)``; on a card made once per
    array, type and device and dropped with the array (the hierarchy's
    tables live as long as their hierarchy).  A CPU tensor may share the
    array's memory, so it is made anew each time."""
    if torch.device(device).type == "cpu":
        return torch.as_tensor(arr, dtype=dtype, device=device)
    return _kept(arr, (dtype, str(device)), lambda: torch.as_tensor(
        arr, dtype=dtype, device=device))


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
    if isinstance(vec, np.ndarray):
        t = cached_tensor(vec, like.dtype, like.device)
    else:
        t = torch.as_tensor(np.asarray(vec), dtype=like.dtype,
                            device=like.device)
    return t.reshape(shp)


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


def solve_tables(offdiag: np.ndarray, divisors: np.ndarray, dtype):
    """``(w, off, div)``: the solve's coefficients in ``dtype`` (a torch
    float type), as the JAX package casts them; ``w = off / div[:-1]`` is
    taken in that type."""
    npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    off = np.asarray(offdiag).astype(npdt)
    div = np.asarray(divisors).astype(npdt)
    return off / div[:-1], off, div


def _device_tables(offdiag, divisors, dtype, device):
    """:func:`solve_tables` on ``device``, made once per level (kept as
    long as the level's divisors array lives)."""
    return _kept(divisors, ("solve", dtype, str(device)), lambda: tuple(
        torch.as_tensor(a, device=device)
        for a in solve_tables(offdiag, divisors, dtype)))


def chunk_length(n: int, m: int) -> int:
    """S1's chunk length for ``m`` lines of ``n`` nodes."""
    per_line = max(1, -(-_SOLVE_THREADS // m))
    nchunks = min(per_line, max(1, n // _SOLVE_MIN_CHUNK))
    return -(-n // nchunks)


def mass_solve_plain(b: torch.Tensor, offdiag: np.ndarray,
                     divisors: np.ndarray, axis: int) -> torch.Tensor:
    """Plain PyTorch S1: the Thomas solve ``M x = b`` along ``axis``, a
    Python loop over the planes of that axis in the JAX scan's order.  The
    divisors divide as 0-d tensors on ``b``'s device: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal instead, which
    is not the division of the JAX package and of the kernel."""
    n = b.shape[axis]
    if n < 2:
        raise ValueError("mass_solve requires >= 2 nodes along axis")
    w, off, div = solve_tables(offdiag, divisors, b.dtype)
    divt = torch.as_tensor(div, device=b.device)
    bm = b.movedim(axis, 0)
    # forward sweep: d'_i = d_i - (off[i-1] / div[i-1]) * d'_{i-1}
    d = [bm[0]]
    for i in range(1, n):
        d.append(bm[i] - float(w[i - 1]) * d[-1])
    # backward sweep: x_{n-1} = d'_{n-1} / div[n-1];
    # x_i = (d'_i - off[i] * x_{i+1}) / div[i]
    x = [None] * n
    x[n - 1] = d[n - 1] / divt[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = (d[i] - float(off[i]) * x[i + 1]) / divt[i]
    return torch.stack(x).movedim(0, axis)


@_build.counted
def mass_solve(b: torch.Tensor, offdiag: np.ndarray, divisors: np.ndarray,
               axis: int) -> torch.Tensor:
    """Solve ``M x = b`` along ``axis`` (Thomas, with the precomputed
    divisors: the pre-eliminated diagonal).  ``offdiag``: the (n-1,)
    off-diagonal ``h/6``; ``divisors``: (n,).  float32 or float64; S1 on
    a CUDA tensor, the plain version on a CPU tensor."""
    n = b.shape[axis]
    if n < 2:
        raise ValueError("mass_solve requires >= 2 nodes along axis")
    if b.device.type == "cpu":
        return mass_solve_plain(b, offdiag, divisors, axis)
    device = _build.device_of("mass_solve", b)
    if b.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"mass_solve: float32 or float64 data, got "
                         f"{b.dtype}")
    w, off, div = _device_tables(offdiag, divisors, b.dtype, device)
    m = b.numel() // n
    if m == 0:
        return torch.empty_like(b)
    # S1 reads an (outer, n, inner) array, the threads of a warp on
    # neighbouring lines; the last axis of an N-D array (inner = 1) is
    # moved first so that they still are
    inner = math.prod(b.shape[axis + 1:])
    moved = inner == 1 and m > 1
    bm = b.movedim(axis, 0).contiguous() if moved else b.contiguous()
    if moved:
        inner = m
    x = torch.empty_like(bm)
    chunk = chunk_length(n, m)
    nchunks = -(-n // chunk)
    # one chunk a line needs no scratch: one kernel runs both sweeps in x
    dd = probe = x
    if nchunks > 1:
        dd = torch.empty_like(bm)
        probe = torch.empty((nchunks, m), dtype=b.dtype, device=device)
    _build.launch("mgard_mass_solve", bm.data_ptr(), w.data_ptr(),
                  off.data_ptr(), div.data_ptr(), x.data_ptr(),
                  dd.data_ptr(), probe.data_ptr(), n, m, inner, chunk,
                  _SOLVE_OVERLAP, int(b.dtype == torch.float64),
                  device=device)
    mass_solve.launches += 1
    return x.movedim(0, axis) if moved else x

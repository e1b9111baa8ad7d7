"""Levelwise linear quantization of the multilevel coefficients (the
port of ``mgard_tpu/ops/quantize.py``'s pyramid half).

**L-infinity** (``s = inf``): the quantum is ``2*tol / ((L+1) * (1 +
3^d))`` with ``d`` the number of non-flat dims.  For the segmented codec
it is computed on the host in float32 exactly as the JAX package
computes it when it traces ``Compressor._encode_impl`` with a float32
tolerance: ``2*tol`` in float32, times the float32 reciprocal of the
denominator (XLA folds the division by that constant into this
multiplication), and ``inv_q = 1 / q`` in float32.  So the port
quantizes with the very same float32 ``inv_q`` and dequantizes with the
same ``q``.

The flat stream (``scale_pyramid``/``dequantize_pyramid``: the PYRAMID
layout and every non-segmented codec) follows the JAX package's other
rounding, ``blk * (1 / q.astype(dtype))``, in the setting where its
tolerance is traced as float64 (``jax_enable_x64``, which float64 data
needs and the JAX tests turn on): ``q`` is formed in float64 (``2*tol``
times the float64 reciprocal of the denominator, the same folding), cast
to the data's dtype, and only then inverted in that dtype; dequantizing
multiplies by the cast ``q``.  The two roundings can differ by an ulp of
the quantum, far inside the bound's slack.

The LEVEL_BLOCKS stream scales its (level, region) blocks the same way
(``scale_blocks``/``dequantize_blocks``), each block with the weights of
its own positions.

**s-norm** (finite ``s``): the quantum of a level-``l`` node is ``2*tol /
(2^(s*l) * sqrt(ndof * vol(node)))``, with ``vol`` the product over the
non-flat dims of half the distance between the node's neighbours in
level ``l``'s grid (a flat dim gives a factor of 1).  Each level is
multiplied by the scalar ``2^(s*l) * sqrt(ndof) / (2*tol)``, formed in
float64 and cast to the data's dtype once, and then by each dim's
``sqrt(vol)`` vector, cast to that dtype, in the order d = 0 .. ndim-1;
dequantizing multiplies by the inverse scalar and divides by each
vector in the same order.  Those are the JAX functions' operations one
for one, so on the same pyramid both give the same bits (its jitted
compressor may merge constant factors, which moves a last bit at some
values; both stay far inside the bound).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..hierarchy import Hierarchy
from .transform import block_specs
from .tridiag import along_axis

__all__ = ["supremum_quantum", "inverse_quantum", "round_quantize",
           "flat_quantum", "scale_pyramid", "dequantize_pyramid",
           "scale_blocks", "quantize_blocks", "dequantize_blocks",
           "TORCH_DTYPE"]

TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}
_NUMPY_DTYPE = {t: n for n, t in TORCH_DTYPE.items()}


def supremum_quantum(hier: Hierarchy, tol: float) -> np.float32:
    """The uniform L-infinity quantum, as a float32."""
    d = hier.effective_ndim
    denom = np.float32((hier.L + 1) * (1 + 3.0 ** d))
    return np.float32(np.float32(2.0) * np.float32(tol)) \
        * (np.float32(1.0) / denom)


def inverse_quantum(hier: Hierarchy, tol: float) -> np.float32:
    """``1 / supremum_quantum`` in float32 (compressor.py:309-311)."""
    return np.float32(1.0) / supremum_quantum(hier, tol)


def flat_quantum(hier: Hierarchy, tol: float, dtype):
    """``(q, 1 / q)`` of the flat stream, as numpy scalars of ``dtype``."""
    d = hier.effective_ndim
    denom = (hier.L + 1) * (1 + 3.0 ** d)
    q = np.dtype(dtype).type(np.float64(2.0 * float(tol)) * (1.0 / denom))
    return q, np.dtype(dtype).type(1) / q


def _level_weight_vectors(hier: Hierarchy, l: int):
    """Per-dim ``sqrt(vol)`` vectors (float64) over level ``l``'s grid
    (``quantize.py:69``): ones(1) for a flat dim.  Parent positions of a
    detail array hold zeros, so the weight there multiplies nothing."""
    return [np.ones(1) if hier.shape[d] == 1
            else np.sqrt(hier.dims[d][l].volumes) for d in range(hier.ndim)]


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float64 value cast once to ``like``'s dtype, as a 0-d tensor."""
    return torch.tensor(_NUMPY_DTYPE[like.dtype].type(value),
                        device=like.device)


def scale_pyramid(hier: Hierarchy, pyramid, s: float, tol: float):
    """Each pyramid level times its inverse quanta, not rounded
    (``quantize.py:82``)."""
    if math.isinf(s):
        _, inv = flat_quantum(hier, tol, _NUMPY_DTYPE[pyramid[0].dtype])
        return [blk * torch.tensor(inv, device=blk.device)
                for blk in pyramid]
    out = []
    for l, blk in enumerate(pyramid):
        scaled = blk * _scalar((2.0 ** (s * l)) * math.sqrt(hier.ndof())
                               / (2.0 * float(tol)), blk)
        for d, w in enumerate(_level_weight_vectors(hier, l)):
            scaled = scaled * along_axis(w, blk, d)
        out.append(scaled)
    return out


def dequantize_pyramid(hier: Hierarchy, qpyramid, s: float, tol: float,
                       dtype):
    """Integer pyramid levels times their quanta, in ``dtype``
    (``quantize.py:140``)."""
    tdt = TORCH_DTYPE[np.dtype(dtype)]
    if math.isinf(s):
        q, _ = flat_quantum(hier, tol, dtype)
        return [blk.to(tdt) * torch.tensor(q, device=blk.device)
                for blk in qpyramid]
    out = []
    for l, blk in enumerate(qpyramid):
        c = blk.to(tdt)
        c = c * _scalar((2.0 * float(tol))
                        / ((2.0 ** (s * l)) * math.sqrt(hier.ndof())), c)
        for d, w in enumerate(_level_weight_vectors(hier, l)):
            c = c / along_axis(w, c, d)
        out.append(c)
    return out


def round_quantize(scaled: torch.Tensor, int_dtype=torch.int32
                   ) -> torch.Tensor:
    """Round half away from zero, then cast to ``int_dtype``: int32, or
    int64 for float64 data (``quantize.py:103``)."""
    t = torch.trunc(0.5 + scaled.abs())
    return torch.where(scaled < 0, -t, t).to(int_dtype)


def _block_inv_quantum_volume(hier: Hierarchy, l: int, pos):
    """Per-dim ``sqrt(vol)`` vectors (float64) of one block: level
    ``l``'s volumes at the block's positions (``quantize.py:47``)."""
    return [np.ones(1) if hier.shape[d] == 1
            else np.sqrt(hier.dims[d][l].volumes[np.asarray(pos[d])])
            for d in range(hier.ndim)]


def scale_blocks(hier: Hierarchy, blocks, s: float, tol: float):
    """Each (level, region) block of :func:`transform.block_specs` times
    its inverse quanta, not rounded (``quantize.py:157``)."""
    if math.isinf(s):
        return scale_pyramid(hier, blocks, s, tol)
    out = []
    for (l, _, _, pos), blk in zip(block_specs(hier), blocks):
        scaled = blk * _scalar((2.0 ** (s * l)) * math.sqrt(hier.ndof())
                               / (2.0 * float(tol)), blk)
        for d, w in enumerate(_block_inv_quantum_volume(hier, l, pos)):
            scaled = scaled * along_axis(w, blk, d)
        out.append(scaled)
    return out


def quantize_blocks(hier: Hierarchy, blocks, s: float, tol: float,
                    int_dtype=torch.int32):
    """:func:`scale_blocks` rounded to ``int_dtype``
    (``quantize.py:177``)."""
    return [round_quantize(b, int_dtype)
            for b in scale_blocks(hier, blocks, s, tol)]


def dequantize_blocks(hier: Hierarchy, qblocks, s: float, tol: float,
                      dtype):
    """Inverse of :func:`quantize_blocks`, in ``dtype``
    (``quantize.py:204``)."""
    if math.isinf(s):
        return dequantize_pyramid(hier, qblocks, s, tol, dtype)
    tdt = TORCH_DTYPE[np.dtype(dtype)]
    out = []
    for (l, _, _, pos), blk in zip(block_specs(hier), qblocks):
        c = blk.to(tdt)
        c = c * _scalar((2.0 * float(tol))
                        / ((2.0 ** (s * l)) * math.sqrt(hier.ndof())), c)
        for d, w in enumerate(_block_inv_quantum_volume(hier, l, pos)):
            c = c / along_axis(w, c, d)
        out.append(c)
    return out

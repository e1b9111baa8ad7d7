"""L-infinity quantization (the port of the s = inf half of
``mgard_tpu/ops/quantize.py``).

The quantum is ``2*tol / ((L+1) * (1 + 3^d))`` with ``d`` the number of
non-flat dims.  For the segmented codec it is computed on the host in
float32 exactly as the JAX package computes it when it traces
``Compressor._encode_impl`` with a float32 tolerance: ``2*tol`` in
float32, times the float32 reciprocal of the denominator (XLA folds the
division by that constant into this multiplication), and ``inv_q = 1 /
q`` in float32.  So the port quantizes with the very same float32
``inv_q`` and dequantizes with the same ``q``.

The flat stream (``scale_pyramid``/``dequantize_pyramid``: the PYRAMID
layout and every non-segmented codec) follows the JAX package's other
rounding, ``blk * (1 / q.astype(dtype))``, in the setting where its
tolerance is traced as float64 (``jax_enable_x64``, which float64 data
needs and the JAX tests turn on): ``q`` is formed in float64 (``2*tol``
times the float64 reciprocal of the denominator, the same folding), cast
to the data's dtype, and only then inverted in that dtype; dequantizing
multiplies by the cast ``q``.  The two roundings can differ by an ulp of
the quantum, far inside the bound's slack.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..hierarchy import Hierarchy

__all__ = ["supremum_quantum", "inverse_quantum", "round_quantize",
           "flat_quantum", "scale_pyramid", "dequantize_pyramid",
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


def _finite_s_raises(s: float) -> None:
    if not math.isinf(s):
        raise NotImplementedError(
            "s-norm error control (finite s) is not ported to "
            "mgard_tpu_torch yet (ROADMAP queue A, item 3)")


def scale_pyramid(hier: Hierarchy, pyramid, s: float, tol: float):
    """Each pyramid level times the inverse quantum, not rounded
    (``quantize.py:82``, s = inf)."""
    _finite_s_raises(s)
    _, inv = flat_quantum(hier, tol, _NUMPY_DTYPE[pyramid[0].dtype])
    return [blk * torch.tensor(inv, device=blk.device) for blk in pyramid]


def dequantize_pyramid(hier: Hierarchy, qpyramid, s: float, tol: float,
                       dtype):
    """Integer pyramid levels times the quantum, in ``dtype``
    (``quantize.py:135``, s = inf)."""
    _finite_s_raises(s)
    q, _ = flat_quantum(hier, tol, dtype)
    tdt = TORCH_DTYPE[np.dtype(dtype)]
    return [blk.to(tdt) * torch.tensor(q, device=blk.device)
            for blk in qpyramid]


def round_quantize(scaled: torch.Tensor, int_dtype=torch.int32
                   ) -> torch.Tensor:
    """Round half away from zero, then cast to ``int_dtype``: int32, or
    int64 for float64 data (``quantize.py:103``)."""
    t = torch.trunc(0.5 + scaled.abs())
    return torch.where(scaled < 0, -t, t).to(int_dtype)

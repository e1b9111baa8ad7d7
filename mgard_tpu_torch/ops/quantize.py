"""L-infinity quantization (the port of the s = inf half of
``mgard_tpu/ops/quantize.py``).

The quantum is ``2*tol / ((L+1) * (1 + 3^d))`` with ``d`` the number of
non-flat dims.  It is computed on the host in float32 exactly as the JAX
package computes it when it traces ``Compressor._encode_impl`` with its
default float32 tolerance: ``2*tol`` in float32, times the float32
reciprocal of the denominator (XLA folds the division by that constant
into this multiplication), and ``inv_q = 1 / q`` in float32.  So the port
quantizes with the very same float32 ``inv_q`` and dequantizes with the
same ``q``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hierarchy import Hierarchy

__all__ = ["supremum_quantum", "inverse_quantum", "round_quantize"]


def supremum_quantum(hier: Hierarchy, tol: float) -> np.float32:
    """The uniform L-infinity quantum, as a float32."""
    d = hier.effective_ndim
    denom = np.float32((hier.L + 1) * (1 + 3.0 ** d))
    return np.float32(np.float32(2.0) * np.float32(tol)) \
        * (np.float32(1.0) / denom)


def inverse_quantum(hier: Hierarchy, tol: float) -> np.float32:
    """``1 / supremum_quantum`` in float32 (compressor.py:309-311)."""
    return np.float32(1.0) / supremum_quantum(hier, tol)


def round_quantize(scaled: torch.Tensor, int_dtype=torch.int32
                   ) -> torch.Tensor:
    """Round half away from zero, then cast (``quantize.py:103``)."""
    t = torch.trunc(0.5 + scaled.abs())
    return torch.where(scaled < 0, -t, t).to(int_dtype)

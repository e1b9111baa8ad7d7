"""Quantity-of-interest preservation (MGARD-QOI), the port of
``mgard_tpu/models/qoi.py`` (reference TensorQuantityOfInterest,
``include/TensorQuantityOfInterest.tpp:10-54``).

For a linear functional Q, its operator norm as a map (V, ||.||_s) -> R
bounds what a compression at s-norm tolerance ``tol / ||Q||_{-s}`` can
change Q by: ``|Q(u) - Q(u')| <= tol``.  The load vector is one
reverse-mode pass, ``torch.autograd.grad`` of Q at zero (exact for a
linear Q), in place of the reference's one evaluation a basis function.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..hierarchy import Hierarchy
from ..ops import norms
from ..ops.transform import _level_dims
from ..ops.tridiag import mass_solve, table_scope

__all__ = ["QuantityOfInterest", "compress_qoi"]


class QuantityOfInterest:
    """Operator-norm machinery for a linear functional Q(u).

    ``functional`` is a callable ``Q(u) -> scalar`` (linear in u, a
    float64 tensor of the hierarchy's shape on ``device``) or a weight
    array of that shape (``Q(u) = sum(w * u)``).  The component norms are
    computed on ``device`` (None: the card) in float64.
    """

    def __init__(self, hier: Hierarchy,
                 functional: Union[Callable, np.ndarray], device=None):
        from ..api import resolve_device
        dev = resolve_device(device)
        self.hier = hier
        if callable(functional):
            zero = torch.zeros(hier.shape, dtype=torch.float64, device=dev,
                               requires_grad=True)
            (f,) = torch.autograd.grad(
                torch.as_tensor(functional(zero), dtype=torch.float64),
                zero)
        else:
            f = torch.as_tensor(np.asarray(functional), dtype=torch.float64
                                ).to(dev)
            if tuple(f.shape) != hier.shape:
                raise ValueError("weight array shape mismatch")
        with torch.no_grad(), table_scope():
            # the Riesz representative r solves M r = f on the finest level
            r = f
            for d in _level_dims(hier, hier.L):
                lev = hier.dims[d][hier.L]
                r = mass_solve(r, lev.offdiag, lev.divisors, d)
            comps = norms.orthogonal_component_square_norms(hier, r)
        self.component_square_norms = [float(c) for c in comps]

    def norm(self, s: float) -> float:
        """Norm of Q as an operator on (V, ||.||_s)
        (TensorQuantityOfInterest.tpp:47-54)."""
        return math.sqrt(sum(
            2.0 ** (2 * -s * l) * c
            for l, c in enumerate(self.component_square_norms)))


def compress_qoi(data, qoi: QuantityOfInterest, tolerance: float,
                 s: float = 0.0, config: Optional[Config] = None,
                 device=None) -> bytes:
    """Compress so that |Q(u) - Q(decompressed)| <= tolerance."""
    from ..api import compress
    tau = tolerance / qoi.norm(s)
    return compress(data, tau, s=s, config=config, device=device)

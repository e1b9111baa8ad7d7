"""Norms of functions on a mesh hierarchy (the port of
``mgard_tpu/ops/norms.py``; reference TensorNorms,
include/TensorNorms.tpp:17-135).

* L-infinity: max |u|.
* L2: sqrt(u' M u), with M the finest level's tensor mass matrix.
* s-norm: sqrt(sum_l 2^(2sl) ||P_l u - P_{l-1} u||_L2^2), through the
  orthogonal components: f = M u is restricted down the hierarchy, and
  the squared norm of the projection onto level l is (M_l^-1 f_l) . f_l.

These are the norms that the s-norm error control bounds
(``||u - out||_s <= tol``).  No compress path calls them; they check
that bound, in the tests and on the card.  Plain PyTorch on dense
pyramid levels, as the JAX package's are XLA.
"""

from __future__ import annotations

import math

import torch

from ..hierarchy import Hierarchy
from .transform import _level_dims, restrict
from .tridiag import mass_apply, mass_solve

__all__ = ["norm", "l2_norm", "linf_norm", "s_norm",
           "orthogonal_component_square_norms"]


def _mass_all(hier: Hierarchy, v: torch.Tensor, l: int) -> torch.Tensor:
    for d in _level_dims(hier, l):
        v = mass_apply(v, hier.dims[d][l].h, d)
    return v


def _solve_all(hier: Hierarchy, v: torch.Tensor, l: int) -> torch.Tensor:
    for d in _level_dims(hier, l):
        lev = hier.dims[d][l]
        v = mass_solve(v, lev.offdiag, lev.divisors, d)
    return v


def _restrict_all(hier: Hierarchy, v: torch.Tensor, l: int
                  ) -> torch.Tensor:
    for d in _level_dims(hier, l):
        v = restrict(v, hier.dims[d][l], d)
    return v


def linf_norm(u: torch.Tensor) -> torch.Tensor:
    return u.abs().max()


def l2_norm(hier: Hierarchy, u: torch.Tensor) -> torch.Tensor:
    f = _mass_all(hier, u, hier.L)
    return torch.sqrt(torch.sum(u * f))


def orthogonal_component_square_norms(hier: Hierarchy, u: torch.Tensor):
    """Squared L2 norms of the orthogonal components, coarsest first
    (reference TensorNorms.tpp:45-97), as 0-d tensors."""
    f = _mass_all(hier, u, hier.L)
    sq = [None] * (hier.L + 1)
    sq[hier.L] = torch.sum(u * f)
    for l in range(hier.L - 1, -1, -1):
        f = _restrict_all(hier, f, l + 1)
        proj = _solve_all(hier, f, l)
        sq[l] = torch.sum(proj * f)
    comps = [sq[0]]
    for l in range(1, hier.L + 1):
        comps.append(torch.clamp(sq[l] - sq[l - 1], min=0.0))
    return comps


def s_norm(hier: Hierarchy, u: torch.Tensor, s: float) -> torch.Tensor:
    comps = orthogonal_component_square_norms(hier, u)
    total = u.new_zeros(())
    for l, c in enumerate(comps):
        total = total + (2.0 ** (2.0 * s * l)) * c
    return torch.sqrt(total)


def norm(hier: Hierarchy, u: torch.Tensor, s: float) -> torch.Tensor:
    """The s-norm of ``u`` (shape ``hier.shape``), by ``s``: L-infinity
    for inf, L2 for 0 (reference TensorNorms.tpp:125-135)."""
    if math.isinf(s):
        return linf_norm(u)
    if s == 0:
        return l2_norm(hier, u)
    return s_norm(hier, u, s)

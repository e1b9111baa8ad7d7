"""Multilevel decomposition on unstructured simplicial meshes (the port of
``mgard_tpu/unstructured/hierarchy.py``).

The transform per level ``l`` (fine to coarse), with values ``u`` on the
level-``l`` nodes:

    detail   = u_new - 0.5 (u[ea] + u[eb])      # subtract interpolant
    b        = R_{l-1} M_l (0 (+) detail)       # mass apply + restriction
    corr     = M_{l-1}^{-1} b                   # PCG, diagonal precond
    u_old   += corr                             # L2 projection to l-1

Every operator runs on the meshes' device.  The mass products and the
restriction sum in a fixed order (``mesh.IncidenceTable``), and the
solve is the conjugate-gradient loop of ``jax.scipy.sparse.linalg.cg``
with the same iterates (:func:`cg_solve`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .mesh import IncidenceTable, MeshLevel, refine_uniform

__all__ = ["UniformMeshHierarchy", "cg_solve"]

# CG iterations run in blocks of this many between two reads of the stop
# test on the host.
CG_BLOCK = 8


def cg_solve(mesh: MeshLevel, b: torch.Tensor, tol: float = 1e-9,
             maxiter: int = 400) -> Tuple[torch.Tensor, int]:
    """Solve M x = b with diagonally-preconditioned CG (reference
    pcg::pcg with MassMatrixPreconditioner, src/unstructured/pcg.cpp):
    ``jax.scipy.sparse.linalg.cg``'s loop (``_cg_solve``) with x0 = 0,
    the stop test ``<r, r> <= tol^2 <b, b>`` or ``k = maxiter`` before
    each step, and gamma = <r, M^{-1} r>.  Returns x and the iterations.

    The test depends on the data, and reading it each step would stall
    the device once a step; so the steps run in blocks of
    :data:`CG_BLOCK`, each step applied only where the test still held
    (a mask on the device freezes x, r, p and gamma once it fails), with
    one read of the test a block.  The iterates are those of JAX's
    ``while_loop``."""
    dinv = (1.0 / mesh.mass_diagonal()).to(b.dtype)
    A = mesh.mass_matvec
    atol2 = torch.clamp_min(tol * tol * torch.dot(b, b), 0.0)
    x = torch.zeros_like(b)
    r = b.clone()
    p = z = dinv * r
    gamma = torch.dot(r, z)
    k = torch.zeros((), dtype=torch.int64, device=b.device)

    def running():
        return (torch.dot(r, r) > atol2) & (k < maxiter)

    while bool(running()):
        for _ in range(CG_BLOCK):
            live = running()
            Ap = A(p)
            alpha = gamma / torch.dot(p, Ap)
            r_ = r - alpha * Ap
            z_ = dinv * r_
            gamma_ = torch.dot(r_, z_)
            p_ = z_ + (gamma_ / gamma) * p
            x = torch.where(live, x + alpha * p, x)
            r = torch.where(live, r_, r)
            p = torch.where(live, p_, p)
            gamma = torch.where(live, gamma_, gamma)
            k = k + live
    return x, int(k)


class UniformMeshHierarchy:
    """Hierarchy built by ``L`` uniform refinements of a root mesh, on the
    root's device.

    Meshes are ordered coarsest (level 0) to finest (level L), and a
    nodal dataset on the finest mesh is ordered new_nodes(0),
    new_nodes(1), ... -- the reference's ordering contract
    (include/unstructured/MeshHierarchy.hpp:24-48).  ``cg_iterations``
    maps each level to the iterations of the latest solve on it.
    """

    def __init__(self, root: MeshLevel, L: int):
        if L < 1:
            raise ValueError("L must be >= 1")
        meshes = [root]
        for _ in range(L):
            meshes.append(refine_uniform(meshes[-1]))
        self.meshes: List[MeshLevel] = meshes
        self.L = L
        self.device = root.device
        self.cg_iterations: Dict[int, int] = {}
        self._restrictions: Dict[int, IncidenceTable] = {}

    def ndof(self, l: int = -1) -> int:
        return self.meshes[l].ndof

    def ndof_new(self, l: int) -> int:
        return self.ndof(l) - (self.ndof(l - 1) if l else 0)

    def _as_tensor(self, u) -> torch.Tensor:
        u = torch.as_tensor(u, device=self.device)
        if tuple(u.shape) != (self.ndof(),):
            raise ValueError(f"expected ({self.ndof()},), got "
                             f"{tuple(u.shape)}")
        return u

    def _solve(self, l: int, b: torch.Tensor) -> torch.Tensor:
        x, self.cg_iterations[l] = cg_solve(self.meshes[l], b)
        return x

    # ------------------------------------------------------------------
    # transform
    # ------------------------------------------------------------------
    def _interpolant_on_new(self, u_old: torch.Tensor, l: int
                            ) -> torch.Tensor:
        ep = self.meshes[l].edge_parents
        return 0.5 * (u_old[ep[:, 0]] + u_old[ep[:, 1]])

    def _restrict(self, F: torch.Tensor, l: int) -> torch.Tensor:
        """Adjoint of midpoint interpolation, level l -> l-1 (reference
        UniformRestriction::do_operator_parentheses): each old node gets
        half of every new node it is a parent of, first as the edges'
        first ends, then as their second, as the JAX package's two
        scatter-adds add them."""
        n = self.ndof(l - 1)
        if l not in self._restrictions:
            ep = self.meshes[l].edge_parents
            self._restrictions[l] = IncidenceTable(
                torch.cat([ep[:, 0], ep[:, 1]]), n)
        half_new = 0.5 * F[n:]
        return self._restrictions[l].sum(torch.cat([half_new, half_new]),
                                         init=F[:n])

    def _correction(self, detail: torch.Tensor, l: int) -> torch.Tensor:
        """M_{l-1}^{-1} R (M_l (0 (+) detail)) (reference
        do_calculate_correction_from_multilevel_component,
        src/unstructured/MeshHierarchy.cpp:385-417)."""
        n = self.ndof(l - 1)
        full = torch.cat([detail.new_zeros(n), detail])
        b = self._restrict(self.meshes[l].mass_matvec(full), l)
        return self._solve(l - 1, b)

    def decompose(self, u) -> torch.Tensor:
        """Nodal values on the finest mesh -> multilevel coefficients
        (level-ordered: level-0 projection, then per-level details)."""
        out = self._as_tensor(u)
        for l in range(self.L, 0, -1):
            n, m = self.ndof(l - 1), self.ndof(l)
            u_old, u_new = out[:n], out[n:m]
            detail = u_new - self._interpolant_on_new(u_old, l)
            u_old = u_old + self._correction(detail, l)
            out = torch.cat([u_old, detail, out[m:]])
        return out

    def recompose(self, u) -> torch.Tensor:
        """Exact inverse of :meth:`decompose` (up to CG tolerance)."""
        out = self._as_tensor(u)
        for l in range(1, self.L + 1):
            n, m = self.ndof(l - 1), self.ndof(l)
            u_old, detail = out[:n], out[n:m]
            u_old = u_old - self._correction(detail, l)
            u_new = detail + self._interpolant_on_new(u_old, l)
            out = torch.cat([u_old, u_new, out[m:]])
        return out

    # ------------------------------------------------------------------
    # norms & estimators (reference norms.cpp / estimators.cpp)
    # ------------------------------------------------------------------
    def norm(self, u, s: float = math.inf) -> float:
        """L-inf (s = inf), L2 (s = 0) or s-norm of nodal values ``u``
        on the finest mesh (reference src/unstructured/norms.cpp)."""
        u = torch.as_tensor(u, device=self.device)
        if math.isinf(s):
            return float(u.abs().max())
        if s == 0:
            fine = self.meshes[-1]
            return math.sqrt(float(torch.dot(u, fine.mass_matvec(u))))
        # s-norm: sum over levels of 2^{2sl} ||P_l u - P_{l-1} u||_L2^2,
        # with P_l the L2 projection onto level l.
        proj = [None] * (self.L + 1)
        proj[self.L] = u
        for l in range(self.L, 0, -1):
            b = self._restrict(self.meshes[l].mass_matvec(proj[l]), l)
            proj[l - 1] = self._solve(l - 1, b)
        total = 0.0
        for l in range(self.L + 1):
            p = proj[l]
            if l == 0:
                sq = float(torch.dot(p, self.meshes[0].mass_matvec(p)))
            else:
                up = torch.cat([proj[l - 1],
                                self._interpolant_on_new(proj[l - 1], l)])
                diff = p - up
                sq = float(torch.dot(diff,
                                     self.meshes[l].mass_matvec(diff)))
            total += 2.0 ** (2 * s * l) * sq
        return math.sqrt(total)

    def estimator(self, coeffs, s: float) -> float:
        """Computable upper-bound functional on the s-norm from
        multilevel coefficients (reference estimators.cpp:28-75):
        sqrt(sum_l 2^{2sl} <mc_l, M_l|_new mc_l>), with the reliability
        constant folded in by the caller/quantizer."""
        if math.isinf(s):
            raise ValueError("pointwise estimator not implemented "
                             "(reference estimators.cpp:70-73)")
        coeffs = torch.as_tensor(coeffs, device=self.device)
        total = 0.0
        for l in range(self.L + 1):
            lo = self.ndof(l - 1) if l else 0
            hi = self.ndof(l)
            mesh = self.meshes[l]
            full = coeffs.new_zeros(mesh.ndof)
            full[lo:hi] = coeffs[lo:hi]
            b = mesh.mass_matvec(full)
            sq = float(torch.dot(coeffs[lo:hi], b[lo:hi]))
            total += 2.0 ** (2 * s * l) * sq
        return math.sqrt(total)

    def estimator_bounds(self, s: float = 0.0):
        """(realism, reliability) constants relating estimator and norm
        (reference s_square_estimator_bounds, estimators.cpp:17-26)."""
        d = self.meshes[0].dim
        realism = 0.1 if d == 2 else 1.0 / 24
        return realism, 1.0

    def indicator_bounds(self):
        """(realism, reliability) for the square indicator
        (reference s_square_indicator_bounds, indicators.cpp:7-10)."""
        d = self.meshes[0].dim
        return 1.0 / ((d + 1) * (d + 2)), 1.0 / (d + 1)

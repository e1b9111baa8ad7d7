"""Simplicial meshes: levels, uniform refinement, P1 mass operators (the
port of ``mgard_tpu/unstructured/mesh.py``).

A mesh level is a pair of tensors on one device -- node coordinates
(float64) and element connectivity (int64) -- and every operator is a
gather followed by a sum over the elements that hold each node.

The sums run in a fixed order: each level builds once a node->incidence
table (:class:`IncidenceTable`: a stable sort of the incidences by node,
padded to the level's largest valence) and adds each node's terms one
after the other in the order of their incidences, as the JAX package's
``segment_sum`` and numpy's ``add.at`` do on the CPU.  A scatter-add
(``index_add_``) would add them in whatever order its atomics land on a
GPU, and the last bits would change from run to run.

Node-ordering invariant (reference MeshHierarchy.hpp:24-48): nodes of the
coarse mesh keep their indices under refinement; new (edge-midpoint)
nodes are appended after them, in lexicographic edge order.  So on level
``l`` the first ``ndof(l-1)`` values belong to the coarse mesh ("old"
nodes) and the rest are "new".
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["MeshLevel", "IncidenceTable", "refine_uniform",
           "structured_triangle_mesh", "structured_tet_mesh", "load_msh"]


def _device(device) -> torch.device:
    from ..api import resolve_device
    return resolve_device(device)


class IncidenceTable:
    """Sums of values over the incidences of each of ``n`` targets, in a
    fixed order.  ``index`` (M,) names the target of each incidence; the
    table (width, n) lists each target's incidences in increasing order,
    padded with M (a zero appended to the values), where ``width`` is the
    largest count of incidences a target has."""

    def __init__(self, index: torch.Tensor, n: int):
        m = index.numel()
        if m and bool(index.min() < 0):
            raise ValueError("node indices must be non-negative")
        order = torch.sort(index, stable=True).indices
        target = index[order]
        counts = torch.bincount(index, minlength=n)
        self.width = int(counts.max()) if m else 0
        col = torch.arange(m, device=index.device) \
            - (torch.cumsum(counts, 0) - counts)[target]
        table = torch.full((self.width, n), m, dtype=torch.int64,
                           device=index.device)
        table[col, target] = order
        self.table, self.n = table, n

    def sum(self, values: torch.Tensor, init: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
        """``init`` (or zeros) plus each target's values, added one after
        the other in incidence order."""
        ext = torch.cat([values, values.new_zeros(1)])
        acc = values.new_zeros(self.n) if init is None else init
        for row in self.table:
            acc = acc + ext[row]
        return acc


class MeshLevel:
    """One simplicial mesh: triangles (d=2) or tetrahedra (d=3), on
    ``device`` (None: the card).

    ``nodes``: (N, ambient_dim) float64.  ``elements``: (E, d+1) int64.
    ``edge_parents``: for refined meshes, the (n_new, 2) endpoint indices
    of the bisected edge that produced each new node (new node ``k`` has
    index ``n_old + k``); ``None`` for a root mesh.
    """

    def __init__(self, nodes, elements, edge_parents=None, device=None):
        dev = _device(device)
        self.nodes = torch.as_tensor(nodes, dtype=torch.float64, device=dev)
        self.elements = torch.as_tensor(elements, dtype=torch.int64,
                                        device=dev)
        if self.elements.ndim != 2 or self.elements.shape[1] not in (3, 4):
            raise ValueError("elements must be (E, 3) or (E, 4)")
        self.edge_parents = None if edge_parents is None else \
            torch.as_tensor(edge_parents, dtype=torch.int64, device=dev)
        self.device = dev
        self.measures = _measures(self.nodes, self.elements)
        self._table = None

    @property
    def ndof(self) -> int:
        return self.nodes.shape[0]

    @property
    def dim(self) -> int:
        """Topological dimension (2 = triangles, 3 = tetrahedra)."""
        return self.elements.shape[1] - 1

    def incidence(self) -> IncidenceTable:
        """The node->incidence table of ``elements.reshape(-1)``, built at
        first use."""
        if self._table is None:
            self._table = IncidenceTable(self.elements.reshape(-1),
                                         self.ndof)
        return self._table

    def _per_incidence(self, per_element: torch.Tensor) -> torch.Tensor:
        """Each element's value repeated for its d+1 nodes (np.repeat)."""
        return per_element[:, None].expand(-1, self.dim + 1).reshape(-1)

    # -- P1 finite-element operators ------------------------------------
    # Local mass matrix of a d-simplex with measure |T| is
    #   M_ij = |T| / ((d+1)(d+2)) * (1 + delta_ij)
    # (reference SubsetMassMatrix::do_operator_parentheses,
    # src/unstructured/MassMatrix.cpp:52-60).

    def mass_matvec(self, u: torch.Tensor) -> torch.Tensor:
        """b = M u via a per-element gather and the node sums (no
        assembly)."""
        d = self.dim
        c = (self.measures / ((d + 1) * (d + 2))).to(u.dtype)
        ue = u[self.elements]                           # (E, d+1)
        esum = ue[:, 0]
        for j in range(1, d + 1):
            esum = esum + ue[:, j]
        contrib = c[:, None] * (ue + esum[:, None])     # (E, d+1)
        del ue
        return self.incidence().sum(contrib.reshape(-1))

    def mass_diagonal(self) -> torch.Tensor:
        """diag(M) -- the reference's MassMatrixPreconditioner input."""
        d = self.dim
        c = self.measures / ((d + 1) * (d + 2))
        return self.incidence().sum(self._per_incidence(2.0 * c))

    def containing_elements_measure(self) -> torch.Tensor:
        """Per node, total measure of elements containing it (reference
        MeshLevel::containing_elements_measure, used by the s-norm
        indicator factor, src/unstructured/indicators.cpp:12-15)."""
        return self.incidence().sum(self._per_incidence(self.measures))


def _measures(nodes: torch.Tensor, elements: torch.Tensor) -> torch.Tensor:
    """Element measures: an explicit 2x2 or 3x3 determinant, or for
    triangles in 3-D half the length of a cross product."""
    corners = nodes[elements]                       # (E, d+1, a)
    vecs = corners[:, 1:, :] - corners[:, :1, :]    # (E, d, a)
    del corners
    d = elements.shape[1] - 1
    if d == 2:
        if nodes.shape[1] == 2:
            cross = (vecs[:, 0, 0] * vecs[:, 1, 1]
                     - vecs[:, 0, 1] * vecs[:, 1, 0])
            return cross.abs() / 2.0
        cross = torch.linalg.cross(vecs[:, 0, :], vecs[:, 1, :])
        return torch.sqrt((cross * cross).sum(-1)) / 2.0
    v = [[vecs[:, i, j] for j in range(3)] for i in range(3)]
    det = (v[0][0] * (v[1][1] * v[2][2] - v[1][2] * v[2][1])
           - v[0][1] * (v[1][0] * v[2][2] - v[1][2] * v[2][0])
           + v[0][2] * (v[1][0] * v[2][1] - v[1][1] * v[2][0]))
    return det.abs() / 6.0


def _edge_pairs(d: int):
    return [(i, j) for i in range(d + 1) for j in range(i + 1, d + 1)]


def refine_uniform(mesh: MeshLevel) -> MeshLevel:
    """Uniform refinement: bisect every edge; quadrisect triangles /
    octasect tetrahedra (reference UniformMeshRefiner,
    src/unstructured/UniformMeshRefiner.cpp:50-80), on the mesh's device.

    The edges of all elements, pair by pair as ``_unique_edges`` lists
    them, go through ``torch.unique`` as keys ``a * N + b`` (a < b): its
    sorted order is the lexicographic edge order, and its inverse names
    each element's midpoints.  New nodes are the edge midpoints, appended
    after the old nodes in that order, so coarse indices are preserved;
    the children are gathered in the JAX package's loop order.
    """
    d = mesh.dim
    if d not in (2, 3):
        raise ValueError("only triangles and tetrahedra are supported")
    els = mesh.elements
    if els.shape[0] == 0:
        # the JAX package's refined table of no rows has shape (0,)
        raise ValueError("elements must be (E, 3) or (E, 4)")
    n_old, n_el = mesh.ndof, els.shape[0]
    pairs = _edge_pairs(d)
    a = torch.cat([els[:, i] for i, _ in pairs])
    b = torch.cat([els[:, j] for _, j in pairs])
    keys = torch.minimum(a, b) * n_old + torch.maximum(a, b)
    del a, b
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    del keys
    edges = torch.stack([uniq // n_old, uniq % n_old], 1)
    del uniq
    nodes = mesh.nodes
    midpoints = 0.5 * (nodes[edges[:, 0]] + nodes[edges[:, 1]])
    mids = (n_old + inverse).reshape(len(pairs), n_el)
    del inverse
    if d == 2:
        x, y, z = els.unbind(1)
        ab, ca, bc = mids.unbind(0)
        children = [(x, ab, ca), (ab, y, bc), (ca, bc, z), (ab, bc, ca)]
    else:
        x, y, z, w = els.unbind(1)
        ab, ac, ad, bc, bd, cd = mids.unbind(0)
        # 4 corner tets + central octahedron split along the ac-bd
        # diagonal (Bey's red refinement)
        children = [(x, ab, ac, ad), (ab, y, bc, bd),
                    (ac, bc, z, cd), (ad, bd, cd, w),
                    (ab, ac, ad, bd), (ab, ac, bc, bd),
                    (ac, ad, bd, cd), (ac, bc, bd, cd)]
    new_elements = torch.stack([torch.stack(c, 1) for c in children], 1
                               ).reshape(-1, d + 1)
    return MeshLevel(torch.cat([nodes, midpoints]), new_elements,
                     edge_parents=edges, device=mesh.device)


def _need_cells(n) -> None:
    """A structured grid with fewer than two nodes along an axis has no
    cell: the JAX package's builders refuse its empty element table."""
    if min(n) < 2:
        raise ValueError("elements must be (E, 3) or (E, 4)")


def structured_triangle_mesh(nx: int, ny: int, device=None) -> MeshLevel:
    """Convenience root mesh: an (nx x ny)-vertex unit square split into
    triangles (two per cell)."""
    _need_cells((nx, ny))
    dev = _device(device)
    xs, ys = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny),
                         indexing="ij")
    nodes = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1)
    i = torch.arange(nx - 1, device=dev)[:, None]
    j = torch.arange(ny - 1, device=dev)[None, :]
    a = (i * ny + j).reshape(-1)
    b, c, dd = a + ny, a + ny + 1, a + 1
    elements = torch.stack([torch.stack([a, b, c], 1),
                            torch.stack([a, c, dd], 1)], 1).reshape(-1, 3)
    return MeshLevel(nodes, elements, device=dev)


# The 6-tet (Kuhn) split of a cube's corners v0..v7 (bit order zyx).
_KUHN = ((0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7), (0, 2, 6, 7),
         (0, 4, 5, 7), (0, 4, 6, 7))


def structured_tet_mesh(n: Tuple[int, int, int], device=None) -> MeshLevel:
    """Unit-cube root mesh: each hex cell split into 6 tetrahedra."""
    nx, ny, nz = n
    _need_cells(n)
    dev = _device(device)
    ax = [np.linspace(0, 1, k) for k in (nx, ny, nz)]
    xs, ys, zs = np.meshgrid(*ax, indexing="ij")
    nodes = np.stack([xs.reshape(-1), ys.reshape(-1), zs.reshape(-1)],
                     axis=1)
    i = torch.arange(nx - 1, device=dev)[:, None, None]
    j = torch.arange(ny - 1, device=dev)[None, :, None]
    k = torch.arange(nz - 1, device=dev)[None, None, :]
    base = ((i * ny + j) * nz + k).reshape(-1)
    corner = torch.tensor([(di * ny + dj) * nz + dk for di in (0, 1)
                           for dj in (0, 1) for dk in (0, 1)], device=dev)
    offsets = corner[torch.tensor(_KUHN, device=dev)]          # (6, 4)
    elements = (base[:, None, None] + offsets).reshape(-1, 4)
    return MeshLevel(nodes, elements, device=dev)


def load_msh(path, device=None) -> MeshLevel:
    """Load a Gmsh 2.2 ASCII ``.msh`` file as a :class:`MeshLevel` on
    ``device`` (the file is read on the host).

    Reads the $Nodes and $Elements sections; keeps the highest-dimension
    simplices present (type 4 tetrahedra, else type 2 triangles) and
    drops lower-dimensional boundary elements, renumbering nodes
    densely.
    """
    nodes = {}
    tris = []
    tets = []
    with open(path) as f:
        lines = iter(f.read().splitlines())
    for line in lines:
        tok = line.strip()
        if tok == "$Nodes":
            count = int(next(lines))
            for _ in range(count):
                parts = next(lines).split()
                nodes[int(parts[0])] = [float(x) for x in parts[1:4]]
        elif tok == "$Elements":
            count = int(next(lines))
            for _ in range(count):
                parts = next(lines).split()
                etype = int(parts[1])
                ntags = int(parts[2])
                conn = [int(x) for x in parts[3 + ntags:]]
                if etype == 2:
                    tris.append(conn)
                elif etype == 4:
                    tets.append(conn)
    elements = tets if tets else tris
    if not elements:
        raise ValueError(f"{path}: no triangles or tetrahedra found")
    used = sorted({i for el in elements for i in el})
    renum = {i: k for k, i in enumerate(used)}
    coords = np.asarray([nodes[i] for i in used], dtype=np.float64)
    conn = np.asarray([[renum[i] for i in el] for el in elements],
                      dtype=np.int64)
    return MeshLevel(coords, conn, device=device)

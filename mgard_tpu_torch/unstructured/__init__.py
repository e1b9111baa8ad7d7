"""Unstructured (simplicial) mesh compression: the port of
``mgard_tpu/unstructured/``, counterpart of the reference's experimental
MOAB-backed stack (include/unstructured/, src/unstructured/ in
CODARcode/MGARD)."""

from .mesh import (MeshLevel, refine_uniform, structured_triangle_mesh,
                   structured_tet_mesh)
from .hierarchy import UniformMeshHierarchy
from .compress import compress, decompress

__all__ = [
    "MeshLevel", "refine_uniform", "structured_triangle_mesh",
    "structured_tet_mesh", "UniformMeshHierarchy", "compress",
    "decompress",
]

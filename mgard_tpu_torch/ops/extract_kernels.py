"""K1: one-pass coarse extraction of a dense 3-D float32 level array.

Replaces ``mgard_tpu/ops/extract_kernels.py:75`` (``extract_coarse_3d``).
The coarse nodes of a level are "evens of the even prefix, plus the
last node" in every dim, for the stride-2 and the front-interleaved
nondyadic levels alike.  The kernel (``csrc/extract.cu``) is a gather
with one thread per output element: bit-identical by construction, and
bound by bytes (the selected source planes read once, the output
written once).
"""

from __future__ import annotations

import numpy as np
import torch

from ..hierarchy import Hierarchy
from . import _build

__all__ = ["extract_supported", "extract_coarse_3d",
           "extract_coarse_3d_plain"]


def _evens_plus_last(pos, n: int) -> bool:
    want = np.append(np.arange(0, n - 1, 2), n - 1)
    return pos is not None and len(pos) == len(want) \
        and np.array_equal(np.asarray(pos), want)


def extract_supported(hier: Hierarchy, l: int, A: torch.Tensor) -> bool:
    """The JAX package's gate (``extract_kernels.py:44``) with its
    backend test replaced by "the tensor is on CUDA": 3 non-flat dims,
    every dim's coarse set in the evens-plus-last pattern, n2 >= 128 and
    n0 >= 8."""
    if not A.is_cuda or A.dtype != torch.float32:
        return False
    dims = [d for d in range(hier.ndim) if hier.shape[d] > 1]
    if hier.ndim != 3 or dims != [0, 1, 2]:
        return False
    for d in range(3):
        lev = hier.dims[d][l]
        if not _evens_plus_last(lev.coarse_pos, lev.n):
            return False
    return hier.dims[2][l].n >= 128 and hier.dims[0][l].n >= 8


def _coarse_index(hier: Hierarchy, l: int, device) -> list:
    """Per-dim int32 coarse-position vectors on ``device`` (cached)."""
    cache = hier.__dict__.setdefault("_torch_coarse_idx", {})
    key = (l, str(device))
    if key not in cache:
        cache[key] = [torch.as_tensor(np.asarray(hier.dims[d][l].coarse_pos),
                                      dtype=torch.int32, device=device)
                      for d in range(3)]
    return cache[key]


def extract_coarse_3d_plain(A: torch.Tensor, idx) -> torch.Tensor:
    """Plain PyTorch version: three index_selects."""
    for d in range(3):
        A = A.index_select(d, idx[d].long())
    return A


@_build.counted
def extract_coarse_3d(hier: Hierarchy, A: torch.Tensor, l: int
                      ) -> torch.Tensor:
    """Coarse nodes of the dense level-``l`` array ``A`` (n0, n1, n2)."""
    idx = _coarse_index(hier, l, A.device)
    if A.device.type == "cpu":
        return extract_coarse_3d_plain(A, idx)
    device = _build.device_of("extract_coarse_3d", A, *idx)
    if A.dtype != torch.float32 or A.dim() != 3:
        raise ValueError("extract_coarse_3d takes a 3-D float32 tensor")
    A = A.contiguous()
    n0, n1, n2 = A.shape
    nc = [int(i.numel()) for i in idx]
    out = torch.empty(nc, dtype=torch.float32, device=A.device)
    _build.launch("mgard_extract_coarse_3d", A.data_ptr(), out.data_ptr(),
                  idx[0].data_ptr(), idx[1].data_ptr(), idx[2].data_ptr(),
                  n1, n2, nc[0], nc[1], nc[2], device=device)
    extract_coarse_3d.launches += 1
    return out


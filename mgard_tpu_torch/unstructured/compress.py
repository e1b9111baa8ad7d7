"""Error-bounded compression on unstructured meshes (the port of
``mgard_tpu/unstructured/compress.py``).

Counterpart of the reference's unstructured MultilevelCoefficientQuantizer
(include/unstructured/MultilevelCoefficientQuantizer.tpp:9-45) wired into
the per-group bitplane codec.  Per-node quantum on level ``l``:

    q(node) = 2 tol / sqrt(R_est * R_ind * 2^{2sl} * mu(node) * ndof)

where ``mu`` is the total measure of elements containing the node and
``R_est``/``R_ind`` are the reliability constants of the estimator and
indicator bounds (reference s_quantum).  Rounding matches the structured
quantizer: trunc(copysign(0.5 + |x/q|, x)).

The buffer is ``MGTU``, then ``<ddqII`` (s, tolerance, node count, the
exponent bytes' and the word bytes' lengths), the per-group exponents
with their trailing zeros dropped and the stream words; each package
decodes the other's.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from ..ops import bitplane
from .hierarchy import UniformMeshHierarchy

__all__ = ["compress", "decompress"]

_MAGIC = b"MGTU"
_HEAD = "<ddqII"


def _quanta(hier: UniformMeshHierarchy, s: float,
            tol: float) -> torch.Tensor:
    """Per-coefficient quantum vector over the level-ordered dof, float64
    on the hierarchy's device."""
    _, rel_est = hier.estimator_bounds(s)
    _, rel_ind = hier.indicator_bounds()
    N = hier.ndof()
    q = torch.zeros(N, dtype=torch.float64, device=hier.device)
    for l in range(hier.L + 1):
        lo = hier.ndof(l - 1) if l else 0
        hi = hier.ndof(l)
        mu = hier.meshes[l].containing_elements_measure()[lo:hi]
        factor = rel_est * rel_ind * float(np.exp2(2 * s * l)) * mu * N
        q[lo:hi] = 2.0 * tol / torch.sqrt(factor)
    return q


def compress(hier: UniformMeshHierarchy, u, s: float,
             tolerance: float) -> bytes:
    """Compress nodal values ``u`` on the finest mesh with an s-norm
    error bound, on the hierarchy's device.  The mesh itself is not
    stored (like the reference's in-memory API, the caller keeps the
    hierarchy)."""
    if math.isinf(s):
        raise ValueError("unstructured compression controls the s-norm; "
                         "pass a finite s (reference estimators.cpp:70)")
    u = torch.as_tensor(u, dtype=torch.float64, device=hier.device)
    coeffs = hier.decompose(u)
    scaled = coeffs / _quanta(hier, s, tolerance)
    del coeffs
    if int(float(scaled.abs().max())) >= 2 ** 31 - 1:
        raise OverflowError("tolerance too small for data range")
    ints = torch.trunc(torch.copysign(0.5 + scaled.abs(), scaled)
                       ).to(torch.int32)
    del scaled
    exps, words, count = bitplane.encode_pergroup(ints)
    exp_full = exps.cpu().numpy()
    nz = np.nonzero(exp_full)[0]
    exp_np = exp_full[:int(nz[-1]) + 1].tobytes() if len(nz) else b""
    word_np = np.ascontiguousarray(words[:int(count)].cpu().numpy(),
                                   "<i4").tobytes()
    head = _MAGIC + struct.pack(_HEAD, float(s), float(tolerance),
                                hier.ndof(), len(exp_np), len(word_np))
    return head + exp_np + word_np


def decompress(hier: UniformMeshHierarchy, buf: bytes) -> np.ndarray:
    """Decode an ``MGTU`` buffer on the hierarchy's device: nodal values on
    the finest mesh (float64 numpy)."""
    if buf[:4] != _MAGIC:
        raise ValueError("not an unstructured-mgard-tpu buffer")
    s, tol, n, n_exp, n_words = struct.unpack_from(_HEAD, buf, 4)
    off = 4 + struct.calcsize(_HEAD)
    if n != hier.ndof():
        raise ValueError("hierarchy/buffer dof mismatch")
    ngroups = bitplane.num_chunks(n) * bitplane.CHUNK_GROUPS
    if n_exp > ngroups or n_words % 4 or off + n_exp + n_words > len(buf):
        raise ValueError("corrupted buffer: stream sizes do not match the "
                         "header")
    exps = np.zeros(ngroups, dtype=np.uint8)
    exps[:n_exp] = np.frombuffer(buf, dtype=np.uint8, count=n_exp,
                                 offset=off)
    words = np.frombuffer(buf, dtype="<i4", count=n_words // 4,
                          offset=off + n_exp).astype(np.int32)
    dev = hier.device
    ints = bitplane.decode_pergroup(torch.from_numpy(exps).to(dev),
                                    torch.from_numpy(words).to(dev), n)
    coeffs = ints.to(torch.float64) * _quanta(hier, s, tol)
    return hier.recompose(coeffs).cpu().numpy()

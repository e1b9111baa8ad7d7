"""Carrying the JAX package's state into the port.

This system has no weights: its state is the multilevel pyramid and the
container.  A container written by ``mgard_tpu`` decodes with
:func:`mgard_tpu_torch.decompress` as it is (the two share the format).
A pyramid produced by ``mgard_tpu.ops.transform.decompose`` crosses as a
list of numpy arrays, one per level, coarsest first.

The models cross the same way.  ROI containers and host-lossless
containers (Huffman + zlib/zstd, NONE, and the zstd/LZ4 second stages)
are containers: they cross as bytes.  An MDR artifact crosses as
``MDRMetadata.pack()`` plus its stream bytes, which
``mgard_tpu_torch.models.mdr.MDRMetadata.unpack`` and an
``MDReconstructor`` read as they are.  A QoI weight array crosses as a
numpy array.

Reference MGARD state crosses as it is written: a buffer of the
reference ``mgard`` or ``mgard-x`` tools (or of either package's
``compress_mgard``/``compress_mgard_x``) decodes with
:func:`mgard_tpu_torch.decompress`, and an ``mdr-x`` directory with
``mgard_tpu_torch.io.mdrx_compat.mdrx_reconstruct``.  As in the JAX
package, the MGARD-X and MDR-X readers recompose in float64 on the
device and cast to the buffer's dtype, for float32 buffers too (so no
float32 kernel launches there); the CPU-format reader recomposes in the
buffer's dtype.  A native ZFP stream (``models/zfp.py``) and a
reference ZFP stream (``models/zfp_stream.py``) cross as bytes.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..hierarchy import Hierarchy

__all__ = ["pyramid_from_numpy"]


def pyramid_from_numpy(hier: Hierarchy, arrays: Sequence[np.ndarray],
                       device) -> List[torch.Tensor]:
    """Level arrays (shapes ``hier.shapes``) as float32 tensors on
    ``device``."""
    if len(arrays) != hier.L + 1:
        raise ValueError(f"expected {hier.L + 1} levels, got {len(arrays)}")
    out = []
    for l, a in enumerate(arrays):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(hier.shapes[l]):
            raise ValueError(f"level {l}: expected shape {hier.shapes[l]}, "
                             f"got {a.shape}")
        out.append(torch.from_numpy(np.array(a, dtype=np.float32)
                                    ).to(device))
    return out


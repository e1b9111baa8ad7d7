"""mgard_tpu_torch: the PyTorch/CUDA port of mgard_tpu.

An error-bounded lossy compressor for N-D float32 and float64 arrays
(MGARD's multilevel decomposition, L-infinity and s-norm error
control, bitplane codecs), running on an NVIDIA H100 with hand-written CUDA kernels for its hot
loops.  It writes and reads the same containers as the JAX package.

Importing the package loads no CUDA code: the kernels are built with
``nvcc`` and loaded at their first launch (``ops/_build.py``).
"""

import torch

# The JAX reference the port is held to computes in plain float32 off
# the TPU; keep every float32 matmul in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .api import (compress, decompress, estimate_memory_footprint,  # noqa: E402
                  release_cache)
from .config import (Config, Decomposition, ErrorMode, Layout,  # noqa: E402
                     Lossless)
from .hierarchy import Hierarchy  # noqa: E402
from .models.compressor import Compressor, get_compressor  # noqa: E402

__all__ = ["compress", "decompress", "release_cache",
           "estimate_memory_footprint", "Compressor", "get_compressor",
           "Hierarchy", "Config", "Decomposition", "ErrorMode", "Layout",
           "Lossless"]

__version__ = "0.1.0"

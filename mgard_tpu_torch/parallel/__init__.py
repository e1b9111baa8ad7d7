"""Domain decomposition (``parallel/domain.py``) and the sharded
compressor (``parallel/sharded.py``) of the port."""

from .domain import (DomainDecomposer, block_grid_blocks,  # noqa: F401
                     local_abs_tol)
from .sharded import ShardedCompressor  # noqa: F401

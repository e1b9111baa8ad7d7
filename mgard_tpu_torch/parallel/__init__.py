"""Domain decomposition of the port (``parallel/domain.py``)."""

from .domain import (DomainDecomposer, block_grid_blocks,  # noqa: F401
                     local_abs_tol)

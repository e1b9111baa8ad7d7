"""Where the port keeps its built libraries across processes.

The JAX package keeps its compiled executables in a persistent cache
directory (``mgard_tpu/utils/cache.py``).  The port's counterpart of a
compiled executable is its kernel library (every ``csrc/*.cu`` compiled
by ``nvcc`` and linked into one shared object) and the two host codecs
of ``native/`` (one ``g++`` each), built by ``ops/_build.py`` at first
use.  Each library's file name carries a hash of its sources, its
compiler and its flags, so a directory shared by several checkouts,
hosts or processes never hands one a library built otherwise, and a
process that finds its library there loads it without building.
Libraries of older sources stay until the directory is cleared.

The directory is, in this order: the argument of
:func:`enable_persistent_cache`, else ``MGARD_TPU_CACHE_DIR``, else the
package's ``_build/``.  The empty string disables the cache: the
process then builds into a temporary directory of its own, removed at
exit.  Without a call, the first build reads the setting; a call after
the libraries are loaded moves later builds only.
"""

from __future__ import annotations

from ..ops import _build

__all__ = ["DEFAULT_CACHE_DIR", "enable_persistent_cache"]

DEFAULT_CACHE_DIR = str(_build.DEFAULT_BUILD_DIR)


def enable_persistent_cache(path: str | None = None) -> str | None:
    """Point the port's library builds at ``path`` (default:
    ``MGARD_TPU_CACHE_DIR``, else the package's ``_build/``): see
    :func:`ops._build.set_build_dir`.  Returns the directory used, or
    None when the cache is disabled.  Idempotent."""
    return _build.set_build_dir(path)

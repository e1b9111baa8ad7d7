"""Debug / sanitizer mode (the port of ``mgard_tpu/utils/debug.py``).

The reference builds with ASAN/UBSAN in debug configurations
(CMakeLists.txt:344-345) and offers
``DeviceRuntime::SyncAllKernelsAndCheckErrors`` (DeviceAdapter.h:315).
The JAX package turns on ``jax_debug_nans``/``jax_debug_infs``.  The
port's counterpart: every kernel launch (``ops/_build.launch``) is
followed by a synchronize of its device, so that a kernel's fault raises
at once, naming the kernel, plus the host-side integrity checks of the
codec pipeline (encode word counts within capacity, decoded output
finite).  Off, it does nothing.

Enable with ``mgard_tpu_torch.utils.debug.enable()`` or the environment
variable ``MGARD_TPU_DEBUG=1``.
"""

from __future__ import annotations

import os

_enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def check(cond: bool, msg: str) -> None:
    """Debug-mode assertion (no-op unless enabled)."""
    if _enabled and not cond:
        raise AssertionError(f"mgard_tpu debug check failed: {msg}")


if os.environ.get("MGARD_TPU_DEBUG") == "1":
    enable()

"""Logging, spans and counters (the port of ``mgard_tpu/utils/log.py``;
counterpart of RuntimeX log/Timer,
include/mgard-x/RuntimeX/Utilities/{Log.h,Timer.hpp}): bitmask log
levels; named spans of host work (:class:`Timer`, opened through
:func:`span`); and counters of what the port copies (:func:`count`).

A span is seen two ways, and costs nothing where neither asks for it:

* while ``torch.profiler`` records, it is a ``record_function`` range:
  a ``user_annotation`` event in the same trace and on the same clock as
  the kernels it launches (the port keeps no timestamps of its own);
* while ``level & TIME`` (``Config(log_level=TIME)``), its host
  milliseconds are printed to standard error, with GB/s where it knows
  its bytes.

The encode and decode name their stages (``mgard.encode``,
``mgard.decompose``, ``mgard.level.<l>``, ``mgard.correction``,
``mgard.quantize`` on the flat route, ``mgard.bitplane`` around every
codec; ``mgard.decode``, ``mgard.dequantize`` on the flat route,
``mgard.recompose``).  Counters
are always on: ``tables.bytes`` holds the bytes of the host tables that
``ops/tridiag._upload`` has queued to a card, ``tables.resident`` the
encodes and decodes that ran on tables kept on the card
(``models/compressor.Compressor._table_scope``).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import defaultdict

from torch.autograd import profiler as _profiler

INFO = 1
TIME = 2
DBG = 4
WARN = 8
ERR = 16

level = ERR | WARN  # module-global, set via Config.log_level


def log(mask: int, msg: str):
    if level & mask:
        tag = {INFO: "info", TIME: "time", DBG: "dbg", WARN: "warn",
               ERR: "err"}.get(mask, "log")
        print(f"[mgard-tpu {tag}] {msg}", file=sys.stderr, flush=True)


class Timer:
    """A named span of host work with optional GB/s reporting
    (Timer.hpp:12-45 'print_throughput' role).  Inside a profiled
    region it opens ``record_function(name)``; it reads the host clock,
    as the JAX package's does, so that what it reports includes the
    device work only where the timed code waits for it."""

    def __init__(self, name: str, nbytes: int = 0):
        self.name = name
        self.nbytes = nbytes
        self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.seconds = dt
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if level & TIME:
            extra = ""
            if self.nbytes:
                extra = f" ({self.nbytes / dt / 1e9:.2f} GB/s)"
            log(TIME, f"{self.name}: {dt*1e3:.2f} ms{extra}")


_IDLE = contextlib.nullcontext()


def span(name: str, nbytes: int = 0):
    """``Timer(name, nbytes)`` while the profiler records or ``level &
    TIME``; otherwise one shared context that does nothing (no
    ``record_function``, no allocation)."""
    if _profiler._is_profiler_enabled or level & TIME:
        return Timer(name, nbytes)
    return _IDLE


_COUNTS = defaultdict(int)
_COUNTS_LOCK = threading.Lock()


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    with _COUNTS_LOCK:
        _COUNTS[name] += n


def counts() -> dict:
    """A snapshot of every counter: name -> value."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_counts():
    """Set every counter back to nothing."""
    with _COUNTS_LOCK:
        _COUNTS.clear()

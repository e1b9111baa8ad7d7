"""Logging and timing utilities (the port of ``mgard_tpu/utils/log.py``;
counterpart of RuntimeX log/Timer,
include/mgard-x/RuntimeX/Utilities/{Log.h,Timer.hpp}): bitmask log levels
and a wall-clock timer that reports GB/s throughput."""

from __future__ import annotations

import sys
import time

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
    """Wall-clock phase timer with optional GB/s reporting
    (Timer.hpp:12-45 'print_throughput' role).  It reads the host clock,
    as the JAX package's does: what it times includes the device work
    only where the timed code waits for it."""

    def __init__(self, name: str, nbytes: int = 0):
        self.name = name
        self.nbytes = nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.seconds = dt
        if level & TIME:
            extra = ""
            if self.nbytes:
                extra = f" ({self.nbytes / dt / 1e9:.2f} GB/s)"
            log(TIME, f"{self.name}: {dt*1e3:.2f} ms{extra}")

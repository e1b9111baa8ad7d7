"""Readers of the program's own spans in a traced half.

The port opens ``torch.profiler.record_function`` ranges around its
stages while the profiler records (``mgard_tpu_torch/utils/log.span``):
``mgard.encode`` and ``mgard.decode`` around a whole call, and inside
them ``mgard.decompose`` / ``mgard.recompose``, ``mgard.level.<l>``,
``mgard.correction`` and ``mgard.bitplane``.  They reach a
:class:`trace.Half` as host events of the category ``user_annotation``.
A program without them (an older checkout) gives every reader here
nothing to read: None.  Times in events are microseconds; readers return
milliseconds a call.

The profiler's device timestamps are not always on the host's clock: in
some traced passes they ran up to 3 ms early, drifting by 0.8% (H100,
torch 2.11), and the first operation's record can be missing.  So the
readers never compare a device time with a host time: each device
operation is paired with its launch by order (the port runs on one
stream, so the device runs its operations in the order the host queued
them), and a stretch of the host's calls between two of its waits for
the device counts only where every pair in it fits (a library's launch
call launched a library's kernel, a copy call a copy).
"""

from __future__ import annotations

import bisect

# host API calls that put one operation on the device's stream, in the
# order the device runs them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cudaMemcpyAsync",
                "cudaMemcpy", "cudaMemsetAsync", "cudaMemset",
                "cuLaunchKernel", "cuLaunchKernelEx")
# launch calls that launch only a library's (cuBLAS's) kernels
LIBRARY_CALLS = ("cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
# host calls that return once the device has run everything queued
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize")


def spans(h, name):
    """(start, end) of the half's spans named ``name``, by start."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in h.host
                  if e["cat"] == "user_annotation" and e["name"] == name)


def _span_at(intervals, x):
    """The index of the one of the sorted, disjoint ``intervals`` that
    holds ``x``, or None."""
    i = bisect.bisect_right(intervals, (x, float("inf"))) - 1
    return i if i >= 0 and intervals[i][0] <= x < intervals[i][1] else None


def span_ms(t, half, name):
    """Host milliseconds a call inside the spans named ``name``."""
    h = t.half(half)
    if h is None:
        return None
    found = spans(h, name)
    if not found:
        return None
    return sum(b - a for a, b in found) / 1e3 / h.calls


def _fits(call, op):
    """Whether the launch call named ``call`` can have queued ``op``."""
    if op["cat"] != "kernel":
        return call.startswith("cudaMemcpy" if op["cat"] == "gpu_memcpy"
                               else "cudaMemset")
    if call.startswith(("cudaMemcpy", "cudaMemset")):
        return False
    return call not in LIBRARY_CALLS or (op["kernel"] is None
                                         and op["layer"] != "torch")


def pairs(h):
    """``(pairs, share)``: each device operation of the half, in the
    device's order, with the host time of the launch that queued it,
    from the stretches where every pair fits, and the share of all
    launches that those pairs hold.  Records lost at either end shift
    the pairing: of the shifts, the one with the fewest pairs that do
    not fit is taken."""
    ops = sorted(h.kernels + [e for e in h.device if e["cat"] != "kernel"],
                 key=lambda e: e["ts"])
    calls = sorted((e["ts"], e["name"]) for e in h.host
                   if e["cat"] in ("cuda_runtime", "cuda_driver")
                   and e["name"] in LAUNCH_CALLS)
    if not ops or not calls:
        return [], 0.0

    def shifted(o):
        return range(max(0, -o), min(len(ops), len(calls) - o))

    def misfits(o):
        return sum(not _fits(calls[i + o][1], ops[i]) for i in shifted(o))
    d = len(calls) - len(ops)
    o = min(range(min(0, d), max(0, d) + 1), key=misfits)
    cuts = sorted(e["ts"] + e["dur"] for e in h.host
                  if e["cat"] == "cuda_runtime" and e["name"] in SYNC_CALLS)
    stretch = [bisect.bisect_right(cuts, ts) for ts, _ in calls]
    unpaired = set(range(len(calls))) - {i + o for i in shifted(o)}
    bad = {stretch[j] for j in unpaired} | {
        stretch[i + o] for i in shifted(o)
        if not _fits(calls[i + o][1], ops[i])}
    kept = [(ops[i], calls[i + o][0]) for i in shifted(o)
            if stretch[i + o] not in bad]
    return kept, len(kept) / len(calls)


def launched_ms(t, half, name):
    """Device milliseconds a call of the kernels and copies launched
    while the host is inside a span named ``name``."""
    h = t.half(half)
    if h is None:
        return None
    found = spans(h, name)
    if not found:
        return None
    kept, share = pairs(h)
    if not kept:
        return None
    us = sum(op["dur"] for op, a in kept if _span_at(found, a) is not None)
    return us / share / 1e3 / h.calls


def paced_ms(t, half, name):
    """Device idle milliseconds a call between two operations that the
    host launched inside one and the same span named ``name``: the device
    waiting on the host while the host is inside that stage (the wait
    for a call's first operation, and any after the host's own wait for
    the device, lie outside)."""
    h = t.half(half)
    if h is None:
        return None
    found = spans(h, name)
    if not found:
        return None
    kept, share = pairs(h)
    if not kept:
        return None
    idle, end, prev = 0.0, None, None
    for op, a in kept:
        where = _span_at(found, a)
        if end is not None and where is not None and where == prev:
            idle += max(0.0, op["ts"] - end)
        end = max(end or op["ts"], op["ts"] + op["dur"])
        prev = where
    return idle / share / 1e3 / h.calls

"""The reduction from a profiler trace to per-layer numbers.

A traced run records, after each half of its window, whole passes over
the cell's fields under ``torch.profiler`` (CPU and CUDA activities),
inside a range named ``portbench.<half>``.  :func:`load_chrome` reads the
exported trace into plain events; :class:`Trace` sorts the device's
kernels into layers by the kernel-name map (``kernelmap/*.json``) and
gives the readers of ``metrics/`` what they take: per-call sums, the
device's idle share of the range, and roofline shares from the byte
counts of ``kernels/``.  Times in events are microseconds.
"""

from __future__ import annotations

import heapq
import json
from collections import Counter, defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
RANGE_PREFIX = "portbench."


def load_chrome(path) -> list:
    """The complete events (``ph`` "X") of a Chrome trace, as dicts of
    cat, name, ts and dur."""
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    return [dict(cat=e.get("cat", ""), name=e.get("name", ""),
                 ts=float(e["ts"]), dur=float(e.get("dur", 0.0)))
            for e in events if e.get("ph") == "X" and "ts" in e]


def symbol(name: str) -> str:
    """The bare function name of a demangled kernel name: no return type,
    namespace, template arguments or parameters."""
    depth, kept = 0, []
    for ch in name.replace("(anonymous namespace)::", ""):
        if ch in "<>":
            depth = depth + 1 if ch == "<" else max(depth - 1, 0)
        elif depth == 0:
            if ch == "(":
                break
            kept.append(ch)
    return "".join(kept).strip().split(" ")[-1].split("::")[-1]


class KernelMap:
    """Symbol -> (kernel, layer), merged from every file of
    ``kernelmap/``; a kernel no file names is a library's where its name
    holds a library pattern, else PyTorch's (layer "torch")."""

    def __init__(self, parts):
        self.symbols, self.libraries = {}, {}
        for part in parts:
            for sym, entry in part.get("symbols", {}).items():
                if sym in self.symbols:
                    raise ValueError(f"kernel map names {sym} twice")
                self.symbols[sym] = entry
            for lib, patterns in part.get("libraries", {}).items():
                self.libraries.setdefault(lib, []).extend(
                    p.lower() for p in patterns)

    def classify(self, name: str):
        entry = self.symbols.get(symbol(name))
        if entry is not None:
            return entry["kernel"], entry["layer"]
        low = name.lower()
        for lib, patterns in self.libraries.items():
            if any(p in low for p in patterns):
                return None, lib
        return None, "torch"


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


class Half:
    """The events of one traced range: ``calls`` calls of one half."""

    def __init__(self, events, name: str, calls: int, kmap: KernelMap):
        rng = [e for e in events if e["cat"] == "user_annotation"
               and e["name"] == RANGE_PREFIX + name]
        if len(rng) != 1:
            raise ValueError(f"the trace holds {len(rng)} ranges named "
                             f"{RANGE_PREFIX + name}")
        self.lo, self.hi = rng[0]["ts"], rng[0]["ts"] + rng[0]["dur"]
        self.calls = calls
        inside = [e for e in events if self.lo <= e["ts"] < self.hi]
        self.device = [e for e in inside if e["cat"] in DEVICE_CATS]
        self.host = [e for e in inside if e["cat"] in HOST_CATS
                     and not e["name"].startswith(RANGE_PREFIX)]
        self.kernels = []
        for e in self.device:
            if e["cat"] == "kernel":
                kernel, layer = kmap.classify(e["name"])
                self.kernels.append(dict(e, kernel=kernel, layer=layer))

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_us(self) -> float:
        return union_us([(e["ts"], e["ts"] + e["dur"]) for e in self.device],
                        self.lo, self.hi)

    def gaps(self):
        """The idle stretches of the device inside the range, each named
        by the innermost (shortest) host event under its middle ("host" if
        none)."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        host = sorted(range(len(self.host)), key=lambda i: self.host[i]["ts"])
        out, end, nxt, under = [], self.lo, 0, []
        for a, b in spans + [(self.hi, self.hi)]:
            if a > end:
                mid = (a + end) / 2
                # middles only grow: an event that ended is never under
                # a later one
                while nxt < len(host) and self.host[host[nxt]]["ts"] <= mid:
                    h = self.host[host[nxt]]
                    heapq.heappush(under, (h["dur"], host[nxt],
                                           h["ts"] + h["dur"], h["name"]))
                    nxt += 1
                while under and under[0][2] <= mid:
                    heapq.heappop(under)
                out.append((under[0][3] if under else "host", a - end))
            end = max(end, b)
        return out


class Trace:
    """What the readers of ``metrics/`` read: the traced halves, the
    kernel byte counts and the card's peak."""

    def __init__(self, halves: dict, shape, itemsize: int,
                 kernel_bytes, peak_bytes_per_s: float):
        self.halves = halves
        self.shape, self.itemsize = tuple(shape), int(itemsize)
        self.kernel_bytes = kernel_bytes
        self.peak_bytes_per_s = peak_bytes_per_s

    def half(self, name):
        return self.halves.get(name)

    def layer_ms(self, name, layers):
        """Kernel milliseconds a call in the layers named; None where the
        half has none."""
        h = self.half(name)
        if h is None:
            return None
        durs = [k["dur"] for k in h.kernels if k["layer"] in layers]
        return sum(durs) / 1e3 / h.calls if durs else None

    def copy_ms(self, name, direction):
        """Milliseconds a call of device copies whose name holds
        ``direction`` ("HtoD", "DtoH", "DtoD")."""
        h = self.half(name)
        if h is None:
            return None
        durs = [e["dur"] for e in h.device if e["cat"] == "gpu_memcpy"
                and direction in e["name"]]
        return sum(durs) / 1e3 / h.calls if durs else None

    def launches(self, name):
        h = self.half(name)
        if h is None or not h.kernels:
            return None
        return len(h.kernels) / h.calls

    def idle_pct(self, name):
        """The share of the traced range in which the device ran nothing.
        The profiler slows the host, so where the host paces the device
        this reads higher than in an untraced run."""
        h = self.half(name)
        if h is None or not h.device:
            return None
        return 100.0 * (1.0 - h.busy_us() / h.window_us)

    def roofline_pct(self, name, kernel):
        """The least time the card could take over the kernel's bytes at
        its peak bandwidth, as a share of its traced time."""
        h = self.half(name)
        if h is None or self.peak_bytes_per_s is None:
            return None
        durs = [k["dur"] for k in h.kernels if k["kernel"] == kernel]
        if not durs:
            return None
        launches = len(durs) / h.calls
        nbytes = self.kernel_bytes(kernel).bytes_per_call(
            self.shape, self.itemsize, launches)
        if not nbytes:
            return None
        least_us = nbytes / self.peak_bytes_per_s * 1e6
        return 100.0 * least_us / (sum(durs) / h.calls)

    def device_seconds(self):
        """(busy, window) seconds over the traced ranges."""
        busy = sum(h.busy_us() for h in self.halves.values())
        window = sum(h.window_us for h in self.halves.values())
        return busy / 1e6, window / 1e6

    def breakdown(self, top=10):
        ops, gaps = Counter(), Counter()
        for h in self.halves.values():
            for e in h.device:
                ops[symbol(e["name"]) if e["cat"] == "kernel"
                    else e["name"]] += e["dur"] / 1e6
            for name, us in h.gaps():
                gaps[name] += us / 1e6
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}

    def unmapped(self):
        """Names of the kernels sorted to PyTorch, with their counts."""
        seen = defaultdict(int)
        for h in self.halves.values():
            for k in h.kernels:
                if k["layer"] == "torch":
                    seen[symbol(k["name"])] += 1
        return dict(sorted(seen.items(), key=lambda kv: -kv[1]))

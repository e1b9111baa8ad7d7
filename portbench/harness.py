"""One run of one cell: set-up, the measured window, the containers, the
reference's verdict and the result's line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel is a file that :class:`Bench` finds by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json`` (through the
config's ``file``), ``traffic/<mix>.json``, ``metrics/<metric>.py`` (a
``read(trace)`` that returns a number or None), ``kernels/<kernel>.py``
(a ``bytes_per_call(shape, itemsize, launches)``) and every
``kernelmap/*.json``.

The window drives the program's in-situ entry: ``get_compressor(shape,
dtype, s, config=Config(), device=...)``, whose ``encode_device`` and
``decode_device`` run on fields already on the card.  One client, closed
loop: the compress half encodes the fields in turn and reads each
stream's word count and status back to the host (which ends that call);
the decompress half decodes the streams that the compress half left, in
turn, and synchronizes on each result.  Each half keeps, for each field,
one stream or one decoded array drawn uniformly from the seed among that
field's calls.  After the window the program writes one container per
field (``Compressor.compress``), whose bytes give the ratio, and reads
each back (``Compressor.decompress``); then the reference judges each
kept array and each container's array against the field it rebuilds from
the seed.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import random
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import reference
from portbench import trace as tr

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mgard_tpu", "zstandard")
# seconds that the traced passes after a half span at least, at the
# untraced half's pace: whole passes over the fields, so that the
# profiler's start weighs little in every cell
TRACED_S = 0.25


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.pkg = self.root / "portbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    @staticmethod
    def _named(entries, name, what):
        for entry in entries:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")

    def workload(self, name: str) -> dict:
        return self._named(self.spec["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.spec["configs"], name, "config")
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.pkg / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, kind: str, cell: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell``
        reports."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def _module(self, folder: str, name: str):
        path = self.pkg / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str):
        return self._module("metrics", metric).read

    def kernel(self, kernel: str):
        return self._module("kernels", kernel)

    def kernel_map(self) -> tr.KernelMap:
        parts = []
        for path in sorted((self.pkg / "kernelmap").glob("*.json")):
            with open(path) as f:
                parts.append(json.load(f))
        return tr.KernelMap(parts)

    def peak_bytes_per_s(self, device_name: str):
        with open(self.pkg / "peaks.json") as f:
            peaks = json.load(f)
        for key, entry in peaks.items():
            if isinstance(entry, dict) and (key == device_name
                                            or key in device_name):
                return float(entry["bytes_per_s"])
        return None


def pin_knobs():
    """Run the program at its default knobs: before it is imported, drop
    every ``MGARD_TPU_*`` variable (its kernels then build into
    ``mgard_tpu_torch/_build/`` inside the checkout) and name an autotune
    table that does not exist, in a temporary directory under the run's
    ``TMPDIR``.  Returns that directory, which the caller keeps open."""
    for key in [k for k in os.environ if k.startswith("MGARD_TPU_")]:
        del os.environ[key]
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    os.environ["MGARD_TPU_AUTOTUNE"] = os.path.join(tmp.name,
                                                    "autotune.json")
    return tmp


def forbidden_modules() -> list:
    """Top-level names of ``sys.modules`` that are in FORBIDDEN, compared
    whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _loop(call, n: int, seconds=None, count=None):
    """``call(i % n)`` for i = 0, 1, ...: ``count`` calls, or until
    ``seconds`` have passed and every field has had a call.  Returns
    (calls, elapsed seconds by the host clock)."""
    start, i = time.perf_counter(), 0
    while True:
        call(i % n)
        i += 1
        elapsed = time.perf_counter() - start
        if count is not None:
            if i >= count:
                return i, elapsed
        elif i >= n and elapsed >= seconds:
            return i, elapsed


class _Cell:
    """The state of one run: the compressor, the fields, what each half
    keeps, and the counts.  Compress latencies come from CUDA events on
    the card, from the host clock on the CPU (where the tests drive a
    run)."""

    def __init__(self, torch, comp, fields, tol, rng, device):
        self.torch, self.comp, self.fields = torch, comp, fields
        self.tol, self.rng, self.device = tol, rng, device
        n = len(fields)
        self.streams, self.outs = [None] * n, [None] * n
        self.encoded, self.decoded = [0] * n, [0] * n
        self.bad_status = 0
        self.latencies = []
        self.enqueue_ms = []     # host time for encode_device to return
        self.timing = True       # whether compress latencies are kept
        if device.type == "cuda":
            def mark():
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                return event
            self.mark, self.ms = mark, lambda a, b: a.elapsed_time(b)
        else:
            self.mark = time.perf_counter
            self.ms = lambda a, b: (b - a) * 1e3

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def compress(self, f: int):
        torch = self.torch
        begin, host = self.mark(), time.perf_counter()
        exponents, words, count, status = self.comp.encode_device(
            self.fields[f], self.tol)
        host = (time.perf_counter() - host) * 1e3
        small = torch.stack((count.to(torch.int64),
                             status.to(torch.int64))).cpu()
        end = self.mark()
        nwords, status = (int(x) for x in small.tolist())
        if self.timing:
            self.latencies.append((begin, end))
            self.enqueue_ms.append(host)
        self.bad_status += status != 0
        self.encoded[f] += 1
        if self.rng.randrange(self.encoded[f]) == 0:
            self.streams[f] = (exponents, words[:nwords])

    def decompress(self, f: int):
        exponents, words = self.streams[f]
        out = self.comp.decode_device(exponents, words, self.tol)
        self.sync()
        self.decoded[f] += 1
        if self.rng.randrange(self.decoded[f]) == 0:
            self.outs[f] = out

    def latency_ms(self):
        return [self.ms(a, b) for a, b in self.latencies]


def _containers(comp, fields, tol):
    """(bytes of all containers, each container's array on the host): one
    container a field through ``Compressor.compress``, read back through
    ``Compressor.decompress``.  A container that cannot be written or read
    back gives None in place of its array, and the bytes are then 0, so
    that no ratio is reported."""
    stored, backs = 0, []
    for field in fields:
        try:
            buf = comp.compress(field, tol)
            backs.append(comp.decompress(buf))
            stored += len(buf)
        except Exception as exc:  # judged below as a field not read back
            _log(f"container not read back: {type(exc).__name__}: {exc}")
            backs.append(None)
    return (stored if all(b is not None for b in backs) else 0), backs


def _activities(device):
    from torch.profiler import ProfilerActivity
    if device.type == "cuda":
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def _traced(torch, device, name, body):
    """Run ``body()`` under the profiler inside the range
    ``portbench.<name>``; returns the trace's events."""
    from torch.profiler import profile, record_function
    with profile(activities=_activities(device)) as prof:
        with record_function(tr.RANGE_PREFIX + name):
            body()
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return tr.load_chrome(path)


def _profiler_warmup(torch, device):
    """Start the profiler once before the window, so that the traced
    passes do not pay its first start."""
    from torch.profiler import profile
    with profile(activities=_activities(device)):
        torch.ones(1, device=device).sum().item()


def _quantiles(values):
    """'median / p95' of ``values``, or 'nan' where there are none."""
    if not values:
        return "nan"
    return (f"{float(np.median(values)):.6f} / "
            f"{float(np.percentile(values, 95)):.6f}")


def _log(*parts):
    print("portbench:", *parts, file=sys.stderr, flush=True)


def run(bench: Bench, cell_name: str, seed: int, seconds: float,
        trace: bool, device: str = "cuda", t0: float = None) -> dict:
    """One run of ``cell_name``; returns the result's line as a dict (its
    ``checks`` last).  ``t0`` is the host clock at the process's start."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = bench.workload(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])

    import torch
    from mgard_tpu_torch.config import Config
    from mgard_tpu_torch.models.compressor import get_compressor

    dev = torch.device(device)
    shape = tuple(int(n) for n in cfg["shape"])
    dtype = np.dtype(cfg["dtype"])
    tol = float(mix["abs_tol"])
    nfields = len(cfg["fields"])
    field_bytes = math.prod(shape) * dtype.itemsize

    comp = get_compressor(shape, dtype, float(mix["s"]), config=Config(),
                          device=dev)
    fields = [reference.make_field(cfg, seed, f, dev)
              for f in range(nfields)]
    # set-up: one pass of each half, which builds every shape the window
    # uses
    warm = _Cell(torch, comp, fields, tol, random.Random(seed), dev)
    _loop(warm.compress, nfields, count=nfields)
    _loop(warm.decompress, nfields, count=nfields)
    del warm
    if trace:
        _profiler_warmup(torch, dev)
    state = _Cell(torch, comp, fields, tol, random.Random(seed), dev)
    state.sync()
    setup_s = time.perf_counter() - t0

    # the window: both halves, each followed in a traced run by whole
    # traced passes over the fields
    def traced_calls(n, elapsed):
        return nfields * max(1, math.ceil(TRACED_S * n / elapsed / nfields))

    events, calls = {}, {}
    n_c, t_c = _loop(state.compress, nfields, seconds=seconds / 2)
    state.timing = False
    if trace:
        calls["compress"] = traced_calls(n_c, t_c)
        events["compress"] = _traced(
            torch, dev, "compress",
            lambda: _loop(state.compress, nfields, count=calls["compress"]))
    n_d, t_d = _loop(state.decompress, nfields, seconds=seconds / 2)
    if trace:
        calls["decompress"] = traced_calls(n_d, t_d)
        events["decompress"] = _traced(
            torch, dev, "decompress",
            lambda: _loop(state.decompress, nfields,
                          count=calls["decompress"]))
    state.sync()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    latencies = state.latency_ms()
    enqueue_ms = state.enqueue_ms
    attempted = sum(state.encoded) + sum(state.decoded)

    # after the window: one container per field and its read-back, then
    # the program's state freed and the reference's verdict on every kept
    # array and every container's array
    stored, backs = _containers(comp, fields, tol)
    outs, bad_status = state.outs, state.bad_status
    del state, fields, comp
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    errors, back_errors, ranges = [], [], []
    for f in range(nfields):
        field = reference.make_field(cfg, seed, f, dev)
        ranges.append(reference.value_range(field))
        if outs[f] is not None:
            errors.append(reference.max_abs_error(field, outs[f]))
        back_errors.append(math.inf if backs[f] is None else
                           reference.max_abs_error(field, backs[f]))
        outs[f] = backs[f] = None
        del field
    unchecked = nfields - len(errors)
    max_err = max(errors) if errors else math.inf
    back_err = max(back_errors)
    failed = (bad_status + unchecked + sum(e > tol for e in errors)
              + sum(e > tol for e in back_errors))

    kind = "per_layer" if trace else "end_to_end"
    values = {}
    if trace:
        kmap = bench.kernel_map()
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        halves = {h: tr.Half(ev, h, calls[h], kmap)
                  for h, ev in events.items()}
        t = tr.Trace(halves, shape, dtype.itemsize, bench.kernel,
                     bench.peak_bytes_per_s(name))
        for m in bench.metrics("per_layer", cell_name):
            values[m["name"]] = bench.reader(m["name"])(t)
        busy_s, window_s = t.device_seconds()
        _log("kernels sorted to PyTorch (name: launches):", t.unmapped())
        untraced = {"compress": t_c / n_c * 1e3,
                    "decompress": t_d / n_d * 1e3}
        _log("ms a call, untraced half / traced pass (the profiler's cost):",
             {h: (untraced[h], halves[h].window_us / 1e3 / halves[h].calls)
              for h in halves})
    else:
        values = {
            "compress_GBps": n_c * field_bytes / t_c / 1e9,
            "decompress_GBps": n_d * field_bytes / t_d / 1e9,
            "compress_p95_ms": float(np.percentile(latencies, 95)),
            "ratio": nfields * field_bytes / stored if stored else None,
            "setup_s": setup_s,
        }
    units = {m["name"]: m["unit"] for m in bench.metrics(kind, cell_name)}
    metrics = {k: {"value": float(values[k]), "unit": u}
               for k, u in units.items() if values.get(k) is not None}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0 and max(max_err, back_err) <= tol,
              "attempted": attempted, "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = busy_s
        device_info["window_s"] = window_s
        result["breakdown"] = t.breakdown()
    _log(f"{cell_name} seed {seed}: {n_c} compresses in {t_c:.6f} s, "
         f"{n_d} decompresses in {t_d:.6f} s, {stored} bytes stored, "
         f"compress latency median "
         f"{float(np.median(latencies)) if latencies else math.nan:.6f} ms "
         f"over {len(latencies)}, p95 "
         f"{float(np.percentile(latencies, 95)) if latencies else math.nan:.6f}"
         f" ms, host enqueue of a compress median / p95 "
         f"{_quantiles(enqueue_ms)} ms, max error by field {errors}, by "
         f"container {back_errors}, value range (max - min) by field "
         f"{ranges}")
    result["checks"] = {
        "max_err": {"value": max_err if math.isfinite(max_err)
                    else str(max_err), "limit": tol},
        "container_max_err": {"value": back_err if math.isfinite(back_err)
                              else str(back_err), "limit": tol},
        "bad_status": {"value": int(bad_status), "limit": 0},
        "unchecked_fields": {"value": unchecked, "limit": 0},
    }
    return result

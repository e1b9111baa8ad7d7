"""Autotuner: benchmark codec configurations and persist the winners (the
port of ``mgard_tpu/utils/autotune.py``).

Counterpart of the reference AutoTuner
(include/mgard-x/RuntimeX/AutoTuners/, src/mgard-x/Executables/
mgard-x-autotuner.cpp), which benchmarks per-kernel block sizes and
rewrites its own source tables.  Here the results go to a JSON table in
the JAX package's format, keyed by (device kind, dtype, size bucket), and
are read when a Config is built (``Config.tuned``) or, for the knobs the
``ops`` modules read at import, when the package is imported
(``apply_tuned``).

The device kind is ``torch.cuda.get_device_name`` with spaces replaced by
``_`` (``NVIDIA_H100_80GB_HBM3``), or ``cpu``, as JAX names its CPU, so
on the CPU both packages write the same keys.  The default table is
``~/.cache/mgard_tpu_torch/autotune.json``, not the JAX package's:
``default_knobs`` carries no device in its key, so a table tuned for a
TPU must not seed this package.  ``MGARD_TPU_AUTOTUNE`` overrides it, as
in the JAX package.

Run ``python -m mgard_tpu_torch.utils.autotune probe --shape 256 256 256``
(one configuration, the process's knobs) or ``... sweep`` (every knob of
the grid, one process a candidate); both take ``--device`` (default: the
card).

Importing this module imports nothing of the package beyond ``config``:
``mgard_tpu_torch/__init__`` calls :func:`apply_tuned` before the
modules that read the knobs are imported.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config, Lossless

_DEFAULT_PATH = pathlib.Path(
    os.environ.get("MGARD_TPU_AUTOTUNE",
                   os.path.expanduser("~/.cache/mgard_tpu_torch/"
                                      "autotune.json")))


def _size_bucket(ndof: int) -> str:
    return f"2^{max(10, int(math.log2(max(ndof, 1))))}"


def _device(device=None) -> torch.device:
    from ..api import resolve_device
    return resolve_device(device)


def _device_kind(device=None) -> str:
    dev = _device(device)
    if dev.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(dev).replace(" ", "_")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_table(path: Optional[pathlib.Path] = None) -> Dict:
    path = path or _DEFAULT_PATH
    if path.exists():
        return json.loads(path.read_text())
    return {}


def _key(shape, dtype, device=None) -> str:
    return f"{_device_kind(device)}|{np.dtype(dtype).name}|" \
           f"{_size_bucket(int(np.prod(shape)))}"


def lookup(shape, dtype, path: Optional[pathlib.Path] = None,
           device=None) -> Optional[Config]:
    """The tuned Config for this (device, dtype, size), if any.

    Merges the codec pick (:func:`autotune`) with the knob winners
    (:func:`sweep_knobs`) recorded under the same key.  The chunk width
    applies per workload because containers record their width."""
    table = load_table(path)
    key = _key(shape, dtype, device)
    entry = table.get(key)
    knobs = table.get("knobs", {}).get(key, {})
    if entry is None and not knobs:
        return None
    kw = {}
    if entry is not None:
        kw["lossless"] = Lossless(entry["lossless"])
    cg = knobs.get("MGARD_TPU_CHUNK_GROUPS")
    if cg:
        kw["chunk_groups"] = int(cg)
    return Config(**kw)


def _field(shape, dtype, device, scale: float = 1.0) -> torch.Tensor:
    """The JAX package's tuning field: a cumulative sum of normal noise
    along the last axis (seed 0), smooth-ish."""
    rng = np.random.default_rng(0)
    v = np.cumsum(rng.normal(size=shape).astype(dtype), axis=-1)
    if scale != 1.0:
        v = v * scale
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def _slope(fn, iters: int, lo: int, hi: int, device,
           tries: int = 5) -> float:
    """Seconds a call of ``fn``, from the difference of ``hi * iters``
    and ``lo * iters`` calls, each run ending in a synchronize: the fixed
    cost of a run cancels.  A difference that is not positive (the
    longer run was slowed less, as on a shared card) is no reading: the
    pair is run again, up to ``tries`` times, and then it raises, where
    the JAX package clamps it to a nanosecond."""
    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        return time.perf_counter() - t0
    for _ in range(tries):
        t1, t2 = run(lo * iters), run(hi * iters)
        if t2 > t1:
            return (t2 - t1) / ((hi - lo) * iters)
    raise RuntimeError(f"no positive timing slope in {tries} tries")


def _score(r: Dict, objective: str) -> float:
    if objective == "throughput":
        return r["gbps"]
    if objective == "ratio":
        return r["ratio"]
    return r["gbps"] * r["ratio"]


def _encoded_bytes(exponents: torch.Tensor, count) -> int:
    return int(count) * 4 + int(exponents.numel())


def autotune(shape, dtype=np.float32, s: float = math.inf,
             candidates: Optional[List[Lossless]] = None,
             objective: str = "balanced", iters: int = 3,
             save: bool = True,
             path: Optional[pathlib.Path] = None, device=None) -> Dict:
    """Benchmark codecs for this shape/dtype on ``device`` (None: the
    card).

    objective: "throughput" (GB/s of the device encode), "ratio", or
    "balanced" (GB/s * ratio).  Returns the per-candidate results and
    persists the winner when ``save``.
    """
    from ..hierarchy import Hierarchy
    from ..models.compressor import Compressor

    dev = _device(device)
    if candidates is None:
        candidates = [Lossless.BITPLANE, Lossless.BITPLANE_GROUP]
    hier = Hierarchy(shape)
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    v = _field(shape, dtype, dev)
    tol = 1e-3

    results = {}
    for cand in candidates:
        comp = Compressor(hier, np.dtype(dtype), s=s,
                          config=Config(lossless=cand), device=dev)
        comp.encode_device(v, tol)
        t = _slope(lambda: comp.encode_device(v, tol), iters, 1, 2, dev)
        e, _, c, _ = comp.encode_device(v, tol)
        results[int(cand)] = {"gbps": nbytes / t / 1e9,
                              "ratio": nbytes / max(_encoded_bytes(e, c), 1)}

    best = max(results, key=lambda k: _score(results[k], objective))
    if save:
        path = path or _DEFAULT_PATH
        table = load_table(path)
        table[_key(shape, dtype, dev)] = {"lossless": best,
                                          "results": results,
                                          "objective": objective}
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(table, indent=1))
    return {"best": Lossless(best), "results": results}


# --- runtime-knob sweep -----------------------------------------------------
#
# The knobs that shape the stream or the path (the codec chunk width, the
# chunk tile, the dense-matmul size cap, the GPK kernels on or off, the
# pipeline depth) are module constants read from the environment at
# import.  The sweep therefore benchmarks each candidate in a subprocess
# with the environment set, the reference AutoTuner's "benchmark, then
# persist a table the next run reads" without its source rewrite.
# Winners land in the JSON table; apply_tuned() (called from
# mgard_tpu_torch/__init__ before the ops modules import) seeds the
# environment with them, except the switches in EXPLICIT_ONLY: the sweep
# records their winners, but only a variable the user sets turns a
# hand-written kernel off (a probe on a shared card can read any GB/s).

KNOB_ENV = {
    "chunk_groups": "MGARD_TPU_CHUNK_GROUPS",
    "bp_cb": "MGARD_TPU_BP_CB",
    "matmul_max_n": "MGARD_TPU_MATMUL_MAX_N",
    "gpk": "MGARD_TPU_GPK",
    "pipeline_depth": "MGARD_TPU_PIPELINE_DEPTH",
}

EXPLICIT_ONLY = ("MGARD_TPU_GPK",)

DEFAULT_GRID = {
    "chunk_groups": [1024, 2048, 4096],
    "bp_cb": [4, 8],
    "gpk": [1, 0],
}


def probe(shape, dtype=np.float32, s: float = math.inf,
          tol: float = 1e-3, iters: int = 4, device=None) -> Dict:
    """Benchmark the device encode + decode of this process's
    configuration (the knobs read at import) on ``device`` (None: the
    card).  Returns {gbps, t_enc_ms, t_dec_ms, ratio}; run by
    ``python -m mgard_tpu_torch.utils.autotune probe`` from sweeps."""
    from ..hierarchy import Hierarchy
    from ..models.compressor import Compressor

    dev = _device(device)
    comp = Compressor(Hierarchy(shape), np.dtype(dtype), s=s, device=dev)
    v = _field(shape, dtype, dev, scale=0.01)
    e, w, c, _ = comp.encode_device(v, tol)
    comp.decode_device(e, w, tol)
    _sync(dev)
    t_enc = _slope(lambda: comp.encode_device(v, tol), iters, 1, 3, dev)
    t_dec = _slope(lambda: comp.decode_device(e, w, tol), iters, 1, 3, dev)
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return {
        "gbps": nbytes / (t_enc + t_dec) / 1e9,
        "t_enc_ms": t_enc * 1e3, "t_dec_ms": t_dec * 1e3,
        "ratio": nbytes / max(_encoded_bytes(e, c), 1),
    }


def sweep_knobs(shape=(256, 256, 256), dtype=np.float32,
                grid: Optional[Dict] = None, objective: str = "balanced",
                budget_s: int = 900, save: bool = True,
                path: Optional[pathlib.Path] = None,
                log=print, _runner=None, device=None) -> Dict:
    """One-at-a-time sweep around the current defaults: for each knob,
    benchmark each candidate in a subprocess (a fresh import, so the
    environment takes effect) on ``device`` (None: the card), keep the
    winner, move to the next knob.

    Winners persist per (device, dtype, size bucket) under
    ``table["knobs"][key]``, plus ``default_knobs``, the winners of the
    largest swept bucket, which apply_tuned() seeds at import.
    ``_runner`` replaces the subprocess with a probe function (tests)."""
    import subprocess
    import sys

    grid = grid or DEFAULT_GRID
    current: Dict[str, object] = {}
    results: Dict[str, Dict] = {}
    # the subprocess imports this checkout's package
    root = str(pathlib.Path(__file__).resolve().parents[2])
    cmd = [sys.executable, "-m", "mgard_tpu_torch.utils.autotune", "probe",
           "--shape", *map(str, shape), "--dtype", np.dtype(dtype).name]
    if device is not None:
        cmd += ["--device", str(device)]

    def run_probe(knobs: Dict) -> Optional[Dict]:
        if _runner is not None:
            return _runner(knobs)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        for k, val in knobs.items():
            env[KNOB_ENV[k]] = str(val)
        try:
            out = subprocess.run(cmd, env=env, capture_output=True,
                                 text=True, timeout=budget_s, check=True)
            return json.loads(out.stdout.strip().splitlines()[-1])
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                json.JSONDecodeError, IndexError) as exc:
            log(f"#   candidate {knobs} failed: {type(exc).__name__}")
            return None

    for knob, candidates in grid.items():
        results[knob] = {}
        best_val, best_score = None, -1.0
        for cand in candidates:
            r = run_probe({**current, knob: cand})
            if r is None:
                continue
            results[knob][str(cand)] = {k: round(float(vv), 4)
                                        for k, vv in r.items()}
            log(f"# {knob}={cand}: {r['gbps']:.2f} GB/s, "
                f"ratio {r['ratio']:.2f}x")
            if _score(r, objective) > best_score:
                best_val, best_score = cand, _score(r, objective)
        if best_val is not None:
            current[knob] = best_val

    if save and current:
        path = path or _DEFAULT_PATH
        table = load_table(path)
        winners_env = {KNOB_ENV[k]: str(v) for k, v in current.items()}
        knobs_tbl = table.setdefault("knobs", {})
        knobs_tbl[_key(shape, dtype, device)] = dict(
            winners_env, _ndof=int(np.prod(shape)))
        # default_knobs = the largest swept bucket's winners (seeded at
        # import); per-workload widths come from lookup()/Config.tuned
        largest = max(knobs_tbl.values(), key=lambda e: e.get("_ndof", 0))
        table["default_knobs"] = {k: v for k, v in largest.items()
                                  if not k.startswith("_")}
        table.setdefault("sweeps", {})[
            f"{np.dtype(dtype).name}|{'x'.join(map(str, shape))}"] = results
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(table, indent=1))
    return {"winners": current, "results": results}


def apply_tuned(path: Optional[pathlib.Path] = None) -> None:
    """Seed environment defaults from the persisted sweep winners.
    Called from mgard_tpu_torch/__init__ before the ops modules import;
    a variable the user set always wins (setdefault), and the switches
    of EXPLICIT_ONLY are never seeded."""
    try:
        table = load_table(path)
    except (OSError, json.JSONDecodeError):
        return
    for env_key, val in table.get("default_knobs", {}).items():
        if env_key in KNOB_ENV.values() and env_key not in EXPLICIT_ONLY:
            os.environ.setdefault(env_key, str(val))


def _main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="mgard_tpu_torch.utils.autotune")
    sub = p.add_subparsers(dest="cmd", required=True)
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=None,
                     help="torch device (default: the CUDA card)")
    pr = sub.add_parser("probe", parents=[dev])
    pr.add_argument("--shape", nargs="+", type=int, required=True)
    pr.add_argument("--dtype", default="float32")
    pr.add_argument("--tol", type=float, default=1e-3)
    sw = sub.add_parser("sweep", parents=[dev])
    sw.add_argument("--shape", nargs="+", type=int,
                    default=[256, 256, 256])
    sw.add_argument("--dtype", default="float32")
    sw.add_argument("--objective", default="balanced")
    args = p.parse_args(argv)
    if args.cmd == "probe":
        r = probe(tuple(args.shape), np.dtype(args.dtype), tol=args.tol,
                  device=args.device)
    else:
        r = sweep_knobs(tuple(args.shape), np.dtype(args.dtype),
                        objective=args.objective, device=args.device)
    print(json.dumps(r))


if __name__ == "__main__":
    _main()

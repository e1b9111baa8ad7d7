#!/usr/bin/env python3
"""Time K2 (``bp_quant_max``) and K6 (``gpk_prolong_add``) of one or more
checkouts of the port on one NVIDIA GPU, in turns.

    python3 chip_probe.py [--ptxas | --api | --hierarchy] TREE [TREE ...]

Each TREE is a directory that holds ``mgard_tpu_torch/`` (this checkout
is ``.``; an older commit unpacked with ``git archive`` is another).  The
trees run in the order given, each in its own process, so that
``OLD NEW NEW OLD`` compares two versions on one card with the spread
between turns in view.  For each tree, on the main path's own inputs
(the 512^3 field of ``chip_smoke.py``, its 10-segment pyramid and its
level-9 K6 inputs), it prints one JSON line with, in ms by CUDA events:

* ``k2_batched``: one launch over the 10 segments (where the tree has
  ``bp_quant_max_segments``), held bit for bit against the concatenated
  plain results;
* ``k2_per_segment``: the one-segment wrapper called once per segment;
* ``k2_largest``: the largest segment (512^3 values) alone;
* ``k2_profiler_per_segment`` / ``k2_profiler_batched``: the device time
  of K2's kernels alone, summed over one encode's launches, by
  ``torch.profiler`` (``null`` where it records no device time);
* ``k6``: K6 at level 9, held bit for bit against its plain version.

``--api`` instead times, for each tree, the 512^3 API round trip
(``mt.compress`` and ``mt.decompress`` with numpy in and out, host
clock) five times after one warm-up, and holds the output within the
tolerance.

``--hierarchy`` instead times, for each tree, the host build of
``Hierarchy((280953867,))`` (the long-dims phase's 1-D series; host
clock, no device work) and prints the process's peak resident set.

``--ptxas`` first compiles each ``csrc/*.cu`` of this checkout with
``nvcc -Xptxas -v`` and prints the registers, shared memory and spills
of every kernel.  Without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def ptxas_report() -> None:
    sys.path.insert(0, HERE)
    from mgard_tpu_torch.ops import _build
    obj = os.path.join(tempfile.mkdtemp(), "ptxas.o")
    for src in _build.sources():
        cmd = _build.compile_command(src, obj)
        cmd.insert(-4, "-Xptxas")
        cmd.insert(-4, "-v")
        res = subprocess.run(cmd, capture_output=True, text=True)
        print(f"ptxas {src.name} (rc {res.returncode}):", flush=True)
        for line in (res.stdout + res.stderr).splitlines():
            if "Compiling entry" in line or "Used" in line \
                    or "spill" in line or "error" in line:
                print("  " + line.strip(), flush=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on {src.name}")


def profiled_ms(fn, reps: int, match: str):
    """Device time of the kernels whose name holds ``match``, per call of
    ``fn``, by torch.profiler; None where no device time is recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if match in ev.key:
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            total += t
    return total / reps / 1e3 if total else None


def run_tree(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, HERE)
    import torch
    from chip_smoke import SHAPE, TOL, cuda_ms, max_abs_diff, \
        smooth_field_host
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import bitplane, bp_kernels as bk, _build
    from mgard_tpu_torch.ops import extract_kernels as xk
    from mgard_tpu_torch.ops import stencil_kernels as sk, transform
    from mgard_tpu_torch.ops.quantize import inverse_quantum

    if not os.path.samefile(os.path.dirname(mt.__file__),
                            os.path.join(tree, "mgard_tpu_torch")):
        raise RuntimeError(f"imported {mt.__file__}, not {tree}'s package")
    _build.lib()
    hier = mt.Hierarchy(SHAPE)
    v = torch.from_numpy(smooth_field_host(SHAPE)).cuda()
    pyr = [p.reshape(-1).contiguous() for p in transform.decompose(hier, v)]
    C = bitplane.CHUNK_GROUPS
    inv_q = float(inverse_quantum(hier, TOL))
    ncs = [bitplane.num_chunks_tiled(p.numel(), C) for p in pyr]
    big = max(range(len(pyr)), key=lambda s: pyr[s].numel())
    res = {"tree": tree, "segments": len(pyr), "chunks": sum(ncs)}

    per_seg = lambda: [bk.bp_quant_max(p, nc, C, inv_q)
                       for p, nc in zip(pyr, ncs)]
    res["k2_per_segment"] = cuda_ms(per_seg, 20)
    res["k2_largest"] = cuda_ms(
        lambda: bk.bp_quant_max(pyr[big], ncs[big], C, inv_q), 20)
    res["k2_profiler_per_segment"] = profiled_ms(per_seg, 5, "quant_max")
    if hasattr(bk, "bp_quant_max_segments"):
        batched = lambda: bk.bp_quant_max_segments(pyr, ncs, C, inv_q)
        got = batched()
        want = bk.bp_quant_max_segments_plain(pyr, ncs, C, inv_q)
        res["k2_batched_err"] = max(max_abs_diff(g, w)
                                    for g, w in zip(got, want))
        res["k2_batched"] = cuda_ms(batched, 20)
        res["k2_profiler_batched"] = profiled_ms(batched, 5, "quant_max")
        if res["k2_batched_err"]:
            raise AssertionError("batched K2 differs from its plain version")
        del got, want
    del pyr

    l = hier.L
    det = sk.gpk_detail(hier, v, l)
    Cc = xk.extract_coarse_3d(hier, v, l)
    got = sk.gpk_prolong_add(hier, Cc, det, l)
    res["k6_err"] = max_abs_diff(got, sk.gpk_prolong_add_plain(hier, Cc,
                                                               det, l))
    res["k6"] = cuda_ms(lambda: sk.gpk_prolong_add(hier, Cc, det, l), 20)
    res["k6_profiler"] = profiled_ms(
        lambda: sk.gpk_prolong_add(hier, Cc, det, l), 5, "prolong_add")
    if res["k6_err"]:
        raise AssertionError("K6 differs from its plain version")
    return res


def run_api(tree: str, reps: int = 5) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, HERE)
    import time
    from chip_smoke import SHAPE, TOL, smooth_field_host
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import _build

    if not os.path.samefile(os.path.dirname(mt.__file__),
                            os.path.join(tree, "mgard_tpu_torch")):
        raise RuntimeError(f"imported {mt.__file__}, not {tree}'s package")
    _build.lib()
    v = smooth_field_host(SHAPE)
    mt.decompress(mt.compress(v, TOL))
    comp_ms, dec_ms = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        buf = mt.compress(v, TOL)
        t1 = time.perf_counter()
        out = mt.decompress(buf)
        t2 = time.perf_counter()
        comp_ms.append(1e3 * (t1 - t0))
        dec_ms.append(1e3 * (t2 - t1))
        err = float(np.abs(out.astype(np.float64) - v).max())
        if not err <= TOL:
            raise AssertionError(f"error {err} exceeds {TOL}")
        del out
    return {"tree": tree, "shape": list(SHAPE), "bytes": len(buf),
            "compress_ms": comp_ms, "decompress_ms": dec_ms,
            "compress_mean_ms": float(np.mean(comp_ms)),
            "decompress_mean_ms": float(np.mean(dec_ms))}


def run_hierarchy(tree: str) -> dict:
    import resource
    import time
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from mgard_tpu_torch import hierarchy

    if not os.path.samefile(os.path.dirname(hierarchy.__file__),
                            os.path.join(tree, "mgard_tpu_torch")):
        raise RuntimeError(f"imported {hierarchy.__file__}, not {tree}'s "
                           "package")
    shape = (280953867,)
    t0 = time.perf_counter()
    hier = hierarchy.Hierarchy(shape)
    build_s = time.perf_counter() - t0
    return {"tree": tree, "shape": list(shape), "L": hier.L,
            "build_s": build_s, "cpus": os.cpu_count(),
            "peak_rss_bytes":
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_probe.py: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        print(json.dumps(run_tree(args[1])), flush=True)
        return 0
    if args[:1] == ["--one-api"]:
        print(json.dumps(run_api(args[1])), flush=True)
        return 0
    if args[:1] == ["--one-hierarchy"]:
        print(json.dumps(run_hierarchy(args[1])), flush=True)
        return 0
    one = "--one"
    if args[:1] == ["--ptxas"]:
        ptxas_report()
        args = args[1:]
    elif args[:1] in (["--api"], ["--hierarchy"]):
        one = "--one-" + args[0][2:]
        args = args[1:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    for tree in args:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              one, tree])
        if res.returncode:
            return res.returncode
    return 0


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main())

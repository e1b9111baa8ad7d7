#!/usr/bin/env python3
"""Time K2 (``bp_quant_max``) and K6 (``gpk_prolong_add``) of one or more
checkouts of the port on one NVIDIA GPU, in turns.

    python3 chip_probe.py [--ptxas | --api | --hierarchy | --s1f64]
                          TREE [TREE ...]
    python3 chip_probe.py --s1f64-sweep
    python3 chip_probe.py --s1f64-runs

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

``--s1f64`` instead times, for each tree, float64 S1 (``mass_solve`` on
float64 data) where the port calls it: at level 6 of the (64, 512, 8192)
field of ``chip_smoke.py`` along each axis, on the correction's own
input as ``chip_smoke.long_field`` makes it (and float32 S1 there, for
comparison), and at each of the 24
solves of the orthogonal components of a float64 256^3 field (levels 7
to 0, ``norms._solve_all``), each held bit for bit against its plain
version and timed in ``chip_smoke.TURNS`` queued turns beside a float64
tensordot with the dense inverse; then float64 S1 on long series, fewer
than 32 lines (``SERIES``: one line of 2^24 + 1 nodes, and four such
lines of 2^22 + 1 nodes along the last axis and along the first), each
held bit for bit against S1 at another cut (256 runs of 16 nodes a
block) and by its float64 residual, in turns, with float32 S1 on the
one line beside it; then the float64 (64, 512, 8192) device encode and
decode (CUDA events, three runs each after a warm-up), the path those
solves sit in.  Where the tree's ``tridiag`` has float64 routes, each
solve's route, threads and blocks an SM are given too.

``--s1f64-sweep`` times the same (b) solves and the 129^3 and 65^3
component solves of this checkout under each setting of ``S1F64_SWEEP``
(constants of ``ops/tridiag.py`` that choose float64's routes), each
held bit for bit against its plain version, in turns.

``--s1f64-runs`` times float64 S1 on the long series of this checkout
at its default geometry and at each (threads, run) of the runs kernel
(one line a block) that fits a block, each held as ``--s1f64`` holds
the series.

``--ptxas`` first compiles each ``csrc/*.cu`` of this checkout with
``nvcc -Xptxas -v`` and prints the registers, shared memory and spills
of every kernel.  Without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import inspect
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


# Settings of float64 S1's route constants that --s1f64-sweep times.
S1F64_SWEEP = (
    {},
    {"_MEET_BITS": 58},
    {"_MEET_BITS": 66},
    {"_MEET_BITS": 70},
    {"_MEET_BITS": 90},
    {"_TWO_A_SM": 233472 // 3 - 1024},
)


def s1f64_inputs(tree: str):
    """S1's inputs: ``[(label, b, level, axis)]`` at (b)'s level 6 along
    each axis in float64 and in float32 (the float32 solves, for float32
    S1's times beside them), then the 24 solves of a float64 256^3
    field's orthogonal components.  The timing lines go to a log of this
    process beside ``chip_smoke.py``'s own."""
    import torch
    import chip_smoke
    from chip_smoke import LONG_FIELD, SEED, smooth_field_card
    chip_smoke.LOG_FILE = os.path.join(
        os.path.dirname(chip_smoke.LOG_FILE),
        f"chip_probe_{os.getpid()}.log")
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import norms, transform, tridiag

    if not os.path.samefile(os.path.dirname(mt.__file__),
                            os.path.join(tree, "mgard_tpu_torch")):
        raise RuntimeError(f"imported {mt.__file__}, not {tree}'s package")
    hier = mt.Hierarchy(LONG_FIELD)
    l = hier.L
    top = transform.decompose(hier, smooth_field_card(
        LONG_FIELD, seed=SEED + 1))[l]
    cases = []
    for dtype, name in ((torch.float64, ""), (torch.float32, " float32")):
        B = top.to(dtype)
        for d in transform._level_dims(hier, l):
            B = tridiag.mass_apply(B, hier.dims[d][l].h, d)
            B = transform.restrict(B, hier.dims[d][l], d)
        for d in transform._level_dims(hier, l):
            B = B.contiguous()
            lev = hier.dims[d][l - 1]
            cases.append((f"(b){name} level {l} axis {d}", B, lev, d))
            B = tridiag.mass_solve(B, lev.offdiag, lev.divisors, d)
        del B
    del top
    shape = (256,) * 3
    h256 = mt.Hierarchy(shape)
    u = smooth_field_card(shape, seed=SEED + 1).double()
    saved = norms.mass_solve

    def keep(b, offdiag, divisors, axis):
        lev = next(lv for lv in h256.dims[axis] if lv.divisors is divisors)
        cases.append((f"256^3 components {tuple(b.shape)} axis {axis}",
                      b.clone(), lev, axis))
        return saved(b, offdiag, divisors, axis)

    norms.mass_solve = keep
    try:
        norms.orthogonal_component_square_norms(h256, u)
    finally:
        norms.mass_solve = saved
    del u
    torch.cuda.empty_cache()
    return cases


def s1f64_row(label, b, lev, axis, walks, ms) -> dict:
    """A timed solve's row: its ms, bound, share, walks, and where the
    tree has float64 routes its route, threads and blocks an SM."""
    from chip_smoke import bound_ms, s1_bytes
    from mgard_tpu_torch.ops import tridiag
    row = {"label": label, "shape": list(b.shape), "axis": axis, "ms": ms,
           "bound_ms": bound_ms(s1_bytes(b, axis), 0)[0],
           "walks": walks.tolist()}
    row["share"] = row["bound_ms"] / ms
    if hasattr(tridiag, "solve_overlap"):
        n, size = b.shape[axis], b.element_size()
        geo = tridiag.solve_geometry(n, b.numel() // n, size, None,
                                     tridiag.solve_overlap(
                                         lev.offdiag, lev.divisors, size))
        per_sm = tridiag._blocks_an_sm(geo.smem, geo.threads, *(
            (size,) if "itemsize" in inspect.signature(
                tridiag._blocks_an_sm).parameters else ()))
        row.update(route=geo.route, lines=geo.lines, threads=geo.threads,
                   run=geo.run, nseg=geo.nseg, overlap=geo.overlap,
                   blocks_an_sm=per_sm)
    return row


def s1f64_time(label, b, lev, axis, library=True) -> dict:
    """One float64 S1 solve: bit for bit against its plain version, its
    median ms in queued turns, its bound, its walks, its route where the
    tree has float64 routes, and a tensordot's median ms."""
    import torch
    from chip_smoke import bits_equal, s1_library_ms, turns_median
    from mgard_tpu_torch.ops import tridiag
    plain = tridiag.mass_solve_plain(b, lev.offdiag, lev.divisors, axis)
    walks = torch.zeros(2, dtype=torch.int32, device=b.device)
    same = bits_equal(tridiag.mass_solve(b, lev.offdiag, lev.divisors,
                                         axis, walks=walks), plain)
    del plain
    if not same:
        raise AssertionError(f"{label}: S1 differs from its plain version")
    with tridiag.table_scope():
        ms = turns_median(label, lambda: tridiag.mass_solve(
            b, lev.offdiag, lev.divisors, axis))
    row = s1f64_row(label, b, lev, axis, walks, ms)
    if library:
        row["tensordot_ms"] = s1_library_ms(b, lev, axis, label)[0]
    return row


# Long series of float64 S1: (shape, axis), fewer than 32 lines.
SERIES = (((1 << 24) + 1,), 0), ((4, (1 << 22) + 1), 1), \
    (((1 << 22) + 1, 4), 0)


_SERIES_LEVELS = {}


def s1f64_series(only=None) -> list:
    """float64 S1 on each of ``SERIES`` (and float32 on the first): normal
    data from a seed, on a uniform level of its length; bit for bit
    against S1 cut into 256 runs of 16 nodes a block (the runs kernel's
    other geometry; exact either way), its float64 residual within
    ``chip_smoke.SOLVE_RESIDUAL_BOUND``, then timed in turns."""
    import torch
    import mgard_tpu_torch as mt
    from chip_smoke import SOLVE_RESIDUAL_BOUND, bits_equal, \
        solve_residual, turns_median
    from mgard_tpu_torch.ops import tridiag
    rows = []
    g = torch.Generator(device="cuda").manual_seed(7)
    for k, (shape, axis) in enumerate(SERIES):
        n = shape[axis]
        if n not in _SERIES_LEVELS:
            _SERIES_LEVELS[n] = mt.Hierarchy((n,)).dims[0][-1]
        lev = _SERIES_LEVELS[n]
        for dtype in (torch.float64, torch.float32)[:2 if k == 0 else 1]:
            if only is not None and dtype != only:
                continue
            b = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            label = f"series {shape} axis {axis} {str(dtype)[6:]}"
            walks = torch.zeros(2, dtype=torch.int32, device="cuda")
            x = tridiag.mass_solve(b, lev.offdiag, lev.divisors, axis,
                                   walks=walks)
            other = tridiag.mass_solve(b, lev.offdiag, lev.divisors, axis,
                                       segment=4096)
            with tridiag.table_scope():
                res = solve_residual(b, x, lev, axis)
            if not bits_equal(x, other) or not res <= SOLVE_RESIDUAL_BOUND:
                raise AssertionError(f"{label}: S1 differs at another cut, "
                                     f"or its residual is {res}")
            del x, other
            with tridiag.table_scope():
                ms = turns_median(label, lambda: tridiag.mass_solve(
                    b, lev.offdiag, lev.divisors, axis))
            row = s1f64_row(label, b, lev, axis, walks, ms)
            row["residual"] = res
            rows.append(row)
            del b
        torch.cuda.empty_cache()
    return rows


def run_s1f64(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, HERE)
    import torch
    from chip_smoke import LONG_FIELD, SEED, TOL, cuda_ms, \
        smooth_field_card
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import _build

    _build.lib()
    rows = [s1f64_time(*case) for case in s1f64_inputs(tree)]
    comps = [r for r in rows if r["label"].startswith("256^3")]
    res = {"tree": tree, "solves": rows,
           "components_ms": sum(r["ms"] for r in comps),
           "components_bound_ms": sum(r["bound_ms"] for r in comps),
           "components_tensordot_ms": sum(r["tensordot_ms"] for r in comps)}
    torch.cuda.empty_cache()
    res["series"] = s1f64_series()
    comp = mt.get_compressor(LONG_FIELD, np.float64, device="cuda")
    v = smooth_field_card(LONG_FIELD, seed=SEED + 1).double()
    enc = comp.encode_device(v, TOL)
    res["f64_encode_ms"] = cuda_ms(lambda: comp.encode_device(v, TOL), 3)
    res["f64_decode_ms"] = cuda_ms(lambda: comp.decode_device(
        enc[0], enc[1], TOL), 3)
    res["f64_encode_decode_ms"] = res["f64_encode_ms"] + res["f64_decode_ms"]
    return res


def run_s1f64_runs() -> dict:
    """float64 S1 on ``SERIES`` (:func:`s1f64_series`) once at the default
    geometry and once at each (threads, run) of the runs kernel that
    fits a block, forced by a wrapper of ``tridiag.solve_geometry``."""
    sys.path.insert(0, HERE)
    import torch
    from mgard_tpu_torch.ops import _build, tridiag
    _build.lib()
    saved = tridiag.solve_geometry
    res = {"tree": HERE, "default": s1f64_series(torch.float64)}
    for t in (32, 64, 128, 256):
        for run in (6, 8, 11, 16, 20, 26, 40, 60, 80):

            def forced(n, m, itemsize, segment=None, overlap=None):
                if itemsize != 8 or m >= 32 or segment is not None:
                    return saved(n, m, itemsize, segment, overlap)
                ovl = int(overlap)
                smem = tridiag.solve_smem(1, run, t * run, n, ovl, 8, t,
                                          "runs")
                nseg = -(-n // (t * run))
                return tridiag.SolveGeometry(1, run, t * run, nseg, ovl,
                                             smem, m * nseg, t, "runs")

            if tridiag.solve_smem(1, run, t * run, 1 << 20, 40, 8, t,
                                  "runs") > tridiag._SMEM_MAX:
                continue
            tridiag.solve_geometry = forced
            try:
                rows = s1f64_series(torch.float64)
            finally:
                tridiag.solve_geometry = saved
            res.setdefault("forced", []).append(
                {"threads": t, "run": run, "rows": rows})
    return res


def run_s1f64_sweep() -> dict:
    sys.path.insert(0, HERE)
    import torch
    from mgard_tpu_torch.ops import _build, tridiag

    _build.lib()
    cases = [c for c in s1f64_inputs(HERE) if c[1].dtype == torch.float64
             and (c[0].startswith("(b)") or c[1].shape[c[3]] in (65, 129))]
    saved = {k: getattr(tridiag, k) for st in S1F64_SWEEP for k in st}
    res = {"tree": HERE, "settings": []}
    for setting in S1F64_SWEEP:
        for k, v in setting.items():
            setattr(tridiag, k, v)
        tridiag._OVERLAPS.clear()
        try:
            rows = [s1f64_time(*c, library=False) for c in cases]
        finally:
            for k, v in saved.items():
                setattr(tridiag, k, v)
            tridiag._OVERLAPS.clear()
        res["settings"].append({"setting": setting, "solves": rows})
    return res


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
    if args[:1] == ["--one-s1f64"]:
        print(json.dumps(run_s1f64(args[1])), flush=True)
        return 0
    if args[:1] == ["--s1f64-runs"]:
        print(json.dumps(run_s1f64_runs()), flush=True)
        return 0
    if args[:1] == ["--s1f64-sweep"]:
        print(json.dumps(run_s1f64_sweep()), flush=True)
        return 0
    one = "--one"
    if args[:1] == ["--ptxas"]:
        ptxas_report()
        args = args[1:]
    if args[:1] in (["--api"], ["--hierarchy"], ["--s1f64"]):
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

#!/usr/bin/env python3
"""Smoke test of mgard_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (one ``nvcc`` call), holds each kernel
against its plain PyTorch version at the shapes of the main path,
drives the main path once through the public API (a 512^3 float32 field
compressed at an absolute L-infinity tolerance of 1e-3 and decompressed
again), checks the result, and prints one JSON line per kernel summary
and a last line ``{"ok": true, "device": {...}}``.  Any failure raises
and the script exits non-zero; without a CUDA device it exits non-zero
before doing anything.

Phases (each prints its wall time):
  1. setup   - card name and power limit, versions, the kernel build;
  2. kernels - K1-K4 against their plain versions, on the main path's
               own inputs (the decomposition of the field), bit-identical,
               timed with CUDA events;
  3. main    - mgard_tpu_torch.compress / decompress at 512^3 with the
               launch counters set to 0 just before and read just after;
               then the device and host parts timed separately, and a
               65^3 cross-check of the card against the CPU path;
  4. summary - the kernels line, the card line, the ok line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SHAPE = (512, 512, 512)
TOL = 1e-3
SEED = 0
# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside
# the tensor cores (the rate the scalar integer and float work of these
# kernels is counted against).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Scalar operations per value: quantize (scale, abs, add, finiteness and
# overflow tests, trunc, cast, sign, zigzag), the 32x32 butterfly (480
# per 32 values) and dequantize (unzigzag, cast, scale).
OPS_QUANT, OPS_BUTTERFLY, OPS_DEQUANT = 10, 15, 6


def log(msg: str) -> None:
    print(msg, flush=True)


def smooth_field_host(shape, seed=SEED):
    """bench.py's smooth test field (three separable cosine modes plus
    1e-3 Gaussian noise), built with numpy from ``seed``."""
    x = [np.linspace(0.0, 1.0, s, dtype=np.float32) for s in shape]
    f = np.zeros(shape, dtype=np.float32)
    for k in (1, 3, 7):
        term = np.ones(shape, dtype=np.float32)
        for d, xx in enumerate(x):
            shp = [1] * len(shape)
            shp[d] = len(xx)
            term = term * np.cos(np.pi * k * xx + 0.1 * k * (d + 1)
                                 ).reshape(shp)
        f = f + term / k
    rng = np.random.default_rng(seed)
    return (f + 0.001 * rng.standard_normal(shape).astype(np.float32)
            ).astype(np.float32)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        log(f"== phase {self.name}: {time.perf_counter() - self.t0:.3f} s"
            + (" (failed)" if exc[0] else ""))
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` runs, by CUDA events, after one
    warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_diff(a, b) -> float:
    import torch
    if a.dtype.is_floating_point:
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            return float((a - b).abs().max()) or float("nan")
        return 0.0
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def check_kernels(hier, v):
    """K1-K4 against their plain versions on the main path's inputs."""
    import torch
    from mgard_tpu_torch.ops import bitplane, bp_kernels as bk
    from mgard_tpu_torch.ops import extract_kernels as xk, transform
    from mgard_tpu_torch.ops.quantize import inverse_quantum, \
        supremum_quantum

    results = []

    def add(name, source, replaces, err, ms, plain_ms, nbytes, ops,
            library_ms=None):
        b, by = bound_ms(nbytes, ops)
        log(f"kernel {name}: max_abs_err={err} (tolerance 0: "
            f"bit-identical) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}) "
            f"library_ms={library_ms}")
        if err != 0.0:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        results.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b, bound_by=by,
                            library_ms=library_ms))

    # K1 at every level of the decomposition its gate admits
    k1_inputs, A = [], v
    for l in range(hier.L, 0, -1):
        if xk.extract_supported(hier, l, A):
            k1_inputs.append((l, A))
        C = transform._extract_old_all(hier, A, l)
        detail = A - transform._prolong_all(hier, C, l)
        A = C + transform._correction(hier, detail, l)
    del C, detail, A
    idx = {l: xk._coarse_index(hier, l, v.device) for l, _ in k1_inputs}
    err = max(max_abs_diff(xk.extract_coarse_3d(hier, a, l),
                           xk.extract_coarse_3d_plain(a, idx[l]))
              for l, a in k1_inputs)
    k1 = lambda: [xk.extract_coarse_3d(hier, a, l) for l, a in k1_inputs]
    k1_plain = lambda: [xk.extract_coarse_3d_plain(a, idx[l])
                        for l, a in k1_inputs]
    meshes = {l: (i[0].long()[:, None, None], i[1].long()[None, :, None],
                  i[2].long()[None, None, :]) for l, i in idx.items()}
    k1_lib = lambda: [a[meshes[l]] for l, a in k1_inputs]
    nbytes = sum(4 * (len(idx[l][0]) * len(idx[l][1]) * a.shape[2]
                      + len(idx[l][0]) * len(idx[l][1]) * len(idx[l][2]))
                 for l, a in k1_inputs)
    add("extract_coarse_3d", "mgard_tpu_torch/csrc/extract.cu",
        "mgard_tpu/ops/extract_kernels.py:84", err, cuda_ms(k1, 5),
        cuda_ms(k1_plain, 3), nbytes, 0, library_ms=cuda_ms(k1_lib, 3))
    del k1_inputs

    # K2-K4 on the pyramid of the main path
    pyr = [p.reshape(-1).contiguous() for p in transform.decompose(hier, v)]
    C = bitplane.CHUNK_GROUPS
    inv_q = float(inverse_quantum(hier, TOL))
    quantum = float(supremum_quantum(hier, TOL))
    ncs = [bitplane.num_chunks_tiled(p.numel(), C) for p in pyr]
    nvals = sum(p.numel() for p in pyr)

    got = [bk.bp_quant_max(p, nc, C, inv_q) for p, nc in zip(pyr, ncs)]
    want = [bk.bp_quant_max_plain(p, nc, C, inv_q) for p, nc in zip(pyr, ncs)]
    err = max(max(max_abs_diff(g[0], w[0]), max_abs_diff(g[1], w[1]))
              for g, w in zip(got, want))
    if any(int(g[1].max()) for g in got):
        raise AssertionError("main-path data gave a nonzero codec status")
    add("bp_quant_max", "mgard_tpu_torch/csrc/bp_codec.cu",
        "mgard_tpu/ops/pallas_kernels.py:536", err,
        cuda_ms(lambda: [bk.bp_quant_max(p, nc, C, inv_q)
                         for p, nc in zip(pyr, ncs)], 5),
        cuda_ms(lambda: [bk.bp_quant_max_plain(p, nc, C, inv_q)
                         for p, nc in zip(pyr, ncs)], 2),
        4 * nvals + 8 * sum(ncs), (OPS_QUANT + 1) * nvals)

    e = bitplane._bit_length32(torch.cat([g[0] for g in got]))
    offsets = bitplane._offsets(e)
    starts = np.concatenate([[0], np.cumsum(ncs)]).astype(int)
    rows = int(e.sum())
    cap = sum(ncs) * 33 * C
    words = torch.zeros(cap, dtype=torch.int32, device=v.device)
    words_plain = torch.zeros_like(words)

    def k3(fn, buf):
        for p, nc, a in zip(pyr, ncs, starts):
            fn(p, nc, C, inv_q, offsets[a:a + nc], e[a:a + nc], buf)
    k3(bk.bp_quant_condense, words)
    k3(bk.bp_quant_condense_plain, words_plain)
    err = max_abs_diff(words, words_plain)
    add("bp_quant_condense", "mgard_tpu_torch/csrc/bp_codec.cu",
        "mgard_tpu/ops/pallas_kernels.py:481", err,
        cuda_ms(lambda: k3(bk.bp_quant_condense, words), 5),
        cuda_ms(lambda: k3(bk.bp_quant_condense_plain, words_plain), 2),
        4 * nvals + 4 * rows * C + 8 * sum(ncs),
        (OPS_QUANT + OPS_BUTTERFLY) * nvals)
    del words_plain

    stream = words[:rows * C]

    def k4(fn):
        return [fn(stream, C, offsets[a:a + nc], e[a:a + nc], quantum,
                   p.numel()) for p, nc, a in zip(pyr, ncs, starts)]
    err = max(max_abs_diff(g, w) for g, w in
              zip(k4(bk.bp_decode_condense_f32),
                  k4(bk.bp_decode_condense_f32_plain)))
    add("bp_decode_condense_f32", "mgard_tpu_torch/csrc/bp_codec.cu",
        "mgard_tpu/ops/pallas_kernels.py:621", err,
        cuda_ms(lambda: k4(bk.bp_decode_condense_f32), 5),
        cuda_ms(lambda: k4(bk.bp_decode_condense_f32_plain), 2),
        4 * rows * C + 4 * nvals + 8 * sum(ncs),
        (OPS_BUTTERFLY + OPS_DEQUANT) * nvals)
    log(f"codec inputs: {len(pyr)} segments, {nvals} values, {sum(ncs)} "
        f"chunks, {rows} stream rows of {C} words")
    return results


def main_path(v_host):
    """The user's path once, with the launch counters around it."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import bp_kernels as bk

    bk.reset_launches()
    t0 = time.perf_counter()
    buf = mt.compress(v_host, TOL)
    t1 = time.perf_counter()
    out = mt.decompress(buf)
    t2 = time.perf_counter()
    counts = bk.launch_counts()
    log(f"main path: compress {1e3 * (t1 - t0):.3f} ms, decompress "
        f"{1e3 * (t2 - t1):.3f} ms (host clock, H2D and D2H included); "
        f"launches {counts}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if out.shape != v_host.shape or out.dtype != np.float32:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    if not np.isfinite(out).all():
        raise AssertionError("non-finite output")
    err = float(np.abs(out.astype(np.float64) - v_host).max())
    ratio = v_host.nbytes / len(buf)
    log(f"main path: max|v - out| = {err!r} (tolerance {TOL}), ratio "
        f"{ratio!r}, {len(buf)} bytes")
    if not err <= TOL:
        raise AssertionError(f"error {err} exceeds the tolerance {TOL}")
    del out
    torch.cuda.synchronize()
    return buf, counts


def time_parts(v_host, buf):
    """Device encode/decode by CUDA events; host parts by host clock."""
    import torch
    from mgard_tpu_torch.api import compressor_for
    from mgard_tpu_torch.io import format as fmt

    header, sections = fmt.read_container(buf)
    comp = compressor_for(header)
    v = torch.from_numpy(v_host).cuda()
    enc_ms = cuda_ms(lambda: comp.encode_device(v, TOL), 3)
    outs = comp.encode_device(v, TOL)
    t0 = time.perf_counter()
    secs = comp.sections_from_outputs(*outs)
    t1 = time.perf_counter()
    fmt.write_container(header, secs)
    t2 = time.perf_counter()
    header2, sections2 = fmt.read_container(buf)
    exps, words = comp.stream_tensors(header2, sections2)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    dec_ms = cuda_ms(lambda: comp.decode_device(exps, words, TOL), 3)
    out = comp.decode_device(exps, words, TOL)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    out.cpu()
    t5 = time.perf_counter()
    gb = v_host.nbytes / 1e9
    log(f"device encode {enc_ms:.3f} ms ({gb / enc_ms * 1e3:.2f} GB/s), "
        f"device decode {dec_ms:.3f} ms ({gb / dec_ms * 1e3:.2f} GB/s)")
    log(f"host: read-back + sections {1e3 * (t1 - t0):.3f} ms, container "
        f"write {1e3 * (t2 - t1):.3f} ms, container read + H2D "
        f"{1e3 * (t3 - t2):.3f} ms, decoded D2H {1e3 * (t5 - t4):.3f} ms")


def small_reference_check():
    """65^3: the card's containers decode on the CPU path within the
    tolerance and the other way round, and the card's pyramid agrees
    with the CPU's."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import transform

    shape, tol = (65, 65, 65), 1e-3
    v = smooth_field_host(shape, seed=1)
    cfg = mt.Config(adapt_lossless=False)
    hier = mt.Hierarchy(shape)
    pg = transform.decompose(hier, torch.from_numpy(v).cuda())
    pc = transform.decompose(hier, torch.from_numpy(v))
    rel = max(float((a.cpu() - b).abs().max()) for a, b in zip(pg, pc)) \
        / float(np.abs(v).max())
    if not rel <= 1e-5:
        raise AssertionError(f"card and CPU pyramids differ by {rel}")
    b_gpu = mt.compress(v, tol, config=cfg)
    b_cpu = mt.compress(v, tol, config=cfg, device="cpu")
    errs = [float(np.abs(mt.decompress(b, device=d) - v).max())
            for b in (b_gpu, b_cpu) for d in ("cuda", "cpu")]
    log(f"65^3 reference check: pyramid rel diff {rel!r}, cross-decode "
        f"errors {errs}, same bytes {b_gpu == b_cpu}")
    if not max(errs) <= tol:
        raise AssertionError(f"cross-decode error {max(errs)} > {tol}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs only on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import _build

    with Phase("setup"):
        card = card_line()
        log(f"card: {card}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
            f"{sys.version.split()[0]}, device "
            f"{torch.cuda.get_device_name(0)}")
        _build.build()
        _build.lib()
        log(f"kernel build: {_build.build_seconds:.2f} s "
            f"({' '.join(_build.build_command(_build.LIB_PATH))})")

    with Phase("data"):
        v_host = smooth_field_host(SHAPE)
        hier = mt.Hierarchy(SHAPE)
        log(f"field {SHAPE} float32, {v_host.nbytes} bytes, L = {hier.L}")

    with Phase("kernels"):
        v = torch.from_numpy(v_host).cuda()
        kernels = check_kernels(hier, v)
        del v
        torch.cuda.empty_cache()

    with Phase("main path"):
        buf, counts = main_path(v_host)

    with Phase("timing"):
        time_parts(v_host, buf)

    with Phase("reference"):
        small_reference_check()

    for k in kernels:
        k["launches"] = counts[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

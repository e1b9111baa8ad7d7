"""Batched tridiagonal (mass-matrix) apply and solve along one axis (the
port of ``mgard_tpu/ops/tridiag.py``).

The 1-D mass matrix on a grid with spacings ``h`` is symmetric tridiagonal:

    diag    = [h0/3, (h0+h1)/3, ..., (h_{n-3}+h_{n-2})/3, h_{n-2}/3]
    offdiag = h/6

(reference ``ConstituentMassMatrix``, include/TensorMassMatrix.tpp:14-90).
The inverse is the Thomas algorithm with the divisors the hierarchy
precomputes per level (``ConstituentMassMatrixInverse``,
TensorMassMatrix.tpp:123-290).

The solve is sequential along its axis and parallel across the others.
The JAX package writes it as a ``lax.scan`` over planes of the solve
axis, which XLA runs as a loop on the device.  Here :func:`mass_solve`
launches S1, a hand-written CUDA Thomas solve (``csrc/tridiag.cu``), for a
CUDA tensor, and runs :func:`mass_solve_plain`, a Python loop over the
same planes, for a CPU tensor.  Two callers: the transform's correction
wherever a level does not take the dense matrices (a dim over
``MGARD_TPU_MATMUL_MAX_N`` nodes, or ``MGARD_TPU_SOLVER=scan``;
``ops/transform.py``), and the s-norms (``ops/norms.py``) at every level.
:func:`mass_apply` stays plain torch, as it is plain XLA in JAX.

Host tables that the operators read (spacings, ratios, indices, the
solve's coefficients) are converted to the data's type on the host once,
into page-locked memory when a card is present, and kept there as long
as the host array they come from lives; they are copied to a card as
the operators need them (:func:`cached_tensor`).  Inside a
:func:`table_scope` a table is copied once and dropped when the innermost
open scope closes: the compressor opens one for each encode and decode,
and the transform one for each level, so that no such table stays on the
card after the call and at most one level's tables are there at a time.
Outside any scope a table is copied for each use.
"""

from __future__ import annotations

import contextlib
import math
import mmap
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..utils import log
from . import _build

__all__ = ["mass_apply", "mass_solve", "mass_solve_plain", "solve_tables",
           "solve_geometry", "solve_overlap", "SolveGeometry",
           "cached_tensor", "table_scope", "pad_fold", "along_axis"]

# S1's tiles (csrc/tridiag.cuh).  float32: 256 threads a block; shared
# memory aimed at three blocks an SM, else two, at most what one block
# may have (H100); a run of _SOLVE_RUN nodes a thread where a block takes
# one line; runs and tiles start _SOLVE_OVERLAP[4] nodes early (the
# sweeps contract by about 0.27 a step: float32 meets in ~13 steps).
# float64 starts them the level's overlap early (solve_overlap), the
# steps that contract a guess's error to 2^-_MEET_BITS (half an ulp with
# a margin of 2^20, for values that shrink along a line: at 2^-58 the
# (64, 512, 8192) field's level 6 walked thousands of runs on an H100),
# _SOLVE_OVERLAP[8] where the level is not known.
_SOLVE_THREADS = 256
_SOLVE_SMEM = (74 * 1024, 110 * 1024)
_SMEM_MAX = 232448
_SOLVE_RUN = 16
_SOLVE_OVERLAP = {4: 32, 8: 40}
_TILE_LINES = (256, 128, 64, 32)
_MEET_BITS = 74
_OVERLAP_MAX = 128
# float64's routes: an H100 has _SMS SMs of _SM_SMEM bytes of shared
# memory (a block takes 1 KB more than it asks for), _SM_THREADS threads
# and _SM_REGS registers, of which float64's kernels take up to
# _F64_REGS a thread (ptxas: 80 to 108); a line shorter than
# _SHORT_OVERLAPS overlaps is not split (one thread solves it, in a tile
# of at most _SHORT_SMEM bytes where the level has the lines for two
# such blocks an SM); every tile fits two blocks an SM (_TWO_A_SM).
_SMS = 132
_SM_SMEM = 233472
_SM_THREADS = 2048
_SM_REGS = 65536
_F64_REGS = 128
_SHORT_OVERLAPS = 4
_SHORT_SMEM = 40 * 1024
_TWO_A_SM = _SM_SMEM // 2 - 1024
_ROUTES = {"runs": 0, "lines": 1, "short": 2}

# The open table scopes, innermost last: each maps a key to a table made
# while it was the innermost one.
_SCOPES = []


@contextlib.contextmanager
def table_scope():
    """Tables that :func:`cached_tensor` and :func:`mass_solve` copy to a
    card while this scope is the innermost open one are copied once and
    dropped when it closes (those of an enclosing scope stay)."""
    _SCOPES.append({})
    try:
        yield
    finally:
        _SCOPES.pop()


def _kept(arr: np.ndarray, key: tuple, build):
    """``build()``, made once per ``key`` and host array ``arr`` in the
    innermost open :func:`table_scope` (or taken from an enclosing one
    that made it); made anew for each call when no scope is open."""
    if not _SCOPES:
        return build()
    key = (id(arr),) + key
    for scope in reversed(_SCOPES):
        hit = scope.get(key)
        if hit is not None:
            return hit
    # the scope holds the array too, so that its id is not reused
    hit = _SCOPES[-1][key] = build()
    _SCOPES[-1][("array",) + key] = arr
    return hit


_HOST = {}


def _locked(t: torch.Tensor) -> torch.Tensor:
    """A copy of the CPU tensor ``t``; when a card is present, in pages of
    its own (no other allocation shares them, so that no two tables lock
    one page) registered with ``cudaHostRegister``, so that its copies to
    a card are queued without waiting and run at the bus's rate."""
    if not torch.cuda.is_available() or t.numel() == 0:
        return t.clone()
    nbytes = t.numel() * t.element_size()
    span = -(-nbytes // mmap.PAGESIZE) * mmap.PAGESIZE
    raw = torch.empty(span + mmap.PAGESIZE, dtype=torch.uint8)
    start = -raw.data_ptr() % mmap.PAGESIZE
    out = raw[start:start + nbytes].view(t.dtype).view(t.shape)
    out.copy_(t)
    err = torch.cuda.cudart().cudaHostRegister(out.data_ptr(), span, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister failed: {err}")
    out._mgard_locked = span
    return out


def _drop_host(key) -> None:
    hit = _HOST.pop(key, None)
    for t in hit if isinstance(hit, tuple) else (hit,):
        if getattr(t, "_mgard_locked", 0):
            copied = getattr(t, "_mgard_copied", None)
            if copied is not None:
                copied.synchronize()        # no copy still reads it
            torch.cuda.cudart().cudaHostUnregister(t.data_ptr())


def locked_bytes() -> int:
    """Bytes of host memory that the host tables hold page-locked."""
    return sum(getattr(t, "_mgard_locked", 0) for hit in _HOST.values()
               for t in (hit if isinstance(hit, tuple) else (hit,)))


def _host_kept(arr: np.ndarray, key: tuple, build):
    """``build()`` (a CPU tensor or a tuple of them, which may share
    memory with ``arr``), copied once per ``key`` and host array ``arr``
    (:func:`_locked`) and dropped with the array: the host side of a
    table, which the calls that need it copy to the card
    (:func:`_upload`)."""
    key = (id(arr),) + key
    hit = _HOST.get(key)
    if hit is None:
        hit = build()
        hit = tuple(map(_locked, hit)) if isinstance(hit, tuple) \
            else _locked(hit)
        _HOST[key] = hit
        weakref.finalize(arr, _drop_host, key)
    return hit


def _upload(host: torch.Tensor, device) -> torch.Tensor:
    """A host table's copy on ``device``, queued on its current stream
    without waiting; an event recorded after it tells when the host
    pages are free again.  Its bytes go to the counter ``tables.bytes``
    (``utils/log.count``)."""
    log.count("tables.bytes", host.numel() * host.element_size())
    out = host.to(device, non_blocking=True)
    if getattr(host, "_mgard_locked", 0):
        host._mgard_copied = torch.cuda.Event()
        host._mgard_copied.record(torch.cuda.current_stream(device))
    return out


def _on_card(device) -> bool:
    return torch.device(device).type != "cpu"


def cached_tensor(arr: np.ndarray, dtype: torch.dtype, device
                  ) -> torch.Tensor:
    """``torch.as_tensor(arr, dtype, device)``; on a card copied from a
    host tensor converted once per array and type (:func:`_host_kept`),
    as :func:`_kept` says.  A CPU tensor may share the array's memory, so
    it is made anew each time."""
    if not _on_card(device):
        return torch.as_tensor(arr, dtype=dtype, device=device)
    host = _host_kept(arr, (dtype,), lambda: torch.as_tensor(arr,
                                                             dtype=dtype))
    return _kept(arr, (dtype, str(device)), lambda: _upload(host, device))


def along_axis(vec, like: torch.Tensor, axis: int) -> torch.Tensor:
    """A float64 vector in ``like``'s dtype and device, shaped to
    broadcast along ``axis`` of ``like``."""
    shp = [1] * like.dim()
    shp[axis] = len(vec)
    if isinstance(vec, np.ndarray):
        t = cached_tensor(vec, like.dtype, like.device)
    else:
        t = torch.as_tensor(np.asarray(vec), dtype=like.dtype,
                            device=like.device)
    return t.reshape(shp)


def mass_apply(v: torch.Tensor, h: np.ndarray, axis: int) -> torch.Tensor:
    """Apply the 1-D mass matrix along ``axis`` of ``v``; ``h``: the
    (n-1,) spacings of this level's grid in that dim."""
    n = v.shape[axis]
    if n < 2:
        raise ValueError("mass_apply requires >= 2 nodes along axis")
    hb = along_axis(h, v, axis)
    lo = v.narrow(axis, 0, n - 1)
    hi = v.narrow(axis, 1, n - 1)
    # each interval [x_j, x_{j+1}] adds h/3 * its own end + h/6 * the
    # other to each of its two nodes: left = third*lo + sixth*hi to node
    # j, right = sixth*lo + third*hi to node j+1.  The JAX package sums
    # the two zero-padded arrays; the same float operations run here in
    # place, in one output and two temporaries: out[:-1] = left, out[-1]
    # = 0, out[1:] += right, and out[0] += 0, the pad's zero, which
    # turns a -0 into +0 as the padded sum does
    third = hb / 3
    sixth = hb / 6
    out = torch.empty_like(v)
    out_lo = out.narrow(axis, 0, n - 1)
    torch.mul(third, lo, out=out_lo)
    tmp = sixth * hi
    out_lo += tmp
    out.narrow(axis, n - 1, 1).zero_()
    torch.mul(third, hi, out=tmp)
    right = sixth * lo
    right += tmp
    del tmp
    out.narrow(axis, 1, n - 1).add_(right)
    del right
    out.narrow(axis, 0, 1).add_(0.0)
    return out


def pad_fold(old: torch.Tensor, left_fn, right_fn, k: int, axis: int
             ) -> torch.Tensor:
    """``old + pad(left, 0, nc - k) + pad(right, 1, nc - k - 1)`` along
    ``axis``, with ``left = left_fn()`` and ``right = right_fn()`` of
    length ``k`` there and ``nc`` that of ``old``: summed left to right as
    the JAX package sums the padded arrays, into one new tensor, each
    temporary made only when it is added."""
    nc = old.shape[axis]
    out = torch.empty(old.shape, dtype=old.dtype, device=old.device)
    torch.add(old.narrow(axis, 0, k), left_fn(), out=out.narrow(axis, 0, k))
    # the pads' zeros: x + 0 turns a -0 into +0, and adding 0 twice is
    # adding it once
    torch.add(old.narrow(axis, k, nc - k), 0.0,
              out=out.narrow(axis, k, nc - k))
    out.narrow(axis, 1, k).add_(right_fn())
    out.narrow(axis, 0, 1).add_(0.0)
    return out


def solve_tables(offdiag: np.ndarray, divisors: np.ndarray, dtype):
    """``(w, off, div)``: the solve's coefficients in ``dtype`` (a torch
    float type), as the JAX package casts them; ``w = off / div[:-1]`` is
    taken in that type."""
    npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    off = np.asarray(offdiag).astype(npdt)
    div = np.asarray(divisors).astype(npdt)
    return off / div[:-1], off, div


def _device_tables(offdiag, divisors, dtype, device):
    """S1's tables ``(off, div)`` in ``dtype`` (it divides ``w`` itself),
    on ``device``, kept as :func:`_kept` says, copied from host tensors
    made once per level."""
    host = _host_kept(divisors, ("solve", dtype), lambda: tuple(
        torch.from_numpy(a) for a in solve_tables(offdiag, divisors,
                                                  dtype)[1:]))
    return _kept(divisors, ("solve", dtype, str(device)), lambda: tuple(
        _upload(t, device) for t in host))


class SolveGeometry(NamedTuple):
    """S1's launch: ``lines`` lines a tile (1: one line a block, the runs
    kernel), ``run`` nodes a thread's run, ``segment`` nodes of a line a
    block owns, ``nseg`` segments a line, ``overlap`` nodes a run or a
    tile starts early, ``smem`` bytes of shared memory a block,
    ``blocks`` blocks of the tile kernel, ``threads`` threads a block,
    ``route`` the kernel: "runs", "lines" or "short" (one thread a whole
    line, ``lines`` = ``threads``)."""
    lines: int
    run: int
    segment: int
    nseg: int
    overlap: int
    smem: int
    blocks: int
    threads: int = _SOLVE_THREADS
    route: str = "lines"


def solve_smem(lines: int, run: int, segment: int, n: int, overlap: int,
               itemsize: int, threads: int = _SOLVE_THREADS,
               route=None) -> int:
    """Shared memory of one S1 block, in bytes (``smem_bytes`` of
    csrc/tridiag.cuh); ``route`` defaults to "runs" for one line a
    block, else "lines"."""
    route = route or ("runs" if lines == 1 else "lines")
    # off, div, w and, in float64, 1 / div of each node of a tile
    tables = 4 if itemsize == 8 else 3
    if route == "short":
        return (lines * (n | 1) + tables * n) * itemsize
    probes = (3 * itemsize + 4) * threads
    if route == "runs":
        pad = -(-overlap // run) * run
        return 4 * (segment + 2 * pad) // run * (run + 1) * itemsize + probes
    width = min(n, segment + 2 * overlap)
    return (lines * (width | 1) + tables * width) * itemsize + probes


_OVERLAPS = {}


def _meet_steps(offdiag: np.ndarray, divisors: np.ndarray) -> int:
    """The fewest steps k such that every k consecutive factors
    |w_i| = |off_i / div_i| of a level multiply to 2^-_MEET_BITS or
    less (windows taken in chunks of 2^20 factors, each made on its own,
    so a long level needs little memory); n where no k below n does
    (such a line is never split), and _OVERLAP_MAX where none up to it
    does on a longer line."""
    n = len(divisors)
    offdiag, divisors = np.asarray(offdiag), np.asarray(divisors)
    cap = min(_OVERLAP_MAX, n - 1)
    k, chunk = 1, 1 << 20
    for a in range(0, n - 1, chunk):
        b = min(a + chunk + cap, n - 1)
        with np.errstate(all="ignore"):
            seg = np.log2(np.abs(offdiag[a:b].astype(np.float64)
                                 / divisors[a:b].astype(np.float64)))
        # a zero factor contracts at once; a NaN one never
        seg = np.nan_to_num(seg, nan=np.inf, posinf=np.inf, neginf=-4096.0)
        c = np.concatenate(([0.0], np.cumsum(seg)))
        while k <= min(cap, len(seg)):
            if (c[k:] - c[:-k]).max() <= -_MEET_BITS:
                break
            k += 1
        if k > cap:
            return n if n - 1 <= _OVERLAP_MAX else _OVERLAP_MAX
    return k


def solve_overlap(offdiag: np.ndarray, divisors: np.ndarray,
                  itemsize: int) -> int:
    """The nodes a run of S1 starts early: _SOLVE_OVERLAP[4] in float32;
    in float64 the level's own (:func:`_meet_steps`), found once per
    divisors array."""
    if itemsize != 8:
        return _SOLVE_OVERLAP[itemsize]
    key = id(divisors)
    hit = _OVERLAPS.get(key)
    if hit is None:
        hit = _OVERLAPS[key] = _meet_steps(offdiag, divisors)
        weakref.finalize(divisors, _OVERLAPS.pop, key, None)
    return hit


def _blocks_an_sm(smem: int, threads: int, itemsize: int = 8) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of shared memory
    that one SM holds at once (float64's by its registers too)."""
    regs = _SM_REGS // (_F64_REGS * threads) if itemsize == 8 else 32
    return min(_SM_SMEM // (smem + 1024), _SM_THREADS // threads, regs, 32)


def solve_geometry(n: int, m: int, itemsize: int, segment=None,
                   overlap=None) -> SolveGeometry:
    """S1's tiles for ``m`` lines of ``n`` nodes of ``itemsize``-byte
    floats, whose runs start ``overlap`` nodes early (default
    ``_SOLVE_OVERLAP[itemsize]``; :func:`mass_solve` passes
    :func:`solve_overlap`'s).

    float32, 256 threads a block.  32 lines or more: the most lines a
    tile (256, 128, 64 or 32; 256 / lines runs a line) whose whole lines
    fit the aimed shared memory, else 32 lines cut into the longest
    segments that fit, where a run is at least as long as the overlap
    (which then at most doubles its sweeps); each aim in turn, then all
    of a block's shared memory.  Fewer lines: one line a block, 256 runs
    of ``_SOLVE_RUN`` nodes (fewer on a short line).

    float64.  A line shorter than ``_SHORT_OVERLAPS`` overlaps: the
    short route, one thread a whole line, the most lines a tile (256 to
    32) within ``_SHORT_SMEM`` that still leave the level two blocks an
    SM (of ``_SMS``), else 32.
    Else runs at least twice the overlap, in tiles that fit two blocks
    an SM: 32 lines or more, 2 to 8 runs a line on whole lines, else on
    segments of 32 lines, the threads a block following the tile (64 to
    256), the tile that keeps the most threads an SM busy on nodes of
    their own (each counted by run / (run + overlap)), then the longest
    segments; fewer lines, one line a block, the threads (32 to 256) and
    even run (2 up to what the line needs; a run's padded row of run + 1
    doubles then starts a bank further on) that score best the same way,
    then the shorter run: a long series takes 128 threads of runs of 16,
    three blocks an SM, shorter than twice the overlap, since the
    kernel's four values a node leave no room for more threads of
    longer runs.

    ``segment`` forces the cut of either type as float32 cuts it
    (``segment``: 256 times a power of two where a block takes one
    line); the kernel is exact with any cut and any overlap."""
    ovl = int(overlap or _SOLVE_OVERLAP[itemsize])

    def geometry(route, lines, threads, run, seg):
        nseg = -(-n // seg)
        smem = solve_smem(lines, run, seg, n, ovl, itemsize, threads, route)
        if smem > _SMEM_MAX:
            raise ValueError(f"S1: a tile of {lines} lines by {seg} + 2 x "
                             f"{ovl} nodes does not fit a block")
        return SolveGeometry(lines, run, seg, nseg, ovl, smem,
                             (m if lines == 1 else -(-m // lines)) * nseg,
                             threads, route)

    if itemsize == 8 and segment is None:
        return _geometry_f64(n, m, ovl, geometry)
    if m < 32:
        if segment is None:
            run = 2
            while run < _SOLVE_RUN and run * _SOLVE_THREADS < n:
                run *= 2
        else:
            run = segment // _SOLVE_THREADS
            if run < 2 or run & (run - 1) or run * _SOLVE_THREADS != segment:
                raise ValueError(f"S1: a one-line segment is 256 times a "
                                 f"power of two >= 2, got {segment}")
        return geometry("runs", 1, _SOLVE_THREADS, run,
                        run * _SOLVE_THREADS)
    if segment is not None:
        runs = _SOLVE_THREADS // 32
        return geometry("lines", 32, _SOLVE_THREADS,
                        -(-min(segment, n) // runs), min(segment, n))
    for cap in (*_SOLVE_SMEM, _SMEM_MAX):
        for lines in _TILE_LINES:
            run = -(-n // (_SOLVE_THREADS // lines))
            if solve_smem(lines, run, n, n, ovl, itemsize) <= cap:
                return geometry("lines", lines, _SOLVE_THREADS, run, n)
        runs = _SOLVE_THREADS // 32
        run = 0
        while solve_smem(32, run + 1, runs * (run + 1), n, ovl,
                         itemsize) <= cap:
            run += 1
        if run >= (ovl if cap < _SMEM_MAX else 1):
            return geometry("lines", 32, _SOLVE_THREADS, run, runs * run)
    raise ValueError(f"S1: no tile of {n}-node lines fits a block")


def _geometry_f64(n: int, m: int, ovl: int, geometry) -> SolveGeometry:
    """float64's routes (:func:`solve_geometry`)."""
    def smem(route, lines, threads, run, seg):
        return solve_smem(lines, run, seg, n, ovl, 8, threads, route)

    if n < _SHORT_OVERLAPS * ovl:
        fits = [t for t in _TILE_LINES
                if smem("short", t, t, n, n) <= _TWO_A_SM]
        for t in fits:
            if smem("short", t, t, n, n) <= _SHORT_SMEM \
                    and -(-m // t) >= 2 * _SMS:
                return geometry("short", t, t, n, n)
        if fits:
            return geometry("short", fits[-1], fits[-1], n, n)
    # score a tile by the threads an SM holds, each counted by the share
    # of its sweeps that are its own nodes and not guessed ones
    if m < 32:
        best = None
        for t in (32, 64, 128, 256):
            for run in range(2, max(2, -(-n // t)) + 2, 2):
                size = smem("runs", 1, t, run, t * run)
                if size > _TWO_A_SM:
                    break
                score = (_blocks_an_sm(size, t) * t * run / (run + ovl),
                         -run)
                if best is None or score > best[0]:
                    best = (score, t, run)
        t, run = best[1:] if best else (32, 2)
        return geometry("runs", 1, t, run, t * run)
    # 32 lines or more: whole lines, else segments of 32 lines
    best = None

    def consider(lines, threads, run, seg):
        nonlocal best
        size = smem("lines", lines, threads, run, seg)
        if size <= _TWO_A_SM:
            score = (_blocks_an_sm(size, threads) * threads * run
                     / (run + ovl), seg)
            if best is None or score > best[0]:
                best = (score, (lines, threads, run, seg))

    for lines in (128, 64, 32):
        for runs in range(2, _SOLVE_THREADS // lines + 1):
            threads = lines * runs
            if -(-n // runs) >= 2 * ovl:
                consider(lines, threads, -(-n // runs), n)
            run = 2 * ovl
            if lines != 32 or runs * run >= n or smem(
                    "lines", 32, threads, run, runs * run) > _TWO_A_SM:
                continue
            while runs * (run + 1) < n and smem(
                    "lines", 32, threads, run + 1,
                    runs * (run + 1)) <= _TWO_A_SM:
                run += 1
            consider(32, threads, run, runs * run)
    if best is not None:
        return geometry("lines", *best[1])
    # no run twice the overlap fits: the longest that fit a block
    run = 0
    while smem("lines", 32, 128, run + 1, 4 * (run + 1)) <= _SMEM_MAX \
            and 4 * run < n:
        run += 1
    return geometry("lines", 32, 128, max(run, 1), min(4 * max(run, 1), n))


def mass_solve_plain(b: torch.Tensor, offdiag: np.ndarray,
                     divisors: np.ndarray, axis: int) -> torch.Tensor:
    """Plain PyTorch S1: the Thomas solve ``M x = b`` along ``axis``, a
    Python loop over the planes of that axis in the JAX scan's order.  The
    divisors divide as 0-d tensors on ``b``'s device: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal instead, which
    is not the division of the JAX package and of the kernel."""
    n = b.shape[axis]
    if n < 2:
        raise ValueError("mass_solve requires >= 2 nodes along axis")
    w, off, div = solve_tables(offdiag, divisors, b.dtype)
    divt = torch.as_tensor(div, device=b.device)
    bm = b.movedim(axis, 0)
    # forward sweep: d'_i = d_i - (off[i-1] / div[i-1]) * d'_{i-1}
    d = [bm[0]]
    for i in range(1, n):
        d.append(bm[i] - float(w[i - 1]) * d[-1])
    # backward sweep: x_{n-1} = d'_{n-1} / div[n-1];
    # x_i = (d'_i - off[i] * x_{i+1}) / div[i]
    x = [None] * n
    x[n - 1] = d[n - 1] / divt[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = (d[i] - float(off[i]) * x[i + 1]) / divt[i]
    return torch.stack(x).movedim(0, axis)


@_build.counted
def mass_solve(b: torch.Tensor, offdiag: np.ndarray, divisors: np.ndarray,
               axis: int, segment=None, overlap=None, walks=None
               ) -> torch.Tensor:
    """Solve ``M x = b`` along ``axis`` (Thomas, with the precomputed
    divisors: the pre-eliminated diagonal).  ``offdiag``: the (n-1,)
    off-diagonal ``h/6``; ``divisors``: (n,).  float32 or float64; S1 on
    a CUDA tensor, the plain version on a CPU tensor.  ``segment`` and
    ``overlap`` force S1's cut (:func:`solve_geometry`); ``walks``, an
    int32 CUDA tensor of 2, gets the count of S1's walks in shared
    memory and of its re-solved segments added."""
    n = b.shape[axis]
    if n < 2:
        raise ValueError("mass_solve requires >= 2 nodes along axis")
    if b.device.type == "cpu":
        return mass_solve_plain(b, offdiag, divisors, axis)
    device = _build.device_of("mass_solve", b)
    if b.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"mass_solve: float32 or float64 data, got "
                         f"{b.dtype}")
    if walks is not None and (walks.dtype != torch.int32
                              or walks.numel() != 2
                              or walks.device != device):
        raise ValueError("mass_solve: walks must be 2 int32 values on the "
                         "data's device")
    off, div = _device_tables(offdiag, divisors, b.dtype, device)
    m = b.numel() // n
    if m == 0:
        return torch.empty_like(b)
    # S1 reads (outer, n, inner) as it lies: no axis is moved
    inner = math.prod(b.shape[axis + 1:])
    itemsize = 8 if b.dtype == torch.float64 else 4
    geo = solve_geometry(n, m, itemsize, segment, overlap or solve_overlap(
        offdiag, divisors, itemsize))
    bc = b.contiguous()
    x = torch.empty_like(bc)
    bounds = flags = None
    if geo.nseg > 1:
        # each block's boundary values and the checks' flags
        bounds = torch.empty((4, geo.nseg, m), dtype=b.dtype, device=device)
        flags = torch.empty((geo.nseg + 1, m), dtype=torch.int32,
                            device=device)
    _build.launch("mgard_mass_solve", bc.data_ptr(), off.data_ptr(),
                  div.data_ptr(), x.data_ptr(),
                  None if bounds is None else bounds.data_ptr(),
                  None if flags is None else flags.data_ptr(),
                  None if walks is None else walks.data_ptr(), n, m, inner,
                  _ROUTES[geo.route], geo.threads, geo.lines, geo.run,
                  geo.segment, geo.overlap, int(b.dtype == torch.float64),
                  device=device)
    mass_solve.launches += 1
    return x

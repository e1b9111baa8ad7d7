#!/usr/bin/env python3
"""Smoke test of mgard_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (one ``nvcc -c`` per source, all at once,
then one link), holds each kernel against its plain PyTorch version at
the shapes of the path that runs it, drives each path once through the
public API (a 512^3 float32 field compressed at an absolute L-infinity
tolerance of 1e-3 and decompressed again: segmented, with the one-pass
GPK kernels, then with the two-pass ones, then with the LPK correction;
on the flat PYRAMID stream; the default per-group codec at 128^3; the
512^3 field as float64; then with s-norm error control; then the FINE
and LEVEL_BLOCKS layouts and the SINGLEDIM and HYBRID decompositions;
then the host losslesses and second stages, MGARD-ROI, MGARD-QOI and
MDR; then reference MGARD buffers (MGARD-X at 513^3, the CPU format,
MDR-X directories) and the two ZFP codecs; then long dims, over 4096
nodes, whose correction solves with S1; then an unstructured tetrahedral
mesh of 2,146,689 nodes; then a 1024^3 field split into blocks and the
sharded compressor; then the six examples, the command line and the
autotuner's knob sweep), checks every result, and prints
the kernels' JSON line, the card's line and a last line ``{"ok": true,
"device": {...}}``.  Any failure raises and the
script exits non-zero; without a CUDA device it exits non-zero before
doing anything.

Phases (each prints its wall time; long dims and multi-block also the
seconds of each of their steps, as "-- step <name>: <s> s"):
  1. setup     - card name and power limit, versions, the kernel build
                 and, beside it, the host codecs' (one g++ each) and the
                 main field (host numpy; the "data" step waits for it);
  2. kernels   - K1-K10 against their plain versions, on the main path's
                 own inputs (the decomposition of the field; K5 and K7 on
                 the field at the finest level, K8 on K7's output, K6 and
                 K9 on K1's coarse array, K10 on K9's output, with K5's
                 detail), bit-identical, timed with CUDA events, and the
                 matmul form that K5/K6 replace timed beside them; K2 as
                 one launch over the 10 segments (timed alone, beside the
                 one-segment wrapper once per segment and the largest
                 segment alone) and with a NaN and an overflow planted in
                 two segments, status 2 and 1 on exactly their chunks;
                 K4 timed in 21 turns of its 10 launches (median and
                 quartiles), K1 (its levels), K5, K9 and K16 in 21 turns
                 too;
                 K8 o K7 bit-identical to K5 and K10 o K9 to K6; K12 and
                 K11 on
                 the flat PYRAMID stream of the field (with an int32
                 minimum planted in it), and K4 and K11 on a stream with
                 no words (every exponent 0); K14 and K15 (the
                 sign-magnitude cores, which no path runs) on that planted
                 stream cut into (32, 128) chunks, bit-identical, K15 o K14
                 the identity; K16 and K17 (the segmented
                 encode's older split, which no path runs) on the main
                 path's segments, bit-identical, K16's maxima and statuses
                 equal to K2's and K17 o K16 writing K3's stream (K16
                 also with a NaN and an overflow planted); K13 on K5's
                 level-9 detail, bit-identical, with the dense dim-0
                 SGEMM it replaces timed beside it, and the LPK correction
                 against the matmul correction within 1e-5 * max|ref|;
 2a. stencil forms - ops/stencil.py (the shift-stencil forms, plain
                 PyTorch, any rank and dtype) at level 9: its lerps in
                 K5's dim order bit for bit against K5 and its plain
                 version, detail_stencil and interp_all (dim order 0, 1,
                 2) within 1e-6 * max|A| of them, on the main field and
                 on phase 3's nonuniform grid; detail_stencil timed
                 beside K5 and the matmul form; at level 8 (257^3, which
                 K5's gate refuses) on the main field's coarse nodes,
                 float32 and float64, against the matmul form within
                 1e-6 * max|A| and 8 float64 ulps of max|A|;
  3. nonuniform- K5-K10 and K13 bit-identical to their plain versions,
                 and the two-pass compositions to K5/K6, on a grid with
                 random coordinates: with the weights of 0.5 of a uniform
                 grid every lerp product is exact, so only such a grid
                 shows a multiply-add that the compiler contracted;
  4. main path - mgard_tpu_torch.compress / decompress at 512^3 with the
                 launch counters set to 0 just before and read just
                 after; K1-K6 launch, K2, K5 and K6 once each, K7-K17
                 not; K2 launched per segment writes the same container;
  5. timing    - device encode/decode by CUDA events, with the GPK
                 kernels on and then off (the matmul form), and the host
                 parts by host clock;
 5a. codec widths - K2, K3 and K4 at chunk widths 1024 and 2048 (the
                 main path runs 4096) on the main field's segments, each
                 chain bit for bit against its plain versions and each
                 kernel timed; then the main field through
                 get_compressor(..., chunk_groups=C) at 1024, 2048 and
                 4096: the header records C, 4096 writes the main path's
                 container, each decodes within the tolerance, device
                 encode/decode timed in turns with each width's ratio;
                 the GPK-off timing above sets transform._GPK (what
                 MGARD_TPU_GPK=0 sets at import);
 5b. codec pick - utils.autotune.autotune at 512^3 float32 (iters=1)
                 into a temporary table: BITPLANE against BITPLANE_GROUP
                 (GB/s and ratio), lookup and Config.tuned give the winner;
  6. two-pass  - the main path again with stencil_kernels._FUSED off
                 (what MGARD_TPU_GPK_FUSED=0 sets at import): K7-K10 once
                 each, K5/K6 not, the same container bytes as the main
                 path; device encode/decode timed in turns with the
                 one-pass kernels;
  7. lpk       - the main path again with transform._LPK on (what
                 MGARD_TPU_LPK=1 sets at import): K13 twice (decompose
                 and recompose), the other kernels as on the main path,
                 the ratio within 1% of the main path's, containers
                 cross-decoded both ways with the default; device
                 encode/decode timed in turns with LPK off;
  8. flat      - the same field with Config(layout=PYRAMID): the flat
                 chunked stream, K12 and K11 once each, K2-K4 not at all;
                 the encode's peak memory within the planner's factor
                 (``api.footprint_per_byte``), as in each phase below
                 that reports a peak;
  9. per-group - the default Config at 128^3 (under 2^22 values, so the
                 per-group codec; no codec kernel launches); its encode
                 peak;
 10. float64   - the 512^3 field as float64, default Config: the wide
                 codec, 2048 groups a chunk, no kernel launches (every
                 kernel is float32 only, as in the JAX package);
 11. s-norm    - finite s, each case with its own counters, ratio and
                 CUDA-event times, and ||v - out||_s <= the recorded
                 tolerance by the port's norms in float64: 512^3 s = 0
                 on the default Config (segmented: K11 once per level, K4
                 never), timed in turns with the L-infinity main path;
                 512^3 s = 1 on the flat PYRAMID stream (K12/K11 once);
                 128^3 s = -1 REL 1e-6 (per-group); 256^3 float64 s = 0
                 (wide);
 12. layouts   - the 512^3 field through the API with Config(layout=FINE),
                 Config(layout=LEVEL_BLOCKS) (both launch as the flat
                 path), Config(decomposition=SINGLEDIM) (S1 once a level
                 and dim each way, 27 each way, K12/K11 once; S1's share
                 of the device encode and decode) and
                 Config(decomposition=HYBRID, num_local_levels=1) (global
                 grid 320^3: K1 where its gate admits the global levels,
                 in the encode and again in the decode, K5/K6 where
                 theirs does, K12/K11 once), each with its error, ratio,
                 device times and encode peak, and K12/K11 bit for bit
                 against their plain versions on its own stream (K12's
                 words the container's); HYBRID's K1 bit for bit at each
                 level its gate admits, on the encode's and the decode's
                 inputs; HYBRID with two, three, four and ten local
                 levels' encode peaks (ten: the last count that shrinks
                 the global grid, 10^3), each within the planner's
                 factor; S1
                 bit for bit against its plain version at SINGLEDIM's
                 top-level solves (257, 512, 512) dim 0, (257, 257, 512)
                 dim 1, (257, 257, 257) dim 2, each timed in 21 turns
                 beside a tensordot with the dense inverse;
 13. host codecs - the 512^3 field with NONE and HUFFMAN_ZLIB (the flat
                 PYRAMID stream coded on the host: the flat path's
                 transform kernels, no codec kernel), each API round
                 trip a HostLeg (a host thread whose card work is held
                 to fixed points, counted apart: the encode until its
                 stream is on the host, the decode's last card part
                 after the main thread lets it run); the host stages
                 recorded inside the round trip by the host clock (the
                 compressor's host encode and decode, and the Huffman and
                 zlib calls within them): the API's host encode took
                 _quantized_flat's stream from the card and gave the
                 container's section, its host decode gave that stream
                 back bit for bit.  NONE's host work runs beside
                 BITPLANE_LZ4 (the main path's launches; each
                 LZ4-decompressed section
                 the unstaged container's byte for byte; its decompress
                 by the host clock) and the zstd losslesses (a round
                 trip where zstandard is installed, else
                 ModuleNotFoundError from each, printed which); then
                 NONE's round trip ends, HUFFMAN_ZLIB starts, and its
                 host work (~25 s) goes on beside phases 14-19;
 14. CPU format - the reference CPU format (CPU_HUFFMAN_ZLIB) at 129^3,
                 s = inf and s = 0: K1/K5/K6 bit for bit against their
                 plain versions on the encode's inputs, then the two
                 compresses, each a HostLeg, K1 and K5 as their gates
                 admit in each encode's card part (``_cpu_quantized``),
                 counted until both streams are on the host; their zlib
                 level 9 (host work alone) runs on beside phases 15-20;
 15. roi       - compress_roi at 512^3 (threshold 0.5, block 8) and the
                 API's decompress: the flat path's transform kernels,
                 error <= tol on ROI and buffer nodes and <= scalar * tol
                 elsewhere, the ratio against the per-group container's;
                 compress_roi's peak device memory;
 16. qoi       - a box-mean functional: its component norms on the card
                 against the port's CPU ones at 65^3 (rtol 1e-9); at
                 512^3 S1 3 (L + 1) times, compress_qoi at s = 0 with
                 |Q(u) - Q(u')| <= 1e-4 and the main path's K1/K5/K6;
                 the norms again with each S1 call (float64, at every
                 level's shape) bit for bit against its plain version;
 17. mdr       - mdr_refactor at 512^3 (LOSSLESS_NONE; K1 as the main
                 path, K5 once), then at 1e-2, 1e-3 and 1e-4 each of the
                 greedy, inorder and roundrobin requests: its bytes, a
                 reconstruction within the tolerance (K6 once), its time;
                 the refactor's peak device memory;
                 incremental 1e-2 then 1e-4 equal to a one-shot 1e-4
                 reconstruction bit for bit;
 18. interop   - reference MGARD buffers (``io/mgard_compat.py``), each
                 round trip with its own launch counters: MGARD-X at 513^3
                 (the 2^9 + 1 grid its users write; bench.py's kind of
                 field built on the card), ABS 1e-3, X_HUFFMAN: error,
                 ratio, API times, K1 and K5 as their gates admit in the
                 encode (K1 at levels 9-7) and bit for bit against their
                 plain versions on its inputs (level_kernel_errs),
                 nothing in the float64 decode; its stages one by one
                 (quantized stream, host codebook, Huffman blob = the
                 container's byte for byte, its decode on the card = the
                 stream bit for bit); REL 1e-4 at 513^3; s = 0 at 129^3
                 (RMS of the error within the tolerance and within
                 1e-3, not a raw fallback, the card's decode the CPU's
                 of the same buffer to a float32 rounding); the zstd writers
                 and zstd goldens raise ModuleNotFoundError without
                 zstandard; the 17x17 X golden and the three zfp_stream
                 goldens (byte for byte, with zfp_stream's time a block);
                 a synthetic mdr-x directory of the 129^3 field in
                 float64 (``tests/mdrx_fixture.py``): all planes
                 within 1e-12 of the written coefficients' float64
                 recompose on the CPU, plane counts rising as the
                 tolerance tightens;
 19. zfp       - the native fixed-rate codec (``models/zfp.py``) at 512^3,
                 rates 8 and 16: size exactly rate bits a value plus the
                 side bytes, error, API and device times (CUDA events), no
                 kernel launched; on a 128^3 crop the card's stream is the
                 CPU's byte for byte;
 20. HUFFMAN_ZLIB - waits for phase 13's round trip, runs its decode's
                 card part: error, ratio, launches (the encode's and the
                 decode's card parts), the host stages, the checks above;
                 device encode/decode by CUDA events; the encode's peak
                 within the planner's factor;
 21. CPU format decode - waits for phase 14's compresses and decodes
                 them, each with its own launch counters (K6 as its gate
                 admits in each float32 decode): max|v - out| <= 1e-3 at
                 s = inf and ||v - out||_0 <= 1e-3 by the port's norms at
                 s = 0, zlib level 9's time;
 22. long dims - dims over 4096 nodes take the per-dim transform, its
                 correction solving with S1 (``csrc/tridiag.cuh``); each
                 case with its own launch counters, bench.py's kind of
                 field built in float32 on the card from seed 0, ABS
                 1e-3, after S1 bit for bit against its plain version on
                 each of its layouts at its default geometry and with
                 walks forced (a small segment, a 1-node overlap, data
                 with zeros, signed zeros, a NaN and 1e-30 values; walks
                 in shared memory and re-solved segments both counted and
                 > 0 in every case with more than one segment a line),
                 and float64 on each of its routes (short, lines, runs)
                 at its own geometry on that data, NaN-aware, with its
                 walks and blocks an SM logged (check_solve_layouts):
                 (a) a 1-D series of 280,953,867 values (one HACC
                 field of SDRBench; L = 29, 30 segments): the hierarchy's
                 build time (host work alone, built on a host thread
                 while phases 13-21 run), the round trip, S1 twice a
                 per-dim level,
                 device encode/decode and S1's share of them, S1 per
                 level and alone on the top level's 2^28 + 1 nodes (in
                 TURNS queued turns), S1
                 bit for bit against its plain version on solves of at
                 most 2^16 nodes and within SOLVE_RESIDUAL_BOUND above;
                 (b) (64, 512, 8192), levels 5-6 per dim: K5/K6 once,
                 K1 where its gate admits, K2 once, device times, and S1
                 at level 6 along each axis bit for bit against its
                 plain version and timed in TURNS turns, dim 0 (the
                 kernels line's entry) beside a tensordot with the
                 dense inverse, and so again in float64 (the entry
                 mass_solve_f64: dim 0; each solve's route, blocks an SM
                 and walks logged);
                 the (b) field as float64 at s = inf and s = 0: the
                 encode peaks against the planner's factor, and at
                 s = inf its device encode and decode (CUDA events);
                 float64 S1 at each solve of the orthogonal components
                 of a 256^3 float64 field (every finite s-norm's but
                 s = 0's, and QoI's), held against its plain version,
                 with its route, blocks an SM and walks, the first solve
                 of each level timed in TURNS turns; for (a)
                 and (b) the encode's peak device memory and the scoped
                 tables within it against the planner's factor (the
                 resident tables logged beside it), no scoped table left
                 on the card by a call, the ratio and error those before
                 the tables' memory repair, for (a) the top level's
                 tables copied from the host against built on the card,
                 a warm encode and decode that copy no table and count
                 two calls on resident tables, the resident bytes equal
                 to transform.table_bytes, none left after
                 release_cache, and
                 K1-K6 bit for bit against their plain versions at their
                 own shapes, K3's stream the container's (K2 over (a)'s
                 30 segments in one launch); (c) (8192, 8192) at s = 0,
                 ||v - out||_0 by the port's norms in float64 (S1 at
                 every level of those), K11 bit for bit against its
                 plain version on the container's top level, and the
                 encode peak of that field as float64; (d) the
                 512^3 field with transform._SOLVER = "scan" (what
                 MGARD_TPU_SOLVER=scan sets at import): every level per
                 dim, the ratio within 1% of the default's, containers
                 cross-decoded with the default both ways, device times
                 beside the matmul correction's, S1 bit for bit
                 against its plain version at every level (9 to 1);
 23. unstructured - a tetrahedral mesh on the card: the unit cube of
                 8^3 cells, six tetrahedra each, refined 4 times
                 (2,146,689 nodes, 12,582,912 tetrahedra; build time),
                 a float64 smooth field of the coordinates plus noise:
                 at s = 0 and s = 1 the MGTU round trip within 1e-3 in
                 the s-norm, its ratio, decompose/recompose and
                 compress/decompress times, the CG iterations of each
                 level; no kernel launch; the phase's peak memory; each
                 container's bytes and error those before the mesh
                 refusals below (which move no byte); then the meshes
                 the JAX package refuses, built on the card (grids with
                 an axis of fewer than two nodes, element tables of no
                 rows refined, a negative node index through a round
                 trip): each raises ValueError, no compress returns a
                 buffer, and the card's allocated memory is what it was;
 24. multi-block - a 1024^3 float32 field (bench.py's kind, built in
                 float32 on the card slab by slab, its noise from a CUDA
                 generator), which the default Config splits into two
                 (512, 1024, 1024) slabs along dim 0: compress and
                 decompress through the API with the launch counters set
                 to 0 just before and read just after, L-infinity 1e-3,
                 twice the launches of one slab compressed alone, whose
                 sections are block 1's byte for byte; K1-K6 bit for
                 bit against their plain versions on that slab (K3's
                 stream the container's, K4 decoding it) and again at
                 tolerance 1e-6, where the stream passes 2^28 words;
                 the pinned host cache and the process's
                 peak RSS; one block's device encode/decode by CUDA
                 events and the encode's peak memory against the JAX
                 estimate of 4.485x; the 512^3 field in two slabs
                 (max_block_bytes half its bytes), L-infinity 1e-3 and
                 REL 1e-4 (norm max|v| block by block); at 512^3 Variable
                 slabs (dd_sizes 100, 200, 212)
                 at s = 0, sqrt(sum_b ||v_b - out_b||_0^2) <= 1e-3, and
                 N-D blocks of 256^3 (K5/K6 once a block) at L-infinity;
                 a (16, 4096, 4096) field with adjust_shape, stored as
                 (256, 256, 4096) and returned in its own shape, K1-K6
                 bit for bit against their plain versions at that shape;
 25. sharded   - ShardedCompressor.for_global on cuda:0, the main field
                 in two slabs, ABS and REL: each container the API's for
                 the same slabs (phase 24's) byte for byte, with its
                 launches; its round-trip step; then the planner peaks
                 gathered above (float64 long dims, HYBRID k = 3, 4 and 10,
                 per-group, ROI, MDR), each against the planner's factor;
25a. examples  - the six examples/torch_*.py run in this process on the
                 card at their default sizes, each raising if an error
                 exceeds its bound;
 26. reference - card-versus-CPU cross-checks at 65^3 (matmul form
                 only; each of the three flat paths too) and
                 (32, 256, 256) (K5/K6 on the card, then K7-K10, then
                 K5/K6 with K13): the pyramids agree and each container
                 decodes on both within the tolerance; with finite s at
                 65^3 (s = 0) and on a nonuniform (33, 65, 65) grid
                 (s = 1), segmented, each decode on the card through K11;
                 at 65^3 HYBRID with two local levels and on a nonuniform
                 grid, LEVEL_BLOCKS and HYBRID at s = 0, FINE in float64;
 27. cli       - ``python -m mgard_tpu_torch`` in three processes at
                 once, started before phase 25 and run beside phases
                 25-26 (their host-clock times contended): compress
                 of the main field (its container the main path's byte
                 for byte), decompress of that container (the output
                 within 1e-3) and inspect (its header lines); the same
                 compress and decompress through ``cli.main`` in this
                 process, counted (K1-K6 as the main path);
27a. sweep     - utils.autotune.sweep_knobs at 256^3 float32 over
                 SWEEP_GRID, one `python -m mgard_tpu_torch.utils.autotune
                 probe` process a candidate, started before phase 24 and
                 run beside phases 24-27 (its readings contended:
                 recorded, not judged; every candidate must give one),
                 into a temporary table; then one fresh process
                 under MGARD_TPU_AUTOTUNE=<that table> with
                 MGARD_TPU_GPK=0 MGARD_TPU_XK=0 compresses and decompresses
                 the main field with its counters: K1, K5 and K6 never,
                 K2-K4 launched, the header's chunk_groups the table's
                 default_knobs width, the container decoded here within
                 the tolerance;
 28. summary   - the kernels line (S1 and mass_solve_f64, float64 S1
                 with QoI's launches, after K1-K17), the card line, the
                 ok line.
"""

from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import resource
import struct
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

T_START = time.perf_counter()
SHAPE = (512, 512, 512)
TOL = 1e-3
SEED = 0
# Turns of the settled timings (K4's 10 launches of one decode, K9, K16,
# each S1 case and its tensordot): the median and quartiles settle each
# figure
TURNS = 21
# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside
# the tensor cores (the rate the scalar integer and float work of these
# kernels is counted against).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Scalar operations per value: quantize (scale, abs, add, finiteness and
# overflow tests, trunc, cast, sign, zigzag), the 32x32 butterfly (480
# per 32 values) and dequantize (unzigzag, cast, scale).
OPS_QUANT, OPS_BUTTERFLY, OPS_DEQUANT = 10, 15, 6
# One lerp (1 - w) * l + w * r: a subtract, two multiplies, an add.
OPS_LERP = 4
# Compression ratio of the main path's field with the matmul-only
# transform (the port before K5/K6, on an H100); the GPK transform must
# stay within 1% of it.
RATIO_MATMUL_ONLY = 2.5212
# The kernels of the segmented main path, and the flat stream's pair.
SEGMENTED_KERNELS = ("extract_coarse_3d", "bp_quant_max", "bp_quant_condense",
                     "bp_decode_condense_f32", "gpk_detail",
                     "gpk_prolong_add")
FLAT_KERNELS = ("bp_encode_condense", "bp_decode_condense")
# The two-pass GPK kernels K7-K10 (stencil_kernels._FUSED off).
TWO_PASS_KERNELS = ("run_b20", "run_b1sub", "run_dec_b20", "run_dec_b1add")
# K13, on the LPK path only (transform._LPK on, MGARD_TPU_LPK=1).
LPK_KERNELS = ("rm_dim0",)
# K16 and K17, the segmented encode's older split, and K14 and K15, the
# sign-magnitude cores: no path launches them.
SPLIT_KERNELS = ("bp_quant_zigzag", "bp_condense_into")
CORE_KERNELS = ("bp_encode_core", "bp_decode_core")
NO_PATH_KERNELS = SPLIT_KERNELS + CORE_KERNELS
# The tolerance of the LPK correction against the matmul one, relative to
# max|matmul correction| (tests/test_lpk_kernels.py's).
LPK_REL_TOL = 1e-5
# ops/stencil.py against K5 in another dim order, and against the matmul
# form, relative to max|A|: float32 (tests/test_torch_stencil.py's
# DIM_ORDER_BOUND, about 8 ulps), and float64 in ulps.
STENCIL_REL_TOL = 1e-6
STENCIL_ULPS_F64 = 8
# Encode peaks over their inputs' bytes, gathered from the phases that
# run those calls and logged together by planner_summary: float64 long
# dims ((8192, 8192) at s = 0, (64, 512, 8192) at s = inf and 0), HYBRID
# with three, four and ten local levels, the per-group codec (each held
# to the planner's factor by encode_peak), the ROI compress and the MDR
# refactor (which no planner governs).
PLANNER_PEAKS = {}


# Every log line also goes to chiprun_out/chip_smoke.log beside the
# script (git-ignored), whole where a terminal keeps only the output's end.
LOG_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chiprun_out", "chip_smoke.log")
_log_file = None


def log(msg: str) -> None:
    global _log_file
    print(msg, flush=True)
    if _log_file is None:
        os.makedirs(os.path.dirname(LOG_FILE), exist_ok=True)
        _log_file = open(LOG_FILE, "w")
    _log_file.write(msg + "\n")
    _log_file.flush()


def smooth_field_host(shape, seed=SEED):
    """bench.py's smooth test field (three separable cosine modes plus
    1e-3 Gaussian noise), built with numpy from ``seed``: each mode the
    product of its per-dim cosines taken from the first dim on, the
    noise drawn in float64 and cast, every step in place where it can
    be."""
    x = [np.linspace(0.0, 1.0, s, dtype=np.float32) for s in shape]
    f = np.zeros(shape, dtype=np.float32)
    for k in (1, 3, 7):
        c = [np.cos(np.pi * k * xx + 0.1 * k * (d + 1))
             for d, xx in enumerate(x)]
        term = c[0].copy()
        for cd in c[1:]:
            term = term[..., None] * cd
        term /= k
        f += term
    noise = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    noise *= 0.001
    f += noise
    return f


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


class Laps:
    """The steps of a phase: each call logs the seconds since the last
    (or since the laps began) on a line of its own."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self, step):
        t = time.perf_counter()
        log(f"-- step {step}: {t - self.t0:.3f} s")
        self.t0 = t


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean ms of ``fn`` over ``reps`` runs, by CUDA events, after one
    warm-up run (none where ``warm`` is false: the caller has just run
    it)."""
    import torch
    if warm:
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


def turn_ms(fn, turns: int) -> np.ndarray:
    """The ms of each of ``turns`` calls of ``fn`` (after one warm-up), by
    CUDA events recorded between them.  The card first sleeps while the
    host queues every call, so that the events time the card's work and
    not the host's launch gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(turns + 1)]
    torch.cuda._sleep(100_000_000)         # ~50 ms of card clock cycles
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    ev[-1].synchronize()
    return np.asarray([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])


def turns_median(label, fn, turns: int = TURNS) -> float:
    """The median ms of ``fn`` over ``turns`` queued turns
    (:func:`turn_ms`), logged with its quartiles."""
    t = turn_ms(fn, turns)
    q1, med, q3 = np.percentile(t, [25, 50, 75])
    log(f"{label}: {turns} turns (CUDA events between turns, the queue "
        f"kept full): median {med:.4f} ms, quartiles {q1:.4f} / {q3:.4f} ms "
        f"(min {t.min():.4f}, max {t.max():.4f})")
    return float(med)


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


def record(results, name, source, replaces, err, ms, plain_ms, nbytes, ops,
           library_ms=None):
    """Log one kernel's check and times and append its summary; raise if
    it differs from its plain version."""
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


def check_kernels(hier, v):
    """K1-K4 against their plain versions on the main path's inputs."""
    import functools
    import torch
    from mgard_tpu_torch.ops import bitplane, bp_kernels as bk
    from mgard_tpu_torch.ops import extract_kernels as xk, transform
    from mgard_tpu_torch.ops import stencil_kernels as sk
    from mgard_tpu_torch.ops.quantize import inverse_quantum, \
        supremum_quantum

    results = []
    add = functools.partial(record, results)

    # K1 at every level of the decomposition its gate admits, on the
    # levels of the main path's own decomposition (K5 where it runs)
    k1_inputs, A = [], v
    for l in range(hier.L, 0, -1):
        if xk.extract_supported(hier, l, A):
            k1_inputs.append((l, A))
        C = transform._extract_old_all(hier, A, l)
        if sk.gpk_supported(hier, l, A):
            detail = sk.gpk_detail(hier, A, l)
        else:
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
        "mgard_tpu/ops/extract_kernels.py:84", err,
        turns_median(f"K1, {len(k1_inputs)} levels a turn", k1),
        cuda_ms(k1_plain, 3), nbytes, 0, library_ms=cuda_ms(k1_lib, 3))
    del k1_inputs

    # K2-K4 on the pyramid of the main path
    pyr = [p.reshape(-1).contiguous() for p in transform.decompose(hier, v)]
    C = bitplane.CHUNK_GROUPS
    inv_q = float(inverse_quantum(hier, TOL))
    quantum = float(supremum_quantum(hier, TOL))
    ch = codec_chain(pyr, C, inv_q, quantum)
    ncs = ch.ncs
    nvals = sum(p.numel() for p in pyr)

    # K2: one launch over the whole pyramid, as encode_segments calls it,
    # against the concatenated plain results; the one-segment wrapper
    # once per segment gives the same words
    got = [bk.bp_quant_max(p, nc, C, inv_q) for p, nc in zip(pyr, ncs)]
    if any(not torch.equal(torch.cat([g[k] for g in got]), b)
           for k, b in enumerate((ch.mx, ch.status))):
        raise AssertionError("K2 per segment differs from K2 batched")
    if int(ch.status.max()):
        raise AssertionError("main-path data gave a nonzero codec status")
    check_quant_max_planted(pyr, ncs, C, inv_q)
    big = max(range(len(pyr)), key=lambda k: pyr[k].numel())
    per_segment_ms = cuda_ms(lambda: [bk.bp_quant_max(p, nc, C, inv_q)
                                      for p, nc in zip(pyr, ncs)], 10)
    largest_ms = cuda_ms(lambda: bk.bp_quant_max(pyr[big], ncs[big], C,
                                                 inv_q), 10)
    batched_ms = cuda_ms(lambda: bk.bp_quant_max_segments(pyr, ncs, C,
                                                          inv_q), 10)
    log(f"K2 times: one launch over the {len(pyr)} segments "
        f"{batched_ms:.4f} ms; the one-segment wrapper once per segment "
        f"{per_segment_ms:.4f} ms; the largest segment ({pyr[big].numel()} "
        f"values, {ncs[big]} chunks) alone {largest_ms:.4f} ms")
    add("bp_quant_max", "mgard_tpu_torch/csrc/bp_codec.cu",
        "mgard_tpu/ops/pallas_kernels.py:536",
        max(ch.err["K2"], ch.err["status"]), batched_ms,
        cuda_ms(lambda: bk.bp_quant_max_segments_plain(pyr, ncs, C, inv_q),
                2),
        4 * nvals + 8 * sum(ncs), (OPS_QUANT + 1) * nvals)

    spare = torch.zeros_like(ch.words)
    add("bp_quant_condense", "mgard_tpu_torch/csrc/bp_codec.cu",
        "mgard_tpu/ops/pallas_kernels.py:481", ch.err["K3"],
        cuda_ms(lambda: ch.k3(bk.bp_quant_condense, ch.words), 5),
        cuda_ms(lambda: ch.k3(bk.bp_quant_condense_plain, spare), 2),
        4 * nvals + 4 * ch.rows * C + 8 * sum(ncs),
        (OPS_QUANT + OPS_BUTTERFLY) * nvals)
    del spare
    check_split_kernels(add, pyr, ncs, C, inv_q, got, ch.words, ch.rows)

    med = turns_median(f"K4, {len(pyr)} launches a turn",
                       lambda: ch.k4(bk.bp_decode_condense_f32))
    add("bp_decode_condense_f32", "mgard_tpu_torch/csrc/bp_codec.cu",
        "mgard_tpu/ops/pallas_kernels.py:621", ch.err["K4"], med,
        cuda_ms(lambda: ch.k4(bk.bp_decode_condense_f32_plain), 2),
        4 * ch.rows * C + 4 * nvals + 8 * sum(ncs),
        (OPS_BUTTERFLY + OPS_DEQUANT) * nvals)
    log(f"codec inputs: {len(pyr)} segments, {nvals} values, {sum(ncs)} "
        f"chunks, {ch.rows} stream rows of {C} words")
    return results


def codec_chain(pyr, C, inv_q, quantum):
    """K2 over the flat segments ``pyr`` in one launch, then K3 and K4
    once a segment, at chunk width C, each against its plain version on
    the same inputs: K3's and K4's plain versions take the kernels'
    exponents, offsets and stream, so that each error is its own
    kernel's.  Returns the layout (``ncs``, ``starts``), the kernels'
    results (``mx``, ``status``, ``e``, ``offsets``, ``rows``, ``words``,
    ``stream``), the errors ``err`` (K2's maxima, its statuses, K3, K4)
    and the runners ``k3(fn, buf)`` and ``k4(fn)`` that timings call."""
    import types
    import torch
    from mgard_tpu_torch.ops import bitplane, bp_kernels as bk

    ncs = [bitplane.num_chunks_tiled(p.numel(), C) for p in pyr]
    starts = np.concatenate([[0], np.cumsum(ncs)]).astype(int)
    segs = list(zip(pyr, ncs, starts))
    mx, status = bk.bp_quant_max_segments(pyr, ncs, C, inv_q)
    want = bk.bp_quant_max_segments_plain(pyr, ncs, C, inv_q)
    err = {"K2": max_abs_diff(mx, want[0]),
           "status": max_abs_diff(status, want[1])}
    del want
    e = bitplane._bit_length32(mx)
    offsets = bitplane._offsets(e)
    rows = int(e.sum())

    def k3(fn, buf):
        for p, nc, a in segs:
            fn(p, nc, C, inv_q, offsets[a:a + nc], e[a:a + nc], buf)
    words = torch.zeros(sum(ncs) * 33 * C, dtype=torch.int32,
                        device=pyr[0].device)
    words_plain = torch.zeros_like(words)
    k3(bk.bp_quant_condense, words)
    k3(bk.bp_quant_condense_plain, words_plain)
    err["K3"] = max_abs_diff(words, words_plain)
    del words_plain
    stream = words[:rows * C]

    def k4(fn):
        return [fn(stream, C, offsets[a:a + nc], e[a:a + nc], quantum,
                   p.numel()) for p, nc, a in segs]
    err["K4"] = max(max_abs_diff(g, w) for g, w in
                    zip(k4(bk.bp_decode_condense_f32),
                        k4(bk.bp_decode_condense_f32_plain)))
    return types.SimpleNamespace(
        ncs=ncs, starts=starts, mx=mx, status=status, e=e, offsets=offsets,
        rows=rows, words=words, stream=stream, err=err, k3=k3, k4=k4)


def check_quant_max_planted(pyr, ncs, C, inv_q):
    """K2 batched on the main path's segments with a NaN planted in chunk
    5 of the largest and a value past the int32 range in chunk 2 of the
    next: bit for bit against the concatenated plain results, status 2
    and 1 on exactly those chunks."""
    import torch
    from mgard_tpu_torch.ops import bp_kernels as bk

    big = max(range(len(pyr)), key=lambda k: pyr[k].numel())
    other = max((k for k in range(len(pyr)) if k != big),
                key=lambda k: pyr[k].numel())
    segs = list(pyr)
    segs[big] = pyr[big].clone()
    segs[big][5 * 32 * C + 11] = float("nan")
    segs[other] = pyr[other].clone()
    segs[other][2 * 32 * C + 7] = 2.0 ** 32 / inv_q
    got = bk.bp_quant_max_segments(segs, ncs, C, inv_q)
    want = bk.bp_quant_max_segments_plain(segs, ncs, C, inv_q)
    err = max(max_abs_diff(g, w) for g, w in zip(got, want))
    starts = np.concatenate([[0], np.cumsum(ncs)]).astype(int)
    expect = torch.zeros_like(got[1])
    expect[starts[big] + 5] = 2
    expect[starts[other] + 2] = 1
    flagged = torch.nonzero(got[1]).flatten().tolist()
    log(f"K2 batched with a NaN in chunk 5 of segment {big} and 2^32 / "
        f"inv_q in chunk 2 of segment {other}: max_abs_err={err} "
        f"(tolerance 0), status {got[1][flagged].tolist()} at global "
        f"chunks {flagged} (expected 2 at {starts[big] + 5}, 1 at "
        f"{starts[other] + 2})")
    if err or not torch.equal(got[1], expect):
        raise AssertionError("K2 batched on planted values: statuses "
                             f"{got[1][flagged].tolist()} at {flagged}, "
                             f"error {err}")


def check_split_kernels(add, pyr, ncs, C, inv_q, k2, words, rows):
    """K16 and K17 against their plain versions on the main path's
    segments, bit for bit: K16's maxima and statuses equal K2's (``k2``),
    and K17, fed K16's words at the row offsets of K16's maxima, writes
    K3's stream ``words`` (``rows`` rows of C words) into one shared
    buffer.  K16 also on a copy of one segment with a NaN and a value past
    the int32 range planted, so that status codes 2 and 1 show."""
    import torch
    from mgard_tpu_torch.ops import bitplane, bp_kernels as bk

    starts = np.concatenate([[0], np.cumsum(ncs)]).astype(int)
    nvals = sum(p.numel() for p in pyr)
    nwords = sum(ncs) * 32 * C
    before = bk.bp_quant_zigzag.launches
    zs = [bk.bp_quant_zigzag(p, nc, C, inv_q) for p, nc in zip(pyr, ncs)]
    launches = [bk.bp_quant_zigzag.launches - before]
    err = 0.0
    for p, nc, got in zip(pyr, ncs, zs):
        want = bk.bp_quant_zigzag_plain(p, nc, C, inv_q)
        err = max([err] + [max_abs_diff(g, w) for g, w in zip(got, want)])
        del want
    if any(not torch.equal(z[1], m[0]) or not torch.equal(z[2], m[1])
           for z, m in zip(zs, k2)):
        raise AssertionError("K16's maxima or statuses differ from K2's")
    planted = pyr[-2].clone()
    planted[3] = float("nan")
    planted[32 * C + 5] = 2.0 ** 32 / inv_q
    nc = ncs[-2]
    got = bk.bp_quant_zigzag(planted, nc, C, inv_q)
    want = bk.bp_quant_zigzag_plain(planted, nc, C, inv_q)
    perr = max(max_abs_diff(g, w) for g, w in zip(got, want))
    codes = got[2].tolist()
    log(f"K16 on segment {len(pyr) - 2} with a NaN and 2^32 / inv_q planted: "
        f"max_abs_err={perr} (tolerance 0), status of its first chunks "
        f"{codes[:3]}")
    if codes[:2] != [2, 1] or any(codes[2:]):
        raise AssertionError(f"K16's statuses on the planted segment: "
                             f"{codes}")
    del planted, got, want
    add("bp_quant_zigzag", "mgard_tpu_torch/csrc/bp_codec.cu",
        "mgard_tpu/ops/pallas_kernels.py:380", max(err, perr),
        turns_median(f"K16, {len(pyr)} launches a turn",
                     lambda: [bk.bp_quant_zigzag(p, nc, C, inv_q)
                              for p, nc in zip(pyr, ncs)]),
        cuda_ms(lambda: [bk.bp_quant_zigzag_plain(p, nc, C, inv_q)
                         for p, nc in zip(pyr, ncs)], 2),
        4 * nvals + 4 * nwords + 8 * sum(ncs), (OPS_QUANT + 1) * nvals)

    e = bitplane._bit_length32(torch.cat([z[1] for z in zs]))
    offsets = bitplane._offsets(e)
    if int(e.sum()) != rows:
        raise AssertionError("K16's exponents differ from K2's")
    split = torch.zeros_like(words)
    split_plain = torch.zeros_like(words)

    def k17(fn, buf):
        for (z, _, _), nc, a in zip(zs, ncs, starts):
            fn(z, offsets[a:a + nc], e[a:a + nc], buf)
    before = bk.bp_condense_into.launches
    k17(bk.bp_condense_into, split)
    launches.append(bk.bp_condense_into.launches - before)
    k17(bk.bp_condense_into_plain, split_plain)
    err = max_abs_diff(split, split_plain)
    same = torch.equal(split[:rows * C], words[:rows * C])
    log(f"K17 o K16 over {len(pyr)} segments: the K3 stream of {rows} rows "
        f"bit for bit {same}; the check launched K16 {launches[0]} and K17 "
        f"{launches[1]} times (no path launches either)")
    if not same:
        raise AssertionError("K17 o K16 does not write K3's stream")
    del split_plain
    add("bp_condense_into", "mgard_tpu_torch/csrc/bp_codec.cu",
        "mgard_tpu/ops/pallas_kernels.py:576", err,
        cuda_ms(lambda: k17(bk.bp_condense_into, split), 5),
        cuda_ms(lambda: k17(bk.bp_condense_into_plain, split), 2),
        4 * nwords + 4 * rows * C + 8 * sum(ncs), OPS_BUTTERFLY * nwords)


def rm_counts(hier, l):
    """Bytes and operations that K13 must move and do at level ``l``: B
    read once, pad8(nc0) planes written once; 5 products and 4 sums a
    value of rows 0..fc-1, 4 and 3 of row fc."""
    n0, n1, n2 = hier.shapes[l]
    fc = hier.dims[0][l].front_nc
    nc0p = -(-(fc + 1) // 8) * 8
    plane = n1 * n2
    return 4 * (n0 + nc0p) * plane, (9 * fc + 7) * plane


def check_lpk(hier, v):
    """K13 against its plain version on the main path's level-``L``
    detail (K5's output), over all pad8(nc0) rows; the dense dim-0 SGEMM
    it replaces timed beside it; and the LPK correction (K13, then
    [Minv0_pad, K1, K2]) against the matmul correction on that detail."""
    import torch
    from mgard_tpu_torch.ops import lpk_kernels as lk
    from mgard_tpu_torch.ops import stencil_kernels as sk, transform

    l = hier.L
    det = sk.gpk_detail(hier, v, l)
    if not lk.rm0_supported(hier, l, det):
        raise AssertionError(f"the LPK gate refuses level {l}")
    results = []
    Y = lk.rm_dim0(hier, det, l)
    err = max_abs_diff(Y, lk.rm_dim0_plain(hier, det, l))
    lev = hier.dims[0][l]
    RM = torch.as_tensor(transform._restriction_matrix_np(lev)
                         @ transform._mass_matrix_np(lev.h),
                         dtype=torch.float32, device=v.device)
    record(results, "rm_dim0", "mgard_tpu_torch/csrc/lpk.cu",
           "mgard_tpu/ops/lpk_kernels.py:162", err,
           cuda_ms(lambda: lk.rm_dim0(hier, det, l), 10),
           cuda_ms(lambda: lk.rm_dim0_plain(hier, det, l), 3),
           *rm_counts(hier, l),
           library_ms=cuda_ms(lambda: torch.tensordot(RM, det,
                                                      dims=([1], [0])), 5))
    dims = transform._level_dims(hier, l)
    fast = transform._device_mats(hier, "_corr_fast_mats", l,
                                  lk.correction_matrices_fast(hier, l), Y)
    mm = transform._device_mats(hier, "_corr_mats", l,
                                transform._correction_matrices(hier, l), det)
    lpk_corr = lambda: transform._apply_matrix_chain(
        lk.rm_dim0(hier, det, l), fast, dims)
    mm_corr = lambda: transform._apply_matrix_chain(det, mm, dims)
    ref = mm_corr()
    rel = float((lpk_corr() - ref).abs().max()) / float(ref.abs().max())
    log(f"LPK correction at level {l} against the matmul correction: max "
        f"abs diff / max|ref| = {rel!r} (tolerance {LPK_REL_TOL}); K13 + "
        f"[Minv0_pad, K1, K2] {cuda_ms(lpk_corr, 5):.4f} ms, matmul chain "
        f"{cuda_ms(mm_corr, 5):.4f} ms")
    if not rel <= LPK_REL_TOL:
        raise AssertionError(f"the LPK correction differs by {rel}")
    return results


def check_flat_kernels(hier, v):
    """K12 and K11 against their plain versions on the flat PYRAMID
    stream of the main path's field (the stream that Config(layout=
    PYRAMID) encodes), with an int32 minimum planted in it (its zigzag
    word is 0xFFFFFFFF); then K4 and K11 on a stream with no words; then
    K14 and K15 on the same planted stream."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.config import Layout
    from mgard_tpu_torch.ops import bitplane, bp_kernels as bk

    results = []
    comp = mt.get_compressor(SHAPE, np.float32, device="cuda",
                             config=mt.Config(layout=Layout.PYRAMID))
    q, status = comp._quantized_flat(v, TOL)
    if int(status):
        raise AssertionError("main-path data gave a nonzero flat status")
    q[q.numel() // 3] = -2 ** 31
    n = q.numel()
    C = bitplane.CHUNK_GROUPS
    nc = bitplane.num_chunks_tiled(n, C)
    zc = bitplane._zigzag(bk.chunked(q, nc, C))
    e = bitplane._chunk_exponents(zc)
    offsets = bitplane._offsets(e)
    rows = int(e.sum())
    words = torch.zeros(nc * 33 * C, dtype=torch.int32, device=v.device)
    words_plain = torch.zeros_like(words)
    bk.bp_encode_condense(zc, offsets, e, words)
    bk.bp_encode_condense_plain(zc, offsets, e, words_plain)
    err = max_abs_diff(words, words_plain)
    record(results, "bp_encode_condense", "mgard_tpu_torch/csrc/bp_codec.cu",
           "mgard_tpu/ops/pallas_kernels.py:312", err,
           cuda_ms(lambda: bk.bp_encode_condense(zc, offsets, e, words), 5),
           cuda_ms(lambda: bk.bp_encode_condense_plain(zc, offsets, e,
                                                       words_plain), 2),
           4 * zc.numel() + 4 * rows * C + 8 * nc,
           OPS_BUTTERFLY * zc.numel())
    del words_plain, zc
    stream = words[:rows * C]
    got = bk.bp_decode_condense(stream, C, offsets, e, n)
    err = max_abs_diff(got, bk.bp_decode_condense_plain(stream, C, offsets,
                                                        e, n))
    if not torch.equal(got, q):
        raise AssertionError("K11 does not give K12's input back")
    record(results, "bp_decode_condense", "mgard_tpu_torch/csrc/bp_codec.cu",
           "mgard_tpu/ops/pallas_kernels.py:710", err,
           cuda_ms(lambda: bk.bp_decode_condense(stream, C, offsets, e, n),
                   5),
           cuda_ms(lambda: bk.bp_decode_condense_plain(stream, C, offsets,
                                                       e, n), 2),
           4 * rows * C + 4 * n + 8 * nc, (OPS_BUTTERFLY + 2) * n)
    log(f"flat stream: {n} values, {nc} chunks, {rows} stream rows of {C} "
        f"words, one value set to -2^31")
    del got, stream, words
    results += check_core_kernels(q)

    # no stream words at all (an all-zero field): K4 and K11 read no row
    zero_e = torch.zeros(nc, dtype=torch.int32, device=v.device)
    for words in (torch.zeros(0, dtype=torch.int32, device=v.device),
                  torch.zeros(C, dtype=torch.int32, device=v.device)):
        outs = {"K11": (bk.bp_decode_condense(words, C, zero_e, zero_e, n),
                        bk.bp_decode_condense_plain(words, C, zero_e,
                                                    zero_e, n)),
                "K4": (bk.bp_decode_condense_f32(words, C, zero_e, zero_e,
                                                 0.5, n),
                       bk.bp_decode_condense_f32_plain(words, C, zero_e,
                                                       zero_e, 0.5, n))}
        for name, (got, plain) in outs.items():
            if got.any() or plain.any() or max_abs_diff(got, plain):
                raise AssertionError(f"{name} on an empty stream of "
                                     f"{words.numel()} words is not zero")
    log(f"empty stream: K4 and K11 give {n} zeros from 0 words and from a "
        f"one-row buffer, as their plain versions do")
    return results


def check_core_kernels(q):
    """K14 and K15 (the sign-magnitude cores, which no path runs) against
    their plain versions on the flat stream ``q`` (int32, with -2^31
    planted), zero-padded to whole (32, 128) chunks: planes, signs and
    plane counts bit for bit, K15 on K14's output bit for bit, and
    K15 o K14 the identity."""
    import torch
    from mgard_tpu_torch.ops import bp_kernels as bk

    results = []
    lanes = bk.CORE_LANES
    nc = -(-q.numel() // (32 * lanes))
    qc = bk.chunked(q, nc, lanes)
    nvals = qc.numel()
    before = (bk.bp_encode_core.launches, bk.bp_decode_core.launches)
    planes, sign, e = bk.bp_encode_core(qc)
    out = bk.bp_decode_core(planes, sign)
    launches = (bk.bp_encode_core.launches - before[0],
                bk.bp_decode_core.launches - before[1])
    err14 = max(max_abs_diff(g, w) for g, w in
                zip((planes, sign, e), bk.bp_encode_core_plain(qc)))
    err15 = max_abs_diff(out, bk.bp_decode_core_plain(planes, sign))
    same = torch.equal(out, qc)
    del out
    log(f"K14/K15 on {nc} chunks of (32, {lanes}) ({nvals} values, -2^31 "
        f"planted): K15 o K14 the identity {same}; plane counts "
        f"{torch.bincount(e, minlength=33).tolist()} (chunks with e = 0 .. "
        f"32); the check launched K14 {launches[0]} and K15 {launches[1]} "
        f"times (no path launches either)")
    if not same:
        raise AssertionError("K15 o K14 is not the identity")
    record(results, "bp_encode_core", "mgard_tpu_torch/csrc/bp_codec.cu",
           "mgard_tpu/ops/pallas_kernels.py:93", err14,
           cuda_ms(lambda: bk.bp_encode_core(qc), 10),
           cuda_ms(lambda: bk.bp_encode_core_plain(qc), 2),
           8 * nvals + 4 * nc * lanes + 4 * nc,
           (OPS_BUTTERFLY + 4) * nvals)
    record(results, "bp_decode_core", "mgard_tpu_torch/csrc/bp_codec.cu",
           "mgard_tpu/ops/pallas_kernels.py:752", err15,
           cuda_ms(lambda: bk.bp_decode_core(planes, sign), 10),
           cuda_ms(lambda: bk.bp_decode_core_plain(planes, sign), 2),
           8 * nvals + 4 * nc * lanes, (OPS_BUTTERFLY + 3) * nvals)
    return results


def stencil_counts(hier, l):
    """Bytes and operations that K5 and K6 must move and do at level
    ``l``: each input read once, each output written once; the lerps of
    B2 on the rows that are parents in dims 0 and 1, of B0 on the columns
    that are parents in dim 1, and of B1 everywhere, plus one subtract
    (K5) or add (K6) a value."""
    n = [hier.dims[d][l].n for d in range(3)]
    nc = [len(hier.dims[d][l].coarse_pos) for d in range(3)]
    new = [a - b for a, b in zip(n, nc)]
    vals = n[0] * n[1] * n[2]
    ops = OPS_LERP * (nc[0] * nc[1] * new[2] + new[0] * nc[1] * n[2]
                      + n[0] * new[1] * n[2]) + vals
    return (8 * vals, ops), (4 * (nc[0] * nc[1] * nc[2]) + 8 * vals, ops)


def two_pass_counts(hier, l):
    """Bytes and operations that K7-K10 must move and do at level ``l``,
    as :func:`stencil_counts` counts them; V0 goes through device memory
    (K9's has the coarse dim 1).  K7 lerps B2 on the rows that are
    parents in dim 0 and B0 at every j; K9 the same on the coarse
    columns; K8 and K10 lerp B1 everywhere and subtract or add."""
    n = [hier.dims[d][l].n for d in range(3)]
    nc = [len(hier.dims[d][l].coarse_pos) for d in range(3)]
    new = [a - b for a, b in zip(n, nc)]
    vals = n[0] * n[1] * n[2]
    v0c = n[0] * nc[1] * n[2]
    b1 = OPS_LERP * n[0] * new[1] * n[2] + vals
    return {"run_b20": (8 * vals, OPS_LERP * (nc[0] * n[1] * new[2]
                                              + new[0] * n[1] * n[2])),
            "run_b1sub": (12 * vals, b1),
            "run_dec_b20": (4 * (nc[0] * nc[1] * nc[2] + v0c),
                            OPS_LERP * (nc[0] * nc[1] * new[2]
                                        + new[0] * nc[1] * n[2])),
            "run_dec_b1add": (4 * v0c + 8 * vals, b1)}


def check_compositions(hier, A, C, det, label):
    """K8 o K7 against K5 and K10 o K9 against K6, bit for bit; ``det``
    is K5's output on ``A``, ``C`` K1's."""
    from mgard_tpu_torch.ops import stencil_kernels as sk

    l = hier.L
    errs = (max_abs_diff(sk.run_b1sub(hier, sk.run_b20(hier, A, l), A, l),
                         det),
            max_abs_diff(sk.run_dec_b1add(hier, sk.run_dec_b20(hier, C, l),
                                          det, l),
                         sk.gpk_prolong_add(hier, C, det, l)))
    log(f"{label}: K8 o K7 against K5 max_abs_err={errs[0]}, K10 o K9 "
        f"against K6 max_abs_err={errs[1]} (tolerance 0)")
    if errs != (0.0, 0.0):
        raise AssertionError(f"{label}: the two-pass kernels differ from "
                             f"the one-pass ones: {errs}")


def check_stencil(hier, v):
    """K5 on the field at the finest level and K6 on K1's coarse array
    with K5's detail, against their plain versions; the matmul form that
    they replace timed on the same inputs."""
    from mgard_tpu_torch.ops import extract_kernels as xk
    from mgard_tpu_torch.ops import stencil_kernels as sk, transform

    l = hier.L
    if not sk.gpk_supported(hier, l, v):
        raise AssertionError(f"the GPK gate refuses level {l}")
    results = []
    (b5, o5), (b6, o6) = stencil_counts(hier, l)
    det = sk.gpk_detail(hier, v, l)
    err = max_abs_diff(det, sk.gpk_detail_plain(hier, v, l))
    record(results, "gpk_detail", "mgard_tpu_torch/csrc/stencil.cu",
           "mgard_tpu/ops/stencil_kernels.py:356", err,
           turns_median("K5", lambda: sk.gpk_detail(hier, v, l)),
           cuda_ms(lambda: sk.gpk_detail_plain(hier, v, l), 3), b5, o5)
    C = xk.extract_coarse_3d(hier, v, l)
    err = max_abs_diff(sk.gpk_prolong_add(hier, C, det, l),
                       sk.gpk_prolong_add_plain(hier, C, det, l))
    record(results, "gpk_prolong_add", "mgard_tpu_torch/csrc/stencil.cu",
           "mgard_tpu/ops/stencil_kernels.py:626", err,
           cuda_ms(lambda: sk.gpk_prolong_add(hier, C, det, l), 10),
           cuda_ms(lambda: sk.gpk_prolong_add_plain(hier, C, det, l), 3),
           b6, o6)
    mm_det = cuda_ms(lambda: v - transform._prolong_all(hier, C, l), 3)
    mm_add = cuda_ms(lambda: transform._prolong_all(hier, C, l) + det, 3)
    log(f"matmul form at level {l} (float32 SGEMMs and permutes, the path "
        f"without K5/K6): A - prolong(C) {mm_det:.4f} ms, prolong(C) + "
        f"detail {mm_add:.4f} ms")

    # K7-K10, each on the output of the pass before it
    V0 = sk.run_b20(hier, v, l)
    W = sk.run_dec_b20(hier, C, l)
    calls = {"run_b20": (lambda: sk.run_b20(hier, v, l),
                         lambda: sk.run_b20_plain(hier, v, l),
                         "stencil_kernels.py:177"),
             "run_b1sub": (lambda: sk.run_b1sub(hier, V0, v, l),
                           lambda: sk.run_b1sub_plain(hier, V0, v, l),
                           "stencil_kernels.py:230"),
             "run_dec_b20": (lambda: sk.run_dec_b20(hier, C, l),
                             lambda: sk.run_dec_b20_plain(hier, C, l),
                             "stencil_kernels.py:469"),
             "run_dec_b1add": (lambda: sk.run_dec_b1add(hier, W, det, l),
                               lambda: sk.run_dec_b1add_plain(hier, W, det,
                                                              l),
                               "stencil_kernels.py:522")}
    counts = two_pass_counts(hier, l)
    for name, (kernel, plain, line) in calls.items():
        ms = turns_median("K9 (tiled)", kernel) if name == "run_dec_b20" \
            else cuda_ms(kernel, 10)
        record(results, name, "mgard_tpu_torch/csrc/stencil.cu",
               f"mgard_tpu/ops/{line}", max_abs_diff(kernel(), plain()),
               ms, cuda_ms(plain, 3), *counts[name])
    check_compositions(hier, v, C, det, f"{SHAPE} level {l}")
    return results


def nonuniform_grid(shape=(64, 256, 256), seed=SEED):
    """A hierarchy with sorted random coordinates (the end points 0 and
    1) and normal float32 data on the card, both from ``seed``."""
    import torch
    import mgard_tpu_torch as mt

    rng = np.random.default_rng(seed)
    coords = []
    for s in shape:
        c = np.sort(rng.uniform(size=s))
        c[0], c[-1] = 0.0, 1.0
        coords.append(c)
    hier = mt.Hierarchy(shape, coordinates=coords)
    A = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).cuda()
    return hier, A


def check_stencil_nonuniform(shape=(64, 256, 256), seed=SEED):
    """K5-K10 and K13 bit-identical to their plain versions on a grid
    with sorted random coordinates, where the lerp weights are not 0.5
    and the taps of R M are not those of a uniform grid."""
    from mgard_tpu_torch.ops import extract_kernels as xk
    from mgard_tpu_torch.ops import lpk_kernels as lk
    from mgard_tpu_torch.ops import stencil_kernels as sk

    hier, A = nonuniform_grid(shape, seed)
    l = hier.L
    if not sk.gpk_supported(hier, l, A):
        raise AssertionError(f"the GPK gate refuses level {l} of {shape}")
    det = sk.gpk_detail(hier, A, l)
    plain = sk.gpk_detail_plain(hier, A, l)
    err5 = max_abs_diff(det, plain)
    C = xk.extract_coarse_3d(hier, A, l)
    err6 = max_abs_diff(sk.gpk_prolong_add(hier, C, det, l),
                        sk.gpk_prolong_add_plain(hier, C, det, l))
    V0 = sk.run_b20(hier, A, l)
    W = sk.run_dec_b20(hier, C, l)
    if not lk.rm0_supported(hier, l, A):
        raise AssertionError(f"the LPK gate refuses level {l} of {shape}")
    errs = {"K5": err5, "K6": err6,
            "K7": max_abs_diff(V0, sk.run_b20_plain(hier, A, l)),
            "K8": max_abs_diff(sk.run_b1sub(hier, V0, A, l),
                               sk.run_b1sub_plain(hier, V0, A, l)),
            "K9": max_abs_diff(W, sk.run_dec_b20_plain(hier, C, l)),
            "K10": max_abs_diff(sk.run_dec_b1add(hier, W, det, l),
                                sk.run_dec_b1add_plain(hier, W, det, l)),
            "K13": max_abs_diff(lk.rm_dim0(hier, A, l),
                                lk.rm_dim0_plain(hier, A, l))}
    moved = int((fma_detail(hier, A, l) != plain).sum())
    log(f"nonuniform {shape}: max_abs_err {errs} (tolerance 0); a K5 whose "
        f"lerps were contracted into FMAs would differ at {moved} of "
        f"{plain.numel()} values")
    if any(errs.values()):
        raise AssertionError("K5-K10 or K13 differ from their plain versions "
                             "on a nonuniform grid")
    if moved == 0:
        raise AssertionError("the nonuniform grid would not show an FMA "
                             "contraction")
    check_compositions(hier, A, C, det, f"nonuniform {shape}")


def fma_detail(hier, A, l):
    """K5's plain version with every lerp contracted as a compiler would
    without the _rn intrinsics, fma(w, r, (1 - w) * l): the product w * r
    of two float32 values is exact in float64, so the sum is rounded once
    (twice only where the float64 sum is not exact, which is rare)."""
    import torch
    from mgard_tpu_torch.ops import stencil_kernels as sk

    V = A
    for d in (2, 0, 1):
        m, w, _ = sk._mw_arrays(hier, l)[d]
        shp = [1, 1, 1]
        shp[d] = -1
        mt = torch.as_tensor(m, device=A.device).reshape(shp)
        wt = torch.as_tensor(w, device=A.device).reshape(shp)
        lo = ((1 - wt) * torch.roll(V, 1, d)).double()
        lerp = (wt.double() * torch.roll(V, -1, d).double() + lo).float()
        V = torch.where(mt != 0, lerp, V)
    return A - V


def stencil_form_errors(hier, A, l, label):
    """``ops/stencil.py`` against K5 and its plain version at level ``l``:
    the module's lerps taken in K5's dim order (2, 0, 1) must give K5's
    detail bit for bit; ``detail_stencil`` (dim order 0, 1, 2) and
    ``interp_all`` against K5 and its plain version within
    STENCIL_REL_TOL * max|A|.  Returns K5's detail."""
    from mgard_tpu_torch.ops import stencil as st
    from mgard_tpu_torch.ops import stencil_kernels as sk

    det = sk.gpk_detail(hier, A, l)
    plain = sk.gpk_detail_plain(hier, A, l)
    vecs = st._interp_vectors(hier, l)
    V = A
    for d in (2, 0, 1):
        V = st._interp_dim(V, *vecs[d], d)
    exact = (max_abs_diff(A - V, det), max_abs_diff(A - V, plain))
    del V
    ds = st.detail_stencil(hier, A, l)
    near = {"detail_stencil - K5": max_abs_diff(ds, det),
            "detail_stencil - K5 plain": max_abs_diff(ds, plain)}
    del ds
    near["interp_all - (A - K5)"] = max_abs_diff(st.interp_all(hier, A, l),
                                                 A - det)
    bound = STENCIL_REL_TOL * float(A.abs().max())
    log(f"stencil forms, {label} level {l} {tuple(A.shape)}: in K5's dim "
        f"order against K5 and its plain version max_abs_err {exact} "
        f"(tolerance 0); in the module's order {near} (tolerance "
        f"{bound:.3e} = {STENCIL_REL_TOL} * max|A|); supported "
        f"{st.supported(hier, l)}")
    if exact != (0.0, 0.0) or not max(near.values()) <= bound:
        raise AssertionError(f"stencil forms, {label}: {exact} {near}")
    return det


def stencil_forms(hier, v):
    """``ops/stencil.py`` (the shift-stencil forms, plain PyTorch) on the
    main field: at level 9 against K5 (:func:`stencil_form_errors`), on
    the nonuniform phase's grid too, ``detail_stencil`` timed beside K5
    and the matmul form; then at the finest level that K5's gate refuses
    and ``supported`` admits, on the main field's coarse nodes there, in
    float32 and float64 against the matmul form (the transform's off the
    gate), within STENCIL_REL_TOL * max|A| and STENCIL_ULPS_F64 float64
    ulps of max|A|."""
    import torch
    from mgard_tpu_torch.ops import stencil as st
    from mgard_tpu_torch.ops import stencil_kernels as sk, transform

    l = hier.L
    if not (st.supported(hier, l) and sk.gpk_supported(hier, l, v)):
        raise AssertionError(f"level {l}: supported or K5's gate refuses")
    stencil_form_errors(hier, v, l, "main field")
    times = {"K5": cuda_ms(lambda: sk.gpk_detail(hier, v, l), 10),
             "detail_stencil": cuda_ms(lambda: st.detail_stencil(hier, v, l),
                                       5),
             "matmul form": cuda_ms(lambda: v - transform._prolong_all(
                 hier, transform._extract_old_all(hier, v, l), l), 3)}
    log(f"stencil forms at level {l}: detail from A, ms (CUDA events; the "
        f"matmul form with the coarse nodes' extraction) "
        f"{ {k: round(t, 4) for k, t in times.items()} }")
    torch.cuda.empty_cache()
    hn, An = nonuniform_grid()
    stencil_form_errors(hn, An, hn.L, "nonuniform grid")

    # the level below the finest, on the finest level's coarse nodes
    grid, top = hier, v
    if not st.supported(hier, l - 1) or sk.gpk_structure_ok(hier, l - 1):
        log(f"stencil forms: supported admits no level {l - 1} of the main "
            f"field that K5's gate refuses; the nonuniform grid's level "
            f"{hn.L - 1} instead")
        grid, top = hn, An
    k = grid.L - 1
    A = transform._extract_old_all(grid, top, grid.L)
    del An, top
    got = {}
    for A in (A, A.double()):
        form = lambda: A - transform._prolong_all(
            grid, transform._extract_old_all(grid, A, k), k)
        err = max_abs_diff(st.detail_stencil(grid, A, k), form())
        scale = float(A.abs().max())
        bound = scale * (STENCIL_REL_TOL if A.dtype == torch.float32
                         else STENCIL_ULPS_F64 * np.finfo(np.float64).eps)
        got[str(A.dtype)] = (err, bound, round(cuda_ms(
            lambda: st.detail_stencil(grid, A, k), 3), 4),
            round(cuda_ms(form, 3), 4))
        if not err <= bound:
            raise AssertionError(f"stencil forms level {k} {A.dtype}: "
                                 f"{err} against the matmul form")
    log(f"stencil forms at level {k} {tuple(A.shape)} (K5's gate refuses "
        f"it: {not sk.gpk_structure_ok(grid, k)}): detail_stencil against "
        f"the matmul form, (max_abs_err, tolerance, detail_stencil ms, "
        f"matmul form ms) {got}")
    del A
    torch.cuda.empty_cache()
    return times


def main_path(v_host):
    """The user's path once, with the launch counters around it."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    buf = mt.compress(v_host, TOL)
    t1 = time.perf_counter()
    out = mt.decompress(buf)
    t2 = time.perf_counter()
    counts = _build.launch_counts()
    log(f"main path: compress {1e3 * (t1 - t0):.3f} ms, decompress "
        f"{1e3 * (t2 - t1):.3f} ms (host clock, H2D and D2H included); "
        f"launches {counts}")
    missing = [k for k in SEGMENTED_KERNELS if counts[k] == 0]
    extra = [k for k in FLAT_KERNELS + TWO_PASS_KERNELS + LPK_KERNELS
             + NO_PATH_KERNELS + (SOLVE_NAME,) if counts[k]]
    if missing or extra:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}; launched off it: {extra}")
    if counts["gpk_detail"] != 1 or counts["gpk_prolong_add"] != 1 \
            or counts["bp_quant_max"] != 1:
        raise AssertionError("K5, K6 and K2 must launch once each per round "
                             f"trip at {SHAPE}: {counts}")
    if out.shape != v_host.shape or out.dtype != np.float32:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    err = card_max_err(v_host, out)
    if not math.isfinite(err):
        raise AssertionError("non-finite output")
    ratio = v_host.nbytes / len(buf)
    log(f"main path: max|v - out| = {err!r} (tolerance {TOL}), ratio "
        f"{ratio!r}, {len(buf)} bytes")
    if not err <= TOL:
        raise AssertionError(f"error {err} exceeds the tolerance {TOL}")
    if not abs(ratio / RATIO_MATMUL_ONLY - 1) <= 0.01:
        raise AssertionError(f"ratio {ratio} is not within 1% of "
                             f"{RATIO_MATMUL_ONLY}")
    del out
    check_k2_per_segment_container(v_host, buf)
    torch.cuda.synchronize()
    return buf, counts


def check_k2_per_segment_container(v_host, buf):
    """The container that encode_segments writes with K2 launched once
    per segment (the one-segment wrapper, as before the batched launch)
    is the main path's, byte for byte."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import bitplane, bp_kernels as bk

    def per_segment(segs, ncs, C, inv_q):
        outs = [bk.bp_quant_max(s, nc, C, inv_q) for s, nc in zip(segs, ncs)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    batched = bitplane.bp_quant_max_segments
    try:
        bitplane.bp_quant_max_segments = per_segment
        before = bk.bp_quant_max.launches
        other = mt.compress(v_host, TOL)
        launches = bk.bp_quant_max.launches - before
    finally:
        bitplane.bp_quant_max_segments = batched
    log(f"K2 once per segment ({launches} launches): the container is the "
        f"main path's byte for byte {other == buf}")
    if other != buf or launches != mt.Hierarchy(SHAPE).L + 1:
        raise AssertionError("the one-segment K2 path writes another "
                             f"container ({launches} launches)")


def time_device(comp, v, exps, words, label):
    """Device encode and decode by CUDA events."""
    enc_ms = cuda_ms(lambda: comp.encode_device(v, TOL), 3)
    dec_ms = cuda_ms(lambda: comp.decode_device(exps, words, TOL), 3)
    gb = v.numel() * v.element_size() / 1e9
    log(f"{label}: device encode {enc_ms:.3f} ms "
        f"({gb / enc_ms * 1e3:.2f} GB/s), device decode {dec_ms:.3f} ms "
        f"({gb / dec_ms * 1e3:.2f} GB/s)")


def time_parts(v_host, buf):
    """Device encode/decode by CUDA events, with the GPK kernels and with
    the matmul form; host parts by host clock."""
    import torch
    from mgard_tpu_torch.api import compressor_for
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import transform

    header, sections = fmt.read_container(buf)
    comp = compressor_for(header)
    v = torch.from_numpy(v_host).cuda()
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
    out = comp.decode_device(exps, words, TOL)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    out.cpu()
    t5 = time.perf_counter()
    del out
    # on, then off (what MGARD_TPU_GPK=0 sets at import), so the matmul
    # form runs at every level
    gpk = transform._GPK
    try:
        for on in (True, False):
            transform._GPK = on
            time_device(comp, v, exps, words,
                        "GPK on (K5/K6)" if on else "GPK off (matmul form)")
    finally:
        transform._GPK = gpk
    log(f"host: read-back + sections {1e3 * (t1 - t0):.3f} ms, container "
        f"write {1e3 * (t2 - t1):.3f} ms, container read + H2D "
        f"{1e3 * (t3 - t2):.3f} ms, decoded D2H {1e3 * (t5 - t4):.3f} ms")


# The codec widths a sweep may choose (utils/autotune.py DEFAULT_GRID);
# the main path runs the last
CODEC_WIDTHS = (1024, 2048, 4096)


def check_codec_widths(hier, v):
    """K2, K3 and K4 at the chunk widths other than the main path's, on
    the segments of the main field's pyramid: each :func:`codec_chain`
    against its plain versions bit for bit (K2's maxima and statuses,
    K3's stream, K4's values), each kernel timed by CUDA events."""
    import torch
    from mgard_tpu_torch.ops import bp_kernels as bk, transform
    from mgard_tpu_torch.ops.quantize import inverse_quantum, \
        supremum_quantum

    pyr = [p.reshape(-1).contiguous() for p in transform.decompose(hier, v)]
    inv_q = float(inverse_quantum(hier, TOL))
    quantum = float(supremum_quantum(hier, TOL))
    for C in CODEC_WIDTHS[:-1]:
        ch = codec_chain(pyr, C, inv_q, quantum)
        ms = (cuda_ms(lambda: bk.bp_quant_max_segments(pyr, ch.ncs, C,
                                                       inv_q), 5),
              cuda_ms(lambda: ch.k3(bk.bp_quant_condense, ch.words), 5),
              cuda_ms(lambda: ch.k4(bk.bp_decode_condense_f32), 5))
        err = ch.err
        log(f"codec width {C}: {sum(ch.ncs)} chunks, {ch.rows} stream "
            f"rows; K2 / K3 / K4 against their plain versions max_abs_err "
            f"{err['K2']} / {err['K3']} / {err['K4']} (statuses "
            f"{err['status']}; tolerance 0: bit-identical); K2 "
            f"{ms[0]:.4f} ms (one launch), K3 {ms[1]:.4f} ms, K4 "
            f"{ms[2]:.4f} ms ({len(pyr)} launches each; CUDA events)")
        if max(err.values()) != 0.0:
            raise AssertionError(f"codec width {C}: K2-K4 differ from their "
                                 f"plain versions {err}")
        del ch
    del pyr
    torch.cuda.empty_cache()


def codec_width_paths(v_host, main_buf):
    """The main field through ``get_compressor(..., chunk_groups=C)`` at
    each width: the container records C (4096's is the main path's byte
    for byte) and its sections decode on the card within the tolerance;
    the device encode and
    decode timed by CUDA events in turns (1024, 2048, 4096, 4096, 2048,
    1024) with each width's ratio."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import format as fmt

    v = torch.from_numpy(v_host).cuda()
    runs = {}
    for C in CODEC_WIDTHS:
        comp = mt.get_compressor(SHAPE, np.float32, chunk_groups=C)
        buf = comp.compress(v, TOL)
        header, sections = fmt.read_container(buf)
        exps, words = comp.stream_tensors(header, sections)
        out = comp.decode_device(exps, words, TOL)
        err = float((out.double() - v.double()).abs().max())
        del out
        log(f"codec width {C}: {len(buf)} bytes, ratio "
            f"{v_host.nbytes / len(buf)!r}, max|v - out| = {err!r}, header "
            f"chunk_groups {header.chunk_groups}")
        # 2048 is the implicit on-wire width when the field is absent
        if (header.chunk_groups or 2048) != C or not err <= TOL \
                or (C == CODEC_WIDTHS[-1]) != (buf == main_buf):
            raise AssertionError(f"codec width {C}: header "
                                 f"{header.chunk_groups}, error {err}, the "
                                 f"main path's bytes {buf == main_buf}")
        runs[C] = (comp, exps, words, [], [], v_host.nbytes / len(buf))
    for C in CODEC_WIDTHS + CODEC_WIDTHS[::-1]:
        comp, exps, words, enc, dec, _ = runs[C]
        enc.append(cuda_ms(lambda: comp.encode_device(v, TOL), 5))
        dec.append(cuda_ms(lambda: comp.decode_device(exps, words, TOL), 5))
    gb = v_host.nbytes / 1e9
    for C, (_, _, _, enc, dec, ratio) in runs.items():
        log(f"codec width {C}: device encode {enc[0]:.3f} / {enc[1]:.3f} ms "
            f"({gb / np.mean(enc) * 1e3:.2f} GB/s), decode {dec[0]:.3f} / "
            f"{dec[1]:.3f} ms ({gb / np.mean(dec) * 1e3:.2f} GB/s), "
            f"encode + decode {gb / (np.mean(enc) + np.mean(dec)) * 1e3:.2f} "
            f"GB/s, ratio {ratio!r} (two turns, CUDA events)")
    del runs, v
    torch.cuda.empty_cache()


def two_pass_path(v_host, main_buf, main_counts):
    """The main path with ``stencil_kernels._FUSED`` off, set in-process
    as time_parts sets the gate: K7-K10 once each, K5/K6 never, the other
    kernels as on the main path, and the same container bytes (the
    arithmetic is the same).  Device encode and decode timed in turns
    with the one-pass kernels."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.api import compressor_for
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import _build
    from mgard_tpu_torch.ops import stencil_kernels as sk

    fused = sk._FUSED
    try:
        sk._FUSED = False
        _build.reset_launches()
        t0 = time.perf_counter()
        buf = mt.compress(v_host, TOL)
        t1 = time.perf_counter()
        out = mt.decompress(buf)
        t2 = time.perf_counter()
        counts = _build.launch_counts()
    finally:
        sk._FUSED = fused
    err = card_max_err(v_host, out)
    ratio = v_host.nbytes / len(buf)
    main_ratio = v_host.nbytes / len(main_buf)
    log(f"two-pass path: compress {1e3 * (t1 - t0):.3f} ms, decompress "
        f"{1e3 * (t2 - t1):.3f} ms (host clock); max|v - out| = {err!r} "
        f"(tolerance {TOL}), ratio {ratio!r} (main path {main_ratio!r}), "
        f"{len(buf)} bytes, same bytes as the main path {buf == main_buf}; "
        f"launches {counts}")
    want = dict(main_counts, gpk_detail=0, gpk_prolong_add=0,
                **{k: 1 for k in TWO_PASS_KERNELS})
    if counts != want:
        raise AssertionError(f"two-pass path launches {counts}, expected "
                             f"{want}")
    if out.shape != v_host.shape or not err <= TOL:
        raise AssertionError(f"two-pass path: output {out.shape}, error "
                             f"{err}")
    if buf != main_buf:
        raise AssertionError("two-pass path: the container differs from the "
                             "main path's")
    del out

    header, sections = fmt.read_container(buf)
    comp = compressor_for(header)
    v = torch.from_numpy(v_host).cuda()
    exps, words = comp.stream_tensors(header, sections)
    try:
        for on in (True, False, False, True):
            sk._FUSED = on
            time_device(comp, v, exps, words,
                        "one-pass (K5/K6)" if on else "two-pass (K7-K10)")
    finally:
        sk._FUSED = fused
    return counts


def lpk_path(v_host, main_buf, main_counts):
    """The main path with ``transform._LPK`` on, set in-process as
    two_pass_path sets ``_FUSED`` (what MGARD_TPU_LPK=1 sets at import):
    K13 once in decompose and once in recompose, the other kernels as on
    the main path; the error bound, the ratio within 1% of the main
    path's, and containers cross-decoded both ways with the default
    (``_LPK`` off).  Device encode and decode timed in turns with the
    default."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.api import compressor_for
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import _build, transform

    default = transform._LPK
    try:
        transform._LPK = True
        _build.reset_launches()
        t0 = time.perf_counter()
        buf = mt.compress(v_host, TOL)
        t1 = time.perf_counter()
        out = mt.decompress(buf)
        t2 = time.perf_counter()
        counts = _build.launch_counts()
        cross_on = mt.decompress(main_buf)
        transform._LPK = False
        cross_off = mt.decompress(buf)
    finally:
        transform._LPK = default
    errs = [card_max_err(v_host, o) for o in (out, cross_off, cross_on)]
    ratio = v_host.nbytes / len(buf)
    main_ratio = v_host.nbytes / len(main_buf)
    log(f"lpk path: compress {1e3 * (t1 - t0):.3f} ms, decompress "
        f"{1e3 * (t2 - t1):.3f} ms (host clock); max|v - out| = "
        f"{errs[0]!r} (tolerance {TOL}), ratio {ratio!r} (main path "
        f"{main_ratio!r}), {len(buf)} bytes; cross-decode errors {errs[1]!r} "
        f"(its container, LPK off) and {errs[2]!r} (the main path's, LPK "
        f"on); launches {counts}")
    want = dict(main_counts, rm_dim0=2)
    if counts != want:
        raise AssertionError(f"lpk path launches {counts}, expected {want}")
    if out.shape != v_host.shape or not all(e <= TOL for e in errs):
        raise AssertionError(f"lpk path: output {out.shape}, errors {errs}")
    if not abs(ratio / main_ratio - 1) <= 0.01:
        raise AssertionError(f"lpk path: ratio {ratio} is not within 1% of "
                             f"{main_ratio}")
    del out, cross_on, cross_off

    header, sections = fmt.read_container(buf)
    comp = compressor_for(header)
    v = torch.from_numpy(v_host).cuda()
    exps, words = comp.stream_tensors(header, sections)
    try:
        for on in (True, False, False, True):
            transform._LPK = on
            time_device(comp, v, exps, words,
                        "LPK on (K13)" if on else "LPK off (matmul chain)")
    finally:
        transform._LPK = default
    return counts


def drive(label, v_host, config, tol=TOL, s=float("inf"), mode="abs"):
    """One compress / decompress through the API with the launch counters
    set to 0 just before and read just after; the error bound checked
    (max|v - out| for s = inf, else ||v - out||_s by the port's norms, in
    float64 on the card, against the tolerance the container records),
    and the device encode and decode timed by CUDA events.  Returns the
    header, the container, the compressor and the counts."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.api import compressor_for
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    buf = mt.compress(v_host, tol, s=s, mode=mode, config=config)
    t1 = time.perf_counter()
    out = mt.decompress(buf)
    t2 = time.perf_counter()
    counts = _build.launch_counts()
    if out.shape != v_host.shape or out.dtype != v_host.dtype:
        raise AssertionError(f"{label}: output {out.shape} {out.dtype}")
    linf = card_max_err(v_host, out)
    if not math.isfinite(linf):
        raise AssertionError(f"{label}: non-finite output")
    header, sections = fmt.read_container(buf)
    comp = compressor_for(header)
    err = linf if np.isinf(s) else snorm_error(comp.hier, out, v_host, s)
    del out
    bound = header.tolerance
    v = torch.from_numpy(v_host).cuda()
    enc_ms = cuda_ms(lambda: comp.encode_device(v, bound), 3)
    exps, words = comp.stream_tensors(header, sections)
    dec_ms = cuda_ms(lambda: comp.decode_device(
        exps, words, bound, mt.Lossless(header.lossless)), 3)
    del v, exps, words
    torch.cuda.empty_cache()
    gb = v_host.nbytes / 1e9
    norm = "" if np.isinf(s) else f"||v - out||_s = {err!r} (s = {s}), "
    log(f"{label}: {v_host.shape} {v_host.dtype}, lossless "
        f"{mt.Lossless(header.lossless).name}, chunk groups "
        f"{comp.chunk_groups}, {len(buf)} bytes, ratio "
        f"{v_host.nbytes / len(buf)!r}, {norm}max|v - out| = {linf!r} "
        f"({mode} tolerance {tol}, bound {bound!r}); API compress "
        f"{1e3 * (t1 - t0):.3f} ms, decompress {1e3 * (t2 - t1):.3f} ms "
        f"(host clock); device encode {enc_ms:.3f} ms "
        f"({gb / enc_ms * 1e3:.2f} GB/s), decode {dec_ms:.3f} ms "
        f"({gb / dec_ms * 1e3:.2f} GB/s) (CUDA events); launches {counts}")
    if not err <= bound:
        raise AssertionError(f"{label}: error {err} exceeds {bound}")
    return header, buf, comp, counts


def flat_path(v_host, main_counts):
    """The 512^3 field on the flat PYRAMID stream: K12 and K11 once each,
    the transform's kernels as on the segmented path, K2-K4 never; the
    encode's peak memory."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.config import Layout

    header, _, comp, counts = drive("flat path", v_host,
                                    mt.Config(layout=Layout.PYRAMID))
    v = torch.from_numpy(v_host).cuda()
    encode_peak("flat path", comp, v, header.tolerance)
    del v
    torch.cuda.empty_cache()
    want = dict(main_counts, bp_quant_max=0, bp_quant_condense=0,
                bp_decode_condense_f32=0, bp_encode_condense=1,
                bp_decode_condense=1)
    if counts != want or header.lossless != int(mt.Lossless.BITPLANE):
        raise AssertionError(f"flat path launches {counts}, expected "
                             f"{want}; lossless {header.lossless}")
    return counts


def pergroup_path(shape=(128, 128, 128), seed=SEED):
    """The default Config under 2^22 values: the per-group codec, plain
    PyTorch on the card as the JAX package's is XLA; the encode's peak
    memory."""
    import mgard_tpu_torch as mt

    import torch

    v_host = smooth_field_host(shape, seed)
    header, _, comp, counts = drive("per-group path", v_host, mt.Config())
    codec = [k for k in SEGMENTED_KERNELS[1:4] + FLAT_KERNELS + LPK_KERNELS
             + NO_PATH_KERNELS if counts[k]]
    if header.lossless != int(mt.Lossless.BITPLANE_GROUP) or codec:
        raise AssertionError(f"per-group path: lossless {header.lossless}, "
                             f"codec kernels launched {codec}")
    v = torch.from_numpy(v_host).cuda()
    PLANNER_PEAKS["per-group 128^3"] = encode_peak(
        "per-group path", comp, v, header.tolerance)
    del v


def float64_path(v_host):
    """The 512^3 field as float64, default Config: the wide chunked codec
    (2048 groups a chunk), the transform in float64 matmuls, no kernel;
    the encode's peak memory."""
    import torch
    import mgard_tpu_torch as mt

    header, _, comp, counts = drive("float64 path",
                                    v_host.astype(np.float64), mt.Config())
    v = torch.from_numpy(v_host.astype(np.float64)).cuda()
    encode_peak("float64 path", comp, v, header.tolerance)
    del v
    torch.cuda.empty_cache()
    launched = {k: n for k, n in counts.items() if n}
    if header.lossless != int(mt.Lossless.BITPLANE) \
            or (header.chunk_groups or 2048) != 2048 \
            or comp.chunk_groups != 2048 or launched:
        raise AssertionError(f"float64 path: lossless {header.lossless}, "
                             f"chunk groups {header.chunk_groups}, "
                             f"launches {launched}")


def k1_levels(hier) -> int:
    """K1's launches in one decompose of ``hier`` on the card: the levels
    its gate admits (float32 data)."""
    import torch
    from mgard_tpu_torch.ops import extract_kernels as xk
    probe = torch.empty(1, device="cuda")
    return sum(xk.extract_supported(hier, l, probe)
               for l in range(1, hier.L + 1))


def solve_shares(comp, v, header, sections):
    """S1's ms and share of one device encode and one decode (its calls
    timed inside them), and the number of its calls in each."""
    import mgard_tpu_torch as mt
    bound = header.tolerance
    exps, words = comp.stream_tensors(header, sections)
    enc_ms = cuda_ms(lambda: comp.encode_device(v, bound), 1)
    dec_ms = cuda_ms(lambda: comp.decode_device(
        exps, words, bound, mt.Lossless(header.lossless)), 1)
    with SolveProbe(comp.hier) as enc:
        comp.encode_device(v, bound)
    with SolveProbe(comp.hier) as dec:
        comp.decode_device(exps, words, bound, mt.Lossless(header.lossless))
    del exps, words
    out = []
    for label, probe, ms in (("encode", enc, enc_ms), ("decode", dec,
                                                       dec_ms)):
        t = probe.times()
        solve = sum(x[-1] for x in t)
        out.append(f"S1 {solve:.3f} ms of the {label}'s {ms:.3f} ms "
                   f"({solve / ms:.2%}) in {len(t)} calls")
    return "; ".join(out)


def check_stream_kernels(label, comp, v, tol, sections):
    """K12 and K11 bit for bit against their plain versions on the flat
    stream that ``comp`` quantizes from ``v`` on the card (its
    ``_quantized_flat``, in a table scope as the encode runs it): K12's
    exponents and words must be the container's ``sections``, and K11 on
    the container's words must give the stream back.  Returns the
    stream."""
    import torch
    from mgard_tpu_torch.ops import bitplane, bp_kernels as bk, tridiag

    with tridiag.table_scope():
        q, status = comp._quantized_flat(v, tol)
    if int(status):
        raise AssertionError(f"{label}: nonzero flat status {int(status)}")
    n, C = q.numel(), comp.chunk_groups
    nc = bitplane.num_chunks_tiled(n, C)
    zc = bitplane._zigzag(bk.chunked(q, nc, C))
    e = bitplane._chunk_exponents(zc)
    offsets = bitplane._offsets(e)
    nwords = int(e.sum()) * C
    words = torch.zeros(bitplane.max_words(n, C), dtype=torch.int32,
                        device=v.device)
    words_plain = torch.zeros_like(words)
    bk.bp_encode_condense(zc, offsets, e, words)
    bk.bp_encode_condense_plain(zc, offsets, e, words_plain)
    errs = {"bp_encode_condense": max_abs_diff(words, words_plain)}
    del zc, words_plain
    stored = np.frombuffer(sections[0], dtype=np.uint8)
    e_host = e.cpu().numpy()
    stream = torch.from_numpy(
        np.frombuffer(sections[1], dtype="<i4").astype(np.int32)).cuda()
    theirs = bool(np.array_equal(e_host[:len(stored)], stored)
                  and not e_host[len(stored):].any()
                  and torch.equal(stream, words[:nwords]))
    del words
    got = bk.bp_decode_condense(stream, C, offsets, e, n)
    errs["bp_decode_condense"] = max_abs_diff(
        got, bk.bp_decode_condense_plain(stream, C, offsets, e, n))
    back = torch.equal(got, q)
    del got, stream
    log(f"{label}: K12 and K11 against their plain versions on its "
        f"{n}-value stream ({nc} chunks, {nwords} words; tolerance 0): "
        f"{errs}; K12's stream is the container's {theirs}; K11 gives the "
        f"stream back {back}")
    if any(errs.values()) or not (theirs and back):
        raise AssertionError(f"{label}: K12/K11 on its stream: {errs}, "
                             f"the container's {theirs}, back {back}")
    return q


def check_hybrid_kernels(comp, v, q):
    """K1 (K5 and K6 where their gates admit) bit for bit against the
    plain versions at every level of HYBRID's global grid that the gates
    admit, on both of K1's inputs: down the global decomposition of the
    local levels' output (run on the card), and down the decode's split
    of the global part, cast to the data's dtype from the stream ``q``
    (which K11 gives back from the container).  K1 must be checked at
    every level it is launched at, each way."""
    import torch
    from mgard_tpu_torch.ops import transform_hybrid as th, tridiag

    hc, k, ops = comp._hybrid_hc, comp._hybrid_k, comp._hybrid_ops
    shapes = th.padded_shape(tuple(v.shape), k)
    A = v
    with tridiag.table_scope():
        for lvl in range(k):
            A, _ = th._local_decompose_level(
                th._edge_pad(A, shapes[lvl]),
                None if ops is None else ops[lvl])
    enc = level_kernel_errs(hc, A)
    del A
    fine = q[:hc.ndof()].to(v.dtype).reshape(hc.shape)
    dec = level_kernel_errs(hc, fine, split=True)
    del fine
    torch.cuda.empty_cache()
    levels = k1_levels(hc)
    log(f"HYBRID kernels on the global grid {hc.shape} (one entry a level, "
        f"tolerance 0): encode {enc}; decode's split {dec}")
    bad = {k_: x for k_, x in list(enc.items()) + list(dec.items())
           if any(y != 0.0 for y in x)}
    if bad or len(enc["extract_coarse_3d"]) != levels \
            or len(dec["extract_coarse_3d"]) != levels:
        raise AssertionError(f"HYBRID kernels: {bad}, K1 checked at "
                             f"{len(enc['extract_coarse_3d'])} / "
                             f"{len(dec['extract_coarse_3d'])} levels of "
                             f"{levels}")


def layout_paths(v_host, flat_counts):
    """The FINE and LEVEL_BLOCKS layouts and the SINGLEDIM and HYBRID
    (one local level) decompositions at 512^3 through the API, each with
    its own launch counters, error, ratio, device times and encode peak:
    FINE and LEVEL_BLOCKS launch as the flat PYRAMID path (the MULTIDIM
    transform's kernels, K12 and K11 once); SINGLEDIM launches S1 once a
    level and dim each way and K12/K11 once; HYBRID launches K1 where
    its gate admits the global levels (encode and decode: the decode
    splits the float global part in fine order), K5/K6 where theirs
    does, K12/K11 once.  On each path K12 and K11 are held against their
    plain versions on its stream (:func:`check_stream_kernels`), on
    HYBRID K1, K5 and K6 on the global grid (:func:`check_hybrid_kernels`);
    then the encode peaks of HYBRID with two, three, four and the most
    local levels (:func:`hybrid_peak_levels`)."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import stencil_kernels as sk

    zero = {k: 0 for k in flat_counts}
    results = {}
    cases = (("FINE", mt.Config(layout=mt.Layout.FINE)),
             ("LEVEL_BLOCKS", mt.Config(layout=mt.Layout.LEVEL_BLOCKS)),
             ("SINGLEDIM",
              mt.Config(decomposition=mt.Decomposition.SINGLEDIM)),
             ("HYBRID", mt.Config(decomposition=mt.Decomposition.HYBRID,
                                  num_local_levels=1)))
    for label, cfg in cases:
        header, buf, comp, counts = drive(f"{label} path", v_host, cfg)
        hier = comp.hier
        if label in ("FINE", "LEVEL_BLOCKS"):
            want = dict(flat_counts)
        elif label == "SINGLEDIM":
            want = dict(zero, bp_encode_condense=1, bp_decode_condense=1)
            want[SOLVE_NAME] = 2 * hier.effective_ndim * hier.L
        else:
            hc = comp._hybrid_hc
            gpk = int(sk.gpk_structure_ok(hc, hc.L))
            want = dict(zero, bp_encode_condense=1, bp_decode_condense=1,
                        extract_coarse_3d=2 * k1_levels(hc),
                        gpk_detail=gpk, gpk_prolong_add=gpk)
            log(f"HYBRID path: global grid {hc.shape}, L = {hc.L}, K1 "
                f"levels {k1_levels(hc)}, GPK at the top level {bool(gpk)}")
        expect_launches(f"{label} path", counts, want)
        if header.lossless != int(mt.Lossless.BITPLANE) \
                or header.decomposition != (2 if label == "HYBRID"
                                            else int(cfg.decomposition)):
            raise AssertionError(f"{label} path: header {header}")
        v = torch.from_numpy(v_host).cuda()
        sections = fmt.read_container(buf)[1]
        q = check_stream_kernels(f"{label} path", comp, v, header.tolerance,
                                 sections)
        if label == "HYBRID":
            check_hybrid_kernels(comp, v, q)
        del q
        peak = encode_peak(f"{label} path", comp, v, header.tolerance)
        if label == "SINGLEDIM":
            log(f"SINGLEDIM path: {solve_shares(comp, v, header, sections)}")
        del v
        torch.cuda.empty_cache()
        results[label] = (v_host.nbytes / len(buf), peak)
    # HYBRID with two local levels: the encode's peak (the planner's
    # HYBRID factor covers both)
    comp = mt.get_compressor(SHAPE, np.float32, device="cuda",
                             config=mt.Config(
                                 decomposition=mt.Decomposition.HYBRID,
                                 num_local_levels=2))
    v = torch.from_numpy(v_host).cuda()
    results["HYBRID k = 2"] = (None, encode_peak("HYBRID k = 2", comp, v,
                                                 TOL))
    # and with three, four and the most local levels that shrink the
    # global grid: the planner's HYBRID factor must cover each
    for k in hybrid_peak_levels():
        comp = mt.get_compressor(SHAPE, np.float32, device="cuda",
                                 config=mt.Config(
                                     decomposition=mt.Decomposition.HYBRID,
                                     num_local_levels=k))
        peak = encode_peak(f"HYBRID k = {k} (global grid "
                           f"{comp._hybrid_hc.shape})", comp, v, TOL)
        results[f"HYBRID k = {k}"] = (None, peak)
        PLANNER_PEAKS[f"HYBRID k = {k} 512^3"] = peak
    del v, comp
    torch.cuda.empty_cache()
    log(f"layout paths (ratio, encode peak x): {results}")
    return results


def hybrid_peak_levels():
    """The local level counts whose HYBRID encode peaks are measured at
    SHAPE: 3, 4 and the largest whose global grid is smaller than the one
    before it (more local levels leave it as it is)."""
    from mgard_tpu_torch.ops import transform_hybrid as th
    k = 1
    while th.coarse_shape(SHAPE, k + 1) != th.coarse_shape(SHAPE, k):
        k += 1
    return (3, 4, k)


def check_singledim_s1(v_host):
    """S1 bit for bit against its plain version at the SINGLEDIM
    decomposition's top-level solves of the 512^3 field: (257, 512, 512)
    along dim 0, (257, 257, 512) along dim 1, (257, 257, 257) along dim 2
    (the last axis, read as it lies), each on the correction's own input,
    timed in turns beside a tensordot with the dense inverse."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import transform, tridiag

    hier = mt.Hierarchy(SHAPE)
    l = hier.L
    A = torch.from_numpy(v_host).cuda()
    got = []
    for d in transform._level_dims(hier, l):
        lev, clev = hier.dims[d][l], hier.dims[d][l - 1]
        old = transform.extract_old(A, lev, d)
        detail = A - transform.prolong(old, lev, d)
        B = transform.restrict(tridiag.mass_apply(detail, lev.h, d), lev, d)
        del detail
        label = f"S1 SINGLEDIM {tuple(B.shape)} axis {d}"
        x, same, ms = s1_turns(B, clev, d, label)
        lib_ms, lib = s1_library_ms(B, clev, d, label)
        del lib
        bound = bound_ms(s1_bytes(B, d), 0)[0]
        got.append((tuple(B.shape), d, same, round(ms, 4), round(bound, 4),
                    f"{bound / ms:.1%}", round(lib_ms, 4)))
        A = old + x
        del B, x, old
    del A
    torch.cuda.empty_cache()
    log(f"S1 at the SINGLEDIM top-level solves (shape, axis, bit-identical, "
        f"median ms, bound ms with its tables, share, tensordot median ms): "
        f"{got}")
    if [g[0] for g in got] != [(257, 512, 512), (257, 257, 512),
                               (257, 257, 257)] \
            or not all(g[2] for g in got):
        raise AssertionError(f"S1 at the SINGLEDIM shapes: {got}")


def layout_reference_check(shape=(65, 65, 65), seed=6, tol=1e-3):
    """Card against CPU on the new configurations at a small shape (the
    chunked codec, adapt_lossless off): HYBRID with two local levels,
    LEVEL_BLOCKS and HYBRID at s = 0, FINE in float64, HYBRID on a
    nonuniform grid (each block's own operators).  The containers made on
    each decode on both within the tolerance (max|v - out|, or
    ||v - out||_s by the port's norms)."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import _build

    D, Lt = mt.Decomposition, mt.Layout
    rng = np.random.default_rng(seed)
    coords = []
    for n in shape:
        c = np.sort(rng.uniform(size=n))
        c[0], c[-1] = 0.0, 1.0
        coords.append(c)
    v32 = smooth_field_host(shape, seed=seed)
    cases = (("HYBRID k = 2", v32, D.HYBRID, Lt.PYRAMID_SEG, 2, np.inf,
              None),
             ("LEVEL_BLOCKS s = 0", v32, D.MULTIDIM, Lt.LEVEL_BLOCKS, 1,
              0.0, None),
             ("HYBRID s = 0", v32, D.HYBRID, Lt.PYRAMID_SEG, 1, 0.0, None),
             ("FINE float64", v32.astype(np.float64), D.MULTIDIM, Lt.FINE,
              1, np.inf, None),
             ("HYBRID nonuniform", v32, D.HYBRID, Lt.PYRAMID_SEG, 1, np.inf,
              coords))
    for label, v, dec, layout, k, s, co in cases:
        cfg = mt.Config(decomposition=dec, layout=layout, num_local_levels=k,
                        adapt_lossless=False)
        hier = mt.Hierarchy(shape, coordinates=co)
        _build.reset_launches()
        b_gpu = mt.compress(v, tol, s=s, config=cfg, coordinates=co)
        b_cpu = mt.compress(v, tol, s=s, config=cfg, coordinates=co,
                            device="cpu")
        errs = []
        for b in (b_gpu, b_cpu):
            for d in ("cuda", "cpu"):
                out = mt.decompress(b, device=d)
                errs.append(float(np.abs(out.astype(np.float64) - v).max())
                            if np.isinf(s) else
                            snorm_error(hier, out.astype(v.dtype), v, s))
        counts = {k_: n for k_, n in _build.launch_counts().items() if n}
        log(f"{shape} {label} reference check: cross-decode errors {errs} "
            f"(card->card, card->CPU, CPU->card, CPU->CPU), sizes "
            f"{len(b_gpu)} / {len(b_cpu)}, same bytes {b_gpu == b_cpu}, "
            f"launches {counts}")
        if not max(errs) <= tol:
            raise AssertionError(f"{label}: cross-decode error {max(errs)} "
                                 f"> {tol}")
        if v.dtype == np.float32 and not counts.get("bp_decode_condense"):
            raise AssertionError(f"{label}: the card decoded without K11")


def snorm_error(hier, out, v_host, s) -> float:
    """||v - out||_s by the port's norms, in float64 on the card."""
    import torch
    from mgard_tpu_torch.ops import norms

    u = torch.from_numpy(out).cuda().double()
    u -= torch.from_numpy(v_host).cuda().double()
    err = float(norms.norm(hier, u, s))
    del u
    torch.cuda.empty_cache()
    return err


def snorm_paths(v_host, main_buf, main_counts):
    """Finite s through the API: 512^3 s = 0 on the default Config (the
    segmented stream: K2/K3 on the scaled levels, K11 once per level, K4
    never), timed in turns with the L-infinity main path; 512^3 s = 1 on
    Config(layout=PYRAMID) (K12/K11 once each); 128^3 s = -1 REL 1e-6
    (1e-6 * sqrt(sum v^2)) on the default Config (per-group, no codec
    kernel); 256^3 float64 s = 0 (the wide codec, no kernel)."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.api import compressor_for
    from mgard_tpu_torch.config import Layout
    from mgard_tpu_torch.io import format as fmt

    nseg = mt.Hierarchy(SHAPE).L + 1
    _, buf, _, counts = drive("s-norm path", v_host, mt.Config(), s=0.0)
    want = dict(main_counts, bp_decode_condense_f32=0,
                bp_decode_condense=nseg)
    if counts != want:
        raise AssertionError(f"s-norm path launches {counts}, expected "
                             f"{want}")
    # device encode / decode in turns with the L-infinity main path
    comps = {}
    for label, b in (("L-infinity", main_buf), ("s = 0", buf)):
        header, sections = fmt.read_container(b)
        comp = compressor_for(header)
        comps[label] = (comp, *comp.stream_tensors(header, sections))
    v = torch.from_numpy(v_host).cuda()
    for label in ("L-infinity", "s = 0", "s = 0", "L-infinity"):
        comp, exps, words = comps[label]
        time_device(comp, v, exps, words, f"turn {label}")
    del v, comps
    torch.cuda.empty_cache()

    _, _, _, counts = drive("s-norm flat path", v_host,
                            mt.Config(layout=Layout.PYRAMID), s=1.0)
    want = dict(main_counts, bp_quant_max=0, bp_quant_condense=0,
                bp_decode_condense_f32=0, bp_encode_condense=1,
                bp_decode_condense=1)
    if counts != want:
        raise AssertionError(f"s-norm flat path launches {counts}, "
                             f"expected {want}")

    header, _, _, counts = drive(
        "s-norm per-group path", smooth_field_host((128, 128, 128)),
        mt.Config(), tol=1e-6, s=-1.0, mode="rel")
    codec = [k for k in SEGMENTED_KERNELS[1:4] + FLAT_KERNELS
             + NO_PATH_KERNELS if counts[k]]
    if header.lossless != int(mt.Lossless.BITPLANE_GROUP) or codec:
        raise AssertionError(f"s-norm per-group path: lossless "
                             f"{header.lossless}, codec kernels {codec}")

    header, _, _, counts = drive(
        "s-norm float64 path", smooth_field_host((256, 256, 256), seed=1
                                                 ).astype(np.float64),
        mt.Config(), s=0.0)
    launched = {k: n for k, n in counts.items() if n}
    if header.lossless != int(mt.Lossless.BITPLANE) or launched:
        raise AssertionError(f"s-norm float64 path: lossless "
                             f"{header.lossless}, launches {launched}")


# This slice's phases: the host losslesses and second stages, then the
# models (ROI, QoI, MDR), each at 512^3 float32, ABS 1e-3.
ROI_THRESHOLD, ROI_BLOCK = 0.5, 8
MDR_TOLS = (1e-2, 1e-3, 1e-4)
MDR_STRATEGIES = ("greedy", "inorder", "roundrobin")
# QoI's card norms are held against the port's CPU ones on this shape (the
# CPU solve at 512^3 would take minutes of the run).
QOI_CPU_SHAPE = (65, 65, 65)
QOI_RTOL = 1e-9


def transform_counts(counts):
    """The flat path's counts with no codec kernel: what a path launches
    whose codec runs on the host or in plain PyTorch (K1 where its gate
    admits, K5/K6 once)."""
    return dict(counts, bp_encode_condense=0, bp_decode_condense=0)


def host_timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, 1e3 * (time.perf_counter() - t0)


class HostLeg:
    """One call of ``fn`` on a host thread of its own, whose card work is
    held to fixed points so that it never shares the card with the main
    thread's phases or their launch counts.  :meth:`start` returns once
    the thread's call of ``after`` (an ``(owner, name)``) has returned,
    which ends the call's first card part, with the launches made until
    then; the host work that follows runs beside the main thread.  With
    ``before``, the thread stops once its call of ``before`` has
    returned, until :meth:`finish` sets the launch counters to 0 and lets
    it run its last card part.  ``record`` lists ``(owner, name)`` whose
    calls by the thread are kept in ``calls`` ({name: [(args, result,
    ms)]}).  Calls from other threads pass through."""

    def __init__(self, fn, after, before=None, record=()):
        self.fn, self.after, self.before, self.record = fn, after, before, \
            record
        self.card_done, self.host_done, self.go = (threading.Event()
                                                   for _ in range(3))
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.calls = {name: [] for _, name in record}
        self.result = self.error = self.t_held = self.t_go = None
        self._saved = []

    def _run(self):
        try:
            self.result = self.fn()
        except BaseException as e:
            self.error = e
        finally:
            self.card_done.set()
            self.host_done.set()

    def _wrap(self, owner, name, rec=False, event=None, hold=False):
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))

        def wrapped(*args, **kwargs):
            if threading.current_thread() is not self.thread:
                return fn(*args, **kwargs)
            out, ms = host_timed(fn, *args, **kwargs)
            if rec:
                self.calls[name].append((args, out, ms))
            if event is not None:
                self.t_held = time.perf_counter()
                event.set()
            if hold:
                self.go.wait()
            return out
        setattr(owner, name, wrapped)

    def _restore(self, keep=0):
        while len(self._saved) > keep:
            owner, name, fn = self._saved.pop()
            setattr(owner, name, fn)

    def start(self) -> dict:
        from mgard_tpu_torch.ops import _build
        for owner, name in self.record:
            self._wrap(owner, name, rec=True)
        if self.before:
            self._wrap(*self.before, event=self.host_done, hold=True)
        kept = len(self._saved)
        self._wrap(*self.after, event=self.card_done)
        _build.reset_launches()
        try:
            self.thread.start()
            self.card_done.wait()
        finally:
            self._restore(kept)     # the thread has passed ``after``
        counts = _build.launch_counts()
        if self.error is not None:
            self.finish()
        return counts

    def finish(self):
        """(fn's result, the launches of the last card part, seconds
        waited here for the host work)."""
        from mgard_tpu_torch.ops import _build
        t0 = time.perf_counter()
        self.host_done.wait()
        waited = time.perf_counter() - t0
        _build.reset_launches()
        self.t_go = time.perf_counter()
        self.go.set()
        self.thread.join()
        counts = _build.launch_counts()
        self._restore()
        if self.error is not None:
            raise self.error
        return self.result, counts, waited


def host_lossless_start(v_host, lossless):
    """The API round trip of the main field with a host lossless as a
    :class:`HostLeg`: started here, its launches counted until the
    encode's stream is on the host (``HostStream.wait``); the host encode
    and decode (and, for HUFFMAN_ZLIB, the Huffman and zlib calls within
    them) recorded by the host clock; held before the decode's card
    part.  Returns (the leg, the encode's launches)."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import huffman_native
    from mgard_tpu_torch.models.compressor import Compressor, HostStream

    config = mt.Config(lossless=lossless)
    record = [(Compressor, "_host_lossless_encode"),
              (Compressor, "_host_lossless_decode")]
    if lossless != mt.Lossless.NONE:
        record += [(huffman_native, "huffman_encode"), (zlib, "compress"),
                   (zlib, "decompress"), (huffman_native, "huffman_decode")]

    def round_trip():
        t0 = time.perf_counter()
        buf = mt.compress(v_host, TOL, config=config)
        t1 = time.perf_counter()
        return buf, mt.decompress(buf), t0, t1, time.perf_counter()
    leg = HostLeg(round_trip, after=(HostStream, "wait"),
                  before=(Compressor, "_host_lossless_decode"),
                  record=record)
    return leg, leg.start()


def host_lossless_finish(label, v_host, lossless, want, started,
                         device_times):
    """Finish :func:`host_lossless_start`'s round trip: error, ratio,
    launches (the encode's and the decode's card parts together: the
    flat path's transform kernels, no codec kernel).  The stream the
    API's host encode took must be ``_quantized_flat``'s on the card
    (from ``encode_device``), its result the container's section, and
    the stream the API's host decode gave back that stream bit for bit.
    With ``device_times`` the device encode (to the int stream) and
    decode (from it) by CUDA events and the encode's peak memory (the
    same device work for every host lossless)."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops.tridiag import table_scope

    leg, enc_counts = started
    (buf, out, t0, t1, t2), dec_counts, waited = leg.finish()
    counts = {k: enc_counts[k] + dec_counts[k] for k in enc_counts}
    dec_ms = 1e3 * (leg.t_held - t1 + t2 - leg.t_go)
    header, sections = fmt.read_container(buf)
    err = card_max_err(v_host, out)
    del out
    calls = leg.calls
    (enc_args, section, _), = calls["_host_lossless_encode"]
    (dec_args, back, _), = calls["_host_lossless_decode"]
    names = {"_host_lossless_encode": f"{lossless.name} host encode",
             "_host_lossless_decode": f"{lossless.name} host decode"}
    ms = {names.get(k, k): round(sum(c[2] for c in x), 3)
          for k, x in calls.items()}
    log(f"{label}: {len(buf)} bytes, ratio {v_host.nbytes / len(buf)!r}, "
        f"max|v - out| = {err!r} (tolerance {TOL}); API compress "
        f"{1e3 * (t1 - t0):.3f} ms, decompress {dec_ms:.3f} ms (its hold "
        f"before the card part left out; {waited:.3f} s waited here for "
        f"the host work); host stages (ms) {ms} (host clock, recorded "
        f"inside the API round trip; each host encode and decode includes "
        f"the stages listed after it)")
    expect_launches(label, counts, want)
    if header.lossless != int(lossless) or len(sections) != 1 \
            or not err <= TOL:
        raise AssertionError(f"{label}: lossless {header.lossless}, "
                             f"{len(sections)} sections, error {err}")
    comp = mt.get_compressor(v_host.shape, v_host.dtype,
                             config=mt.Config(lossless=lossless))
    v = torch.from_numpy(v_host).cuda()
    flat, status = comp.encode_device(v, TOL)
    flat_host = flat.cpu().numpy()
    same_input = bool(np.array_equal(enc_args[1], flat_host))
    same_section = section == sections[0] and dec_args[1] == sections[0]
    same_stream = bool(np.array_equal(back, flat_host))
    log(f"{label}: int stream {flat_host.dtype} x {flat_host.size}, status "
        f"{int(status)}; the API's host encode took _quantized_flat's "
        f"stream on the card: {same_input}, and gave the container's "
        f"section: {same_section}; the API's host decode gave that stream "
        f"back bit for bit: {same_stream}")
    if not (same_input and same_section and same_stream):
        raise AssertionError(f"{label}: the host codec's section or "
                             "stream differs")
    del flat_host, back, section, enc_args, dec_args, calls, leg
    if not device_times:
        del v, flat
        return len(buf)

    def decode():
        with table_scope():
            return comp._flat_to_array(flat, TOL)
    enc_ms = cuda_ms(lambda: comp.encode_device(v, TOL), 3)
    dec_dev_ms = cuda_ms(decode, 3)
    log(f"{label}: device encode (to the int stream) {enc_ms:.3f} ms, "
        f"device decode (from it) {dec_dev_ms:.3f} ms (CUDA events)")
    encode_peak(label, comp, v, TOL)
    del v, flat
    torch.cuda.empty_cache()
    return len(buf)


def lz4_path(v_host, main_buf, main_counts):
    """BITPLANE_LZ4: the main path's launches, and each LZ4-decompressed
    section the unstaged BITPLANE container's (the main path's) byte for
    byte; the LZ4 decompress by the host clock."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.io.lz4_native import lz4_decompress

    header, buf, _, counts = drive("BITPLANE_LZ4 path", v_host, mt.Config(
        lossless=mt.Lossless.BITPLANE_LZ4, adapt_lossless=False))
    expect_launches("BITPLANE_LZ4 path", counts, dict(main_counts))
    plain = fmt.read_container(main_buf)[1]
    staged = fmt.read_container(buf)[1]
    raw, dec_ms = [], 0.0
    for s in staged:
        r, ms = host_timed(lz4_decompress, s)
        raw.append(r)
        dec_ms += ms
    log(f"BITPLANE_LZ4 path: sections {[len(s) for s in plain]} -> "
        f"{[len(s) for s in staged]} bytes; LZ4 decompress {dec_ms:.3f} ms "
        f"(host clock); each section the "
        f"unstaged container's byte for byte: {raw == plain}")
    if header.lossless != int(mt.Lossless.BITPLANE_LZ4) or raw != plain:
        raise AssertionError("BITPLANE_LZ4: sections differ from the "
                             "unstaged container's")
    return len(buf)


def zstd_paths(v_host):
    """The zstd losslesses: a round trip where ``zstandard`` is installed;
    where it is not, each must raise ModuleNotFoundError (no other
    bytes written).  Returns which of the two happened."""
    import mgard_tpu_torch as mt

    try:
        import zstandard  # noqa: F401
    except ModuleNotFoundError:
        for lossless in (mt.Lossless.BITPLANE_ZSTD, mt.Lossless.HUFFMAN_ZSTD):
            try:
                mt.compress(v_host, TOL, config=mt.Config(lossless=lossless))
            except ModuleNotFoundError as e:
                log(f"zstd: {lossless.name} raised ModuleNotFoundError "
                    f"({e}) without zstandard, as it must")
            else:
                raise AssertionError(f"{lossless.name} wrote a container "
                                     "without zstandard")
        return "raised (no zstandard)"
    for lossless in (mt.Lossless.BITPLANE_ZSTD, mt.Lossless.HUFFMAN_ZSTD):
        buf = mt.compress(v_host, TOL, config=mt.Config(lossless=lossless))
        err = card_max_err(v_host, mt.decompress(buf))
        log(f"zstd: {lossless.name} {len(buf)} bytes, ratio "
            f"{v_host.nbytes / len(buf)!r}, max|v - out| = {err!r}")
        if not err <= TOL:
            raise AssertionError(f"{lossless.name}: error {err}")
    return "round trips ran"


def host_codec_paths(v_host, main_buf, main_counts, flat_counts):
    """The host losslesses and second stages (see the module docstring),
    HUFFMAN_ZLIB's round trip last: it is started here and its host work
    goes on beside the phases that follow; returns (the container sizes,
    its started leg) for :func:`huffman_zlib_finish`."""
    import mgard_tpu_torch as mt

    want = transform_counts(flat_counts)
    sizes = {"BITPLANE": len(main_buf)}
    lossless = mt.Lossless.NONE
    none = host_lossless_start(v_host, lossless)
    sizes["BITPLANE_LZ4"] = lz4_path(v_host, main_buf, main_counts)
    zstd = zstd_paths(v_host)
    sizes[lossless.name] = host_lossless_finish(
        f"{lossless.name} path", v_host, lossless, want, none,
        device_times=False)
    log(f"host codecs: zstd {zstd}; HUFFMAN_ZLIB's round trip started, its "
        f"host work (Huffman, zlib) goes on beside the phases that follow")
    return sizes, host_lossless_start(v_host, mt.Lossless.HUFFMAN_ZLIB)


def huffman_zlib_finish(v_host, flat_counts, started):
    """Phase "host codecs, HUFFMAN_ZLIB": finish the round trip that
    :func:`host_codec_paths` started."""
    import mgard_tpu_torch as mt

    sizes, leg = started
    lossless = mt.Lossless.HUFFMAN_ZLIB
    sizes[lossless.name] = host_lossless_finish(
        f"{lossless.name} path", v_host, lossless,
        transform_counts(flat_counts), leg, device_times=True)
    log(f"host codecs: container bytes {sizes}")


def roi_path(v_host, flat_counts):
    """MGARD-ROI at 512^3: compress_roi (threshold 0.5, block 8) and the
    API's decompress with the launch counters around them (the flat
    path's transform kernels, no codec kernel); error <= tol on ROI and
    buffer nodes and <= scalar * tol on background ones; the ratio
    against the per-group container of the same field; compress_roi's
    peak device memory."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.models import roi
    from mgard_tpu_torch.ops import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    with CallPeak() as peak:
        buf = roi.compress_roi(v_host, TOL, threshold=ROI_THRESHOLD,
                               block=ROI_BLOCK)
    t1 = time.perf_counter()
    PLANNER_PEAKS["ROI compress 512^3"] = peak.factor(v_host.nbytes)
    log(f"ROI path: compress_roi's peak device memory "
        f"{peak.bytes} bytes = {peak.factor(v_host.nbytes):.4f}x the "
        f"input's (no planner governs the call)")
    out = mt.decompress(buf)
    t2 = time.perf_counter()
    counts = _build.launch_counts()
    expect_launches("ROI path", counts, transform_counts(flat_counts))
    header = fmt.read_container(buf)[0]
    hier = mt.Hierarchy(SHAPE)
    v = torch.from_numpy(v_host).cuda()
    umap = roi.build_roi_map(hier, v, ROI_THRESHOLD, ROI_BLOCK)
    err = (torch.from_numpy(out).cuda().double() - v.double()).abs()
    del out
    inside = float(err[umap != roi.BACKGROUND].max())
    outside = float(err.max())
    shares = [int((umap == k).sum()) for k in (roi.ROI, roi.BUFFER_ZONE,
                                               roi.BACKGROUND)]
    del err, umap, v
    group = mt.compress(v_host, TOL, config=mt.Config(
        lossless=mt.Lossless.BITPLANE_GROUP))
    log(f"ROI path: nodes ROI/buffer/background {shares}, scalar "
        f"{header.roi_scalar}; max error on ROI and buffer nodes "
        f"{inside!r} (tolerance {TOL}), everywhere {outside!r} (bound "
        f"{header.roi_scalar * TOL}); {len(buf)} bytes, ratio "
        f"{v_host.nbytes / len(buf)!r}, against the per-group container's "
        f"{v_host.nbytes / len(group)!r} ({len(group)} bytes); "
        f"compress_roi {1e3 * (t1 - t0):.3f} ms, decompress "
        f"{1e3 * (t2 - t1):.3f} ms (host clock)")
    if not (inside <= TOL and outside <= header.roi_scalar * TOL
            and header.roi_block == ROI_BLOCK):
        raise AssertionError(f"ROI path: errors {inside}, {outside}")
    torch.cuda.empty_cache()


def qoi_path(v_host, main_counts):
    """MGARD-QOI at 512^3: a box-mean functional, its Riesz solve and
    component norms on the card (S1 along each dim at the finest level,
    then at every level of the norms), the norms against the port's CPU
    ones at QOI_CPU_SHAPE (rtol 1e-9), compress_qoi at s = 0 with
    |Q(u) - Q(u')| <= tol, and the norms again with each of S1's 30
    calls held bit for bit against its plain version."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.models import qoi
    from mgard_tpu_torch.ops import _build, norms

    def box(shape):
        return tuple(slice(n // 4, n // 4 + n // 3) for n in shape)

    sl = box(QOI_CPU_SHAPE)
    card = qoi.QuantityOfInterest(mt.Hierarchy(QOI_CPU_SHAPE),
                                  lambda u: u[sl].mean())
    cpu = qoi.QuantityOfInterest(mt.Hierarchy(QOI_CPU_SHAPE),
                                 lambda u: u[sl].mean(), device="cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        card.component_square_norms, cpu.component_square_norms) if b)
    log(f"QoI {QOI_CPU_SHAPE}: component norms card against CPU, max "
        f"relative difference {rel!r} (rtol {QOI_RTOL})")
    if not rel <= QOI_RTOL:
        raise AssertionError(f"QoI norms differ by {rel}")
    hier = mt.Hierarchy(SHAPE)
    sl = box(SHAPE)
    _build.reset_launches()
    t0 = time.perf_counter()
    q = qoi.QuantityOfInterest(hier, lambda u: u[sl].mean())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    solves = _build.launch_counts()[SOLVE_NAME]
    norm = q.norm(0.0)
    tol = 1e-4
    _build.reset_launches()
    t2 = time.perf_counter()
    buf = qoi.compress_qoi(v_host, q, tol, s=0.0)
    out = mt.decompress(buf)
    t3 = time.perf_counter()
    counts = _build.launch_counts()
    want = {k: main_counts[k] for k in ("extract_coarse_3d", "gpk_detail",
                                        "gpk_prolong_add")}
    expect_launches("QoI path", counts, want)
    qv = float(torch.from_numpy(v_host[sl]).cuda().double().mean())
    qo = float(torch.from_numpy(out[sl]).cuda().double().mean())
    del out
    # the same norms again with every S1 call held bit for bit against
    # its plain version on its own input (float64, at each level's shape)
    with SolveProbe(hier, check=True, where=(qoi, norms)) as probe:
        checked = qoi.QuantityOfInterest(hier, lambda u: u[sl].mean())
    probe.verdict("QoI 512^3")
    shapes = sorted({(n, axis, shape) for n, axis, shape, *_ in probe.calls},
                    reverse=True)
    log(f"QoI 512^3: S1 calls held against the plain version "
        f"{len(probe.checked)}, (nodes, axis, shape) {shapes}; norms the "
        f"same as the unprobed run's: "
        f"{checked.component_square_norms == q.component_square_norms}")
    if len(probe.checked) != 3 * (hier.L + 1) \
            or checked.component_square_norms != q.component_square_norms:
        raise AssertionError(f"QoI: {len(probe.checked)} S1 calls checked, "
                             f"or the norms differ")
    del checked, probe
    log(f"QoI path: ||Q||_(-0) = {norm!r}, component norms "
        f"{q.component_square_norms}; S1 launches {solves} (expected "
        f"{3 * (hier.L + 1)}); norms {1e3 * (t1 - t0):.3f} ms, "
        f"compress_qoi + decompress {1e3 * (t3 - t2):.3f} ms (host clock); "
        f"{len(buf)} bytes, ratio {v_host.nbytes / len(buf)!r}; "
        f"|Q(u) - Q(u')| = {abs(qv - qo)!r} (tolerance {tol})")
    if solves != 3 * (hier.L + 1) or not abs(qv - qo) <= tol:
        raise AssertionError(f"QoI path: {solves} solves, error "
                             f"{abs(qv - qo)}")
    torch.cuda.empty_cache()
    return solves


def mdr_retrieve(rec, result, counts, start=None):
    """Feed a reconstructor the streams of ``counts`` (past ``start``'s)
    and return the bytes fed."""
    fed = 0
    for l, c in enumerate(counts):
        streams = {} if start else {0: result.streams[l][0]}
        for b in range(start[l] if start else 0, c):
            streams[1 + b] = result.streams[l][1 + b]
        rec.add_streams(l, streams)
        fed += sum(len(x) for x in streams.values())
    return fed


def mdr_path(v_host, main_counts):
    """MDR at 512^3 with LOSSLESS_NONE: refactor on the card (K1 where its
    gate admits, K5 once), then for each tolerance and interpreter a
    request, the bytes it retrieves and a reconstruction (K6 once each)
    within the tolerance; incremental reconstruction (1e-2, then the
    streams for 1e-4 added) equal to a one-shot 1e-4 one, bit for bit;
    refactor and reconstruct times; the refactor's peak device memory."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.models import mdr
    from mgard_tpu_torch.ops import _build

    hier = mt.Hierarchy(SHAPE)
    v = torch.from_numpy(v_host).cuda()
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CallPeak() as peak:
        res = mdr.mdr_refactor(hier, v, lossless=mdr.LOSSLESS_NONE)
    t1 = time.perf_counter()
    counts = _build.launch_counts()
    # the input was on the card before the call: counted as in a planner
    factor = peak.factor(v_host.nbytes, held=v_host.nbytes)
    PLANNER_PEAKS["MDR refactor 512^3"] = factor
    log(f"MDR refactor: peak device memory {peak.bytes + v_host.nbytes} "
        f"bytes with the input = {factor:.4f}x the input's (no planner "
        f"governs the call)")
    expect_launches("MDR refactor", counts, {
        "extract_coarse_3d": main_counts["extract_coarse_3d"],
        "gpk_detail": 1, "gpk_prolong_add": 0})
    md = res.metadata
    total = sum(len(x) for st in res.streams for x in st)
    log(f"MDR refactor: {1e3 * (t1 - t0):.3f} ms (host clock, the streams "
        f"read back), {md.num_bitplanes} planes, {total} stream bytes, "
        f"exponents {[lm.exponent for lm in md.levels]}")
    table = {}
    for tol in MDR_TOLS:
        for st in MDR_STRATEGIES:
            plan = mdr.mdr_request(md, tol, strategy=st)
            rec = mdr.MDReconstructor(hier, md)
            fed = mdr_retrieve(rec, res, plan)
            _build.reset_launches()
            t2 = time.perf_counter()
            out = rec.reconstruct(plan)
            t3 = time.perf_counter()
            k6 = _build.launch_counts()["gpk_prolong_add"]
            err = card_max_err(v_host, out)
            table[(tol, st)] = (fed, err)
            log(f"MDR {st} at {tol}: planes {plan}, {fed} bytes retrieved, "
                f"max|v - out| = {err!r}, reconstruct {1e3 * (t3 - t2):.3f} "
                f"ms (host clock), K6 {k6}")
            if not err <= tol or k6 != 1:
                raise AssertionError(f"MDR {st} at {tol}: error {err}, K6 "
                                     f"{k6}")
            del out
    c1, c2 = (mdr.mdr_request(md, t) for t in (MDR_TOLS[0], MDR_TOLS[-1]))
    rec = mdr.MDReconstructor(hier, md)
    mdr_retrieve(rec, res, c1)
    rec.reconstruct(c1)
    mdr_retrieve(rec, res, c2, start=c1)
    step = rec.reconstruct(c2)
    one = mdr.mdr_reconstruct(hier, res, MDR_TOLS[-1])
    same = np.array_equal(step.view(np.int32), one.view(np.int32))
    log(f"MDR incremental {MDR_TOLS[0]} then {MDR_TOLS[-1]}: equal to a "
        f"one-shot {MDR_TOLS[-1]} reconstruction bit for bit: {same}; "
        f"retrieved bytes (tolerance, interpreter): "
        f"{ {k: b for k, (b, _) in table.items()} }")
    if not same:
        raise AssertionError("MDR incremental reconstruction differs")
    del v, step, one
    torch.cuda.empty_cache()


# The multi-block phase: a field over Config.max_block_bytes (2 GiB), the
# size the default compress splits into two (512, 1024, 1024) slabs, and a
# lopsided field that adjust_shape stores as (256, 256, 4096).
MB_SHAPE = (1024, 1024, 1024)
ADJUST_SHAPE = (16, 4096, 4096)
REL_TOL = 1e-4
# K2-K4 are checked on a slab at this tolerance too: its stream then
# passes 2^28 words, which no other check reaches.
OFFSET_TOL = 1e-6
DD_SIZES = (100, 200, 212)
ND_EDGE = 256
# JAX's footprint estimate per input byte (api.estimate_memory_footprint).
FOOTPRINT_PER_BYTE = 3.9 * 1.15


def smooth_field_slabs(shape, seed=SEED, slab_values=1 << 26):
    """bench.py's kind of field (three separable cosine modes plus 1e-3
    Gaussian noise) for a 3-D shape, in a host array, built in float32 on
    the card slab by slab along dim 0 and copied back slab by slab; the
    noise is drawn from one CUDA generator seeded with ``seed``, slab
    after slab (so its values are not those of a numpy generator)."""
    import torch
    n0, n1, n2 = shape
    rows = max(1, slab_values // (n1 * n2))
    modes = []
    for k in (1, 3, 7):
        c = [torch.cos(np.pi * k * torch.linspace(
            0.0, 1.0, n, dtype=torch.float32, device="cuda")
            + 0.1 * k * (d + 1)) for d, n in enumerate(shape)]
        modes.append((c[0], (c[1][:, None] * c[2][None, :]) / k))
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = np.empty(shape, dtype=np.float32)
    for a in range(0, n0, rows):
        sl = 0.001 * torch.randn((min(rows, n0 - a), n1, n2), generator=g,
                                 device="cuda")
        for c0, plane in modes:
            sl += c0[a:a + rows, None, None] * plane[None]
        out[a:a + rows] = sl.cpu().numpy()
    return out


def _card_slabs(*arrays, slab_values=1 << 26):
    """Matching dim-0 slabs of host arrays, on the card in float64."""
    import torch
    n1n2 = int(np.prod(arrays[0].shape[1:]))
    rows = max(1, slab_values // n1n2)
    for a in range(0, arrays[0].shape[0], rows):
        yield [torch.from_numpy(x[a:a + rows]).cuda().double()
               for x in arrays]


def card_max_err(v, out) -> float:
    """max|v - out| in float64 on the card, slab by slab (NaN if out
    holds a non-finite value)."""
    err = 0.0
    for vs, os_ in _card_slabs(v, out):
        d = float((os_ - vs).abs().max())
        err = d if d != d else max(err, d)
        if err != err:
            break
    return err


def card_max_abs(v) -> float:
    """max|v| on the card, slab by slab."""
    return max(float(vs.abs().max()) for (vs,) in _card_slabs(v))


def round_trip(label, v, tol, **kw):
    """One API compress and decompress with the launch counters set to 0
    just before and read just after: (container, header, sections,
    output, counts, compress s, decompress s)."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    buf = mt.compress(v, tol, **kw)
    t1 = time.perf_counter()
    out = mt.decompress(buf)
    t2 = time.perf_counter()
    counts = _build.launch_counts()
    header, sections = fmt.read_container(buf)
    if out.shape != v.shape or out.dtype != v.dtype:
        raise AssertionError(f"{label}: output {out.shape} {out.dtype}")
    log(f"{label}: {v.shape} {v.dtype} -> stored {header.shape}, "
        f"{header.dd_nblocks} blocks (dd_dim {header.dd_dim}, edges "
        f"{header.dd_edges}, grid {header.dd_grid}), {len(buf)} bytes, "
        f"ratio {v.nbytes / len(buf)!r}; API compress "
        f"{1e3 * (t1 - t0):.3f} ms, decompress {1e3 * (t2 - t1):.3f} ms "
        f"(host clock, numpy in and out); launches {counts}")
    return buf, header, sections, out, counts, t1 - t0, t2 - t1


def block_device_times(comp, vb, header, sections):
    """One block's device encode and decode by CUDA events, and the
    encode's peak device memory (the block's input counted, as in the
    JAX estimate) over the block's bytes."""
    import torch

    bound = header.tolerance
    outs = comp.encode_device(vb, bound)          # tables made, warm
    del outs
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = comp.encode_device(vb, bound)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before + vb.nbytes
    del outs
    exps, words = comp.stream_tensors(header, sections)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    comp.decode_device(exps, words, bound)
    torch.cuda.synchronize()
    dec_peak = torch.cuda.max_memory_allocated() - before
    enc_ms = cuda_ms(lambda: comp.encode_device(vb, bound), 3)
    dec_ms = cuda_ms(lambda: comp.decode_device(exps, words, bound), 3)
    del exps, words
    torch.cuda.empty_cache()
    gb = vb.nbytes / 1e9
    log(f"block {tuple(vb.shape)}: device encode {enc_ms:.3f} ms "
        f"({gb / enc_ms * 1e3:.2f} GB/s), decode {dec_ms:.3f} ms "
        f"({gb / dec_ms * 1e3:.2f} GB/s) (CUDA events); encode peak "
        f"{peak} bytes = {peak / vb.nbytes:.4f}x the block's "
        f"{vb.nbytes} bytes (JAX estimate {FOOTPRINT_PER_BYTE:.4f}x), "
        f"decode peak above its input {dec_peak} bytes = "
        f"{dec_peak / vb.nbytes:.4f}x")
    if not peak <= FOOTPRINT_PER_BYTE * vb.nbytes:
        log(f"block {tuple(vb.shape)}: the encode's peak exceeds the JAX "
            "estimate")


def host_memory(label):
    """Log PyTorch's pinned host cache (bytes held now, at the peak and
    in all since the last reset, allocations and frees and the
    microseconds they took), the host tables' page-locked bytes and the
    process's peak resident set."""
    import torch
    from mgard_tpu_torch.ops import tridiag
    stats = {}
    if hasattr(torch.cuda, "host_memory_stats"):
        stats = {k: v for k, v in torch.cuda.host_memory_stats().items()
                 if k.startswith(("allocated_bytes.", "num_host_",
                                  "host_alloc_time.total",
                                  "host_free_time.total"))}
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10
    log(f"{label}: pinned host cache {stats}; host tables page-locked "
        f"{tridiag.locked_bytes()} bytes; process peak RSS {peak_rss} "
        f"bytes")


def level_kernel_errs(hier, v, split=False) -> dict:
    """K1, K5 and K6 against their plain versions (max|diff|, one entry a
    level) at every level of ``hier`` that their gates admit, down the
    decomposition of ``v`` (each level's coarse part plus its
    correction), or with ``split`` down the split of a fine-order array
    into its pyramid (each level's coarse nodes; K1 only); each level's
    tables in a table scope of its own, as the transform copies them."""
    from mgard_tpu_torch.ops import extract_kernels as xk, transform
    from mgard_tpu_torch.ops import stencil_kernels as sk, tridiag

    errs = {k: [] for k in ("extract_coarse_3d", "gpk_detail",
                            "gpk_prolong_add")}
    A = v
    for l in range(hier.L, 0, -1):
        with tridiag.table_scope():     # as a call copies them
            if xk.extract_supported(hier, l, A):
                errs["extract_coarse_3d"].append(max_abs_diff(
                    xk.extract_coarse_3d(hier, A, l),
                    xk.extract_coarse_3d_plain(
                        A, xk._coarse_index(hier, l, A.device))))
            Cl = transform._extract_old_all(hier, A, l)
            if split:
                A = Cl
                continue
            if sk.gpk_supported(hier, l, A):
                det = sk.gpk_detail(hier, A, l)
                errs["gpk_detail"].append(max_abs_diff(
                    det, sk.gpk_detail_plain(hier, A, l)))
                errs["gpk_prolong_add"].append(max_abs_diff(
                    sk.gpk_prolong_add(hier, Cl, det, l),
                    sk.gpk_prolong_add_plain(hier, Cl, det, l)))
            else:
                det = A - transform._prolong_all(hier, Cl, l)
            A = Cl + transform._correction(hier, det, l)
            del Cl, det
    return errs


def check_block_kernels(label, comp, v, tol, sections=None,
                        stencil=True) -> int:
    """K1-K6 bit for bit against their plain versions at one block's own
    shape: K1, K5 and K6 at every level of the block's decomposition
    that their gates admit (at least one unless ``stencil`` is false, as
    for a 1-D series), K2-K4 on its pyramid quantized at ``tol``.
    With ``sections`` (the block's in a container), K3's stream must be
    theirs, and K4 and its plain version decode the container's own
    words.  Returns the stream's word count."""
    import torch
    from mgard_tpu_torch.ops import bitplane, bp_kernels as bk, transform
    from mgard_tpu_torch.ops.quantize import inverse_quantum, \
        supremum_quantum

    hier, C = comp.hier, comp.chunk_groups
    errs = level_kernel_errs(hier, v)
    pyr = [p.reshape(-1).contiguous() for p in transform.decompose(hier, v)]
    inv_q = float(inverse_quantum(hier, tol))
    quantum = float(supremum_quantum(hier, tol))
    ncs = [bitplane.num_chunks_tiled(p.numel(), C) for p in pyr]
    starts = np.concatenate([[0], np.cumsum(ncs)]).astype(int)
    zmax, flags = bk.bp_quant_max_segments(pyr, ncs, C, inv_q)
    errs["bp_quant_max"] = [max_abs_diff(g, w) for g, w in zip(
        (zmax, flags), bk.bp_quant_max_segments_plain(pyr, ncs, C, inv_q))]
    if int(flags.max()):
        raise AssertionError(f"{label}: nonzero codec status at tol {tol}")
    e = bitplane._bit_length32(zmax)
    offsets = bitplane._offsets(e)
    nwords = int(e.sum()) * C
    words = torch.zeros(sum(ncs) * 33 * C, dtype=torch.int32,
                        device=v.device)
    words_plain = torch.zeros_like(words)
    for fn, buf in ((bk.bp_quant_condense, words),
                    (bk.bp_quant_condense_plain, words_plain)):
        for p, nc, a in zip(pyr, ncs, starts):
            fn(p, nc, C, inv_q, offsets[a:a + nc], e[a:a + nc], buf)
    errs["bp_quant_condense"] = [max_abs_diff(words, words_plain)]
    del words_plain
    stream = words[:nwords]
    if sections is not None:
        stored = np.frombuffer(sections[0], dtype=np.uint8)
        e_host = e.cpu().numpy()
        stream = torch.from_numpy(
            np.frombuffer(sections[1], dtype="<i4").astype(np.int32)).cuda()
        if not (np.array_equal(e_host[:len(stored)], stored)
                and not e_host[len(stored):].any()
                and torch.equal(stream, words[:nwords])):
            raise AssertionError(f"{label}: K3's stream is not the "
                                 "container's")
    del words
    errs["bp_decode_condense_f32"] = [
        max_abs_diff(bk.bp_decode_condense_f32(stream, C, offsets[a:a + nc],
                                               e[a:a + nc], quantum,
                                               p.numel()),
                     bk.bp_decode_condense_f32_plain(
                         stream, C, offsets[a:a + nc], e[a:a + nc], quantum,
                         p.numel()))
        for p, nc, a in zip(pyr, ncs, starts)]
    del stream, pyr
    torch.cuda.empty_cache()
    log(f"{label}: {tuple(v.shape)} at tol {tol}: K1-K6 against their "
        f"plain versions (tolerance 0, one entry a level or segment): "
        f"{errs}; {len(ncs)} segments, {sum(ncs)} chunks, {nwords} stream "
        f"words (2^28 = {1 << 28}, 2^31 = {1 << 31})"
        + ("; K3's stream is the container's and K4 decoded it"
           if sections is not None else ""))
    stencils = ("extract_coarse_3d", "gpk_detail", "gpk_prolong_add")
    bad = {k: x for k, x in errs.items() if any(y != 0.0 for y in x)
           or not (x or (k in stencils and not stencil))}
    if bad:
        raise AssertionError(f"{label}: kernels missing or differing from "
                             f"their plain versions: {bad}")
    return nwords


def multiblock_default(v, lap):
    """The default compress of the 1024^3 field: two slabs along dim 0,
    L-infinity 1e-3, twice one slab's launches, block 1's sections those
    of a one-domain compress of its slab, one block's device times and
    peak memory."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch import api
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import _build

    budget = api._device_memory_budget(torch.device("cuda"))
    nb = api.plan_blocks(v.shape, v.dtype, mt.Config(), "cuda")
    log(f"plan: budget {budget} bytes (free + cached unused), estimate "
        f"{mt.estimate_memory_footprint(v.shape, v.dtype)} bytes, "
        f"{nb} blocks")
    for reset in ("reset_peak_host_memory_stats",
                  "reset_accumulated_host_memory_stats"):
        if hasattr(torch.cuda, reset):
            getattr(torch.cuda, reset)()
    buf, header, sections, out, counts, _, _ = round_trip(
        "multi-block default", v, TOL)
    host_memory("after the multi-block round trip")
    err = card_max_err(v, out)
    log(f"multi-block default: max|v - out| = {err!r} (tolerance {TOL})")
    if (header.dd_nblocks, header.dd_dim, header.dd_edges, header.dd_grid,
            len(sections)) != (2, 0, None, None, 4) or nb != 2:
        raise AssertionError(f"expected 2 slabs along dim 0: {header}")
    if not err <= TOL:
        raise AssertionError(f"multi-block error {err} exceeds {TOL}")
    lap("1024^3 round trip")

    # block 1 against a one-domain compress of its slab
    half = v.shape[0] // 2
    slab = v[half:]
    comp = mt.get_compressor(slab.shape, v.dtype, config=mt.Config().replace(
        lossless=mt.Lossless(header.lossless), adapt_lossless=False))
    _build.reset_launches()
    single = comp.compress(slab, header.tolerance)
    one_out = mt.decompress(single)
    slab_counts = _build.launch_counts()
    sh, ss = fmt.read_container(single)
    same = ss == sections[2:4]
    log(f"slab {slab.shape} alone: launches {slab_counts}; its sections "
        f"are block 1's byte for byte: {same}")
    if not same:
        raise AssertionError("block 1's sections differ from a one-domain "
                             "compress of its slab")
    if counts != {k: 2 * n for k, n in slab_counts.items()}:
        raise AssertionError(f"multi-block launches {counts} are not twice "
                             f"one slab's {slab_counts}")
    missing = [k for k in SEGMENTED_KERNELS if not counts[k]]
    if missing:
        raise AssertionError(f"not launched on the multi-block path: "
                             f"{missing}")
    del one_out
    lap("slab alone")
    vb = torch.from_numpy(slab).cuda()
    block_device_times(comp, vb, sh, ss)
    lap("slab device times")
    check_block_kernels("slab kernels", comp, vb, header.tolerance, ss)
    lap("slab kernels")
    nwords = check_block_kernels("slab kernels", comp, vb, OFFSET_TOL)
    lap(f"slab kernels at {OFFSET_TOL}")
    if not nwords > 1 << 28:
        raise AssertionError(f"the stream at tol {OFFSET_TOL} holds "
                             f"{nwords} words, not over 2^28")
    del vb, single

    del out
    torch.cuda.empty_cache()
    return counts


def two_slab_paths(v512):
    """The main field cut into two slabs along dim 0 (``max_block_bytes``
    half its bytes), L-infinity 1e-3 and REL 1e-4: the round trip at the
    default pipeline depth; REL's norm max|v| taken block by block on the
    card.  Returns {mode: (container, launches of its compress)} for the
    sharded phase."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import _build

    cfg = mt.Config(max_block_bytes=v512.nbytes // 2)
    bufs = {}
    for mode, tol in (("abs", TOL), ("rel", REL_TOL)):
        _build.reset_launches()
        t0 = time.perf_counter()
        buf = mt.compress(v512, tol, mode=mode, config=cfg)
        t1 = time.perf_counter()
        counts = _build.launch_counts()
        out = mt.decompress(buf)
        t2 = time.perf_counter()
        bufs[mode] = (buf, counts)
        header = fmt.read_container(buf)[0]
        err = card_max_err(v512, out)
        bound = tol * header.norm
        log(f"two slabs {mode}: {len(buf)} bytes, ratio "
            f"{v512.nbytes / len(buf)!r}, norm {header.norm!r}, max|v - out| "
            f"= {err!r} (bound {bound!r}); API compress "
            f"{1e3 * (t1 - t0):.3f} ms, decompress {1e3 * (t2 - t1):.3f} ms "
            f"(host clock); the compress's launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        if (header.dd_nblocks, header.dd_dim) != (2, 0) or not err <= bound:
            raise AssertionError(f"two slabs {mode}: {header.dd_nblocks} "
                                 f"blocks along {header.dd_dim}, error {err}")
        if mode == "rel":
            vmax = card_max_abs(v512)
            if header.norm != float(np.float32(vmax)):
                raise AssertionError(f"REL norm {header.norm} is not "
                                     f"max|v| {vmax}")
        del out
    return bufs


def variable_and_nd_blocks(v512, lap):
    """At 512^3: Variable slabs (dd_sizes) at s = 0, each block's
    ||v_b - out_b||_0 on the card, combined as sqrt(sum of squares) within
    1e-3; N-D blocks of ND_EDGE^3 at L-infinity, K5 and K6 once a
    block."""
    import mgard_tpu_torch as mt

    _, header, _, out, _, _, _ = round_trip(
        "Variable slabs", v512, TOL, s=0.0,
        config=mt.Config(dd_sizes=DD_SIZES))
    edges = np.concatenate([[0], np.cumsum(DD_SIZES)])
    errs = [snorm_error(mt.Hierarchy(v512[a:b].shape), out[a:b], v512[a:b],
                        0.0) for a, b in zip(edges[:-1], edges[1:])]
    total = float(np.sqrt(np.sum(np.square(errs))))
    log(f"Variable slabs: ||v_b - out_b||_0 = {errs} (block bound "
        f"{header.tolerance!r}), combined {total!r} (tolerance {TOL})")
    if header.dd_edges != tuple(int(x) for x in edges) \
            or not total <= TOL:
        raise AssertionError(f"Variable slabs: edges {header.dd_edges}, "
                             f"combined error {total}")
    del out
    lap("Variable slabs")

    _, header, _, out, counts, _, _ = round_trip(
        "N-D blocks", v512, TOL,
        config=mt.Config(dd_method="block", block_edge=ND_EDGE))
    err = card_max_err(v512, out)
    grid = tuple(-(-n // ND_EDGE) for n in v512.shape)
    nblocks = int(np.prod(grid))
    log(f"N-D blocks: max|v - out| = {err!r} (tolerance {TOL})")
    if header.dd_grid != grid or header.dd_nblocks != nblocks \
            or counts["gpk_detail"] != nblocks \
            or counts["gpk_prolong_add"] != nblocks or not err <= TOL:
        raise AssertionError(f"N-D blocks: grid {header.dd_grid}, error "
                             f"{err}, launches {counts}")
    lap("N-D blocks")


def adjust_shape_path(lap):
    """A lopsided field with Config(adjust_shape=True): stored in the
    rebalanced shape, returned in its own; K1-K6 against their plain
    versions at the stored shape."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch import api

    w = smooth_field_slabs(ADJUST_SHAPE, seed=SEED + 1)
    lap("adjust_shape field")
    _, header, sections, out, _, _, _ = round_trip(
        "adjust_shape", w, TOL, config=mt.Config(adjust_shape=True))
    err = card_max_err(w, out)
    log(f"adjust_shape: orig_shape {header.orig_shape}, max|v - out| = "
        f"{err!r} (tolerance {TOL})")
    if header.shape != api.adjust_shape(ADJUST_SHAPE) \
            or header.shape == ADJUST_SHAPE \
            or header.orig_shape != ADJUST_SHAPE or not err <= TOL:
        raise AssertionError(f"adjust_shape: stored {header.shape}, "
                             f"orig_shape {header.orig_shape}, error {err}")
    del out
    lap("adjust_shape round trip")
    vw = torch.from_numpy(w.reshape(header.shape)).cuda()
    check_block_kernels("adjust_shape kernels", api.compressor_for(header),
                        vw, header.tolerance, sections)
    lap("adjust_shape kernels")


def multiblock_paths(v512):
    """The multi-block phase (see the module docstring)."""
    import torch

    torch.cuda.empty_cache()
    lap = Laps()
    v = smooth_field_slabs(MB_SHAPE)
    log(f"multi-block field {MB_SHAPE} float32, {v.nbytes} bytes, built "
        f"on the card, copied to the host")
    lap("1024^3 field")
    counts = multiblock_default(v, lap)
    del v
    two_slabs = two_slab_paths(v512)
    lap("two slabs")
    variable_and_nd_blocks(v512, lap)
    adjust_shape_path(lap)
    torch.cuda.empty_cache()
    return counts, two_slabs


# The long-dims phase: dims over transform._MATMUL_MAX_N = 4096 nodes take
# the per-dim transform, whose correction solves with S1.  LONG_SERIES is
# the length of one 1-D float32 particle field of the HACC cosmology code
# in SDRBench (1.12 GB, one domain, L = 29, 30 segments).
LONG_SERIES = 280953867
LONG_FIELD = (64, 512, 8192)
LONG_SQUARE = (8192, 8192)
# (ratio, max error) of (a) and (b) as PERF.md records them for the
# transform before the per-dim form's memory repair, which moves no bit.
LONG_SERIES_BEFORE = (1.643232256644465, 6.220489740371704e-05)
LONG_FIELD_BEFORE = (2.487497969357994, 2.4646520614624023e-05)
# S1 is held bit for bit against its plain version (a Python loop over
# the nodes) on solves of at most this many nodes.
SOLVE_PLAIN_MAX = 1 << 16
# Above that, max|M x - b| / max|b| in float64 must stay under this bound:
# 8x the largest that the plain version gives on the CPU at 2^20 + 1
# nodes in float32 (tools/solve_residual_bound.py: 1.51e-7 for normal b,
# 1.16e-7 for a smooth b, on a uniform grid).
SOLVE_RESIDUAL_BOUND = 1.2e-6
SOLVE_NAME = "mass_solve"


def smooth_field_card(shape, seed=SEED):
    """bench.py's kind of field (three separable cosine modes plus 1e-3
    Gaussian noise) built in float32 on the card, the noise from a CUDA
    generator seeded with ``seed``."""
    import torch
    f = torch.zeros(shape, dtype=torch.float32, device="cuda")
    for k in (1, 3, 7):
        term = None
        for d, n in enumerate(shape):
            x = torch.linspace(0.0, 1.0, n, dtype=torch.float32,
                               device="cuda")
            c = torch.cos(np.pi * k * x + 0.1 * k * (d + 1))
            shp = [1] * len(shape)
            shp[d] = n
            c = c.reshape(shp)
            term = c if term is None else term * c
        f += term / k
    g = torch.Generator(device="cuda").manual_seed(seed)
    f += 0.001 * torch.randn(shape, generator=g, device="cuda")
    return f


def fallback_pairs(hier):
    """The (level, dim) pairs whose correction takes the per-dim form:
    each solves once in each direction."""
    from mgard_tpu_torch.ops import transform
    return [(l, d) for l in range(1, hier.L + 1)
            if not transform._use_matmul(hier, l)
            for d in transform._level_dims(hier, l)]


def bits_equal(a, b) -> bool:
    import torch
    view = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


def solve_residual(b, x, lev, axis) -> float:
    """max|M x - b| / max|b| in float64, M the level's mass matrix (its
    float64 spacings scoped to this check, also inside a call on resident
    tables)."""
    from mgard_tpu_torch.ops import tridiag
    with tridiag.table_scope(resident=False):
        r = tridiag.mass_apply(x.double(), lev.h, axis)
    r -= b.double()
    return float(r.abs().max()) / float(b.abs().max())


class SolveProbe:
    """Wraps the ``mass_solve`` (S1) of the modules ``where`` (default:
    the transforms') for one run: records each call's nodes, axis and
    CUDA-event time, and with ``check`` holds the output bit for bit
    against the plain version on at most SOLVE_PLAIN_MAX nodes and by its
    float64 residual above."""

    def __init__(self, hier, check=False, where=None):
        self.hier, self.check, self.where = hier, check, where
        self.calls, self.checked = [], []

    def __enter__(self):
        import torch
        from mgard_tpu_torch.ops import transform, tridiag
        from mgard_tpu_torch.ops import transform_singledim as sd
        self.where = self.where or (transform, sd)
        self.saved = tridiag.mass_solve
        if any(m.mass_solve is not self.saved for m in self.where):
            raise AssertionError("a module's mass_solve is not S1's")

        def probe(b, offdiag, divisors, axis):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            x = self.saved(b, offdiag, divisors, axis)
            e.record()
            n = b.shape[axis]
            self.calls.append((n, axis, tuple(b.shape), s, e))
            if self.check:
                lev = next(lv for lv in self.hier.dims[axis]
                           if lv.divisors is divisors)
                if n <= SOLVE_PLAIN_MAX:
                    plain = tridiag.mass_solve_plain(b, offdiag, divisors,
                                                     axis)
                    self.checked.append((n, axis, "bits",
                                         bits_equal(x, plain)))
                else:
                    with tridiag.table_scope():
                        self.checked.append((n, axis, "residual",
                                             solve_residual(b, x, lev,
                                                            axis)))
            return x

        for m in self.where:
            m.mass_solve = probe
        return self

    def __exit__(self, *exc):
        for m in self.where:
            m.mass_solve = self.saved
        return False

    def times(self):
        import torch
        torch.cuda.synchronize()
        return [(n, axis, shape, s.elapsed_time(e))
                for n, axis, shape, s, e in self.calls]

    def verdict(self, label):
        bad = [c for c in self.checked
               if (c[2] == "bits" and not c[3])
               or (c[2] == "residual" and not c[3] <= SOLVE_RESIDUAL_BOUND)]
        log(f"{label}: S1 against its plain version, (nodes, axis, check, "
            f"result): {self.checked}")
        if bad or not self.checked:
            raise AssertionError(f"{label}: S1 checks failed: {bad}")


def table_costs(hier):
    """What the top level's tables of the per-dim form cost each call, two
    ways, host clock: copied from their host sides (the spacings and
    ratios of the level, S1's two tables of the level below), as the
    port does, and built on the card from the level's coordinates and the
    divisors of the level below, which are the same bits (timed here
    only, to choose between them)."""
    import torch
    from mgard_tpu_torch.ops import transform, tridiag

    l = hier.L
    lev, clev = hier.dims[0][l], hier.dims[0][l - 1]
    like = torch.empty(1, device="cuda")
    f = 2 * lev.front_nc - 1 if lev.front_nc else lev.n

    def copied():
        with tridiag.table_scope():
            got = (tridiag.along_axis(lev.h, like, 0),
                   tridiag.along_axis(lev.new_ratio, like, 0),
                   *tridiag._device_tables(clev.offdiag, clev.divisors,
                                           torch.float32, like.device))
            torch.cuda.synchronize()
            return [t.clone() for t in got]

    def built():
        x = torch.from_numpy(lev.x).cuda()
        h = x[1:] - x[:-1]
        xl, xm, xr = x[0:f - 2:2], x[1:f - 1:2], x[2:f:2]
        ratio = ((xm - xl) / (xr - xl)).float()
        xc = transform.extract_old(x, lev, 0)
        off = ((xc[1:] - xc[:-1]) / 6).float()
        div = torch.from_numpy(clev.divisors).cuda().float()
        got = (h.float(), ratio, off, div)
        torch.cuda.synchronize()
        return got

    # the host sides page-locked once, as the scoped path keeps them (the
    # resident path that the round trips took makes none)
    copied()
    times = {}
    for label, fn in (("copied", copied), ("built", built)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        times.setdefault(label, []).append(time.perf_counter() - t0)
        times[label + " tables"] = got
    same = all(bits_equal(a, b) for a, b in zip(times.pop("copied tables"),
                                                 times.pop("built tables")))
    nbytes = sum(t.numel() * t.element_size() for t in got)
    log(f"top level's tables ({lev.n} nodes, {nbytes} bytes on the card): "
        f"copied from the host {times['copied']} s, built on the card "
        f"{times['built']} s (host clock); the same bits: {same}")
    if not same:
        raise AssertionError("tables built on the card differ")


def unmoved(label, ratio, err, before, kept):
    """After a round trip of (a) or (b): no scoped table left on the card
    by it (``kept``: the bytes of scoped tables before it, those of
    earlier checks' own calls; the resident ones, kept for the life of
    the hierarchy, are logged apart), and the ratio and max error those
    of the transform before its memory repair (the repair moves no bit,
    nor does keeping the tables resident)."""
    from mgard_tpu_torch.ops import tridiag
    tables = device_tables_bytes() - kept
    log(f"{label}: scoped tables the round trip left on the card {tables} "
        f"bytes, resident tables {tridiag.resident_bytes()} bytes; ratio "
        f"{ratio!r} and max error {err!r} against "
        f"{before[0]!r} and {before[1]!r} before the repair")
    if tables or (ratio, err) != before:
        raise AssertionError(f"{label}: {tables} bytes of tables kept, or "
                             "the ratio or error moved")


def expect_launches(label, counts, want):
    """Raise unless each kernel named in ``want`` launched that often."""
    got = {k: counts[k] for k in want}
    log(f"{label}: launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def device_tables_bytes() -> int:
    """Bytes of the scoped tables that the operators hold on the card
    (``tridiag.cached_tensor`` and S1's coefficients): those of the open
    table scopes (``tridiag.table_scope``: one for each encode and
    decode, one for each level inside it); no such table outlives its
    scope.  The resident ones (a hierarchy admitted to the card) are
    ``tridiag.resident_bytes()``, counted apart."""
    import torch
    from mgard_tpu_torch.ops import tridiag
    total = 0
    for held in tridiag._SCOPES:
        for hit in held.values():
            for t in hit if isinstance(hit, tuple) else (hit,):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    total += t.numel() * t.element_size()
    return total


class TableProbe:
    """The most bytes of scoped tables the card held at once while the
    probe was open (:func:`device_tables_bytes` after each scoped table
    is made; a resident table is not made through ``tridiag._kept``)."""

    def __enter__(self):
        from mgard_tpu_torch.ops import tridiag
        self.saved, self.most = tridiag._kept, device_tables_bytes()

        def kept(arr, key, build):
            hit = self.saved(arr, key, build)
            self.most = max(self.most, device_tables_bytes())
            return hit

        tridiag._kept = kept
        return self

    def __exit__(self, *exc):
        from mgard_tpu_torch.ops import tridiag
        tridiag._kept = self.saved
        return False


def encode_peak(label, comp, v, bound):
    """The encode's peak device memory over the input's bytes (the input
    counted, as in the planner's estimate), the most bytes of scoped
    tables held within it, and the scoped tables it left on the card,
    which must be none; the peak must be within the planner's factor for
    this shape and configuration (``api.footprint_per_byte``; the peak is
    logged first).  Resident tables (``tridiag.resident_bytes``) are
    logged beside it: those the encode copied count in its peak, those
    held before it do not, as the admission counts them beside the
    planner's factor.  Returns the peak's factor."""
    import torch
    from mgard_tpu_torch import api
    from mgard_tpu_torch.ops import tridiag

    nbytes = v.numel() * v.element_size()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    kept = device_tables_bytes()    # those of earlier checks' own calls
    resident = tridiag.resident_bytes()
    torch.cuda.reset_peak_memory_stats()
    with TableProbe() as tables:
        comp.encode_device(v, bound)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before + nbytes
    after = device_tables_bytes() - kept
    made = tridiag.resident_bytes() - resident
    planned = api.footprint_per_byte(tuple(v.shape), comp.dtype,
                                     comp.config)
    log(f"{label}: encode peak {peak} bytes = {peak / nbytes:.4f}x the "
        f"input's {nbytes} bytes, scoped tables within it at most "
        f"{tables.most - kept} bytes = {(tables.most - kept) / nbytes:.4f}x; "
        f"scoped tables it left on the card {after} bytes; resident "
        f"tables {resident} bytes before it ({resident / nbytes:.4f}x, not "
        f"in the peak), {made} bytes made by it ({made / nbytes:.4f}x, in "
        f"the peak); the planner counts {planned:.4f}x")
    if after:
        raise AssertionError(f"{label}: {after} bytes of tables stay on "
                             "the card after the encode")
    if not peak <= planned * nbytes:
        raise AssertionError(f"{label}: the encode's peak {peak / nbytes}x "
                             f"exceeds the planner's {planned}x")
    return peak / nbytes


class CallPeak:
    """The peak device memory that the calls inside the block allocated
    beyond what the card held when it opened (``bytes``)."""

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        self.before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.bytes = torch.cuda.max_memory_allocated() - self.before
        return False

    def factor(self, nbytes, held=0) -> float:
        """The peak over an input of ``nbytes``, with ``held`` bytes (an
        input already on the card) counted in it."""
        return (self.bytes + held) / nbytes


def long_device_times(label, comp, v, header, sections):
    """Device encode and decode by CUDA events (one warm-up each), and
    S1's share of each: its calls timed inside one more encode and
    decode; the encode's peak memory (:func:`encode_peak`)."""
    import torch
    import mgard_tpu_torch as mt

    bound = header.tolerance
    nbytes = v.numel() * v.element_size()
    encode_peak(label, comp, v, bound)      # the encode's warm-up
    exps, words = comp.stream_tensors(header, sections)
    enc_ms = cuda_ms(lambda: comp.encode_device(v, bound), 1, warm=False)
    dec_ms = cuda_ms(lambda: comp.decode_device(
        exps, words, bound, mt.Lossless(header.lossless)), 1)
    with SolveProbe(comp.hier) as enc_probe:
        comp.encode_device(v, bound)
    with SolveProbe(comp.hier) as dec_probe:
        comp.decode_device(exps, words, bound, mt.Lossless(header.lossless))
    enc_s, dec_s = enc_probe.times(), dec_probe.times()
    del exps, words
    torch.cuda.empty_cache()
    gb = nbytes / 1e9
    solve_enc = sum(t for *_, t in enc_s)
    solve_dec = sum(t for *_, t in dec_s)
    log(f"{label}: device encode {enc_ms:.3f} ms ({gb / enc_ms * 1e3:.2f} "
        f"GB/s), decode {dec_ms:.3f} ms ({gb / dec_ms * 1e3:.2f} GB/s) "
        f"(CUDA events); S1 {solve_enc:.3f} ms of the encode "
        f"({solve_enc / enc_ms:.2%}), {solve_dec:.3f} ms of the decode "
        f"({solve_dec / dec_ms:.2%}); S1 calls in the encode (nodes, axis, "
        f"shape, ms): {enc_s}")
    return enc_s


def s1_bytes(b, axis) -> int:
    """The bytes S1 must move on ``b`` along ``axis``: b read and x written
    once, and its two tables (off, div) read once."""
    n, size = b.shape[axis], b.element_size()
    return 2 * b.numel() * size + (2 * n - 1) * size


def s1_library_ms(b, lev, axis, label):
    """One tensordot of the level's dense inverse mass matrix (built on
    the card in float64 outside the timed region, cast to the data's
    dtype) with ``b`` along ``axis``, as the dense-matrix correction
    applies it, timed in turns; returns (ms, its output)."""
    import torch
    from mgard_tpu_torch.ops import tridiag
    n = b.shape[axis]
    M = tridiag.mass_apply(torch.eye(n, dtype=torch.float64,
                                     device=b.device), lev.h, 0)
    Minv = torch.linalg.inv(M).to(b.dtype)
    del M
    lib = torch.tensordot(Minv, b, dims=([1], [axis])).movedim(0, axis)
    ms = turns_median(f"{label}: tensordot with the dense inverse",
                      lambda: torch.tensordot(Minv, b, dims=([1], [axis])))
    return ms, lib


def s1_turns(b, lev, axis, label, plain=True):
    """S1 on ``b`` along ``axis``: (x, bits equal to the plain version's,
    or None where ``plain`` is false, its median ms over TURNS queued
    turns with its tables copied once)."""
    from mgard_tpu_torch.ops import tridiag
    x = tridiag.mass_solve(b, lev.offdiag, lev.divisors, axis)
    same = plain and bits_equal(x, tridiag.mass_solve_plain(
        b, lev.offdiag, lev.divisors, axis))
    with tridiag.table_scope():     # its tables copied once
        ms = turns_median(f"{label}: S1", lambda: tridiag.mass_solve(
            b, lev.offdiag, lev.divisors, axis))
    return x, same, ms


def s1_record(b, lev, axis, name="S1 " + SOLVE_NAME):
    """S1 at one solve of the main path against its plain version: the
    kernels-line entry ``name`` (bit-identical, timed in turns) with a
    tensordot (:func:`s1_library_ms`) as its library time; float32 or
    float64, as ``b`` is."""
    from mgard_tpu_torch.ops import tridiag
    label = f"S1 on {tuple(b.shape)} {b.dtype} axis {axis}"
    x, same, ms = s1_turns(b, lev, axis, label)
    err = 0.0 if same else float((x - tridiag.mass_solve_plain(
        b, lev.offdiag, lev.divisors, axis)).abs().max()) or float("nan")
    lib_ms, lib = s1_library_ms(b, lev, axis, label)
    lib_err = float((lib.double() - x.double()).abs().max())
    del lib
    log(f"{label}: max|tensordot - S1| {lib_err:.3e}")
    results = []
    record(results, name, "mgard_tpu_torch/csrc/tridiag.cuh",
           "mgard_tpu/ops/tridiag.py:69 (lax.scan, no Pallas kernel)", err,
           ms,
           cuda_ms(lambda: tridiag.mass_solve_plain(
               b, lev.offdiag, lev.divisors, axis), 1, warm=False),
           s1_bytes(b, axis), 0, library_ms=lib_ms)
    return results[0]


def planted_lines(shape, axis, dtype, seed):
    """Normal data along ``axis`` with its first lines planted: a line of
    zeros, signed zeros at every third node, a NaN at node 300 (at the
    middle node of a shorter line) and values scaled to 1e-30 (a 1-D
    series: the zeros, signed zeros and small values in stretches of the
    one line, no NaN; fewer than five lines: as many of those as there
    are lines)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    bm = b.movedim(axis, -1).reshape(-1, shape[axis])   # a view of b
    if bm.shape[0] == 1:
        bm[0, 1000:2000] = 0.0
        bm[0, 2000:3000:3] = -0.0
        bm[0, 3000:4000] *= 1e-30
    else:
        lines = bm.shape[0]
        if lines > 1:
            bm[1] = 0.0
        if lines > 2:
            bm[2, ::3] = -0.0
        if lines > 3:
            bm[3, min(300, shape[axis] // 2)] = float("nan")
        if lines > 4:
            bm[4] *= 1e-30
    return b


def same_or_both_nan(a, b) -> bool:
    """Bit for bit, except that a NaN may stand for a NaN of other bits."""
    import torch
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and bits_equal(
        torch.where(nan, 0, a), torch.where(nan, 0, b))


def s1_launch(b, lev, axis):
    """S1's launch for ``b`` along ``axis``, as ``tridiag.mass_solve``
    chooses it, and the blocks of it that an SM holds at once, as the
    geometry counts them (shared memory, threads, float64's registers)."""
    from mgard_tpu_torch.ops import tridiag
    n, size = b.shape[axis], b.element_size()
    geo = tridiag.solve_geometry(n, b.numel() // n, size, None,
                                 tridiag.solve_overlap(lev.offdiag,
                                                       lev.divisors, size))
    return geo, tridiag._blocks_an_sm(geo.smem, geo.threads, size)


def s1_walks(b, lev, axis):
    """S1's walks in shared memory and re-solved segments on ``b`` at the
    default geometry: [walks, re-solves]."""
    import torch
    from mgard_tpu_torch.ops import tridiag
    walks = torch.zeros(2, dtype=torch.int32, device=b.device)
    tridiag.mass_solve(b, lev.offdiag, lev.divisors, axis, walks=walks)
    return walks.tolist()


def check_solve_layouts():
    """S1 bit for bit against its plain version on each of its layouts,
    float32 and float64: at the default geometry whole lines along the
    first, a middle and the last axis (read as it lies) and segmented
    lines of a 1-D series and of a middle axis, and in float64 each of
    its routes (short lines of 5 to 129 nodes in tiles of 32 to 128
    threads, 129 and 257 nodes in whole-line tiles, segments of 32
    lines, one line a block) on data with zeros, signed zeros, a NaN and
    1e-30 values, NaN-aware, its walks counted (none on a short line);
    then launched with walks forced, where most runs and segments miss
    and are walked: a small segment and a 1-node overlap on a 1-D series
    (one line a block), the last axis of many lines and lines along the
    first and a middle axis (32 lines a tile), and in float64 a 1-node
    overlap at its own geometry (whole lines of 129 nodes in runs of 33,
    a series of 1001 nodes in four segments of 32 runs of 10), each with
    its walks in shared memory and its
    re-solved segments counted (both must be > 0 where a line has more
    than one segment, the first where it has one)."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import tridiag

    cases = [((33, 257, 40), 0), ((33, 257, 40), 1), ((33, 40, 257), 2),
             ((5001,), 0), ((3, 5001, 7), 1), ((64, 5001), 1)]
    got = []
    g = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.float32, torch.float64):
        for shape, axis in cases:
            lev = mt.Hierarchy((shape[axis],)).dims[0][-1]
            b = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            x = tridiag.mass_solve(b, lev.offdiag, lev.divisors, axis)
            geo, _ = s1_launch(b, lev, axis)
            got.append((shape, axis, str(dtype)[6:], geo.route, geo.lines,
                        geo.threads, geo.nseg,
                        bits_equal(x, tridiag.mass_solve_plain(
                            b, lev.offdiag, lev.divisors, axis))))
    log(f"S1 layouts at the default geometry (shape, axis, dtype, route, "
        f"lines a tile, threads a block, segments a line, bit-identical): "
        f"{got}")
    routes = [((1089, 33), 1), ((33, 1089), 0), ((9, 33, 121), 1),
              ((5, 5, 5), 2), ((5, 5, 5), 0), ((16641, 129), 1),
              ((129, 129, 129), 0), ((2, 257, 300), 1), ((40, 4097), 1),
              ((3, 4097, 5), 1), ((9000,), 0)]
    f64 = []
    for i, (shape, axis) in enumerate(routes):
        n = shape[axis]
        lev = mt.Hierarchy((n,), coordinates=[np.sort(
            np.random.default_rng(i).uniform(0, 1, n))]).dims[0][-1]
        b = planted_lines(shape, axis, torch.float64, seed=100 + i)
        geo, per_sm = s1_launch(b, lev, axis)
        walks = s1_walks(b, lev, axis)
        x = tridiag.mass_solve(b, lev.offdiag, lev.divisors, axis)
        ok = same_or_both_nan(x, tridiag.mass_solve_plain(
            b, lev.offdiag, lev.divisors, axis))
        f64.append((shape, axis, geo.route, geo.lines, geo.threads,
                    geo.run, geo.nseg, geo.overlap, per_sm, walks, ok))
        if geo.route == "short" and walks != [0, 0]:
            raise AssertionError(f"S1 float64 {shape} axis {axis}: the "
                                 f"short route walked: {walks}")
    log(f"S1 float64 routes at the default geometry, planted data (shape, "
        f"axis, route, lines a tile, threads a block, run, segments a "
        f"line, overlap, blocks an SM, [walks, re-solves], bit-identical "
        f"or both NaN): {f64}")
    if {c[2] for c in f64} != {"short", "lines", "runs"}:
        raise AssertionError("S1 float64: a route was not taken")
    forced = [((8193,), 0, 512), ((64, 1001), 1, 48), ((1001, 40), 0, 48),
              ((2, 1001, 40), 1, 64)]
    forced64 = [((129, 40), 0, None), ((3, 129, 40), 1, None),
                ((1001,), 0, None)]
    walked = []
    for dtype in (torch.float32, torch.float64):
        for shape, axis, segment in forced + (
                forced64 if dtype == torch.float64 else []):
            lev = mt.Hierarchy((shape[axis],), coordinates=[np.sort(
                np.random.default_rng(0).uniform(0, 1, shape[axis]))]
                               ).dims[0][-1]
            b = planted_lines(shape, axis, dtype, seed=len(walked))
            walks = torch.zeros(2, dtype=torch.int32, device="cuda")
            x = tridiag.mass_solve(b, lev.offdiag, lev.divisors, axis,
                                   segment=segment, overlap=1, walks=walks)
            n = shape[axis]
            geo = tridiag.solve_geometry(n, b.numel() // n,
                                         b.element_size(), segment, 1)
            walked.append((shape, axis, str(dtype)[6:], segment, geo.route,
                           geo.nseg, walks.tolist(),
                           same_or_both_nan(x, tridiag.mass_solve_plain(
                               b, lev.offdiag, lev.divisors, axis))))
    log(f"S1 with walks forced, overlap 1 (shape, axis, dtype, segment, "
        f"route, segments a line, [runs walked in shared memory, segments "
        f"re-solved], bit-identical): {walked}")
    if not all(c[-1] for c in got + f64 + walked) \
            or not all(c[6][0] > 0 and (c[6][1] > 0 or c[5] == 1)
                       for c in walked):
        raise AssertionError("S1 differs from its plain version, or a "
                             "forced case walked nothing")


def long_series_hierarchy():
    """Build the long series' hierarchy into the compressors' cache (host
    work alone: no device work, no kernel launch); returns its build's
    seconds (not the hierarchy, which the cache alone holds)."""
    from mgard_tpu_torch.models import compressor
    t0 = time.perf_counter()
    compressor._cached_hierarchy((LONG_SERIES,), None)
    return time.perf_counter() - t0


def long_series(prebuilt):
    """(a) the 1-D series through the API; ``prebuilt``: the future of
    :func:`long_series_hierarchy`."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch import api
    from mgard_tpu_torch.ops import bp_kernels as bk, tridiag

    shape = (LONG_SERIES,)
    gc.collect()
    lap = Laps()
    v = smooth_field_card(shape)
    v_host = v.cpu().numpy()
    t0 = time.perf_counter()
    build_s = prebuilt.result()
    t1 = time.perf_counter()
    comp = mt.get_compressor(shape, np.float32,
                             device=api.block_devices(None)[0])
    t2 = time.perf_counter()
    hier = comp.hier
    pairs = fallback_pairs(hier)
    nblocks = api.plan_blocks(shape, np.float32, mt.Config(), "cuda")
    log(f"long series {shape} float32, {v_host.nbytes} bytes: hierarchy "
        f"built in {build_s:.3f} s (host, on a thread beside phases "
        f"13-21; {t1 - t0:.3f} s waited for it here), the compressor on "
        f"the cached hierarchy {t2 - t1:.3f} s, L = {hier.L}, {hier.L + 1} "
        f"segments, {nblocks} block(s), per-dim levels {len(pairs)}")
    host_memory("long series hierarchy built")
    if nblocks != 1 or hier.L + 1 > bk.SEGMENT_CAPACITY:
        raise AssertionError("the series must be one domain of at most "
                             f"{bk.SEGMENT_CAPACITY} segments")
    kept = device_tables_bytes()
    lap("(a) field and hierarchy")
    buf, header, sections, out, counts, tc, td = round_trip(
        "long series", v_host, TOL)
    err = card_max_err(v_host, out)
    log(f"long series: max|v - out| = {err!r} (tolerance {TOL}); API "
        f"wall {tc + td:.3f} s")
    host_memory("long series round trip")
    del out
    unmoved("long series", v_host.nbytes / len(buf), err, LONG_SERIES_BEFORE,
            kept)
    expect_launches("long series", counts, {
        SOLVE_NAME: 2 * len(pairs), "bp_quant_max": 1,
        "gpk_detail": 0, "gpk_prolong_add": 0, "extract_coarse_3d": 0})
    if not err <= TOL:
        raise AssertionError(f"long series: error {err} exceeds {TOL}")
    lap("(a) round trip")
    enc = long_device_times("long series", comp, v, header, sections)
    lap("(a) device times")
    per_level = {}
    for n, _, _, ms in enc:
        per_level[n] = per_level.get(n, 0.0) + ms
    log(f"long series: S1 ms per solve in the encode, by nodes: {per_level}")
    # the top level's solve timed on its own
    n_top = max(per_level)
    lev = next(lv for lv in hier.dims[0] if lv.n == n_top)
    b = torch.randn(n_top, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    # (its residual is checked on the encode's own input below)
    _, _, top_ms = s1_turns(b, lev, 0, f"long series top level, {n_top} "
                                       f"nodes", plain=False)
    top_bound = bound_ms(s1_bytes(b, 0), 0)[0]
    log(f"long series: S1 alone on {n_top} nodes: median {top_ms:.4f} ms, "
        f"bound {top_bound:.4f} ms with its tables ("
        f"{bound_ms(8 * n_top, 0)[0]:.4f} ms for b and x alone), "
        f"{top_bound / top_ms:.1%}")
    del b
    lap("(a) top level's S1 in turns")
    with SolveProbe(hier, check=True) as probe:
        comp.encode_device(v, header.tolerance)
    probe.verdict("long series")
    lap("(a) S1 against its plain version")
    table_costs(hier)
    lap("(a) table costs")
    check_block_kernels("long series kernels", api.compressor_for(header), v,
                        header.tolerance, sections, stencil=False)
    lap("(a) kernels")
    resident_tables("long series", comp, v, header, sections)
    del v, comp, hier, lev, probe
    mt.release_cache()
    torch.cuda.empty_cache()
    resident = tridiag.resident_bytes()
    log(f"long series: resident tables after release_cache {resident} "
        f"bytes")
    if resident:
        raise AssertionError(f"long series: {resident} bytes of resident "
                             "tables outlive release_cache")
    return counts


def resident_tables(label, comp, v, header, sections):
    """The resident tables of a warm hierarchy: one encode and one decode
    copy no table (the counter ``tables.bytes`` reads 0) and each counts
    one call on resident tables (``tables.resident``); every table its
    per-dim levels copy is on the card once, as ``transform.table_bytes``
    reckons them (S1's too)."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import transform, tridiag
    from mgard_tpu_torch.utils import log as counters

    exps, words = comp.stream_tensors(header, sections)
    counters.reset_counts()
    comp.encode_device(v, header.tolerance)
    comp.decode_device(exps, words, header.tolerance,
                       mt.Lossless(header.lossless))
    got = counters.counts()
    counters.reset_counts()
    # this hierarchy's own: the entries keyed by its levels' arrays
    own = {id(a) for dims in comp.hier.dims for lev in dims
           for a in vars(lev).values() if isinstance(a, np.ndarray)}
    with tridiag._RESIDENT_LOCK:
        hits = [hit for key, hit in tridiag._RESIDENT.items()
                if key[0] in own]
    resident = sum(t.numel() * t.element_size() for hit in hits
                   for t in tridiag._tensors(hit.tables))
    want = transform.table_bytes(comp.hier, v.element_size())
    log(f"{label}: an encode and a decode on warm tables count {got}; "
        f"resident tables {resident} bytes, reckoned {want} bytes")
    if got.get("tables.bytes", 0) or got.get("tables.resident") != 2:
        raise AssertionError(f"{label}: counters {got}, expected no table "
                             "bytes and two calls on resident tables")
    if resident != want:
        raise AssertionError(f"{label}: {resident} bytes of resident "
                             f"tables, reckoned {want}")


def long_field():
    """(b) the (64, 512, 8192) field through the API, and S1 at level 6
    along each axis against its plain version."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.api import compressor_for
    from mgard_tpu_torch.ops import extract_kernels as xk, transform
    from mgard_tpu_torch.ops import tridiag

    gc.collect()
    lap = Laps()
    v = smooth_field_card(LONG_FIELD, seed=SEED + 1)
    v_host = v.cpu().numpy()
    hier = mt.Hierarchy(LONG_FIELD)
    pairs = fallback_pairs(hier)
    probe_t = torch.empty(1, device="cuda")
    k1 = sum(xk.extract_supported(hier, l, probe_t)
             for l in range(1, hier.L + 1))
    log(f"long field {LONG_FIELD}: L = {hier.L}, per-dim (level, dim) "
        f"pairs {pairs}, K1 levels {k1}")
    kept = device_tables_bytes()
    lap("(b) field")
    buf, header, sections, out, counts, tc, td = round_trip(
        "long field", v_host, TOL)
    err = card_max_err(v_host, out)
    log(f"long field: max|v - out| = {err!r} (tolerance {TOL})")
    host_memory("long field round trip")
    del out
    unmoved("long field", v_host.nbytes / len(buf), err, LONG_FIELD_BEFORE,
            kept)
    expect_launches("long field", counts, {
        SOLVE_NAME: 2 * len(pairs), "gpk_detail": 1, "gpk_prolong_add": 1,
        "bp_quant_max": 1, "extract_coarse_3d": k1})
    if not err <= TOL:
        raise AssertionError(f"long field: error {err} exceeds {TOL}")
    comp = compressor_for(header)
    lap("(b) round trip")
    long_device_times("long field", comp, v, header, sections)
    lap("(b) device times")
    check_block_kernels("long field kernels", comp, v, header.tolerance,
                        sections)
    lap("(b) kernels")
    # S1 at level 6 along each axis, on the correction's own input, in
    # float32 (the kernels line's S1) and in float64 (mass_solve_f64)
    l = hier.L
    top = transform.decompose(hier, v)[l]
    entries = {}
    for name, dtype in (("S1 " + SOLVE_NAME, torch.float32),
                        ("mass_solve_f64", torch.float64)):
        B = top.to(dtype)
        for d in transform._level_dims(hier, l):
            B = tridiag.mass_apply(B, hier.dims[d][l].h, d)
            B = transform.restrict(B, hier.dims[d][l], d)
        for d in transform._level_dims(hier, l):
            B = B.contiguous()
            lev = hier.dims[d][l - 1]
            label = f"S1 on {tuple(B.shape)} {B.dtype} axis {d}"
            if name in entries:
                _, same, ms = s1_turns(B, lev, d, label)
                if not same:
                    raise AssertionError(f"{label}: S1 differs from its "
                                         "plain version")
                lib = ""
            else:
                entries[name] = s1_record(B, lev, d, name)
                ms = entries[name]["ms"]
                lib = f", tensordot {entries[name]['library_ms']:.4f} ms"
            geo, per_sm = s1_launch(B, lev, d)
            log(f"long field level {l} axis {d}: {label} {ms:.4f} ms, "
                f"{bound_ms(s1_bytes(B, d), 0)[0] / ms:.1%} of its byte "
                f"bound{lib}; route "
                f"{geo.route}, {geo.lines} lines x {geo.threads} threads a "
                f"block, run {geo.run}, {geo.nseg} segment(s), overlap "
                f"{geo.overlap}, {per_sm} blocks an SM, [walks, re-solves] "
                f"{s1_walks(B, lev, d)}")
            B = tridiag.mass_solve(B, lev.offdiag, lev.divisors, d)
        del B
    del top
    torch.cuda.empty_cache()
    lap("(b) S1 at level 6, float32 and float64")
    # the field as float64 at s = inf and s = 0: the encode peaks; at
    # s = inf the device encode and decode, the path float64 S1 sits in
    v64 = v.double()
    del v
    for s in (math.inf, 0.0):
        comp = mt.get_compressor(LONG_FIELD, np.float64, s=s, device="cuda")
        PLANNER_PEAKS[f"float64 {LONG_FIELD} s = {s}"] = encode_peak(
            f"long field float64 s = {s}", comp, v64, TOL)
        if s == math.inf:
            float64_device_times(comp, v64)
        del comp
    del v64
    torch.cuda.empty_cache()
    lap("(b) float64 peaks and device times")
    return counts, entries["S1 " + SOLVE_NAME], entries["mass_solve_f64"]


def float64_device_times(comp, v64):
    """The float64 field's device encode and decode (CUDA events, one
    warm-up, three runs each), S1's calls in one more of each (their
    ms, by nodes), and the decode within the tolerance."""
    import torch
    enc = comp.encode_device(v64, TOL)
    exps, words = enc[0], enc[1]
    enc_ms = cuda_ms(lambda: comp.encode_device(v64, TOL), 3, warm=False)
    out = comp.decode_device(exps, words, TOL)
    err = 0.0
    for a in range(0, v64.shape[0], 8):
        d = float((out[a:a + 8] - v64[a:a + 8]).abs().max())
        err = d if d != d else max(err, d)
        if err != err:
            break
    del out
    dec_ms = cuda_ms(lambda: comp.decode_device(exps, words, TOL), 3,
                     warm=False)
    with SolveProbe(comp.hier) as enc_probe:
        comp.encode_device(v64, TOL)
    with SolveProbe(comp.hier) as dec_probe:
        comp.decode_device(exps, words, TOL)
    del enc, exps, words
    torch.cuda.empty_cache()
    solves = [sum(t for *_, t in p.times()) for p in (enc_probe, dec_probe)]
    log(f"long field float64 s = inf: device encode {enc_ms:.3f} ms, "
        f"decode {dec_ms:.3f} ms, encode + decode {enc_ms + dec_ms:.3f} ms "
        f"(CUDA events, 3 runs each); S1 {solves[0]:.3f} / {solves[1]:.3f} "
        f"ms of them; S1 calls in the encode (nodes, axis, shape, ms): "
        f"{enc_probe.times()}; max|v - out| = {err!r}")
    if not err <= TOL:
        raise AssertionError(f"long field float64: error {err} exceeds "
                             f"{TOL}")
    return enc_ms, dec_ms


def s1_norm_levels(shape=(256, 256, 256)):
    """float64 S1 at every solve of the orthogonal components of a float64
    field of ``shape`` (``norms.orthogonal_component_square_norms``: the
    solves of every finite s-norm but s = 0, which is the L2 norm and
    solves nothing, and of QoI's component norms): each held against its
    plain version (:class:`SolveProbe`: bit for bit up to SOLVE_PLAIN_MAX
    nodes, above that by its residual), with its route and walks; the
    first solve of each level timed in TURNS queued turns."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import norms, tridiag

    hier = mt.Hierarchy(shape)
    u = smooth_field_card(shape, seed=SEED + 1).double()
    with SolveProbe(hier, check=True, where=(norms,)) as probe:
        norms.orthogonal_component_square_norms(hier, u)
    probe.verdict(f"float64 S1 in the {shape} s-norm components")
    inputs, saved = [], norms.mass_solve

    def keep(b, offdiag, divisors, axis):
        inputs.append((b.clone(), divisors, axis))
        return saved(b, offdiag, divisors, axis)

    norms.mass_solve = keep
    try:
        norms.orthogonal_component_square_norms(hier, u)
    finally:
        norms.mass_solve = saved
    del u
    rows, timed = [], set()
    for b, divisors, axis in inputs:
        lev = next(lv for lv in hier.dims[axis] if lv.divisors is divisors)
        ms = share = None
        bound = bound_ms(s1_bytes(b, axis), 0)[0]
        if b.shape not in timed:
            timed.add(b.shape)
            with tridiag.table_scope():
                ms = turns_median(
                    f"float64 S1 on {tuple(b.shape)} axis {axis}",
                    lambda: tridiag.mass_solve(b, lev.offdiag, lev.divisors,
                                               axis))
            share = f"{bound / ms:.1%}"
            ms = round(ms, 4)
        geo, per_sm = s1_launch(b, lev, axis)
        rows.append((tuple(b.shape), axis, ms, round(bound, 4), share,
                     geo.route, geo.threads, geo.blocks, per_sm,
                     s1_walks(b, lev, axis)))
    del inputs
    torch.cuda.empty_cache()
    log(f"float64 S1 in the {shape} s-norm components, {len(rows)} solves "
        f"(shape, axis, median ms of the first solve of a level, bound ms "
        f"with its tables, share, route, threads a block, blocks, blocks "
        f"an SM, [walks, re-solves]): {rows}")
    if len(rows) != len(probe.checked) or not rows:
        raise AssertionError(f"float64 S1 norm levels: {len(rows)} solves "
                             f"timed, {len(probe.checked)} checked")
    return rows


def long_square():
    """(c) (8192, 8192) at s = 0 through the API: the error by the port's
    norms in float64 on the card, S1 at every level of those; K11 against
    its plain version on the container's top level; the encode peak of
    the field as float64."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import bitplane, bp_kernels as bk

    lap = Laps()
    v = smooth_field_card(LONG_SQUARE, seed=SEED + 2).cpu().numpy()
    hier = mt.Hierarchy(LONG_SQUARE)
    pairs = fallback_pairs(hier)
    header, buf, comp, counts = drive("long square s = 0", v, mt.Config(),
                                      s=0.0)
    lap("(c) round trip")
    expect_launches("long square", counts, {
        SOLVE_NAME: 2 * len(pairs), "bp_decode_condense": hier.L + 1,
        "bp_decode_condense_f32": 0})
    # K11 on the top level's segment of the container's own stream
    exps, words = comp.stream_tensors(header, fmt.read_container(buf)[1])
    e = exps.to(torch.int32)
    offsets = bitplane._offsets(e)
    C = comp.chunk_groups
    sizes = [int(np.prod(s)) for s in hier.shapes]
    ncs = [bitplane.num_chunks_tiled(n, C) for n in sizes]
    a, nc, n = sum(ncs[:-1]), ncs[-1], sizes[-1]
    got = bk.bp_decode_condense(words, C, offsets[a:a + nc], e[a:a + nc], n)
    err = max_abs_diff(got, bk.bp_decode_condense_plain(
        words, C, offsets[a:a + nc], e[a:a + nc], n))
    log(f"long square: K11 against its plain version on level {hier.L}'s "
        f"segment ({n} values, {nc} chunks, {int(e[a:a + nc].sum()) * C} "
        f"stream words of {words.numel()}): max_abs_err {err} (tolerance "
        f"0)")
    if err != 0.0:
        raise AssertionError("long square: K11 differs from its plain "
                             "version")
    del exps, words, got
    # the same field in float64: the per-dim form's encode peak with the
    # wide codec
    comp = mt.get_compressor(LONG_SQUARE, np.float64, s=0.0, device="cuda")
    v64 = torch.from_numpy(v).cuda().double()
    PLANNER_PEAKS["float64 (8192, 8192) s = 0"] = encode_peak(
        "long square float64 s = 0", comp, v64, TOL)
    del v64, comp
    torch.cuda.empty_cache()
    lap("(c) K11 and the float64 peak")


def scan_solver(v_host, main_buf):
    """(d) the main path's 512^3 field with transform._SOLVER = "scan"
    (what MGARD_TPU_SOLVER=scan sets at import): every level takes the
    per-dim correction; containers cross-decoded with the default; device
    times beside the matmul correction's; S1 at level 9."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.api import compressor_for
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import transform

    lap = Laps()
    hier = mt.Hierarchy(SHAPE)
    saved = transform._SOLVER
    try:
        transform._SOLVER = "scan"
        pairs = fallback_pairs(hier)
        buf, header, sections, out, counts, _, _ = round_trip(
            "scan solver", v_host, TOL)
        err = card_max_err(v_host, out)
        del out
        # the default container decoded with the scan correction
        cross_a = card_max_err(v_host, mt.decompress(main_buf))
    finally:
        transform._SOLVER = saved
    cross_b = card_max_err(v_host, mt.decompress(buf))
    ratio, main_ratio = v_host.nbytes / len(buf), v_host.nbytes / len(
        main_buf)
    log(f"scan solver: max|v - out| = {err!r}, ratio {ratio!r} (default "
        f"{main_ratio!r}); default container decoded by the scan form "
        f"{cross_a!r}, scan container by the default {cross_b!r}")
    expect_launches("scan solver", counts, {
        SOLVE_NAME: 2 * len(pairs), "gpk_detail": 1, "gpk_prolong_add": 1,
        "bp_quant_max": 1})
    if len(pairs) != 3 * hier.L or not max(err, cross_a, cross_b) <= TOL \
            or not abs(ratio / main_ratio - 1) <= 0.01:
        raise AssertionError(f"scan solver: pairs {len(pairs)}, errors "
                             f"{err} {cross_a} {cross_b}, ratio {ratio}")
    lap("(d) round trip and cross-decodes")
    # device times in turns, and S1 at level 9 against its plain version
    comp = compressor_for(header)
    v = torch.from_numpy(v_host).cuda()
    h2, s2 = fmt.read_container(buf)
    exps, words = comp.stream_tensors(h2, s2)
    try:
        for solver in ("matmul", "scan"):
            transform._SOLVER = solver
            time_device(comp, v, exps, words, f"correction {solver}")
        lap("(d) device times")
        transform._SOLVER = "scan"
        with SolveProbe(hier, check=True) as probe:
            transform._correction(hier, transform.decompose(hier, v)[9], 9)
    finally:
        transform._SOLVER = saved
    probe.verdict("scan solver level 9")
    del v, exps, words
    torch.cuda.empty_cache()
    lap("(d) S1 at level 9")
    return counts


def long_dims(v_host, main_buf, prebuilt):
    """The long-dims phase (see the module docstring); ``prebuilt``: the
    future of :func:`long_series_hierarchy`."""
    import torch
    import mgard_tpu_torch as mt

    torch.cuda.empty_cache()
    lap = Laps()
    check_solve_layouts()
    lap("S1 layouts")
    counts = {"series": long_series(prebuilt)}
    counts["field"], entry, entry64 = long_field()
    lap = Laps()
    s1_norm_levels()
    lap("float64 S1 at the s-norm components")
    long_square()
    counts["scan"] = scan_solver(v_host, main_buf)
    mt.release_cache()
    torch.cuda.empty_cache()
    log(f"long dims: S1 launches (a) {counts['series'][SOLVE_NAME]}, (b) "
        f"{counts['field'][SOLVE_NAME]}, (d) {counts['scan'][SOLVE_NAME]}")
    entry["launches"] = counts["series"][SOLVE_NAME]
    return entry, entry64


def snorm_reference_check(shape, seed, s, uniform=True, tol=1e-3):
    """Card against CPU with finite ``s`` on the segmented stream
    (adapt_lossless=False): the containers made on each decode on both
    within ||v - out||_s <= tol; each decode on the card launches K11
    once per level and K4 never."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import _build

    coords = None
    if not uniform:
        rng = np.random.default_rng(seed)
        coords = []
        for n in shape:
            c = np.sort(rng.uniform(size=n))
            c[0], c[-1] = 0.0, 1.0
            coords.append(c)
    hier = mt.Hierarchy(shape, coordinates=coords)
    v = smooth_field_host(shape, seed=seed)
    cfg = mt.Config(adapt_lossless=False)
    _build.reset_launches()
    b_gpu = mt.compress(v, tol, s=s, config=cfg, coordinates=coords)
    b_cpu = mt.compress(v, tol, s=s, config=cfg, coordinates=coords,
                        device="cpu")
    errs = [snorm_error(hier, mt.decompress(b, device=d), v, s)
            for b in (b_gpu, b_cpu) for d in ("cuda", "cpu")]
    counts = _build.launch_counts()
    got = (counts["bp_decode_condense"], counts["bp_decode_condense_f32"])
    log(f"{shape} {'uniform' if uniform else 'nonuniform'} s = {s} reference "
        f"check: cross-decode ||v - out||_s {errs} (card->card, card->CPU, "
        f"CPU->card, CPU->CPU), same bytes {b_gpu == b_cpu}, K11/K4 "
        f"launches {got}")
    if got != (2 * (hier.L + 1), 0):
        raise AssertionError(f"s = {s}: K11/K4 launched {got} times")
    if not max(errs) <= tol:
        raise AssertionError(f"s = {s}: cross-decode error {max(errs)} > "
                             f"{tol}")


def flat_reference_check(shape=(65, 65, 65), seed=3, tol=1e-3):
    """Card against CPU on each flat path at a small shape: the
    containers made on each decode on both within the tolerance."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.config import Layout
    from mgard_tpu_torch.ops import _build

    v32 = smooth_field_host(shape, seed=seed)
    cases = (("PYRAMID", v32, mt.Config(layout=Layout.PYRAMID,
                                        adapt_lossless=False)),
             ("per-group", v32, mt.Config()),
             ("float64", v32.astype(np.float64), mt.Config()))
    for label, v, cfg in cases:
        _build.reset_launches()
        b_gpu = mt.compress(v, tol, config=cfg)
        b_cpu = mt.compress(v, tol, config=cfg, device="cpu")
        errs = [float(np.abs(mt.decompress(b, device=d) - v).max())
                for b in (b_gpu, b_cpu) for d in ("cuda", "cpu")]
        counts = _build.launch_counts()
        flat = (counts["bp_encode_condense"], counts["bp_decode_condense"])
        log(f"{shape} {label} reference check: cross-decode errors {errs} "
            f"(card->card, card->CPU, CPU->card, CPU->CPU), same bytes "
            f"{b_gpu == b_cpu}, K12/K11 launches {flat}")
        if flat != ((1, 2) if label == "PYRAMID" else (0, 0)) \
                or any(counts[k] for k in LPK_KERNELS + NO_PATH_KERNELS):
            raise AssertionError(f"{label}: launches {counts}")
        if not max(errs) <= tol:
            raise AssertionError(f"{label}: cross-decode error {max(errs)} "
                                 f"> {tol}")


def reference_check(shape, seed, tol=1e-3, fused=True, lpk=False):
    """The card against the CPU path at a small shape: the card's pyramid
    agrees with the CPU's, and the containers made on each decode on both
    within the tolerance.  Where the GPK gate admits the finest level,
    the card's compress goes through K5 (K7 and K8 with ``fused`` off)
    and each decode on the card through K6 (K9 and K10); with ``lpk``
    (``transform._LPK`` on) each of them through K13 too where its gate
    admits the level; the CPU path takes the matmul form; elsewhere none
    of them launches."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import _build, lpk_kernels as lk
    from mgard_tpu_torch.ops import stencil_kernels as sk, transform

    v = smooth_field_host(shape, seed=seed)
    cfg = mt.Config(adapt_lossless=False)
    hier = mt.Hierarchy(shape)
    old = sk._FUSED, transform._LPK
    try:
        sk._FUSED, transform._LPK = fused, lpk
        pg = transform.decompose(hier, torch.from_numpy(v).cuda())
        pc = transform.decompose(hier, torch.from_numpy(v))
        rel = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(pg, pc)) / float(np.abs(v).max())
        if not rel <= 1e-5:
            raise AssertionError(f"card and CPU pyramids differ by {rel}")
        _build.reset_launches()
        b_gpu = mt.compress(v, tol, config=cfg)
        b_cpu = mt.compress(v, tol, config=cfg, device="cpu")
        errs = [float(np.abs(mt.decompress(b, device=d) - v).max())
                for b in (b_gpu, b_cpu) for d in ("cuda", "cpu")]
        counts = _build.launch_counts()
    finally:
        sk._FUSED, transform._LPK = old
    names = ("gpk_detail", "gpk_prolong_add") + TWO_PASS_KERNELS \
        + LPK_KERNELS + SPLIT_KERNELS
    got = tuple(counts[k] for k in names)
    want = ((1, 2, 0, 0, 0, 0) if fused else (0, 0, 1, 1, 2, 2)) \
        if sk.gpk_structure_ok(hier, hier.L) else (0,) * 6
    want += (3 if lpk and lk.rm0_structure_ok(hier, hier.L) else 0, 0, 0)
    log(f"{shape} reference check ({'one' if fused else 'two'}-pass GPK, "
        f"LPK {'on' if lpk else 'off'}): pyramid rel diff {rel!r}, "
        f"cross-decode errors {errs} (card->card, card->CPU, CPU->card, "
        f"CPU->CPU), same bytes {b_gpu == b_cpu}, K5/K6/K7/K8/K9/K10/K13/"
        f"K16/K17 launches {got}")
    if got != want:
        raise AssertionError(f"K5-K10, K13, K16, K17 launched {got} times, "
                             f"expected {want}")
    if not max(errs) <= tol:
        raise AssertionError(f"cross-decode error {max(errs)} > {tol}")



# ---------------------------------------------------------------------------
# Interop and ZFP (phases "interop" and "zfp")
# ---------------------------------------------------------------------------

X_SHAPE = (513, 513, 513)        # 2^9 + 1: the X level walk is dyadic
X_SMALL = (129, 129, 129)        # CPU format, X at s = 0, MDR-X
X_REL_TOL = 1e-4
# The X s-norm quanta at 129^3 (2 tol / sqrt(dof) times the level volume)
# are so fine that below ~0.5 the writer stores the subdomain raw; the RMS
# of the error at 1.0 is ~2.1e-4 (H100 runs), and a quantum or a
# dequantization off by a factor of two gives errors of the field's size
X_SNORM_TOL = 1.0
X_SNORM_RMS = 1e-3
MDRX_TOLS = (1e-2, 1e-3, 1e-4)
MDRX_RTOL = 1e-12
ZFP_RATES = (8, 16)
ZFP_CROP = (128, 128, 128)
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")


def synced_ms(fn, *args, **kwargs):
    """(result, ms) of one call by the host clock, the card synchronized
    before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def gate_counts(errs) -> dict:
    """The launches that ``level_kernel_errs``'s walk shows a path's
    encode (K1, K5) and a float32 decode (K6) make."""
    return {"extract_coarse_3d": len(errs["extract_coarse_3d"]),
            "gpk_detail": len(errs["gpk_detail"]),
            "gpk_prolong_add": len(errs["gpk_detail"])}


def nonzero(counts) -> dict:
    return {k: n for k, n in counts.items() if n}


def no_launches(label, counts):
    """Raise unless no kernel launched (a path in float64, or with no
    kernel of its own)."""
    launched = nonzero(counts)
    log(f"{label}: launches {launched or 'none'} (expected none)")
    if launched:
        raise AssertionError(f"{label}: kernels launched: {launched}")


def counted_ms(fn, *args, **kwargs):
    """(result, launch counts, ms by the host clock) of one call, the
    counters set to 0 just before and read just after."""
    from mgard_tpu_torch.ops import _build

    _build.reset_launches()
    out, ms = synced_ms(fn, *args, **kwargs)
    return out, _build.launch_counts(), ms


def x_abs_path(v_host):
    """MGARD-X at X_SHAPE, ABS TOL, X_HUFFMAN: the round trip through
    compress_mgard_x and decompress with its launches (K1 and K5 where
    their gates admit in the encode, K1-K6 bit for bit against their
    plain versions on this path's inputs; nothing in the float64
    decode), then its stages one by one: the quantized stream, the host
    codebook, the Huffman blob (the container's byte for byte) and its
    decode on the card (the stream bit for bit)."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import mgard_compat as mc

    buf, enc_counts, enc_ms = counted_ms(mc.compress_mgard_x, v_host, TOL,
                                         zstd=False)
    out, dec_counts, dec_ms = counted_ms(mt.decompress, buf)
    err = card_max_err(v_host, out)
    del out
    log(f"X ABS {X_SHAPE}: {len(buf)} bytes, ratio "
        f"{v_host.nbytes / len(buf)!r}, max|v - out| = {err!r} (tolerance "
        f"{TOL}); compress_mgard_x {enc_ms:.3f} ms, decompress "
        f"{dec_ms:.3f} ms (host clock, numpy in and out)")
    if not err <= TOL:
        raise AssertionError(f"X ABS: error {err} exceeds {TOL}")
    hier, _ = mc._x_hierarchy(X_SHAPE)
    v = torch.from_numpy(v_host).cuda()
    errs = level_kernel_errs(hier, v)
    del v
    torch.cuda.empty_cache()
    want = gate_counts(errs)
    want["gpk_prolong_add"] = 0
    log(f"X ABS: K1/K5/K6 against their plain versions on the encode's "
        f"inputs (tolerance 0, one entry a level): {errs}")
    if not errs["extract_coarse_3d"] or any(
            y != 0.0 for x in errs.values() for y in x):
        raise AssertionError(f"X ABS: K1/K5/K6 missing or differing: {errs}")
    expect_launches("X ABS encode", enc_counts, want)
    if any(enc_counts[k] for k in enc_counts if k not in want):
        raise AssertionError(f"X ABS encode: other launches {enc_counts}")
    no_launches("X ABS decode (float64 recompose)", dec_counts)

    (q, _, _), q_ms = synced_ms(mc._x_quantized, v_host, TOL, math.inf,
                                "abs", mc.resolve_device(None))
    q = q.reshape(-1)
    freq = torch.bincount(torch.where(
        (q + 4096 < 0) | (q + 4096 >= 8192), 0, q + 4096),
        minlength=8192).cpu().numpy()
    t0 = time.perf_counter()
    lengths = mc._huffman_code_lengths(freq)
    mc._x_codebook(lengths)
    book_ms = 1e3 * (time.perf_counter() - t0)
    blob, enc_blob_ms = synced_ms(mc._encode_x_huffman, q)
    _, payload = mc.read_container(buf)
    if payload[8:] != blob or struct.unpack_from("<Q", payload)[0] != len(
            blob):
        raise AssertionError("X ABS: the Huffman blob is not the "
                             "container's")
    # the decode's peak device memory over what the card held before it,
    # and its groups of chunks (each group's code table at most
    # _X_GROUP_BITS bits, 5 bytes a bit)
    groups, walk = [], mc._x_walk_group
    mc._x_walk_group = lambda *a: groups.append(len(a[1])) or walk(*a)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        back, dec_blob_ms = synced_ms(mc._decode_x_huffman, blob, q.device)
    finally:
        mc._x_walk_group = walk
    dec_peak = torch.cuda.max_memory_allocated() - held
    log(f"X ABS Huffman decode: peak device memory {dec_peak} bytes above "
        f"the {held} held before it; {len(groups)} groups of chunks "
        f"(chunks a group {groups}) of at most {mc._X_GROUP_BITS} bits of "
        f"the {8 * len(blob)}-bit blob; {q.numel()} symbols")
    if not torch.equal(back, q):
        raise AssertionError("X ABS: the blob does not decode to the "
                             "quantized stream")
    if dec_peak > 5 * mc._X_GROUP_BITS + 64 * q.numel():
        raise AssertionError(f"X ABS: the decode's peak {dec_peak} bytes "
                             "exceeds its group budget and outputs")
    log(f"X ABS stages (host clock, card synchronized): transform and "
        f"quantization {q_ms:.3f} ms ({q.numel()} values, max |q| "
        f"{int(q.abs().max())}, {int(((q < -4096) | (q >= 4096)).sum())} "
        f"outliers); code lengths and codebook on the host {book_ms:.3f} ms"
        f" (longest code {int(lengths.max())} bits); Huffman encode on the "
        f"card and read-back {enc_blob_ms:.3f} ms ({len(blob)} bytes, the "
        f"container's); Huffman decode on the card {dec_blob_ms:.3f} ms "
        f"(the stream bit for bit); the rest of decompress (dequantize, "
        f"float64 recompose, copies) ~{dec_ms - dec_blob_ms:.3f} ms")
    del q, back
    torch.cuda.empty_cache()
    return enc_counts


def x_rel_path(v_host, abs_counts):
    """MGARD-X at X_SHAPE, REL X_REL_TOL (norm max|v|): the ABS encode's
    launches, none in the decode."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import mgard_compat as mc

    buf, enc_counts, enc_ms = counted_ms(mc.compress_mgard_x, v_host,
                                         X_REL_TOL, zstd=False, mode="rel")
    out, dec_counts, dec_ms = counted_ms(mt.decompress, buf)
    bound = X_REL_TOL * card_max_abs(v_host)
    err = card_max_err(v_host, out)
    header, _ = mc.read_container(buf)
    norm = header["error_control"]["norm_of_original_data"]
    log(f"X REL {X_SHAPE}: norm {norm!r}, {len(buf)} bytes, ratio "
        f"{v_host.nbytes / len(buf)!r}, max|v - out| = {err!r} (bound "
        f"{bound!r}); {enc_ms:.3f} / {dec_ms:.3f} ms; encode launches "
        f"{nonzero(enc_counts)}")
    if not err <= bound or nonzero(enc_counts) != nonzero(abs_counts):
        raise AssertionError(f"X REL: error {err} (bound {bound}), encode "
                             f"launches {nonzero(enc_counts)}")
    no_launches("X REL decode", dec_counts)


def x_snorm_path(v_small):
    """MGARD-X at X_SMALL, s = 0, ABS X_SNORM_TOL: the RMS of the error
    within the tolerance (``tests/test_mgardx_interop.py:262-279``) and
    within X_SNORM_RMS, and the card's decode the CPU's of the same
    buffer to one float32 rounding of max|out| (both recompose the same
    integers in float64)."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import mgard_compat as mc

    buf, enc_counts, enc_ms = counted_ms(mc.compress_mgard_x, v_small,
                                         X_SNORM_TOL, zstd=False, s=0.0)
    out, dec_counts, dec_ms = counted_ms(mt.decompress, buf)
    ref, cpu_ms = host_timed(mt.decompress, buf, device="cpu")
    rms = float(np.sqrt(np.mean((out.astype(np.float64) - v_small) ** 2)))
    top = float(np.abs(ref).max())
    diff = float(np.abs(out.astype(np.float64) - ref).max())
    log(f"X s = 0 {X_SMALL}: {len(buf)} bytes, ratio "
        f"{v_small.nbytes / len(buf)!r}, RMS of the error {rms!r} "
        f"(tolerance {X_SNORM_TOL}, bound {X_SNORM_RMS}); {enc_ms:.3f} / "
        f"{dec_ms:.3f} ms; encode launches {nonzero(enc_counts)}; the "
        f"CPU's decode of the same buffer ({cpu_ms:.3f} ms): max|card - "
        f"CPU| = {diff!r} (bound {2.0 ** -23 * top!r})")
    if not (rms <= min(X_SNORM_TOL, X_SNORM_RMS)
            and len(buf) < v_small.nbytes):
        raise AssertionError(f"X s = 0: RMS error {rms}, {len(buf)} bytes "
                             "(a raw fallback checks nothing)")
    if not diff <= 2.0 ** -23 * top:
        raise AssertionError(f"X s = 0: the card's decode differs from the "
                             f"CPU's by {diff}")
    no_launches("X s = 0 decode", dec_counts)


def cpu_format_start(v_small):
    """The CPU format (CPU_HUFFMAN_ZLIB) at X_SMALL, s = inf and s = 0:
    K1/K5/K6 bit for bit against their plain versions on the encode's
    inputs, then the two compresses, each a :class:`HostLeg` whose card
    part ends when ``_cpu_quantized`` returns the stream to the host,
    with the launches that the two made, checked: K1 and K5 where their
    gates admit, in each encode.  Their zlib level 9 (the rest of each
    compress: host work alone) goes on beside the phases that follow;
    :func:`cpu_format_finish` waits for it.  Returns (the two legs, the
    per-encode launches that the decodes check)."""
    import torch
    from mgard_tpu_torch.io import mgard_compat as mc

    hier, _ = mc._x_hierarchy(X_SMALL)
    v = torch.from_numpy(v_small).cuda()
    errs = level_kernel_errs(hier, v)
    del v
    log(f"CPU format {X_SMALL}: K1/K5/K6 against their plain versions on "
        f"the encode's inputs (tolerance 0, one entry a level): {errs}")
    if not errs["extract_coarse_3d"] or any(
            y != 0.0 for x in errs.values() for y in x):
        raise AssertionError(f"CPU format: K1/K5/K6 missing or differing: "
                             f"{errs}")
    want = gate_counts(errs)

    def compress(s):
        def one():
            t0 = time.perf_counter()
            buf = mc.compress_mgard(v_small, TOL, s=s, zstd=False)
            return buf, 1e3 * (time.perf_counter() - t0)
        return HostLeg(one, after=(mc, "_cpu_quantized"))

    # each leg's card part before the next starts
    legs, enc_counts = [compress(s) for s in (math.inf, 0.0)], {}
    for leg in legs:
        for k, n in leg.start().items():
            enc_counts[k] = enc_counts.get(k, 0) + n
    expect_launches("CPU format, the two encodes' card parts", enc_counts, {
        "extract_coarse_3d": 2 * want["extract_coarse_3d"],
        "gpk_detail": 2 * want["gpk_detail"]})
    log("CPU format: both encodes have their streams on the host; their "
        "zlib level 9 runs on beside the phases that follow (host work "
        "alone, nothing on the card)")
    return legs, want


def cpu_format_finish(v_small, started):
    """Wait for the CPU format's two compresses (:func:`cpu_format_start`)
    and decode them, each with its own launch counters (K6 where its gate
    admits, in each float32 decode): max|v - out| <= TOL at s = inf,
    ||v - out||_0 <= TOL by the port's norms at s = 0; the transform
    and quantization of s = inf alone by the host clock."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import mgard_compat as mc

    legs, want = started
    (b_inf, ms_inf), _, w_inf = legs[0].finish()
    (b_0, ms_0), _, w_0 = legs[1].finish()
    waited = w_inf + w_0
    (q, q_ms) = synced_ms(mc._cpu_quantized, v_small, TOL, math.inf, None,
                          mc.resolve_device(None))
    out_inf, c_inf, d_inf = counted_ms(mt.decompress, b_inf)
    out_0, c_0, d_0 = counted_ms(mt.decompress, b_0)
    for label, c in (("s = inf", c_inf), ("s = 0", c_0)):
        expect_launches(f"CPU format decode {label}", c, {
            "gpk_prolong_add": want["gpk_prolong_add"]})
    err = float(np.abs(out_inf.astype(np.float64) - v_small).max())
    err0 = snorm_error(mt.Hierarchy(X_SMALL), out_0, v_small, 0.0)
    log(f"CPU format {X_SMALL}: s = inf {len(b_inf)} bytes, ratio "
        f"{v_small.nbytes / len(b_inf)!r}, max|v - out| = {err!r}; s = 0 "
        f"{len(b_0)} bytes, ratio {v_small.nbytes / len(b_0)!r}, ||v - "
        f"out||_0 = {err0!r} (tolerance {TOL}); compress {ms_inf:.3f} / "
        f"{ms_0:.3f} ms on two threads at once (beside the phases between"
        f"; {waited:.3f} s waited for them here), of which the transform "
        f"and quantization of s = inf alone {q_ms:.3f} ms ({q.size} int64 "
        f"values; the rest is zlib level 9 and the container on the "
        f"host); decompress {d_inf:.3f} / {d_0:.3f} ms")
    if not (err <= TOL and err0 <= TOL):
        raise AssertionError(f"CPU format: errors {err}, {err0}")


def zstd_interop(v_small):
    """The zstd writers and the two zstd goldens: round trips where
    ``zstandard`` is installed, else ModuleNotFoundError from each."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import mgard_compat as mc

    calls = {
        "compress_mgard(zstd=True)": lambda: mt.decompress(
            mc.compress_mgard(v_small, TOL, zstd=True)),
        "compress_mgard_x(zstd=True)": lambda: mt.decompress(
            mc.compress_mgard_x(v_small, TOL, zstd=True)),
    }
    for name in ("golden_33cube_f32_abs1e-3_zstd.mgardx",
                 "golden_33cube_f32_reorder1_zstd.mgardx"):
        with open(os.path.join(DATA_DIR, name), "rb") as f:
            calls[name] = (lambda b: lambda: mt.decompress(b))(f.read())
    try:
        import zstandard  # noqa: F401
    except ModuleNotFoundError:
        for name, call in calls.items():
            try:
                call()
            except ModuleNotFoundError as e:
                log(f"zstd: {name} raised ModuleNotFoundError ({e}), as it "
                    "must without zstandard")
            else:
                raise AssertionError(f"{name} ran without zstandard")
        return
    for name, call in calls.items():
        out = call()
        log(f"zstd: {name} ran ({out.shape})")


def golden_checks():
    """The reference's own buffers and streams: the X golden decodes
    within 1e-3 of its input; the three zfp_stream goldens encode from
    their inputs byte for byte and decode as ``tests/test_zfp_stream.py``
    holds them (the 1-D one to its .recon bit for bit, the 2-D one within
    1e-3, the 3-D one to its .recon on the addresses it writes, zeros
    elsewhere), with zfp_stream's time a block."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.models import zfp_stream as Z

    def data(name):
        return os.path.join(DATA_DIR, name)

    v = np.load(data("golden_17x17_f32.npy"))
    with open(data("golden_17x17_f32_abs1e-3.mgardx"), "rb") as f:
        out, counts, ms = counted_ms(mt.decompress, f.read())
    err = float(np.abs(out.astype(np.float64) - v).max())
    log(f"golden 17x17 X buffer: max|v - out| = {err!r} (bound 1e-3), "
        f"{ms:.3f} ms")
    if not (out.dtype == np.float32 and err <= 1e-3):
        raise AssertionError(f"golden 17x17: {out.dtype}, error {err}")
    no_launches("golden 17x17 decode", counts)

    cases = (("golden_zfp_48_input.npy", "golden_zfp_48_f64_r16", (48,),
              np.float64, 16),
             ("golden_zfp_16sq_input.npy", "golden_zfp_16sq_f32_r12",
              (16, 16), np.float32, 12),
             ("golden_zfp_20cube_input.npy", "golden_zfp_20cube_f32_r8",
              (20, 20, 20), np.float32, 8))
    for inp, stem, shape, dtype, rate in cases:
        v = np.load(data(inp))
        with open(data(stem + ".zfps"), "rb") as f:
            gold = f.read()
        t0 = time.perf_counter()
        enc = Z.zfp_encode(v, rate)
        t1 = time.perf_counter()
        dec = Z.zfp_decode(gold, shape, dtype, rate).reshape(-1)
        t2 = time.perf_counter()
        nblocks = int(np.prod([-(-n // 4) for n in shape]))
        if enc != gold:
            raise AssertionError(f"{stem}: the encode is not the golden "
                                 "stream")
        if os.path.exists(data(stem + ".recon")):
            rec = np.fromfile(data(stem + ".recon"), dtype=dtype)
            st = Z._strides(shape, "reference")
            touched = np.zeros(rec.size, bool)
            for origin, extent in Z._blocks_iter(shape):
                touched[Z._block_addr(origin, extent, st).reshape(-1)] = True
            ok = (np.array_equal(dec[touched], rec[touched])
                  and not dec[~touched].any())
            how = f"its .recon bit for bit on {int(touched.sum())} addresses"
        else:
            ok = float(np.abs(dec - v.reshape(-1)).max()) <= 1e-3
            how = "within 1e-3 of its input"
        log(f"{stem}: the encode is the golden stream byte for byte, the "
            f"decode matches {how}: {ok}; zfp_stream "
            f"{1e3 * (t1 - t0) / nblocks:.4f} ms a block to encode, "
            f"{1e3 * (t2 - t1) / nblocks:.4f} to "
            f"decode ({nblocks} blocks, host)")
        if not ok:
            raise AssertionError(f"{stem}: the decode does not match")


def mdrx_path(v_small):
    """A synthetic mdr-x directory of the float64 field at X_SMALL
    (``tests/mdrx_fixture.py``'s ``write_mdrx``, the layout of
    ``mgard_tpu/io/mdrx_compat.py:1-33``): the full-plane reconstruction
    on the card against the written coefficients recomposed in float64
    on the CPU (within MDRX_RTOL of max|ref|), then each of MDRX_TOLS,
    plane counts never falling as the tolerance tightens."""
    import shutil
    import torch
    from mgard_tpu_torch.io import mdrx_compat as mx, mgard_compat as mc
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from mdrx_fixture import write_mdrx

    d = os.path.join(os.path.dirname(LOG_FILE), "mdrx_synthetic")
    shutil.rmtree(d, ignore_errors=True)
    v = v_small.astype(np.float64)
    try:
        fine, write_ms = synced_ms(write_mdrx, d, v)
        full, counts, full_ms = counted_ms(mx.mdrx_reconstruct, d)
        no_launches("MDR-X reconstruct (float64)", counts)
        hier, _ = mc._x_hierarchy(X_SMALL)
        ref = mc._x_recompose(hier, torch.from_numpy(fine)).numpy()
        rel = float(np.abs(full - ref).max() / np.abs(ref).max())
        log(f"MDR-X {X_SMALL} float64: written in {write_ms:.3f} ms; all "
            f"planes read in {full_ms:.3f} ms, max|out - ref| / max|ref| = "
            f"{rel!r} (bound {MDRX_RTOL}), max|v - out| = "
            f"{float(np.abs(full - v).max())!r}")
        if not rel <= MDRX_RTOL:
            raise AssertionError(f"MDR-X: full planes off by {rel}")
        levels = mx.read_mdrx_metadata(d).subdomains[0]
        prev = None
        for tol in MDRX_TOLS:
            counts_k = mx._plane_counts(levels, len(levels[0].sizes), tol,
                                        None)
            out, ms = synced_ms(mx.mdrx_reconstruct, d, tol=tol)
            err = float(np.abs(out - v).max())
            log(f"MDR-X tol {tol}: planes {counts_k}, max|v - out| = "
                f"{err!r}, {ms:.3f} ms")
            if prev is not None and any(a < b for a, b in zip(counts_k,
                                                               prev)):
                raise AssertionError(f"MDR-X: plane counts fell: {prev} -> "
                                     f"{counts_k}")
            prev = counts_k
    finally:
        shutil.rmtree(d, ignore_errors=True)


def interop_paths(v_small):
    """Phase "interop" (see the module docstring); ``v_small`` is the
    field at X_SMALL."""
    import torch
    v513 = smooth_field_card(X_SHAPE).cpu().numpy()
    x_rel_path(v513, x_abs_path(v513))
    del v513
    torch.cuda.empty_cache()
    x_snorm_path(v_small)
    zstd_interop(v_small)
    golden_checks()
    mdrx_path(v_small)


def zfp_paths(v_host):
    """Phase "zfp": the native fixed-rate codec at the main field's
    shape, rates ZFP_RATES: round trip, error, size (``rate`` bits a
    value plus the side bytes, exactly), each direction's device time by
    CUDA events, no kernel launched; on a ZFP_CROP crop the card's
    stream equals the CPU's byte for byte and its decode bit for bit."""
    import torch
    from mgard_tpu_torch.models import zfp

    v = torch.from_numpy(v_host).cuda()
    top = float(v.abs().max())
    shape = v_host.shape
    nblocks = int(np.prod(zfp._blocked(shape)))
    errs = {}
    for rate in ZFP_RATES:
        buf, counts, enc_ms = counted_ms(zfp.compress_zfp, v_host, rate)
        out, dcounts, dec_ms = counted_ms(zfp.decompress_zfp, buf)
        no_launches(f"zfp rate {rate}", {k: counts[k] + dcounts[k]
                                         for k in counts})
        meta = zfp.ZfpMeta(shape, "float32", rate).pack()
        want = len(meta) + nblocks + zfp._num_units(shape) \
            + 4 * rate * zfp._num_groups(shape)
        err = card_max_err(v_host, out)
        e, m, kept = zfp._encode_impl(v, rate)
        enc_dev = cuda_ms(lambda: zfp._encode_impl(v, rate), 3)
        dec_dev = cuda_ms(lambda: zfp._decode_impl(e, m, kept, shape, rate,
                                                   "float32"), 3)
        log(f"zfp rate {rate} {shape}: {len(buf)} bytes (rate bits a value "
            f"plus side bytes: {want}), ratio {v_host.nbytes / len(buf)!r},"
            f" max|v - out| = {err!r} (max|v| {top!r}); API {enc_ms:.3f} / "
            f"{dec_ms:.3f} ms (host clock, numpy in and out); device encode "
            f"{enc_dev:.3f} ms, decode {dec_dev:.3f} ms (CUDA events)")
        if len(buf) != want or not math.isfinite(err):
            raise AssertionError(f"zfp rate {rate}: {len(buf)} bytes, "
                                 f"error {err}")
        errs[rate] = err
        del e, m, kept, out
        crop = np.ascontiguousarray(v_host[tuple(slice(0, n)
                                                 for n in ZFP_CROP)])
        b_card = zfp.compress_zfp(crop, rate)
        b_cpu = zfp.compress_zfp(crop, rate, device="cpu")
        same = b_card == b_cpu and np.array_equal(
            zfp.decompress_zfp(b_card).view(np.int32),
            zfp.decompress_zfp(b_card, device="cpu").view(np.int32))
        log(f"zfp rate {rate} {ZFP_CROP} crop: the card's stream is the "
            f"CPU's byte for byte and its decode bit for bit: {same}")
        if not same:
            raise AssertionError(f"zfp rate {rate}: card and CPU differ")
    # the error falls as the rate rises, and at rate 16 meets
    # tests/test_zfp.py's bound for that rate
    if not (errs[8] > errs[16] and errs[16] < 1e-2 * top + 1e-4):
        raise AssertionError(f"zfp errors {errs}")
    del v
    torch.cuda.empty_cache()



# The unstructured phase: the root mesh (a unit cube of 8^3 cells, six
# tetrahedra each) refined UNST_L times, each tetrahedron into eight: 129^3
# nodes and 3,072 * 8^4 tetrahedra at the finest level.
UNST_ROOT = (9, 9, 9)
UNST_L = 4
UNST_NODES = 2146689
UNST_TETS = 12582912
# (s, tolerance of ||u - u'||_s) of its round trips
UNST_CASES = ((0.0, 1e-3), (1.0, 1e-3))
# (container bytes, ||u - u'||_s) of those round trips before the mesh
# builders and refinement learned to refuse a mesh with no elements
# (which moves no byte)
UNST_BEFORE = {0.0: (784565, 0.0003263931477196724),
               1.0: (1720609, 0.00032658590913060603)}


def unstructured_field(nodes, seed=SEED):
    """A float64 smooth field of the node coordinates, sin(2 pi x)
    cos(pi y) z + x y / 2, plus 1e-3 Gaussian noise from a CUDA generator
    seeded with ``seed``."""
    import torch
    x, y, z = nodes.unbind(1)
    g = torch.Generator(device=nodes.device).manual_seed(seed)
    u = torch.sin(2 * math.pi * x) * torch.cos(math.pi * y) * z \
        + 0.5 * x * y
    return u + 1e-3 * torch.randn(u.shape, generator=g, dtype=u.dtype,
                                  device=u.device)


def unstructured_path():
    """The unstructured mesh path on the card: the hierarchy built by
    uniform refinement (vectorized, on the card), then for each of
    UNST_CASES decompose and recompose timed alone, the MGTU compress and
    decompress, the ratio, the CG iterations of each level's solve and
    ||u - u'||_s <= tol by the hierarchy's norm; no kernel launches (the
    per-group codec and the mesh operators are plain PyTorch); the peak
    device memory of the phase."""
    import torch
    from mgard_tpu_torch import unstructured as un
    from mgard_tpu_torch.ops import _build

    _build.reset_launches()
    with CallPeak() as peak:
        hier, t_build = synced_ms(lambda: un.UniformMeshHierarchy(
            un.structured_tet_mesh(UNST_ROOT, device="cuda"), UNST_L))
        fine = hier.meshes[-1]
        tables, t_tables = synced_ms(
            lambda: [m.incidence().width for m in hier.meshes])
        log(f"unstructured: root {UNST_ROOT} refined {UNST_L} times in "
            f"{t_build:.3f} ms (host clock, synchronized); nodes per level "
            f"{[m.ndof for m in hier.meshes]}, tetrahedra "
            f"{[m.elements.shape[0] for m in hier.meshes]}; incidence "
            f"tables (widths {tables}) {t_tables:.3f} ms")
        if (fine.ndof, fine.elements.shape[0]) != (UNST_NODES, UNST_TETS):
            raise AssertionError(f"unstructured: {fine.ndof} nodes, "
                                 f"{fine.elements.shape[0]} tetrahedra")
        u = unstructured_field(fine.nodes)
        nbytes = u.numel() * u.element_size()
        results = {}
        for s, tol in UNST_CASES:
            coeffs, t_dec = synced_ms(hier.decompose, u)
            iters = dict(hier.cg_iterations)
            back, t_rec = synced_ms(hier.recompose, coeffs)
            rt = float((back - u).abs().max())
            del coeffs, back
            buf, t_c = synced_ms(un.compress, hier, u, s, tol)
            out, t_d = synced_ms(un.decompress, hier, buf)
            err = hier.norm(u - torch.from_numpy(out).cuda(), s)
            del out
            ratio = nbytes / len(buf)
            results[s] = (ratio, err)
            log(f"unstructured s = {s}: {len(buf)} bytes, ratio {ratio!r}, "
                f"||u - u'||_s = {err!r} (tolerance {tol}); decompose "
                f"{t_dec:.3f} ms (CG iterations by level {iters}), "
                f"recompose {t_rec:.3f} ms (max|u - R(D(u))| {rt!r}), "
                f"compress {t_c:.3f} ms, decompress {t_d:.3f} ms (host "
                f"clock, synchronized)")
            if not err <= tol or (len(buf), err) != UNST_BEFORE[s]:
                raise AssertionError(f"unstructured s = {s}: error {err} "
                                     f"exceeds {tol}, or the bytes or the "
                                     f"error moved from {UNST_BEFORE[s]}")
        del u, hier, fine
    counts = _build.launch_counts()
    log(f"unstructured: peak device memory {peak.bytes} bytes "
        f"(elements of the finest level alone {UNST_TETS * 4 * 8} bytes)")
    expect_launches("unstructured", counts, {k: 0 for k in counts})
    torch.cuda.empty_cache()
    mesh_refusals()
    return results


def mesh_refusals():
    """The meshes that the JAX package refuses, built on the card: grids
    with fewer than two nodes along an axis, element tables of no rows
    refined once, and a negative node index through a hierarchy, compress
    and decompress; each must raise ValueError, no compress may return a
    buffer, and the card's allocated memory must be what it was."""
    import torch
    from mgard_tpu_torch import unstructured as un

    tri = [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]
    tet = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
           [0.0, 0.0, 1.0]]
    buffers = []

    def mesh_round_trip(nodes, elements, L):
        hier = un.UniformMeshHierarchy(
            un.MeshLevel(nodes, elements, device="cuda"), L)
        buf = un.compress(hier, torch.linspace(
            0.0, 1.0, hier.ndof(), dtype=torch.float64, device="cuda"),
            0.0, 0.1)
        buffers.append(len(buf))
        return un.decompress(hier, buf)

    cases = [(f"triangles {n}", lambda n=n: un.structured_triangle_mesh(
        *n, device="cuda")) for n in ((2, 1), (1, 1), (1, 2), (0, 3))]
    cases += [(f"tetrahedra {n}", lambda n=n: un.structured_tet_mesh(
        n, device="cuda")) for n in ((1, 2, 3), (2, 2, 1), (0, 2, 2))]
    cases += [(f"no ({k}-node) elements, refined once",
               lambda x=x, k=k: mesh_round_trip(x, np.zeros((0, k), np.int64),
                                                1))
              for k, x in ((3, tri), (4, tet))]
    cases += [("a negative index, two refinements",
               lambda: mesh_round_trip(tri, [[0, 1, -1]], 2))]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    got = []
    for label, call in cases:
        try:
            call()
            got.append((label, None, None))
        except Exception as e:      # the type is what is checked
            got.append((label, type(e).__name__, str(e)))
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    log(f"mesh refusals on the card (case, exception, message): {got}; "
        f"buffers compress returned {buffers}; allocated {before} bytes "
        f"before, "
        f"{after} after; {time.perf_counter() - t0:.3f} s")
    if any(e != "ValueError" for _, e, _ in got) or buffers \
            or after != before:
        raise AssertionError("a mesh that the JAX package refuses was not "
                             "refused with ValueError, or compress returned "
                             "a buffer, or memory stayed allocated")


def run_cli(*args):
    """``python -m mgard_tpu_torch`` with ``args``, started from the
    checkout's root; the process is killed at exit if it still runs."""
    import atexit
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "mgard_tpu_torch",
                             *map(str, args)], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    proc.t0 = t0
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_cli(proc):
    """(the process's stdout, its host-clock seconds); raise unless it
    exited 0."""
    out, err = proc.communicate(timeout=300)
    seconds = time.perf_counter() - proc.t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(proc.args)} exited "
                             f"{proc.returncode}:\n{out}\n{err}")
    return out.strip(), seconds


def cli_start(v_host, main_buf):
    """The CLI's processes, started here and left to run beside the phases
    that follow (sharded, examples and the reference checks, whose
    host-clock times they contend): the main field and the main path's
    container written to a temporary
    directory, then ``python -m mgard_tpu_torch`` compress of the field,
    decompress of that container and inspect of it, in three processes
    at once.  :func:`cli_finish` checks that the compress wrote the same
    container, so the decompress read what the CLI's compress writes."""
    import tempfile
    tmp = tempfile.TemporaryDirectory()
    raw, comp, given, back = (os.path.join(tmp.name, n) for n in (
        "raw.bin", "field.mgardtpu", "main.mgardtpu", "back.bin"))
    v_host.tofile(raw)
    with open(given, "wb") as f:
        f.write(main_buf)
    procs = (run_cli("compress", "-i", raw, "-o", comp, "--shape",
                     *v_host.shape, "--dtype", "float32", "-e", TOL),
             run_cli("decompress", "-i", given, "-o", back),
             run_cli("inspect", "-i", given))
    return tmp, raw, comp, back, procs


def cli_finish(v_host, main_buf, started):
    """The CLI (``python -m mgard_tpu_torch``) on the main field: the
    processes of :func:`cli_start` (compress's container the main path's
    byte for byte; decompress's output within the tolerance; inspect's
    header lines); the same compress and decompress through ``cli.main``
    in this process, with the launch counters around each (its output the
    process's bit for bit)."""
    import contextlib
    import io
    from mgard_tpu_torch import cli
    from mgard_tpu_torch.io import format as fmt
    from mgard_tpu_torch.ops import _build

    tmp, raw, comp, back, (p_c, p_d, p_i) = started
    shape = [str(n) for n in v_host.shape]
    with tmp:
        (said, t_c), (said_d, t_d), (said_i, t_i) = (
            finish_cli(p) for p in (p_c, p_d, p_i))
        with open(comp, "rb") as f:
            same = f.read() == main_buf
        counts = {}
        for name, argv in (
                ("compress", ["compress", "-i", raw, "-o", comp + ".2",
                              "--shape", *shape, "-e", str(TOL)]),
                ("decompress", ["decompress", "-i", comp + ".2", "-o",
                                back + ".2"])):
            _build.reset_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(argv)
            counts[name] = {k: n for k, n in _build.launch_counts().items()
                            if n}
        out = np.fromfile(back, dtype=np.float32).reshape(v_host.shape)
        err = card_max_err(v_host, out)
        same_out = np.array_equal(
            out, np.fromfile(back + ".2", dtype=np.float32
                             ).reshape(v_host.shape))
        del out
    log(f"cli compress: {said!r} in {t_c:.3f} s; decompress: {said_d!r} in "
        f"{t_d:.3f} s; inspect in {t_i:.3f} s (three processes at once, "
        f"beside phases 25-26; host clock); the compress's "
        f"container is the main path's byte for byte: {same}; max|v - out| "
        f"= {err!r} (tolerance {TOL}); in this process, launches {counts}, "
        f"its output the process's bit for bit: {same_out}")
    log("cli inspect: " + " | ".join(said_i.splitlines()))
    levels = fmt.read_container(main_buf)[0].n_levels
    if not (same and same_out and err <= TOL
            and f"levels      : {levels}" in said_i.splitlines()):
        raise AssertionError(f"cli: container {same}, output {same_out}, "
                             f"error {err}, inspect {said_i!r}")
    missing = [k for k in SEGMENTED_KERNELS
               if not (counts["compress"].get(k)
                       or counts["decompress"].get(k))]
    if missing:
        raise AssertionError(f"cli: not launched {missing}")
    return counts


def sharded_path(v_host, two_slabs):
    """ShardedCompressor.for_global over one card, the main field in two
    slabs along dim 0, ABS and REL: each container the API's for the same
    two slabs (:func:`two_slab_paths`, which decoded them) byte for byte,
    with the same launches; the ABS container decoded within 1e-3; the
    compressor's round-trip step on the card."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.config import ErrorMode
    from mgard_tpu_torch.ops import _build
    from mgard_tpu_torch.parallel import ShardedCompressor

    sc = ShardedCompressor.for_global(["cuda:0"], SHAPE, np.float32,
                                      nblocks=2)
    launches = None
    for mode, tol in ((ErrorMode.ABS, TOL), (ErrorMode.REL, REL_TOL)):
        ref, ref_counts = two_slabs[mode.name.lower()]
        _build.reset_launches()
        buf, t_s = synced_ms(sc.compress, v_host, tol, mode)
        counts = _build.launch_counts()
        err = None
        if mode == ErrorMode.ABS:
            err = card_max_err(v_host, mt.decompress(buf))
        log(f"sharded {mode.name}: {len(buf)} bytes, compress "
            f"{t_s:.3f} ms (host clock); the API's container for the "
            f"same slabs byte for byte: {buf == ref}; max|v - out| = {err!r}; "
            f"launches { {k: n for k, n in counts.items() if n} }")
        if not (buf == ref and counts == ref_counts
                and (err is None or err <= TOL)):
            raise AssertionError(f"sharded {mode.name}: same bytes "
                                 f"{buf == ref}, launches {counts} against "
                                 f"{ref_counts}, error {err}")
        launches = launches or counts
        del buf
    step = sc.roundtrip_step()
    blocks = sc.shard_blocks(np.stack(np.split(v_host, 2, axis=0)))
    _build.reset_launches()
    (err, words), t_step = synced_ms(step, blocks, TOL)
    log(f"sharded round-trip step: max|v - out| = {float(err)!r}, "
        f"{int(words)} stream words, {t_step:.3f} ms (host clock, "
        f"synchronized); launches "
        f"{ {k: n for k, n in _build.launch_counts().items() if n} }")
    if not float(err) <= TOL:
        raise AssertionError(f"sharded round-trip step: error {err}")
    del blocks, sc
    torch.cuda.empty_cache()
    return launches


SWEEP_SHAPE = (256, 256, 256)
# The sweep's grid, cut from utils/autotune.py's DEFAULT_GRID to the
# script's time (a probe process costs ~12 s, most of it start-up): one
# chunk width other than the main path's 4096, so that the table's width
# is not the default one, and GPK off.
SWEEP_GRID = {"chunk_groups": [2048], "gpk": [0]}
EXAMPLES = ("torch_basic_compression", "torch_interop",
            "torch_multichip_sharded", "torch_progressive_mdr",
            "torch_qoi_preservation", "torch_xgc_case_study")
# What the fresh process under the swept table runs: the main field's
# round trip with the launch counters around it
FRESH_PROCESS = """
import json, sys
import numpy as np
import mgard_tpu_torch as mt
from mgard_tpu_torch.ops import _build, bitplane, transform
v = np.fromfile(sys.argv[1], dtype=np.float32).reshape(%r)
_build.reset_launches()
buf = mt.compress(v, %r)
out = mt.decompress(buf)
counts = _build.launch_counts()
open(sys.argv[2], "wb").write(buf)
print(json.dumps({"launches": counts, "chunk_groups": bitplane.CHUNK_GROUPS,
                  "gpk": transform._GPK, "xk": transform._XK,
                  "err": float(np.abs(out.astype(np.float64) - v).max())}))
"""


def codec_pick(tmpdir):
    """``autotune`` of the main shape (iters=1) into a temporary table:
    BITPLANE against BITPLANE_GROUP, each one's device encode GB/s (host
    clock around synchronized runs, the slope of one run over two) and
    ratio on the tuner's own field; ``lookup`` and ``Config.tuned`` give
    the winner."""
    import torch
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.utils import autotune

    path = pathlib.Path(tmpdir) / "pick.json"
    t0 = time.perf_counter()
    res = autotune.autotune(SHAPE, np.float32, iters=1, path=path)
    seconds = time.perf_counter() - t0
    picked = {mt.Lossless(k).name: r for k, r in res["results"].items()}
    default = autotune._DEFAULT_PATH
    try:
        autotune._DEFAULT_PATH = path
        tuned = mt.Config.tuned(SHAPE, np.float32)
    finally:
        autotune._DEFAULT_PATH = default
    looked = autotune.lookup(SHAPE, np.float32, path=path)
    log(f"codec pick at {SHAPE} float32 (key "
        f"{autotune._key(SHAPE, np.float32)}): {picked}; best "
        f"{res['best'].name} (balanced: GB/s x ratio); lookup "
        f"{looked.lossless.name}, Config.tuned {tuned.lossless.name}; "
        f"{seconds:.3f} s with the field's build (host clock)")
    if looked.lossless != res["best"] or tuned.lossless != res["best"]:
        raise AssertionError(f"codec pick: best {res['best']}, lookup "
                             f"{looked}, Config.tuned {tuned}")
    torch.cuda.empty_cache()


def _sweep_and_fresh(tmpdir, raw):
    """:func:`sweep_start`'s thread: the sweep, then the fresh process.
    Returns what :func:`sweep_finish` checks; logs nothing."""
    from mgard_tpu_torch.utils import autotune

    path = pathlib.Path(tmpdir) / "sweep.json"
    said = []
    t0 = time.perf_counter()
    res = autotune.sweep_knobs(SWEEP_SHAPE, np.float32, grid=SWEEP_GRID,
                               path=path, log=said.append)
    t_sweep = time.perf_counter() - t0
    table = autotune.load_table(path)
    env = {k: v for k, v in os.environ.items()
           if k not in autotune.KNOB_ENV.values()}
    env.update(PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
               MGARD_TPU_AUTOTUNE=str(path), MGARD_TPU_GPK="0",
               MGARD_TPU_XK="0")
    out = os.path.join(tmpdir, "fresh.mgardtpu")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FRESH_PROCESS % (SHAPE, TOL),
                           raw, out], env=env, capture_output=True,
                          text=True, timeout=600)
    t_fresh = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"fresh process exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    with open(out, "rb") as f:
        buf = f.read()
    return (res, table, t_sweep, said,
            json.loads(proc.stdout.strip().splitlines()[-1]), buf, t_fresh)


def sweep_start(v_host):
    """``sweep_knobs`` at SWEEP_SHAPE over SWEEP_GRID through real
    ``probe`` subprocesses into a temporary table, then one fresh process
    under ``MGARD_TPU_AUTOTUNE=<that table> MGARD_TPU_GPK=0
    MGARD_TPU_XK=0`` that compresses and decompresses the main field with
    its launch counters: on a host thread, started here and left to run
    beside the phases that follow (multi-block, sharded, examples,
    reference, cli:
    host-clock times that are recorded, not judged), so its GB/s are read
    beside them."""
    import tempfile
    tmp = tempfile.TemporaryDirectory()
    raw = os.path.join(tmp.name, "raw.bin")
    v_host.tofile(raw)
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(_sweep_and_fresh, tmp.name, raw)
    pool.shutdown(wait=False)
    return tmp, fut


def sweep_finish(v_host, started):
    """The sweep's winners and readings (contended: recorded, not
    judged, but every candidate of SWEEP_GRID must have given one: a
    probe process that failed fails the phase); the fresh process: K1,
    K5 and K6 launched 0 times (GPK and
    XK off), the codec kernels K2-K4 launched, its container's
    chunk_groups the table's ``default_knobs`` width, decoded here within
    the tolerance."""
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.io import format as fmt

    tmp, fut = started
    with tmp:
        res, table, t_sweep, said, fresh, buf, t_fresh = fut.result()
    for line in said:
        log(f"sweep {line}")
    log(f"sweep at {SWEEP_SHAPE} float32 over {SWEEP_GRID}: winners "
        f"{res['winners']}, {t_sweep:.3f} s (one probe process a "
        f"candidate, beside the phases from multi-block to cli; host "
        f"clock); readings "
        f"{res['results']}; default_knobs {table['default_knobs']}")
    missing = [(k, c) for k, cs in SWEEP_GRID.items() for c in cs
               if str(c) not in res["results"].get(k, {})]
    failed = [line for line in said if "failed" in line]
    if missing or failed:
        raise AssertionError(f"sweep: no reading for {missing}; {failed}")
    width = int(table["default_knobs"]["MGARD_TPU_CHUNK_GROUPS"])
    header = fmt.read_container(buf)[0]
    err = card_max_err(v_host, mt.decompress(buf))
    launches = {k: n for k, n in fresh["launches"].items() if n}
    log(f"fresh process under the swept table with MGARD_TPU_GPK=0 "
        f"MGARD_TPU_XK=0: {t_fresh:.3f} s (host clock); chunk_groups "
        f"{fresh['chunk_groups']}, _GPK {fresh['gpk']}, _XK {fresh['xk']}, "
        f"launches {launches}, its max|v - out| = {fresh['err']!r}; the "
        f"container's header chunk_groups {header.chunk_groups} (table "
        f"{width}), {len(buf)} bytes, ratio {v_host.nbytes / len(buf)!r}, "
        f"decoded here max|v - out| = {err!r}")
    off = [k for k in ("extract_coarse_3d", "gpk_detail", "gpk_prolong_add")
           if fresh["launches"][k]]
    codec = [k for k in ("bp_quant_max", "bp_quant_condense",
                         "bp_decode_condense_f32") if not launches.get(k)]
    if off or codec or fresh["gpk"] or fresh["xk"] \
            or (header.chunk_groups or 2048) != width \
            or fresh["chunk_groups"] != width or not err <= TOL \
            or not fresh["err"] <= TOL:
        raise AssertionError(f"fresh process: launched {off}, codec "
                             f"kernels not launched {codec}, header width "
                             f"{header.chunk_groups} against {width}, "
                             f"errors {fresh['err']} / {err}")


def example_paths():
    """The six examples (``examples/torch_*.py``), each run in this
    process by its ``main(["--device", "cuda"])`` at its default size;
    each raises if an error exceeds its bound.  Their lines, times and
    launches are logged."""
    import contextlib
    import io
    import runpy
    from mgard_tpu_torch.ops import _build

    root = os.path.dirname(os.path.abspath(__file__))
    for name in EXAMPLES:
        main = runpy.run_path(os.path.join(root, "examples",
                                           name + ".py"))["main"]
        said = io.StringIO()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            main(["--device", "cuda"])
        seconds = time.perf_counter() - t0
        log(f"example {name}: {seconds:.3f} s (host clock); launches "
            f"{nonzero(_build.launch_counts())}; said: "
            + " | ".join(x for x in said.getvalue().splitlines() if x))


def planner_summary():
    """The encode peaks gathered for the planner's margins, each against
    the factor the planner counts for that call (none for ROI and MDR)."""
    from mgard_tpu_torch import api
    import mgard_tpu_torch as mt
    planned = {
        "float64 (8192, 8192) s = 0": api.footprint_per_byte(
            LONG_SQUARE, np.float64, mt.Config()),
        "per-group 128^3": api.footprint_per_byte((128,) * 3, np.float32,
                                                  mt.Config())}
    for k in hybrid_peak_levels():
        planned[f"HYBRID k = {k} 512^3"] = api.footprint_per_byte(
            SHAPE, np.float32, mt.Config(
                decomposition=mt.Decomposition.HYBRID, num_local_levels=k))
    for s in (math.inf, 0.0):
        planned[f"float64 {LONG_FIELD} s = {s}"] = api.footprint_per_byte(
            LONG_FIELD, np.float64, mt.Config())
    log(f"planner peaks (peak / input bytes; the planner's factor): "
        f"{ {k: (v, planned.get(k)) for k, v in PLANNER_PEAKS.items()} }")


def pin_knobs():
    """Every check runs at the default knobs: before the package is
    imported (its ``apply_tuned`` seeds the knobs from an autotune table,
    ``~/.cache/mgard_tpu_torch/autotune.json`` unless
    ``MGARD_TPU_AUTOTUNE`` names another), drop every ``MGARD_TPU_*``
    variable and name a table that does not exist, in a temporary
    directory this run makes.  The processes it starts inherit both.
    Returns the directory."""
    import tempfile
    for k in [k for k in os.environ if k.startswith("MGARD_TPU_")]:
        del os.environ[k]
    tmp = tempfile.TemporaryDirectory()
    os.environ["MGARD_TPU_AUTOTUNE"] = os.path.join(tmp.name,
                                                    "autotune.json")
    return tmp


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs only on a "
              "GPU", file=sys.stderr)
        return 2
    no_table = pin_knobs()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mgard_tpu_torch as mt
    from mgard_tpu_torch.ops import _build
    from mgard_tpu_torch.utils import autotune

    # the main field (host numpy) builds on a thread beside the kernels
    field_pool = ThreadPoolExecutor(1)
    field = field_pool.submit(smooth_field_host, SHAPE)
    with Phase("setup"):
        log(f"script: {time.perf_counter() - T_START:.3f} s from its start "
            f"to the setup phase (imports)")
        card = card_line()
        log(f"card: {card}")
        log(f"knobs at their defaults: no MGARD_TPU_* variable, the "
            f"autotune table {autotune._DEFAULT_PATH} (absent: "
            f"{not autotune._DEFAULT_PATH.exists()})")
        if autotune._DEFAULT_PATH.exists():
            raise AssertionError("the autotune table is not pinned")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
            f"{sys.version.split()[0]}, device "
            f"{torch.cuda.get_device_name(0)}")
        # the host codecs (one g++ each) build beside the kernels
        with ThreadPoolExecutor(2) as pool:
            t0 = time.perf_counter()
            host = [pool.submit(_build.host_library, name)
                    for name in ("mgard_huffman", "mgard_lz4")]
            _build.build()
            _build.lib()
            host = [str(f.result().relative_to(_build.BUILD_DIR.parent))
                    for f in host]
        srcs = _build.sources()
        log(f"kernel build: {_build.build_seconds:.2f} s, {len(srcs)} "
            f"sources compiled in parallel "
            f"({' '.join(_build.compile_command(srcs[0], 'x.o'))} ...), "
            f"then one link; host codecs {host} built beside them, "
            f"{time.perf_counter() - t0:.2f} s in all")

    with Phase("data"):
        t0 = time.perf_counter()
        v_host = field.result()
        field_pool.shutdown()
        log(f"main field built beside the setup phase; "
            f"{time.perf_counter() - t0:.3f} s waited for it here")
        hier = mt.Hierarchy(SHAPE)
        log(f"field {SHAPE} float32, {v_host.nbytes} bytes, L = {hier.L}")

    with Phase("kernels"):
        v = torch.from_numpy(v_host).cuda()
        kernels = check_kernels(hier, v) + check_stencil(hier, v) \
            + check_flat_kernels(hier, v) + check_lpk(hier, v)
        del v
        torch.cuda.empty_cache()

    with Phase("stencil forms"):
        v = torch.from_numpy(v_host).cuda()
        stencil_forms(hier, v)
        del v
        torch.cuda.empty_cache()

    with Phase("nonuniform"):
        check_stencil_nonuniform()

    with Phase("main path"):
        buf, counts = main_path(v_host)

    with Phase("timing"):
        time_parts(v_host, buf)

    with Phase("codec widths"):
        v = torch.from_numpy(v_host).cuda()
        check_codec_widths(hier, v)
        del v
        codec_width_paths(v_host, buf)

    with Phase("codec pick"):
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            codec_pick(tmp)

    with Phase("two-pass"):
        two_pass_launches = two_pass_path(v_host, buf, counts)

    with Phase("lpk"):
        lpk_launches = lpk_path(v_host, buf, counts)

    with Phase("flat"):
        flat_counts = flat_path(v_host, counts)

    with Phase("per-group"):
        pergroup_path()

    with Phase("float64"):
        float64_path(v_host)

    with Phase("s-norm"):
        snorm_paths(v_host, buf, counts)

    with Phase("layouts"):
        layout_paths(v_host, flat_counts)
        check_singledim_s1(v_host)

    # The long series' hierarchy (host work alone, ~30 s at its size)
    # builds on a host thread while phases 13-21 run, and nothing frees
    # the compressors' caches before long dims takes it; HUFFMAN_ZLIB's
    # host work and the CPU format's zlib level 9 run on host threads of
    # their own (HostLeg) from phases 13 and 14 to 20 and 21.
    mt.release_cache()
    with ThreadPoolExecutor(1) as pool:
        prebuilt = pool.submit(long_series_hierarchy)

        with Phase("host codecs"):
            huffman_zlib = host_codec_paths(v_host, buf, counts, flat_counts)

        v_small = smooth_field_host(X_SMALL)
        with Phase("CPU format"):
            cpu_format = cpu_format_start(v_small)

        with Phase("roi"):
            roi_path(v_host, flat_counts)

        with Phase("qoi"):
            qoi_solves = qoi_path(v_host, counts)

        with Phase("mdr"):
            mdr_path(v_host, counts)

        with Phase("interop"):
            interop_paths(v_small)

        with Phase("zfp"):
            zfp_paths(v_host)

        with Phase("HUFFMAN_ZLIB"):
            huffman_zlib_finish(v_host, flat_counts, huffman_zlib)
        del huffman_zlib

        with Phase("CPU format decode"):
            cpu_format_finish(v_small, cpu_format)
        del cpu_format, v_small

        with Phase("long dims"):
            s1_entry, s1_f64_entry = long_dims(v_host, buf, prebuilt)

    with Phase("unstructured"):
        unstructured_path()
    del prebuilt

    # the sweep's processes run beside the phases from "multi-block" to
    # "cli", the CLI's beside those from "sharded" to "reference"
    sweep_run = sweep_start(v_host)
    with Phase("multi-block"):
        _, two_slabs = multiblock_paths(v_host)

    cli_run = cli_start(v_host, buf)

    with Phase("sharded"):
        sharded_counts = sharded_path(v_host, two_slabs)
    del two_slabs
    planner_summary()

    with Phase("examples"):
        example_paths()

    with Phase("reference"):
        reference_check((65, 65, 65), seed=1)
        reference_check((32, 256, 256), seed=2)
        reference_check((32, 256, 256), seed=2, fused=False)
        reference_check((32, 256, 256), seed=2, lpk=True)
        flat_reference_check()
        snorm_reference_check((65, 65, 65), seed=4, s=0.0)
        snorm_reference_check((33, 65, 65), seed=5, s=1.0, uniform=False)
        layout_reference_check()

    with Phase("cli"):
        cli_counts = cli_finish(v_host, buf, cli_run)
    del buf, cli_run

    with Phase("sweep"):
        sweep_finish(v_host, sweep_run)
    del sweep_run

    # launches: each kernel's count on the path that runs it; K16/K17 run
    # on no path, so theirs is the main path's 0
    for k in kernels:
        k["launches"] = (flat_counts if k["name"] in FLAT_KERNELS
                         else two_pass_launches
                         if k["name"] in TWO_PASS_KERNELS
                         else lpk_launches if k["name"] in LPK_KERNELS
                         else counts)[k["name"]]
    log(f"launches of the new paths: cli {cli_counts}, sharded compress "
        f"{sharded_counts}, unstructured none")
    # S1 (outside the K numbering): launches on the long series; in
    # float64 on QoI's Riesz solve and norms
    s1_f64_entry["launches"] = qoi_solves
    kernels += [s1_entry, s1_f64_entry]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"script: {time.perf_counter() - T_START:.3f} s from its start to "
        f"the summary")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    no_table.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())

// S1 mass_solve: the batched Thomas solve M x = b of a level's 1-D mass
// matrix along one axis, in float32 or float64.
//
// Replaces the lax.scan of mgard_tpu/ops/tridiag.py:69 (mass_solve), which
// XLA turns into a loop on the device; the JAX package has no Pallas
// kernel for it (mgard_tpu/ops/pallas_kernels.py:11-14).  The wrapper
// (ops/tridiag.py) hands b as it lies, a contiguous (outer, n, inner)
// array with n the solve axis: m = outer * inner independent lines, node i
// of line j at line_base(j) + i * inner, and x comes back in that layout.
// With the host's tables off (n - 1) and div (n) in the data's type and
// w_i = off_i / div_i divided here, correctly rounded in that type as the
// host divides it, the plain version's operations in its order:
//
//   forward   d_0 = b_0,  d_i = b_i - w_{i-1} d_{i-1}
//   backward  x_{n-1} = d_{n-1} / div_{n-1},
//             x_i = (d_i - off_i x_{i+1}) / div_i
//
// Float rule: every multiply, subtract and divide is an _rn intrinsic, so
// nvcc can contract nothing into an FMA, and the divide is the correctly
// rounded one; the result is the plain version's bit for bit.
//
// Bound: bytes (read b, off and div, write x; a few operations a value).
// Design.  A block owns a tile: `lines` lines by a segment of `segment`
// nodes, widened by `overlap` nodes on each side, loaded once into shared
// memory with cp.async, neighbouring threads on neighbouring addresses
// along whichever axis is contiguous (along the lines where inner > 1,
// along one line where inner = 1: the last axis is read as it lies, no
// transposing copy).  Both sweeps run there, so d never reaches device
// memory, and x is written once, coalesced the same way.  Threads split
// each line of the tile into runs of `run` nodes.  The "lines" kernel
// (32 lines or more): thread (l, p) owns run p of line l, the lanes of a
// warp on 32 lines at one node; one array a tile, b then d then x, swept
// in place, and the tile's off, div and w = off / div, shared by its
// lines.  The "runs" kernel (fewer lines): one line a block, 256 runs, a
// run's nodes padded by one word every `run` nodes; b (then x), d, off
// and div, d first holding w.  Either way the 32 lanes of a warp hit 32
// banks, and each sweep loads kStep steps' operands into registers before
// it computes them.
//
// Exactness.  Each sweep is a map of the previous value that contracts
// by about 0.27 a step (|w| and off/div <= 1/2 on any grid), so a run
// starts its sweep `overlap` nodes early from a guess (0 for the value
// before), and meets the exact run, bit for bit, long before its first
// node.  Where a run's value at the node before its first (forward) or
// after its last (backward) has the bits of the neighbouring run's value
// there, it repeated the plain version's operations on the plain
// version's values and is exact.  Where it has not, one thread a line,
// in order along it, walks a forward miss from the exact value until the
// walk meets the stored d (bits compared, so -0 and NaN count right, b
// read again from device memory), and re-solves a backward miss's run
// from the exact d before it and the exact x after it.  Across blocks,
// each block writes its boundary values (its runs' values at the nodes
// beside its segment, its own d at the last and x at the first node) to
// a small array; a check parallel over every (boundary, line) flags
// misses, and a last kernel, one thread a line, returns at once where
// its line has none.  Otherwise it re-solves, in both sweeps, each
// segment whose boundary missed, from the exact value of the segment
// before it (forward, in order) and after it (backward, in reverse
// order), checking the next boundary against the new value.  So the
// result is exact whatever the data; only the time depends on how soon
// the runs meet.  `walks`, when given, counts the runs walked or
// re-solved in blocks ([0]) and the segments re-solved ([1]).  Offsets
// are 64-bit.

#include "tridiag.cuh"

using mgard_s1::Geo;
using mgard_s1::kThreads;

// float is instantiated here, double in tridiag_f64.cu.
extern template cudaError_t mgard_s1::solve<double>(
    const double*, const double*, const double*, double*, double*, int*,
    int*, const Geo&, cudaStream_t);

// b, x: (m / inner, n, inner); off: (n - 1,); div: (n,); all float32
// (is_double 0) or float64 (1).  lines: 1 (the runs kernel; run a power
// of two >= 2, segment = 256 * run) or 32, 64, 128, 256 (the lines
// kernel; segment <= (256 / lines) * run).  bounds: 4 * nseg * m values
// and flags (nseg + 1) * m ints of scratch when the lines take more than
// one segment (nseg = ceil(n / segment)), else unused; walks: 2 ints
// that the walks add to, or null.  n >= 2, inner >= 1 divides m,
// overlap >= 1.
extern "C" cudaError_t mgard_mass_solve(
    const void* b, const void* off, const void* dv, void* x, void* bounds,
    int* flags, int* walks, long long n, long long m, long long inner,
    long long lines, long long run, long long segment, long long overlap,
    int is_double, cudaStream_t stream) {
  if (m <= 0) return cudaSuccess;
  const bool runs_kernel = lines == 1;
  if (n < 2 || inner < 1 || m % inner || overlap < 1 || run < 1 ||
      segment < 1 || overlap > INT_MAX / 4 || run > INT_MAX / 4 ||
      (lines != 1 && lines != 32 && lines != 64 && lines != 128 &&
       lines != 256)) {
    return cudaErrorInvalidValue;
  }
  Geo g{};
  g.n = n;
  g.m = m;
  g.inner = inner;
  g.segment = segment;
  g.nseg = (n + segment - 1) / segment;
  g.lines = static_cast<int>(lines);
  g.runs = kThreads / g.lines;
  g.run = static_cast<int>(run);
  g.overlap = static_cast<int>(overlap);
  if (runs_kernel) {
    if (run < 2 || (run & (run - 1)) || segment != kThreads * run) {
      return cudaErrorInvalidValue;
    }
    while ((1 << g.shift) < g.run) ++g.shift;
    g.pad = static_cast<int>((overlap + run - 1) / run * run);
  } else {
    if (segment > static_cast<long long>(g.runs) * run) {
      return cudaErrorInvalidValue;
    }
    const long long width = segment + 2 * overlap < n ? segment + 2 * overlap
                                                      : n;
    if (width > INT_MAX / 512) return cudaErrorInvalidValue;
    g.width = static_cast<int>(width);
    g.stride = g.width | 1;
  }
  if (g.nseg > 1 && (bounds == nullptr || flags == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (is_double) {
    return mgard_s1::solve(
        static_cast<const double*>(b), static_cast<const double*>(off),
        static_cast<const double*>(dv), static_cast<double*>(x),
        static_cast<double*>(bounds), flags, walks, g, stream);
  }
  return mgard_s1::solve(
      static_cast<const float*>(b), static_cast<const float*>(off),
      static_cast<const float*>(dv), static_cast<float*>(x),
      static_cast<float*>(bounds), flags, walks, g, stream);
}

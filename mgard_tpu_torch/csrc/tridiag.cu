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
// Three routes, chosen by the wrapper's solve_geometry; each holds a tile
// in shared memory, loaded once with cp.async, neighbouring threads on
// neighbouring addresses along whichever axis is contiguous (along the
// lines where inner > 1, along one line where inner = 1: the last axis
// is read as it lies, no transposing copy), both sweeps run there, so d
// never reaches device memory, and x is written once, coalesced the same
// way.  The threads of a block follow the tile (32 to 256).
//
// "short" (float64 lines too short to split, n < 4 overlaps): one thread
// a whole line, as many lines a tile as threads, the lines swept in
// place from their ends; no guess and nothing to check, so exact by
// construction, and the block needs no probes.  A level's lines spread
// over at least two blocks an SM where it has the lines for it.
//
// "lines" (32 lines or more): a block owns `lines` lines by a segment of
// `segment` nodes, widened by `overlap` nodes on each side; thread
// (l, p) owns run p of line l, the lanes of a warp on 32 lines at one
// node; one array a tile, b then d then x, swept in place, and the
// tile's off, div and w = off / div, shared by its lines.
//
// "runs" (fewer lines): one line a block, `threads` runs a segment, a
// run's nodes padded by one word every `run` nodes; b (then x), d, off
// and div, d first holding w.
//
// Either of the last two: the 32 lanes of a warp hit 32 banks, and each
// sweep loads kStep steps' operands into registers before it computes
// them.  float32 takes 256 threads a block, an overlap of 32 nodes and
// the most lines a tile that fit 74 KB (three blocks an SM); float64
// takes the level's overlap (below) and tiles that fit two blocks an SM
// or more.  Its lines tiles take runs at least twice the overlap, so
// that no thread sweeps more guessed nodes than half its own.  Its runs
// kernel holds four values a node, so runs that long would leave an SM
// 64 threads; it takes the threads and even run that keep the most
// threads an SM on nodes of their own (a long series: 128 threads of
// runs of 16, three blocks an SM).
//
// The quotient.  float64's backward step x_i = (d_i - off_i x_{i+1}) /
// div_i waits on the division, a long chain of its own, at every node,
// so the lines and short kernels keep y_i = 1 / div_i (__drcp_rn, where
// 2^-100 <= div_i <= 2^100, else NaN) beside div and divide through it:
// for a = d_i - off_i x_{i+1} and b = div_i,
//   q0 = RN(a y),  x_i = RN(q0 + RN(a - b q0) y)   (two fused steps),
// which feeds the next step at once.  Every step is odd in a (RN is), so
// x_i is Q = the same steps on A = |a|, with a's sign, and x_i is taken
// only where Q is proven RN(A / b).  Beside the chain the kernel forms
// r = RN(A - b Q) (one fused step) and the gaps g+ = succ(Q) - Q and
// g- = Q - pred(Q) from Q's neighbours (differences of neighbouring
// doubles, exact powers of two), the bounds t+ = RN((b/2) g+) and t- =
// RN((b/2) g-), and accepts Q iff 2^-900 <= A <= 2^900, both bounds lie
// in [2^-1022, 2^1022], and
//   -t- < r < t+.
// Proof: b / 2 is exact, and a double times a power of two is exact
// unless the product underflows or overflows, which a result in
// [2^-1022, 2^1022] rules out, so t+- = (b/2) g+- exactly (on the
// quotients the test is meant to pass both lie near A 2^-53).  RN is
// monotone and keeps doubles fixed, so RN(A - b Q) < t+ implies
// A - b Q < t+ (were it >=, its rounding would be >= t+ too), and
// likewise below.  Dividing by b > 0, Q - g-/2 < A / b < Q + g+/2: A / b
// lies strictly between the midpoints of Q and its neighbours, so
// RN(A / b) = Q, and RN(a / b) is
// Q with a's sign since RN is odd.  A NaN or infinite Q, A or y, a zero
// A (pred(0) is a NaN pattern) or a Q far from A / b fail the test.
// (A quotient of two doubles is never a midpoint, so a strict test
// loses no quotient to a tie.)  If any of a sweep's kStep steps fails,
// those kStep steps are taken again from their first x with __ddiv_rn,
// their operands still in registers.  So x is the plain version's bit
// for bit whichever way it was found; the test only decides the time.
// float32 and the runs kernel divide with __fdiv_rn / __ddiv_rn.
//
// Exactness.  Each sweep is a map of the previous value that contracts
// by |w_i| = off_i / div_i a step (about 0.27 inside a uniform grid,
// 0.5 at its ends), so a run starts its sweep `overlap` nodes early
// from a guess (b there forward, d / div there backward), and meets the
// exact run, bit for bit, long before its first node.  float64 takes
// as its overlap the fewest steps k such that every k consecutive
// factors |w_i| of the level multiply to 2^-74 or less: the guess's
// error then falls below half an ulp with a margin of 2^20, for values
// that shrink along the line (40 steps on a uniform grid;
// ops/tridiag.py:solve_overlap).  Where a run's value at
// the node before its first (forward) or after its last (backward) has
// the bits of the neighbouring run's value there, it repeated the plain
// version's operations on the plain version's values and is exact.
// Where it has not, one thread a line, in order along it, walks a
// forward miss from the exact value until the walk meets the stored d
// (bits compared, so -0 and NaN count right, b read again from device
// memory), and re-solves a backward miss's run from the exact d before
// it and the exact x after it.  Across blocks, each block writes its
// boundary values (its runs' values at the nodes beside its segment, its
// own d at the last and x at the first node) to a small array; a check
// parallel over every (boundary, line) flags misses, and a last kernel,
// one thread a line, returns at once where its line has none (float64
// with at most 64 segments a line: that kernel checks its line's
// boundaries itself, one launch fewer).
// Otherwise it re-solves, in both sweeps, each segment whose boundary
// missed, from the exact value of the segment before it (forward, in
// order) and after it (backward, in reverse order), checking the next
// boundary against the new value.  So the result is exact whatever the
// data and whatever the overlap; only the time depends on how soon the
// runs meet.  `walks`, when given, counts the runs walked or re-solved
// in blocks ([0]) and the segments re-solved ([1]).  Offsets are 64-bit.

#include "tridiag.cuh"

using mgard_s1::Geo;
using mgard_s1::kThreads;

// float is instantiated here, double in tridiag_f64.cu.
extern template cudaError_t mgard_s1::solve<double>(
    const double*, const double*, const double*, double*, double*, int*,
    int*, const Geo&, cudaStream_t);

// b, x: (m / inner, n, inner); off: (n - 1,); div: (n,); all float32
// (is_double 0) or float64 (1).  route 0, "runs": lines 1, run >= 2 (a
// power of two in float32), segment = threads * run (segment + 2 pad <
// 2^16 in float64, pad the overlap rounded up to a multiple of run);
// route 1, "lines": lines 32, 64,
// 128 or 256 dividing threads, segment <= (threads / lines) * run;
// route 2, "short": lines = threads, segment = run = n.  threads: a
// multiple of 32 up to 256.  bounds: 4 * nseg * m values and flags
// (nseg + 1) * m ints of scratch when the lines take more than one
// segment (nseg = ceil(n / segment)), else unused; walks: 2 ints that
// the walks add to, or null.  n >= 2, inner >= 1 divides m,
// overlap >= 1.
extern "C" cudaError_t mgard_mass_solve(
    const void* b, const void* off, const void* dv, void* x, void* bounds,
    int* flags, int* walks, long long n, long long m, long long inner,
    long long route, long long threads, long long lines, long long run,
    long long segment, long long overlap, int is_double,
    cudaStream_t stream) {
  if (m <= 0) return cudaSuccess;
  const bool lines_ok = lines == 32 || lines == 64 || lines == 128 ||
                        lines == 256;
  if (n < 2 || inner < 1 || m % inner || overlap < 1 || run < 1 ||
      segment < 1 || overlap > INT_MAX / 4 || run > INT_MAX / 4 ||
      route < mgard_s1::kRuns || route > mgard_s1::kShort || threads < 32 ||
      threads > kThreads || threads % 32 ||
      (route == mgard_s1::kRuns ? lines != 1
                                : !lines_ok || threads % lines)) {
    return cudaErrorInvalidValue;
  }
  Geo g{};
  g.n = n;
  g.m = m;
  g.inner = inner;
  g.segment = segment;
  g.nseg = (n + segment - 1) / segment;
  g.route = static_cast<int>(route);
  g.threads = static_cast<int>(threads);
  g.lines = static_cast<int>(lines);
  g.runs = g.threads / g.lines;
  g.run = static_cast<int>(run);
  g.overlap = static_cast<int>(overlap);
  if (route == mgard_s1::kRuns) {
    g.pad = static_cast<int>((overlap + run - 1) / run * run);
    if (run < 2 || segment != threads * run ||
        (is_double ? segment + 2LL * g.pad >= 65536 : (run & (run - 1)))) {
      return cudaErrorInvalidValue;
    }
    while ((1 << g.shift) < g.run) ++g.shift;
    g.magic = static_cast<unsigned>((0x100000000ULL + run - 1) / run);
  } else {
    if (route == mgard_s1::kShort
            ? lines != threads || segment != n || run != n
            : segment > static_cast<long long>(g.runs) * run) {
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

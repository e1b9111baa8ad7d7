// S1's kernels and their launch, shared by the two sources that
// instantiate them: tridiag.cu (float, and the launcher mgard_mass_solve)
// and tridiag_f64.cu (double), compiled side by side.  See tridiag.cu
// for what S1 computes, its routes and its exactness.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace mgard_s1 {

constexpr int kThreads = 256;     // the most threads a block
constexpr int kWarp = 32;
constexpr int kFixThreads = 128;
constexpr int kCheckSegs = 64;    // float64: fix_bounds checks its line
                                  // itself up to this many segments
constexpr int kSmemMax = 232448;   // the most shared memory a block has

template <typename T> struct Ops;

template <> struct Ops<float> {
  using Bits = unsigned int;
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ Bits bits(float a) {
    return __float_as_uint(a);
  }
};

template <> struct Ops<double> {
  using Bits = unsigned long long;
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ Bits bits(double a) {
    return static_cast<Bits>(__double_as_longlong(a));
  }
  // The reciprocal the backward sweep divides through: 1 / b correctly
  // rounded where 2^-100 <= b <= 2^100, else NaN (every quotient by b
  // then takes the division).
  static __device__ __forceinline__ double rcp(double b) {
    return b >= 0x1p-100 && b <= 0x1p100
               ? __drcp_rn(b)
               : __longlong_as_double(0x7ff8000000000000LL);
  }
  // a / b from y = rcp(b): Q from a product and two fused steps; ok is
  // set only where the test of tridiag.cu proves Q the correctly rounded
  // a / b (2^-900 <= |a| <= 2^900).  Only Q's three operations feed the
  // next step: the test, on |a| and |Q|, runs beside the chain.
  static __device__ __forceinline__ double quot(double a, double b,
                                                double y, bool& ok) {
    const double q0 = __dmul_rn(a, y);
    const double Q = __fma_rn(__fma_rn(-b, q0, a), y, q0);
    const double A = fabs(a), M = fabs(Q);
    const double r = __fma_rn(-b, M, A);
    const long long qb = __double_as_longlong(M);
    const double up = __dsub_rn(__longlong_as_double(qb + 1), M);
    const double dn = __dsub_rn(M, __longlong_as_double(qb - 1));
    const double hb = __dmul_rn(0.5, b);
    const double tu = __dmul_rn(hb, up), td = __dmul_rn(hb, dn);
    ok = (A >= 0x1p-900) & (A <= 0x1p900) & (tu >= 0x1p-1022) &
         (tu <= 0x1p1022) & (td >= 0x1p-1022) & (td <= 0x1p1022) &
         (r < tu) & (r > -td);
    return Q;
  }
};

template <typename T>
__device__ __forceinline__ bool same(T a, T b) {
  return Ops<T>::bits(a) == Ops<T>::bits(b);
}

// Line j of an (outer, n, inner) array starts at (j / inner) * n * inner
// + j % inner; its node i is inner further on.
__device__ __forceinline__ int64_t line_base(int64_t j, int64_t n,
                                             int64_t inner) {
  const int64_t o = j / inner;
  return o * n * inner + (j - o * inner);
}

template <typename T>
__device__ __forceinline__ T fwd_step(T b, T w, T d) {
  return Ops<T>::sub(b, Ops<T>::mul(w, d));
}

template <typename T>
__device__ __forceinline__ T bwd_step(T d, T off, T div, T x) {
  return Ops<T>::div(Ops<T>::sub(d, Ops<T>::mul(off, x)), div);
}

// The routes of a launch.
enum Route { kRuns = 0, kLines = 1, kShort = 2 };

// The geometry of a launch; the wrapper's solve_geometry chooses it and
// the launcher checks it.
struct Geo {
  int64_t n, m, inner;
  int64_t segment;   // nodes of a line that a block owns
  int64_t nseg;      // segments a line
  int route;         // kRuns, kLines or kShort
  int threads;       // threads a block
  int lines;         // lines a tile (1: the runs kernel)
  int runs;          // runs a line: threads / lines (1 in kShort)
  int run;           // nodes a run (a power of two in float32's runs
                     // kernel)
  int overlap;       // nodes a run or a tile starts early / ends late
  int width;         // most nodes of a tile: min(n, segment + 2 overlap)
  int stride;        // lines and short kernels: a line's elements (odd)
  int shift;         // runs kernel, float32: log2(run)
  unsigned magic;    // runs kernel, float64: ceil(2^32 / run)
  int pad;           // runs kernel: overlap rounded up to a multiple of run
};

// Boundary values of each (segment, line), each (nseg, m): pf, the
// block's forward run at node s - 1; dl, its d at e - 1; pb, its
// backward run at node e; xf, its x at node s.  flags (nseg, m): bit 0 a
// forward miss at s, bit 1 a backward miss at e, bit 2 the segment
// re-solved; line (m,): 1 where the line has a miss.
template <typename T>
struct Bounds {
  T *pf, *dl, *pb, *xf;
  int *flags, *line;
};

// Shared memory of the lines kernel: one array, b then d then x (swept
// in place), lines x stride, line-major (an odd stride puts 32 lines at
// one node in 32 banks), then off, div and w of the tile's nodes, shared
// by its lines.  A walk reads b from device memory.
template <typename T>
struct LinesTile {
  // float64 keeps 1 / div beside div: its backward sweep divides
  // through it (Ops<double>::quot)
  static constexpr bool kRcp = sizeof(T) == 8;
  T *b, *d, *off, *dv, *w, *rcp;
  int stride;
  int64_t t0;
  const T* src;
  int64_t j0, n, inner;
  __device__ __forceinline__ int at(int l, int64_t i) const {
    return l * stride + static_cast<int>(i - t0);
  }
  // w_{i-1} for the step to node i, in a sweep and in a walk
  __device__ __forceinline__ T wprev(int, int64_t i) const {
    return w[i - 1 - t0];
  }
  __device__ __forceinline__ T wwalk(int, int64_t i) const {
    return w[i - 1 - t0];
  }
  __device__ __forceinline__ T offi(int64_t i) const { return off[i - t0]; }
  __device__ __forceinline__ T divi(int64_t i) const { return dv[i - t0]; }
  __device__ __forceinline__ T rcpi(int64_t i) const { return rcp[i - t0]; }
  __device__ __forceinline__ T bwalk(int l, int64_t i) const {
    return src[line_base(j0 + l, n, inner) + i * inner];
  }
  // x_i of line l, from a backward sweep
  __device__ __forceinline__ void put(int l, int64_t i, T x) const {
    b[at(l, i)] = x;
  }
};

// The short route's tile where inner > 1: the lines kernel's, but a
// thread's backward sweep writes its line's x straight to device memory
// (`xl`: its line's node 0 there, node i inner further on; the lanes of
// a warp on neighbouring lines, so coalesced), where it waits on
// nothing, and no store phase follows.
template <typename T>
struct ShortTile : LinesTile<T> {
  T* xl;
  __device__ __forceinline__ void put(int, int64_t i, T x) const {
    xl[i * this->inner] = x;
  }
};

// Shared memory of the runs kernel (one line): b (then x), d, off and
// div, node i at r + r / run, r = i - (s - pad): run p's nodes are one
// padded row of run + 1 elements, so 32 runs at one step hit 32 banks
// (float32: run a power of two, r / run a shift; float64: any run, r /
// run as the high word of r * magic, magic = ceil(2^32 / run), exact for
// r < 2^16; the wrapper takes an even run, whose odd rows of doubles
// keep the 16 lanes of each half of a warp on 16 bank pairs).
// Until the forward sweep writes d_i there, node i's slot of d holds
// w_{i-1}, divided once when the tile is loaded.
template <typename T>
struct RunsTile {
  static constexpr bool kRcp = false;
  T *b, *d, *off, *dv;
  int shift;
  unsigned magic;
  int64_t base;
  const T* src;   // the line in device memory, node i at i * inner
  int64_t inner;
  __device__ __forceinline__ int at(int, int64_t i) const {
    const int r = static_cast<int>(i - base);
    if constexpr (sizeof(T) == 4) {
      return r + (r >> shift);
    } else {
      return r + static_cast<int>(__umulhi(static_cast<unsigned>(r),
                                           magic));
    }
  }
  __device__ __forceinline__ T wprev(int l, int64_t i) const {
    return d[at(l, i)];
  }
  __device__ __forceinline__ T wwalk(int l, int64_t i) const {
    const int a = at(l, i - 1);
    return Ops<T>::div(off[a], dv[a]);
  }
  __device__ __forceinline__ T offi(int64_t i) const { return off[at(0, i)]; }
  __device__ __forceinline__ T divi(int64_t i) const { return dv[at(0, i)]; }
  __device__ __forceinline__ T bwalk(int, int64_t i) const {
    return src[i * inner];
  }
  __device__ __forceinline__ void put(int l, int64_t i, T x) const {
    b[at(l, i)] = x;
  }
};

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  __pipeline_memcpy_async(dst, src, sizeof(T));
}

// Steps whose operands a sweep loads into registers before it computes
// them: the recurrence then waits on its arithmetic alone.
constexpr int kStep = 8;

// Forward steps to nodes [i, end) of line l from d; kStore: d_i written.
// Each step reads its own slot of d (w_{i-1} in the runs kernel) before
// it writes it.
template <bool kStore, typename T, typename Tile>
__device__ __forceinline__ T fwd_range(const Tile& tl, int l, int64_t i,
                                       int64_t end, T d) {
  for (; i + kStep <= end; i += kStep) {
    T bv[kStep], wv[kStep];
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      bv[u] = tl.b[tl.at(l, i + u)];
      wv[u] = tl.wprev(l, i + u);
    }
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      d = fwd_step(bv[u], wv[u], d);
      if (kStore) tl.d[tl.at(l, i + u)] = d;
    }
  }
  for (; i < end; ++i) {
    d = fwd_step(tl.b[tl.at(l, i)], tl.wprev(l, i), d);
    if (kStore) tl.d[tl.at(l, i)] = d;
  }
  return d;
}

// Backward steps to nodes i, i - 1, ..., lo of line l from x_{i+1};
// kStore: x_i written.  Where the tile keeps reciprocals, each
// kStep steps divide through them (Ops<double>::quot); if any quotient
// is not proven correctly rounded, the kStep steps are taken again from
// their first x with the division, their operands still in registers.
template <bool kStore, typename T, typename Tile>
__device__ __forceinline__ T bwd_range(const Tile& tl, int l, int64_t i,
                                       int64_t lo, T xv) {
  for (; i - (kStep - 1) >= lo; i -= kStep) {
    T dv[kStep], ov[kStep], qv[kStep];
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      dv[u] = tl.d[tl.at(l, i - u)];
      ov[u] = tl.offi(i - u);
      qv[u] = tl.divi(i - u);
    }
    if constexpr (Tile::kRcp) {
      T yv[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) yv[u] = tl.rcpi(i - u);
      const T x0 = xv;
      bool ok = true;
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        bool k;
        xv = Ops<T>::quot(Ops<T>::sub(dv[u], Ops<T>::mul(ov[u], xv)), qv[u],
                          yv[u], k);
        ok &= k;
        if (kStore) tl.put(l, i - u, xv);
      }
      if (ok) continue;
      xv = x0;
    }
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      xv = bwd_step(dv[u], ov[u], qv[u], xv);
      if (kStore) tl.put(l, i - u, xv);
    }
  }
  for (; i >= lo; --i) {
    xv = bwd_step(tl.d[tl.at(l, i)], tl.offi(i), tl.divi(i), xv);
    if (kStore) tl.put(l, i, xv);
  }
  return xv;
}

// Both sweeps of one tile in shared memory, its checks and walks; thread
// (l, p) owns run p of line l.  The tile's nodes are [t0, t1) of segment
// [s, e); the last run of a line sweeps forward through [e, t1) too,
// where the backward sweep starts.  In each sweep every run first sweeps
// the nodes beyond its own, which other runs own, then, after a barrier,
// its own, so that no run reads a slot its owner has written (d is b in
// the lines kernel, and holds w in the runs kernel).  A forward miss is
// walked from the exact value until it meets the stored d; a backward
// miss re-solves its run from the exact d before it (saved in dl_s) and
// the exact x after it, since d may be gone.  Returns the tile's d at
// e - 1 to thread (l, 0).
template <typename T, typename Tile>
__device__ T solve_tile(const Geo& g, const Tile& tl, T* pf_s, T* pb_s,
                        T* dl_s, int* miss_s, int l, int p, bool live,
                        int64_t s, int64_t e, int64_t t0, int64_t t1,
                        int* walks) {
  const int LT = g.lines;
  const int C = g.run;
  const int ovl = g.overlap;
  const int64_t rs = s + static_cast<int64_t>(p) * C;
  const bool has = live && rs < e;
  const int p_last = static_cast<int>((e - s - 1) / C);
  const int64_t own_end = rs + C < e ? rs + C : e;
  const int k = p * LT + l;

  // forward: from a guess at rs - overlap (exact at node 0)
  const int64_t q0 = rs - ovl > t0 ? rs - ovl : t0;
  T d = T(0);
  if (has && q0 < rs) {
    d = fwd_range<false>(tl, l, q0 + 1, rs, tl.b[tl.at(l, q0)]);
    pf_s[k] = d;
  }
  __syncthreads();
  if (has) {
    int64_t i = rs;
    if (q0 == rs) {
      d = tl.b[tl.at(l, rs)];
      tl.d[tl.at(l, rs)] = d;
      ++i;
    }
    fwd_range<true>(tl, l, i, p == p_last ? t1 : own_end, d);
  }
  __syncthreads();
  int miss = has && p > 0 && !same(pf_s[k], tl.d[tl.at(l, rs - 1)]);
  miss_s[k] = miss;
  if (__syncthreads_or(miss)) {
    // one thread a line walks the runs that missed, in order along it;
    // nodes below `walked` are exact
    if (p == 0 && live) {
      int64_t walked = s;
      for (int r = 1; r <= p_last; ++r) {
        int64_t i = s + static_cast<int64_t>(r) * C;
        if (!miss_s[r * LT + l] || i <= walked) continue;
        T prev = tl.d[tl.at(l, i - 1)];
        for (; i < t1; ++i) {
          const T v = fwd_step(tl.bwalk(l, i), tl.wwalk(l, i), prev);
          if (same(v, tl.d[tl.at(l, i)])) break;
          tl.d[tl.at(l, i)] = prev = v;
        }
        walked = i;
        if (walks) atomicAdd(walks, 1);
      }
    }
    __syncthreads();
  }
  if (has) dl_s[k] = tl.d[tl.at(l, own_end - 1)];

  // backward: from a guess at own_end + overlap - 1 (exact at n - 1)
  T xv = T(0);
  int64_t i = own_end - 1;
  if (has) {
    const int64_t top = (p == p_last ? t1
                         : (own_end + ovl < t1 ? own_end + ovl : t1)) - 1;
    xv = Ops<T>::div(tl.d[tl.at(l, top)], tl.divi(top));
    if (top > own_end - 1) {
      xv = bwd_range<false>(tl, l, top - 1, own_end, xv);
      pb_s[k] = xv;
    }
  }
  __syncthreads();
  if (has) {
    if (i == t1 - 1) {     // the line's last node: x = d / div exactly
      tl.b[tl.at(l, i)] = xv;
      --i;
    }
    bwd_range<true>(tl, l, i, rs, xv);
  }
  __syncthreads();
  miss = has && p < p_last && !same(pb_s[k], tl.b[tl.at(l, own_end)]);
  miss_s[k] = miss;
  if (__syncthreads_or(miss)) {
    // one thread a line, in reverse order along it: a run re-solves
    // where it missed or where the run after it changed its first x
    if (p == 0 && live) {
      bool redone = false;
      for (int r = p_last - 1; r >= 0; --r) {
        const int64_t r0 = s + static_cast<int64_t>(r) * C, r1 = r0 + C;
        const bool again = redone ? !same(pb_s[r * LT + l],
                                          tl.b[tl.at(l, r1)])
                                  : miss_s[r * LT + l] != 0;
        redone = again;
        if (!again) continue;
        int64_t j = r0;
        T dj;
        if (r > 0) {
          dj = dl_s[(r - 1) * LT + l];
        } else if (s > 0) {
          dj = pf_s[l];
        } else {
          dj = tl.bwalk(l, 0);
          tl.d[tl.at(l, 0)] = dj;
          ++j;
        }
        for (; j < r1; ++j) {
          dj = fwd_step(tl.bwalk(l, j), tl.wwalk(l, j), dj);
          tl.d[tl.at(l, j)] = dj;
        }
        T xj = tl.b[tl.at(l, r1)];
        for (j = r1 - 1; j >= r0; --j) {
          xj = bwd_step(tl.d[tl.at(l, j)], tl.offi(j), tl.divi(j), xj);
          tl.b[tl.at(l, j)] = xj;
        }
        if (walks) atomicAdd(walks, 1);
      }
    }
  }
  __syncthreads();
  return p == 0 && live ? dl_s[p_last * LT + l] : T(0);
}

// The boundary values of line j's block in segment seg.
template <typename T>
__device__ __forceinline__ void write_bounds(const Geo& g, Bounds<T> bd,
                                             int64_t seg, int64_t j, T pf,
                                             T dl, T pb, T xf) {
  const int64_t t = seg * g.m + j;
  bd.pf[t] = pf;
  bd.dl[t] = dl;
  bd.pb[t] = pb;
  bd.xf[t] = xf;
  if (seg == 0) bd.line[j] = 0;
}

// Threads a block: float32 always launches kThreads, a constant its
// loops fold in; float64's follow the tile.
template <typename T>
__device__ __forceinline__ int block_threads(const Geo& g) {
  return sizeof(T) == 4 ? kThreads : g.threads;
}

// A tile's lines from device memory into tl.b (nodes [t0, t0 + W) of
// lines j0 .. j0 + nl - 1), coalesced along whichever axis is
// contiguous: where inner = 1 a warp reads a stretch of one line, else
// the lanes of a warp read neighbouring lines at one node.  float32
// takes the start of the thread's line (tid % lines) as lbase, found
// once by its kernel; float64 finds it here and in store_tile, which
// keeps it out of the sweeps' registers (its lines kernel ran ~5%
// slower with it held on an H100).
template <typename T>
__device__ __forceinline__ void load_tile(const Geo& g, const LinesTile<T>& tl,
                                          const T* b, int64_t j0, int nl,
                                          int64_t lbase, int64_t t0, int W,
                                          int tid) {
  const int LT = g.lines;
  if (g.inner == 1) {
    const int warp = tid / kWarp, lane = tid % kWarp;
    for (int ll = warp; ll < nl; ll += block_threads<T>(g) / kWarp) {
      const T* src = b + (j0 + ll) * g.n + t0;
      for (int u = lane; u < W; u += kWarp) {
        copy_async(&tl.b[ll * g.stride + u], src + u);
      }
    }
  } else {
    const int l = tid % LT;
    if (l < nl) {
      const int64_t lb = sizeof(T) == 4 ? lbase
                                        : line_base(j0 + l, g.n, g.inner);
      for (int u = tid / LT; u < W; u += g.runs) {
        copy_async(&tl.b[l * g.stride + u], b + lb + (t0 + u) * g.inner);
      }
    }
  }
  __pipeline_commit();
}

// x at nodes [s, e) of the tile's lines, from tl.b, coalesced as
// load_tile reads.
template <typename T>
__device__ __forceinline__ void store_tile(const Geo& g,
                                           const LinesTile<T>& tl, T* x,
                                           int64_t j0, int nl, int64_t lbase,
                                           int64_t s, int64_t e, int tid) {
  const int LT = g.lines;
  if (g.inner == 1) {
    const int warp = tid / kWarp, lane = tid % kWarp;
    for (int ll = warp; ll < nl; ll += block_threads<T>(g) / kWarp) {
      T* dst = x + (j0 + ll) * g.n;
      for (int64_t i = s + lane; i < e; i += kWarp) {
        dst[i] = tl.b[tl.at(ll, i)];
      }
    }
  } else {
    const int l = tid % LT;
    if (l < nl) {
      const int64_t lb = sizeof(T) == 4 ? lbase
                                        : line_base(j0 + l, g.n, g.inner);
      for (int64_t i = s + tid / LT; i < e; i += g.runs) {
        x[lb + i * g.inner] = tl.b[tl.at(l, i)];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_lines(const T* __restrict__ b, const T* __restrict__ off,
            const T* __restrict__ dv, T* __restrict__ x, Bounds<T> bd,
            Geo g, int* walks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LT = g.lines;
  const int64_t grp = blockIdx.x / g.nseg;
  const int64_t seg = blockIdx.x - grp * g.nseg;
  const int64_t j0 = grp * LT;
  const int nl = static_cast<int>(g.m - j0 < LT ? g.m - j0 : LT);
  const int64_t s = seg * g.segment;
  const int64_t e = s + g.segment < g.n ? s + g.segment : g.n;
  const int64_t t0 = s - g.overlap > 0 ? s - g.overlap : 0;
  const int64_t t1 = e + g.overlap < g.n ? e + g.overlap : g.n;
  const int W = static_cast<int>(t1 - t0);

  LinesTile<T> tl;
  T* base = reinterpret_cast<T*>(smem);
  tl.b = tl.d = base;
  tl.off = base + LT * g.stride;
  tl.dv = tl.off + g.width;
  tl.w = tl.dv + g.width;
  tl.rcp = tl.w + g.width;
  tl.stride = g.stride;
  tl.t0 = t0;
  tl.src = b;
  tl.j0 = j0;
  tl.n = g.n;
  tl.inner = g.inner;
  T* pf_s = tl.w + (LinesTile<T>::kRcp ? 2 : 1) * g.width;
  T* pb_s = pf_s + block_threads<T>(g);
  T* dl_s = pb_s + block_threads<T>(g);
  int* miss_s = reinterpret_cast<int*>(dl_s + block_threads<T>(g));

  const int tid = threadIdx.x;
  const int l = tid % LT, p = tid / LT;
  const bool live = l < nl;
  const int64_t lbase = sizeof(T) == 4 ? line_base(j0 + l, g.n, g.inner)
                                       : 0;

  load_tile(g, tl, b, j0, nl, lbase, t0, W, tid);
  for (int u = tid; u < W; u += block_threads<T>(g)) {
    const int64_t i = t0 + u;
    const T o = i < g.n - 1 ? off[i] : T(0);
    const T q = dv[i];
    tl.off[u] = o;
    tl.dv[u] = q;
    tl.w[u] = Ops<T>::div(o, q);
    if constexpr (LinesTile<T>::kRcp) tl.rcp[u] = Ops<T>::rcp(q);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  const T dl = solve_tile(g, tl, pf_s, pb_s, dl_s, miss_s, l, p, live, s,
                          e, t0, t1, walks);

  store_tile(g, tl, x, j0, nl, lbase, s, e, tid);
  if (g.nseg > 1 && p == 0 && live) {
    const int p_last = static_cast<int>((e - s - 1) / g.run);
    write_bounds(g, bd, seg, j0 + l, pf_s[l], dl, pb_s[p_last * LT + l],
                 tl.b[tl.at(l, s)]);
  }
}

// The short route: one thread a whole line, `lines` (= threads) lines a
// block, the tile's lines in shared memory as the lines kernel lays them
// out (odd stride, read coalesced).  Each thread sweeps its line forward
// and backward in place from its first and its last node: no guess,
// nothing to check, the plain version's operations in its order.
// kThrough (inner > 1): the backward sweep writes x to device memory
// (ShortTile); else x stays in the tile and the block writes it out as
// one run of nl * n values.
template <typename T, bool kThrough>
__global__ void __launch_bounds__(kThreads)
solve_short(const T* __restrict__ b, const T* __restrict__ off,
            const T* __restrict__ dv, T* __restrict__ x, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LT = g.lines;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * LT;
  const int nl = static_cast<int>(g.m - j0 < LT ? g.m - j0 : LT);
  const int64_t n = g.n;

  ShortTile<T> tl;
  T* base = reinterpret_cast<T*>(smem);
  tl.b = tl.d = base;
  tl.off = base + LT * g.stride;
  tl.dv = tl.off + n;
  tl.w = tl.dv + n;
  tl.rcp = tl.w + n;
  tl.stride = g.stride;
  tl.t0 = 0;
  tl.src = b;
  tl.j0 = j0;
  tl.n = n;
  tl.inner = g.inner;

  const int tid = threadIdx.x;
  const int64_t lbase = line_base(j0 + (tid < nl ? tid : 0), n, g.inner);
  tl.xl = x + lbase;
  // where inner = 1 the tile's lines lie end to end in device memory:
  // its threads copy them as one run of nl * n values, element e of it
  // node e % n of line e / n
  const int len = nl * static_cast<int>(n);
  const int64_t at0 = j0 * n;
  if (kThrough) {
    load_tile<T>(g, tl, b, j0, nl, lbase, 0, static_cast<int>(n), tid);
  } else {
    for (int e = tid; e < len; e += g.threads) {
      const int ll = e / static_cast<int>(n);
      copy_async(&tl.b[ll * g.stride + e - ll * static_cast<int>(n)],
                 b + at0 + e);
    }
    __pipeline_commit();
  }
  for (int u = tid; u < n; u += g.threads) {
    const T o = u < n - 1 ? off[u] : T(0);
    const T q = dv[u];
    tl.off[u] = o;
    tl.dv[u] = q;
    tl.w[u] = Ops<T>::div(o, q);
    if constexpr (LinesTile<T>::kRcp) tl.rcp[u] = Ops<T>::rcp(q);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  if (tid < nl) {
    // d_0 = b_0 is in place already
    fwd_range<true>(tl, tid, 1, n, tl.b[tl.at(tid, 0)]);
  }
  if (tid < nl) {
    const T xv = Ops<T>::div(tl.d[tl.at(tid, n - 1)], tl.divi(n - 1));
    if (kThrough) {
      tl.put(tid, n - 1, xv);
      bwd_range<true>(tl, tid, n - 2, 0, xv);
    } else {
      tl.b[tl.at(tid, n - 1)] = xv;
      bwd_range<true>(static_cast<const LinesTile<T>&>(tl), tid, n - 2, 0,
                      xv);
    }
  }
  if (!kThrough) {
    __syncthreads();
    for (int e = tid; e < len; e += g.threads) {
      const int ll = e / static_cast<int>(n);
      x[at0 + e] = tl.b[ll * g.stride + e - ll * static_cast<int>(n)];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_runs(const T* __restrict__ b, const T* __restrict__ off,
           const T* __restrict__ dv, T* __restrict__ x, Bounds<T> bd, Geo g,
           int* walks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t j = blockIdx.x / g.nseg;
  const int64_t seg = blockIdx.x - j * g.nseg;
  const int64_t s = seg * g.segment;
  const int64_t e = s + g.segment < g.n ? s + g.segment : g.n;
  const int64_t t0 = s - g.overlap > 0 ? s - g.overlap : 0;
  const int64_t t1 = e + g.overlap < g.n ? e + g.overlap : g.n;
  const int q = static_cast<int>(sizeof(T) == 4
                                     ? (g.segment + 2 * g.pad) >> g.shift
                                     : (g.segment + 2 * g.pad) / g.run) *
                (g.run + 1);

  RunsTile<T> tl;
  T* base = reinterpret_cast<T*>(smem);
  tl.b = base;
  tl.d = base + q;
  tl.off = base + 2 * q;
  tl.dv = base + 3 * q;
  tl.shift = g.shift;
  tl.magic = g.magic;
  tl.base = s - g.pad;
  T* pf_s = base + 4 * q;
  T* pb_s = pf_s + block_threads<T>(g);
  T* dl_s = pb_s + block_threads<T>(g);
  int* miss_s = reinterpret_cast<int*>(dl_s + block_threads<T>(g));

  const int tid = threadIdx.x;
  const int64_t lbase = line_base(j, g.n, g.inner);
  tl.src = b + lbase;
  tl.inner = g.inner;
  for (int64_t i = t0 + tid; i < t1; i += block_threads<T>(g)) {
    const int a = tl.at(0, i);
    copy_async(&tl.b[a], b + lbase + i * g.inner);
    copy_async(&tl.dv[a], dv + i);
    if (i < g.n - 1) {
      copy_async(&tl.off[a], off + i);
    } else {
      tl.off[a] = T(0);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // w_{i-1} into node i's slot of d, divided once
  for (int64_t i = t0 + 1 + tid; i < t1; i += block_threads<T>(g)) {
    const int a = tl.at(0, i - 1);
    tl.d[tl.at(0, i)] = Ops<T>::div(tl.off[a], tl.dv[a]);
  }
  __syncthreads();

  const T dl = solve_tile(g, tl, pf_s, pb_s, dl_s, miss_s, 0, tid, true, s,
                          e, t0, t1, walks);

  for (int64_t i = s + tid; i < e; i += block_threads<T>(g)) {
    x[lbase + i * g.inner] = tl.b[tl.at(0, i)];
  }
  if (g.nseg > 1 && tid == 0) {
    const int p_last = static_cast<int>((e - s - 1) / g.run);
    write_bounds(g, bd, seg, j, pf_s[0], dl, pb_s[p_last],
                 tl.b[tl.at(0, s)]);
  }
}

// Every (segment, line) boundary at once: a forward miss at s where the
// block's run did not meet the d that the block before it ended with, a
// backward miss at e where its run did not meet the x that the block
// after it began with.
template <typename T>
__global__ void check_bounds(Bounds<T> bd, int64_t nseg, int64_t m) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= nseg * m) return;
  const int64_t seg = t / m;
  int f = 0;
  if (seg > 0 && !same(bd.pf[t], bd.dl[t - m])) f |= 1;
  if (seg < nseg - 1 && !same(bd.pb[t], bd.xf[t + m])) f |= 2;
  bd.flags[t] = f;
  if (f) bd.line[t - seg * m] = 1;
}

// One thread a line: nothing where the line has no miss; else the
// segments whose boundary missed are re-solved from the exact values
// beside them, forward in order, then backward in reverse order, each
// next boundary checked against the new value.  d of a re-solved segment
// goes through x, which its backward sweep then overwrites.  kCheck
// (float64, at most kCheckSegs segments a line): the thread checks its
// line's boundaries itself, as check_bounds does, which then is not
// launched.
template <typename T, bool kCheck>
__global__ void fix_bounds(const T* __restrict__ b, const T* __restrict__ off,
                           const T* __restrict__ dv, T* __restrict__ x,
                           Bounds<T> bd, Geo g, int* walks) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= g.m) return;
  const int64_t m = g.m, n = g.n, inner = g.inner;
  if (kCheck) {
    const auto flag = [&](int64_t seg) {
      const int64_t t = seg * m + j;
      return (seg > 0 && !same(bd.pf[t], bd.dl[t - m]) ? 1 : 0) |
             (seg < g.nseg - 1 && !same(bd.pb[t], bd.xf[t + m]) ? 2 : 0);
    };
    bool any = false;
    for (int64_t seg = 0; seg < g.nseg && !any; ++seg) any = flag(seg);
    if (!any) return;
    for (int64_t seg = 0; seg < g.nseg; ++seg) {
      bd.flags[seg * m + j] = flag(seg);
    }
  } else if (!bd.line[j]) {
    return;
  }
  const int64_t q = line_base(j, n, inner);
  bool redone = false;
  for (int64_t seg = 1; seg < g.nseg; ++seg) {
    const int64_t t = seg * m + j;
    const bool miss = redone ? !same(bd.pf[t], bd.dl[t - m])
                             : (bd.flags[t] & 1);
    redone = miss;
    if (!miss) continue;
    const int64_t s = seg * g.segment;
    const int64_t e = s + g.segment < n ? s + g.segment : n;
    T d = bd.dl[t - m];
    for (int64_t i = s; i < e; ++i) {
      d = fwd_step(b[q + i * inner], Ops<T>::div(off[i - 1], dv[i - 1]), d);
    }
    bd.dl[t] = d;
    bd.flags[t] |= 4;
  }
  redone = false;
  for (int64_t seg = g.nseg - 1; seg >= 0; --seg) {
    const int64_t t = seg * m + j;
    const bool last = seg == g.nseg - 1;
    const bool miss = (bd.flags[t] & 4) ||
                      (!last && (redone ? !same(bd.pb[t], bd.xf[t + m])
                                        : (bd.flags[t] & 2)));
    redone = miss;
    if (!miss) continue;
    const int64_t s = seg * g.segment;
    const int64_t e = s + g.segment < n ? s + g.segment : n;
    T d = s == 0 ? b[q]
                 : fwd_step(b[q + s * inner],
                            Ops<T>::div(off[s - 1], dv[s - 1]), bd.dl[t - m]);
    x[q + s * inner] = d;
    for (int64_t i = s + 1; i < e; ++i) {
      d = fwd_step(b[q + i * inner], Ops<T>::div(off[i - 1], dv[i - 1]), d);
      x[q + i * inner] = d;
    }
    T xv = last ? Ops<T>::div(d, dv[e - 1])
                : bwd_step(d, off[e - 1], dv[e - 1], bd.xf[t + m]);
    x[q + (e - 1) * inner] = xv;
    for (int64_t i = e - 2; i >= s; --i) {
      xv = bwd_step(x[q + i * inner], off[i], dv[i], xv);
      x[q + i * inner] = xv;
    }
    bd.xf[t] = xv;
    if (walks) atomicAdd(walks + 1, 1);
  }
}

// Shared memory of a launch, in bytes (ops/tridiag.py:solve_smem).
inline size_t smem_bytes(const Geo& g, size_t size) {
  // off, div, w and, in float64, 1 / div of each node of a tile
  const size_t tables = size == 8 ? 4 : 3;
  if (g.route == kShort) {
    return (static_cast<size_t>(g.lines) * g.stride +
            tables * static_cast<size_t>(g.n)) * size;
  }
  const size_t probes = (3 * size + sizeof(int)) *
                        static_cast<size_t>(g.threads);
  if (g.route == kRuns) {
    const size_t q = static_cast<size_t>((g.segment + 2 * g.pad) / g.run) *
                     (g.run + 1);
    return 4 * q * size + probes;
  }
  return (static_cast<size_t>(g.lines) * g.stride +
          tables * static_cast<size_t>(g.width)) * size + probes;
}

template <typename T>
cudaError_t solve(const T* b, const T* off, const T* dv, T* x, T* bounds,
                  int* flags, int* walks, const Geo& g,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(g, sizeof(T));
  const int64_t groups = (g.m + g.lines - 1) / g.lines;
  if (smem > static_cast<size_t>(kSmemMax) || groups > INT_MAX / g.nseg ||
      g.nseg * g.m > static_cast<int64_t>(INT_MAX) * kThreads) {
    return cudaErrorInvalidValue;
  }
  const unsigned blocks = static_cast<unsigned>(groups * g.nseg);
  const int64_t nb = g.nseg * g.m;
  Bounds<T> bd{bounds, bounds + nb, bounds + 2 * nb, bounds + 3 * nb, flags,
               flags + nb};
  cudaError_t err;
  if (g.route == kShort) {
    const auto kernel = g.inner > 1 ? solve_short<T, true>
                                    : solve_short<T, false>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, g.threads, smem, stream>>>(b, off, dv, x, g);
  } else if (g.route == kRuns) {
    err = cudaFuncSetAttribute(solve_runs<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    solve_runs<T><<<blocks, g.threads, smem, stream>>>(b, off, dv, x, bd, g,
                                                       walks);
  } else {
    err = cudaFuncSetAttribute(solve_lines<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    solve_lines<T><<<blocks, g.threads, smem, stream>>>(b, off, dv, x, bd,
                                                        g, walks);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || g.nseg == 1) return err;
  const unsigned fix_blocks = static_cast<unsigned>(
      (g.m + kFixThreads - 1) / kFixThreads);
  if (sizeof(T) == 8 && g.nseg <= kCheckSegs) {
    fix_bounds<T, true><<<fix_blocks, kFixThreads, 0, stream>>>(
        b, off, dv, x, bd, g, walks);
    return cudaGetLastError();
  }
  check_bounds<T><<<static_cast<unsigned>((nb + kThreads - 1) / kThreads),
                    kThreads, 0, stream>>>(bd, g.nseg, g.m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fix_bounds<T, false><<<fix_blocks, kFixThreads, 0, stream>>>(
      b, off, dv, x, bd, g, walks);
  return cudaGetLastError();
}

}  // namespace mgard_s1

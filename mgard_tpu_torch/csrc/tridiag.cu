// S1 mass_solve: the batched Thomas solve M x = b of a level's 1-D mass
// matrix along one axis, in float32 or float64.
//
// Replaces the lax.scan of mgard_tpu/ops/tridiag.py:69 (mass_solve), which
// XLA turns into a loop on the device; the JAX package has no Pallas
// kernel for it (mgard_tpu/ops/pallas_kernels.py:11-14).  The wrapper
// (ops/tridiag.py) hands a contiguous (outer, n, inner) array, n the solve
// axis: m = outer * inner independent lines, node i of line j at
// line_base(j) + i * inner, so that the threads of a warp, on neighbouring
// lines, read neighbouring addresses (for the last axis of an N-D array,
// inner = 1, it moves the axis first: outer = 1, inner = m).  With the
// host's tables in the data's type (w = off / div[:-1], off, div), the
// plain version's operations, in its order:
//
//   forward   d_0 = b_0,  d_i = b_i - w_{i-1} d_{i-1}
//   backward  x_{n-1} = d_{n-1} / div_{n-1},
//             x_i = (d_i - off_i x_{i+1}) / div_i
//
// Float rule: every multiply, subtract and divide is an _rn intrinsic, so
// nvcc can contract nothing into an FMA, and the divide is the correctly
// rounded one; the result is the plain version's bit for bit.
//
// Bound: bytes (read b, write x; a few operations a value).  The
// recurrence is serial along a line, so one thread a line leaves the card
// idle where lines are few: a 1-D series has one.  Design: each line is
// cut into chunks of `chunk` nodes, one thread a (chunk, line), threads
// of a warp on neighbouring lines where there are many (coalesced rows).
// Each sweep is a map of the previous value that contracts by about 0.27
// a step (|w| and off/div <= 1/2 on any grid), so a chunk starts its sweep
// `overlap` nodes early from a guess (0 for the value before), and its run
// meets the exact one, bit for bit, long before its first node.  A second
// kernel checks every chunk: where its run holds, at the node before its
// first one, the bits of the previous chunk's value there, the chunk
// repeated the plain version's operations on the plain version's value
// and is exact.  Where it does not, one lane walks the line again from the
// exact value until the walk meets the stored values (bits compared, so
// that -0 and NaN count right).  So the result is exact whatever the data;
// only the time depends on how soon the runs meet.  With one chunk a line
// one kernel runs both sweeps and the forward values d live in the output
// buffer; with several they live in a scratch buffer, since a chunk's
// backward sweep reads the next chunk's d while that chunk writes its x.
// Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kUnroll = 8;

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
};

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

// A whole line a thread (one chunk a line): the forward sweep writes d
// into x, and the backward sweep reads it back while it is likely still
// in L2.  Each sweep loads kUnroll steps' operands before it computes
// them, so that a thread keeps several loads in flight (the backward
// sweep reads each d before it overwrites it with x).
template <typename T>
__global__ void line_solve(const T* __restrict__ b, const T* __restrict__ w,
                           const T* __restrict__ off,
                           const T* __restrict__ dv, T* x, int64_t n,
                           int64_t m, int64_t inner) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= m) return;
  const int64_t q = line_base(j, n, inner);
  T d = b[q];
  x[q] = d;
  int64_t i = 1;
  for (; i + kUnroll <= n; i += kUnroll) {
    T bv[kUnroll], wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bv[u] = b[q + (i + u) * inner];
      wv[u] = __ldg(w + i + u - 1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      d = fwd_step(bv[u], wv[u], d);
      x[q + (i + u) * inner] = d;
    }
  }
  for (; i < n; ++i) {
    d = fwd_step(b[q + i * inner], __ldg(w + i - 1), d);
    x[q + i * inner] = d;
  }
  T xv = Ops<T>::div(d, __ldg(dv + n - 1));
  x[q + (n - 1) * inner] = xv;
  i = n - 2;
  for (; i + 1 >= kUnroll; i -= kUnroll) {
    T dl[kUnroll], ov[kUnroll], qv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dl[u] = x[q + (i - u) * inner];
      ov[u] = __ldg(off + i - u);
      qv[u] = __ldg(dv + i - u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv = bwd_step(dl[u], ov[u], qv[u], xv);
      x[q + (i - u) * inner] = xv;
    }
  }
  for (; i >= 0; --i) {
    xv = bwd_step(x[q + i * inner], __ldg(off + i), __ldg(dv + i), xv);
    x[q + i * inner] = xv;
  }
}

// Forward sweep of chunk c = t / m of line j = t % m into dd; probe[t]:
// the chunk's value at the node before its first one.
template <typename T>
__global__ void fwd_sweep(const T* __restrict__ b, const T* __restrict__ w,
                          T* __restrict__ dd, T* __restrict__ probe,
                          int64_t n, int64_t m, int64_t inner,
                          int64_t chunk, int64_t overlap, int64_t nchunks) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= nchunks * m) return;
  const int64_t c = t / m, j = t - c * m;
  const int64_t q = line_base(j, n, inner);
  const int64_t s = c * chunk;
  const int64_t e = s + chunk < n ? s + chunk : n;
  // from node p: b_p is d_p exactly at p = 0, and d_p as if d_{p-1} were
  // 0 anywhere else
  const int64_t p = s > overlap ? s - overlap : 0;
  T d = b[q + p * inner];
  if (p == s) dd[q + s * inner] = d;
  for (int64_t i = p + 1; i < e; ++i) {
    if (i == s) probe[t] = d;
    d = fwd_step(b[q + i * inner], __ldg(w + i - 1), d);
    if (i >= s) dd[q + i * inner] = d;
  }
}

// Backward sweep of chunk c of line j from dd into x (dd may be x: a
// thread reads d_i before it writes x_i there); probe[t]: the chunk's
// value at the first node of the next chunk.
template <typename T>
__global__ void bwd_sweep(const T* dd, const T* __restrict__ off,
                          const T* __restrict__ dv, T* x,
                          T* __restrict__ probe, int64_t n, int64_t m,
                          int64_t inner, int64_t chunk, int64_t overlap,
                          int64_t nchunks) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= nchunks * m) return;
  const int64_t c = t / m, j = t - c * m;
  const int64_t q = line_base(j, n, inner);
  const int64_t s = c * chunk;
  const int64_t e = s + chunk < n ? s + chunk : n;
  // from node p: x_p = d_p / div_p exactly at p = n - 1, and as if
  // x_{p+1} were 0 anywhere else
  const int64_t p = e - 1 + overlap < n - 1 ? e - 1 + overlap : n - 1;
  T xv = Ops<T>::div(dd[q + p * inner], __ldg(dv + p));
  if (p == e - 1) x[q + p * inner] = xv;
  for (int64_t i = p - 1; i >= s; --i) {
    if (i == e - 1) probe[t] = xv;
    xv = bwd_step(dd[q + i * inner], __ldg(off + i), __ldg(dv + i), xv);
    if (i < e) x[q + i * inner] = xv;
  }
}

// One warp a line: lanes test 32 chunks at once, lane 0 walks the ones
// whose run missed the exact value before them, in order along the line.
template <typename T>
__global__ void fwd_check(const T* __restrict__ b, const T* __restrict__ w,
                          T* __restrict__ dd, const T* __restrict__ probe,
                          int64_t n, int64_t m, int64_t inner,
                          int64_t chunk, int64_t nchunks) {
  const int64_t j = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (j >= m) return;
  const int64_t q = line_base(j, n, inner);
  int64_t walked = 0;   // nodes below this one are exact
  for (int64_t base = 1; base < nchunks; base += kWarp) {
    const int64_t c = base + lane;
    bool miss = false;
    if (c < nchunks && c * chunk > walked) {
      miss = Ops<T>::bits(probe[c * m + j]) !=
             Ops<T>::bits(dd[q + (c * chunk - 1) * inner]);
    }
    unsigned mask = __ballot_sync(0xffffffffu, miss);
    if (lane == 0) {
      while (mask) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        int64_t i = (base + k) * chunk;
        if (i <= walked) continue;   // an earlier walk passed through it
        T prev = dd[q + (i - 1) * inner];
        for (; i < n; ++i) {
          const T v = fwd_step(b[q + i * inner], w[i - 1], prev);
          if (Ops<T>::bits(v) == Ops<T>::bits(dd[q + i * inner])) break;
          dd[q + i * inner] = prev = v;
        }
        walked = i;
      }
    }
    __syncwarp();
    walked = __shfl_sync(0xffffffffu, walked, 0);
  }
}

template <typename T>
__global__ void bwd_check(const T* __restrict__ dd,
                          const T* __restrict__ off,
                          const T* __restrict__ dv, T* __restrict__ x,
                          const T* __restrict__ probe, int64_t n, int64_t m,
                          int64_t inner, int64_t chunk, int64_t nchunks) {
  const int64_t j = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (j >= m) return;
  const int64_t q = line_base(j, n, inner);
  int64_t walked = n;   // nodes from this one on are exact
  for (int64_t top = nchunks - 2; top >= 0; top -= kWarp) {
    const int64_t c = top - lane;
    bool miss = false;
    if (c >= 0 && (c + 1) * chunk - 1 < walked) {
      const int64_t e = (c + 1) * chunk;
      miss = Ops<T>::bits(probe[c * m + j]) !=
             Ops<T>::bits(x[q + e * inner]);
    }
    unsigned mask = __ballot_sync(0xffffffffu, miss);
    if (lane == 0) {
      while (mask) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        int64_t i = (top - k + 1) * chunk - 1;
        if (i >= walked) continue;   // a later walk passed through it
        T prev = x[q + (i + 1) * inner];
        for (; i >= 0; --i) {
          const T v = bwd_step(dd[q + i * inner], off[i], dv[i], prev);
          if (Ops<T>::bits(v) == Ops<T>::bits(x[q + i * inner])) break;
          x[q + i * inner] = prev = v;
        }
        walked = i;
      }
    }
    __syncwarp();
    walked = __shfl_sync(0xffffffffu, walked, 0);
  }
}

template <typename T>
cudaError_t solve(const T* b, const T* w, const T* off, const T* dv, T* x,
                  T* dd, T* probe, int64_t n, int64_t m, int64_t inner,
                  int64_t chunk, int64_t overlap, cudaStream_t stream) {
  const int64_t nchunks = (n + chunk - 1) / chunk;
  const int64_t sweep_blocks = (nchunks * m + kThreads - 1) / kThreads;
  const int64_t check_blocks = (m * kWarp + kThreads - 1) / kThreads;
  if (sweep_blocks > 0x7fffffffLL || check_blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const unsigned sb = static_cast<unsigned>(sweep_blocks);
  const unsigned cb = static_cast<unsigned>(check_blocks);
  if (nchunks == 1) {
    line_solve<T><<<sb, kThreads, 0, stream>>>(b, w, off, dv, x, n, m,
                                               inner);
    return cudaGetLastError();
  }
  fwd_sweep<T><<<sb, kThreads, 0, stream>>>(b, w, dd, probe, n, m, inner,
                                            chunk, overlap, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fwd_check<T><<<cb, kThreads, 0, stream>>>(b, w, dd, probe, n, m, inner,
                                            chunk, nchunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_sweep<T><<<sb, kThreads, 0, stream>>>(dd, off, dv, x, probe, n, m,
                                            inner, chunk, overlap, nchunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_check<T><<<cb, kThreads, 0, stream>>>(dd, off, dv, x, probe, n, m,
                                            inner, chunk, nchunks);
  return cudaGetLastError();
}

}  // namespace

// b, x: (m / inner, n, inner); w, off: (n - 1,); div: (n,); all float32
// (is_double 0) or float64 (1).  dd: scratch shaped as x, unused when
// chunk >= n (then x); probe: (ceil(n / chunk), m) scratch.  n >= 2,
// inner >= 1 divides m, chunk >= 1, overlap >= 1.
extern "C" cudaError_t mgard_mass_solve(const void* b, const void* w,
                                        const void* off, const void* dv,
                                        void* x, void* dd, void* probe,
                                        long long n, long long m,
                                        long long inner, long long chunk,
                                        long long overlap, int is_double,
                                        cudaStream_t stream) {
  if (m <= 0) return cudaSuccess;
  if (n < 2 || inner < 1 || m % inner || chunk < 1 || overlap < 1 ||
      (chunk < n && dd == x)) {
    return cudaErrorInvalidValue;
  }
  if (is_double) {
    return solve(static_cast<const double*>(b), static_cast<const double*>(w),
                 static_cast<const double*>(off),
                 static_cast<const double*>(dv), static_cast<double*>(x),
                 static_cast<double*>(dd), static_cast<double*>(probe), n, m,
                 inner, chunk, overlap, stream);
  }
  return solve(static_cast<const float*>(b), static_cast<const float*>(w),
               static_cast<const float*>(off), static_cast<const float*>(dv),
               static_cast<float*>(x), static_cast<float*>(dd),
               static_cast<float*>(probe), n, m, inner, chunk, overlap,
               stream);
}

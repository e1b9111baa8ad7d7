// The GPK stencil kernels: multilinear interpolation of a level's parent
// grid as per-dim +-1 lerps, applied in the order dim 2, dim 0, dim 1
// (B1 o B0 o B2), in one pass (K5/K6, the default) or in two (K7-K10,
// under MGARD_TPU_GPK_FUSED=0, the JAX package's arithmetic reference):
//
//   K5 gpk_detail       detail = A - (B1 o B0 o B2)(A)
//     replaces mgard_tpu/ops/stencil_kernels.py:_run_fused_detail
//   K6 gpk_prolong_add  out = (B1 o B0 o B2)(embed C) + detail
//     replaces mgard_tpu/ops/stencil_kernels.py:_run_fused_prolong_add
//     and the dim-2 embed before it (_embed2, a 0/1 matmul on the MXU)
//   K7 b20              V0 = (B0 o B2)(A), (n0, n1, n2)
//     replaces _run_b20
//   K8 b1sub            detail = A - B1(V0)
//     replaces _run_b1sub
//   K9 dec_b20          V0 = (B0 o B2)(C embedded in dims 0 and 2),
//                       (n0, nc1, n2): dim 1 stays coarse
//     replaces _run_dec_b20 and, as K6 does, the _embed2 matmul before it
//   K10 dec_b1add       out = B1(V0 embedded in dim 1) + detail
//     replaces _run_dec_b1add
//
// B_d keeps a parent position and lerps a new one from its +-1 parents:
// (1 - w) * left + w * right.  The TPU kernels are shaped by Mosaic (8 x
// 128 tiles, 8-sublane halo strips, in-register rolls, a 64-column decode
// block to fit scoped VMEM, an SMEM row table, the embed on the MXU, K9's
// V0 padded to 8 columns); none of that applies here.  Each B_d only
// reads positions that are parents in that dim, so every output element
// is a small lerp tree over at most 8 source values:
//
//   g2(i', j', k) = S(i', j', k)                     k parent in dim 2
//                 = lerp(w2[k], S(i', j', k-1), S(i', j', k+1))  else
//   g0(i, j', k)  = the same over i, of g2 at i +- 1
//   g1(i, j, k)   = the same over j, of g0 at j +- 1
//
// where S is A itself (K5, K7), C read at the coarse indices (K6, K9: the
// tree reads only parent positions, so no embedded array is formed), or
// the V0 of the first pass (K8; K10 reads it at the coarse index of j).
// A parent position is found through the per-dim coarse index table, so
// the trailing coarse node of an even front-interleaved dim (the `tail`
// flag of the JAX kernels' row table) needs no case of its own.  K8 o K7
// and K10 o K9 run exactly the lerps of K5 and K6.
//
// Float rule: every multiply, subtract and add is an _rn intrinsic, so
// nvcc cannot contract (1 - w) * l + w * r into an FMA; the plain PyTorch
// version runs the same ops one by one, and the kernels match it bit for
// bit on any grid.  With the weights of 0.5 of a uniform grid every
// product is exact and a contraction would not show; a nonuniform grid
// shows it.
//
// Bound: bytes.  K5 reads A and writes detail once (8 bytes a value); K6
// reads C (1/8 of the values), detail, and writes the output (1.14 GB at
// 512^3, level 9: 0.341 ms at 3.35 TB/s).  The two-pass form moves V0
// through device memory besides: K7 reads A and writes V0, K8 reads V0
// and A and writes detail, K9 reads C and writes a V0 of half the values,
// K10 reads it and detail and writes the output.  About 10 flops a value
// are far below the card's float32 rate.
//
// K5, K7, K8 and K10: one thread per output element evaluates its tree,
// k (the contiguous dim) across the threads of a block so that loads and
// stores coalesce; the neighbour reads at i +- 1 and j +- 1 hit rows that
// neighbouring blocks read too, which L1 and L2 serve.  K9 takes K6's
// tile without its dim-1 stage (dec_b20_tiled_kernel).
//
// K6 is tiled (gpk_prolong_add_tiled_kernel): a block of 256 threads owns
// an 8 x 8 x 128 output tile and computes each g2 and g0 value once, in
// shared memory, where the per-element tree recomputed them for up to 4
// outputs, loaded each C value through three index tables, and ran both
// sides of g2's parent/new branch in every warp (k's parity alternates
// within a warp).  Stage 1 stages g2 over the tile's parent rows and
// their halo (at most 5 x 5 rows of 128, 12.5 KB), a select rather than
// a branch on k; stage 2 lerps g0 at the new i of the tile (8 x 5 rows,
// 20 KB); stage 3 lerps g1, adds detail and stores, 16 bytes a thread
// (detail is loaded before stage 1, so its reads are in flight while the
// tile is staged).  The parent rows of a window come from the tables, not
// from parity.  nvcc -Xptxas -v: 80 registers, 33,280 bytes of shared
// memory, no spills, so 3 blocks an SM.  Indices are 64-bit: 4096^3
// overflows int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Per-dim tables: the lerp weight at each fine position (0 at parents)
// and the coarse index of each parent position (-1 at new positions).
struct DimTable {
  const float* w;
  const int* c;
};

__device__ __forceinline__ float lerp_rn(float w, float left, float right) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), left),
                   __fmul_rn(w, right));
}

// Source of K5 and K7: the fine array A; of K8: the V0 of K7.
struct FineSource {
  const float* a;
  int n1, n2;
  __device__ __forceinline__ float operator()(int i, int j, int k) const {
    return a[(static_cast<int64_t>(i) * n1 + j) * n2 + k];
  }
};

// Source of K10: K9's V0 (n0, nc1, n2) at the coarse index of a parent
// position j of dim 1.
struct ExpandSource {
  const float* v;
  const int* c1;
  int nc1, n2;
  __device__ __forceinline__ float operator()(int i, int j, int k) const {
    return v[(static_cast<int64_t>(i) * nc1 + c1[j]) * n2 + k];
  }
};

template <typename Source>
__device__ __forceinline__ float g2(const Source& s, const DimTable& t2,
                                    int i, int j, int k) {
  return t2.c[k] >= 0 ? s(i, j, k)
                      : lerp_rn(t2.w[k], s(i, j, k - 1), s(i, j, k + 1));
}

template <typename Source>
__device__ __forceinline__ float g0(const Source& s, const DimTable& t0,
                                    const DimTable& t2, int i, int j,
                                    int k) {
  return t0.c[i] >= 0 ? g2(s, t2, i, j, k)
                      : lerp_rn(t0.w[i], g2(s, t2, i - 1, j, k),
                                g2(s, t2, i + 1, j, k));
}

template <typename Source>
__device__ __forceinline__ float g1(const Source& s, const DimTable& t1,
                                    int i, int j, int k) {
  return t1.c[j] >= 0 ? s(i, j, k)
                      : lerp_rn(t1.w[j], s(i, j - 1, k), s(i, j + 1, k));
}

// (B0 o B2)(S) as a source of g1.
template <typename Source>
struct B20 {
  const Source& s;
  DimTable t0, t2;
  __device__ __forceinline__ float operator()(int i, int j, int k) const {
    return g0(s, t0, t2, i, j, k);
  }
};

// (B1 o B0 o B2)(S) at (i, j, k).
template <typename Source>
__device__ __forceinline__ float interp(const Source& s, const DimTable& t0,
                                        const DimTable& t1,
                                        const DimTable& t2, int i, int j,
                                        int k) {
  return g1(B20<Source>{s, t0, t2}, t1, i, j, k);
}

__global__ void gpk_detail_kernel(const float* __restrict__ a,
                                  float* __restrict__ out, DimTable t0,
                                  DimTable t1, DimTable t2, int n2) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int i = blockIdx.z;
  if (k >= n2) return;
  const int n1 = gridDim.y;
  const FineSource src{a, n1, n2};
  const int64_t idx = (static_cast<int64_t>(i) * n1 + j) * n2 + k;
  out[idx] = __fsub_rn(a[idx], interp(src, t0, t1, t2, i, j, k));
}

// K6, tiled (see the note at the top):
//   1. g2 at every (i', j') parent row of the tile and its +-1 halo in
//      dims 0 and 1, for every k of the tile, read from C at the coarse
//      indices (a warp reads consecutive C entries of one row);
//   2. g0 at every new i of the tile, for the same parent rows j' (a
//      parent i reads its g2 row directly in stage 3);
//   3. g1 at every (i, j, k) of the tile, plus detail: warp w owns i0 + w
//      and lane q owns k0 + 4q .. 4q + 3, 512 contiguous bytes a warp.
// Each g2 and g0 value is the same _rn expression of the same operands
// as in the per-element tree, so the tile gives the tree's bits.  The
// parent rows of a window are consecutive coarse indices; the gate's 2^k
// structure of dims 0 and 1 (parents at the even positions and at n - 1)
// puts at most kT/2 + 1 of them in a window of kT + 2 positions.
constexpr int kT0 = 8;
constexpr int kT1 = 8;
constexpr int kT2 = 128;
constexpr int kRows0 = kT0 / 2 + 1;
constexpr int kRows1 = kT1 / 2 + 1;
constexpr int kProlongThreads = 32 * kT0;
static_assert(kT2 == 4 * 32, "stage 3 maps one float4 a lane over kT2");

// Coarse index of the first and the last parent of positions
// [p0 - 1, p0 + kT] clipped to [0, n): each end is a parent or the
// neighbour of one.
__device__ __forceinline__ void parent_window(const int* __restrict__ c,
                                              int p0, int kT, int n,
                                              int* first, int* count) {
  const int lo = p0 > 0 ? p0 - 1 : 0;
  const int hi = p0 + kT < n ? p0 + kT : n - 1;
  const int cf = c[lo] >= 0 ? c[lo] : c[lo + 1];
  const int cl = c[hi] >= 0 ? c[hi] : c[hi - 1];
  *first = cf;
  *count = cl - cf + 1;
}

__device__ __forceinline__ float4 lerp4_rn(float w, float4 l, float4 r) {
  return make_float4(lerp_rn(w, l.x, r.x), lerp_rn(w, l.y, r.y),
                     lerp_rn(w, l.z, r.z), lerp_rn(w, l.w, r.w));
}

__global__ void __launch_bounds__(kProlongThreads)
gpk_prolong_add_tiled_kernel(const float* __restrict__ c,
                             const float* __restrict__ detail,
                             float* __restrict__ out, DimTable t0,
                             DimTable t1, DimTable t2, int n0, int n1,
                             int n2, int nc1, int nc2) {
  __shared__ __align__(16) float g2s[kRows0][kRows1][kT2];
  __shared__ __align__(16) float g0s[kT0][kRows1][kT2];
  const int k0 = blockIdx.x * kT2;
  const int j0 = blockIdx.y * kT1;
  const int i0 = blockIdx.z * kT0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = i0 + warp;

  // this thread's detail, loaded first so that it is in flight through
  // stages 1 and 2
  const int64_t row0 = (static_cast<int64_t>(i) * n1 + j0) * n2 + k0;
  const float4* __restrict__ det4 =
      reinterpret_cast<const float4*>(detail + row0) + lane;
  float4 d[kT1];
#pragma unroll
  for (int jj = 0; jj < kT1; ++jj) d[jj] = det4[jj * (n2 / 4)];

  int ca, na, cb, nb;
  parent_window(t0.c, i0, kT0, n0, &ca, &na);
  parent_window(t1.c, j0, kT1, n1, &cb, &nb);
  // unreachable through the wrapper, which admits only the gate's
  // structure; a window past the staging capacity would write outside it
  if (na > kRows0 || nb > kRows1) __trap();

  // stage 1: g2 rows (ca + a, cb + b), a < na, b < nb; thread kk of k,
  // the select (not a branch) keeps alternating parents and new k
  // together in a warp
  {
    const int kk = threadIdx.x % kT2;
    const int k = k0 + kk;
    const int ck = t2.c[k];
    int il = ck, ir = ck;
    float w = 0.0f;
    if (ck < 0) {
      il = t2.c[k - 1];
      ir = t2.c[k + 1];
      w = t2.w[k];
    }
    const int rows = na * nb;
#pragma unroll 4
    for (int q = threadIdx.x / kT2; q < rows; q += kProlongThreads / kT2) {
      const int a = q / nb, b = q - a * nb;
      const float* __restrict__ src =
          c + (static_cast<int64_t>(ca + a) * nc1 + cb + b) * nc2;
      const float l = src[il], r = src[ir];
      g2s[a][b][kk] = ck >= 0 ? l : lerp_rn(w, l, r);
    }
  }
  __syncthreads();

  // stage 2: g0 at new i (warp-uniform branch); rows is this warp's g0
  // or, at a parent i, its g2
  const int ci = t0.c[i];
  const float* rows;
  if (ci >= 0) {
    rows = &g2s[ci - ca][0][0];
  } else {
    const int sl = t0.c[i - 1] - ca, sr = t0.c[i + 1] - ca;
    const float w = t0.w[i];
    for (int b = 0; b < nb; ++b) {
      const float4 l = reinterpret_cast<const float4*>(g2s[sl][b])[lane];
      const float4 r = reinterpret_cast<const float4*>(g2s[sr][b])[lane];
      reinterpret_cast<float4*>(g0s[warp][b])[lane] = lerp4_rn(w, l, r);
    }
    rows = &g0s[warp][0][0];
    __syncwarp();
  }

  // stage 3: g1 + detail (warp-uniform branch on j)
  float4* __restrict__ out4 = reinterpret_cast<float4*>(out + row0) + lane;
#pragma unroll
  for (int jj = 0; jj < kT1; ++jj) {
    const int j = j0 + jj;
    const int cj = t1.c[j];
    float4 g;
    if (cj >= 0) {
      g = reinterpret_cast<const float4*>(rows + (cj - cb) * kT2)[lane];
    } else {
      const float4 l = reinterpret_cast<const float4*>(
          rows + (t1.c[j - 1] - cb) * kT2)[lane];
      const float4 r = reinterpret_cast<const float4*>(
          rows + (t1.c[j + 1] - cb) * kT2)[lane];
      g = lerp4_rn(t1.w[j], l, r);
    }
    out4[jj * (n2 / 4)] =
        make_float4(__fadd_rn(g.x, d[jj].x), __fadd_rn(g.y, d[jj].y),
                    __fadd_rn(g.z, d[jj].z), __fadd_rn(g.w, d[jj].w));
  }
}

__global__ void b20_kernel(const float* __restrict__ a,
                           float* __restrict__ v0, DimTable t0, DimTable t2,
                           int n2) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int i = blockIdx.z;
  if (k >= n2) return;
  const int n1 = gridDim.y;
  const FineSource src{a, n1, n2};
  v0[(static_cast<int64_t>(i) * n1 + j) * n2 + k] = g0(src, t0, t2, i, j, k);
}

__global__ void b1sub_kernel(const float* __restrict__ v0,
                             const float* __restrict__ a,
                             float* __restrict__ out, DimTable t1, int n2) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int i = blockIdx.z;
  if (k >= n2) return;
  const int n1 = gridDim.y;
  const FineSource src{v0, n1, n2};
  const int64_t idx = (static_cast<int64_t>(i) * n1 + j) * n2 + k;
  out[idx] = __fsub_rn(a[idx], g1(src, t1, i, j, k));
}

// K9, tiled (see the note at the top): a block owns 8 fine i x kJ9
// coarse j x 128 k of V0 (n0, nc1, n2).
//   1. g2 at every parent row of the tile's window in dim 0 (at most
//      kT0/2 + 1) for each coarse j of the tile and every k, read from C
//      at the coarse indices of dim 2, a select rather than a branch on k;
//   2. g0 at every i of the tile: warp w owns i0 + w (a parent i copies
//      its g2 row, a new i lerps two), lane q owns k0 + 4q .. 4q + 3,
//      stored 16 bytes a lane.
// nc1 is odd on the gate's levels (2^k / 2 + 1), so the tile in j masks
// its ragged edge.  The same _rn expressions in the same order as the
// per-element tree, so K10 o K9 stays K6 bit for bit.  nvcc -Xptxas -v:
// 40 registers, 20,480 bytes of shared memory, no spills.
constexpr int kJ9 = 8;

__global__ void __launch_bounds__(kProlongThreads)
dec_b20_tiled_kernel(const float* __restrict__ c, float* __restrict__ v0,
                     DimTable t0, DimTable t2, int n0, int nc1, int n2,
                     int nc2) {
  __shared__ __align__(16) float g2s[kRows0][kJ9][kT2];
  const int k0 = blockIdx.x * kT2;
  const int j0 = blockIdx.y * kJ9;
  const int i0 = blockIdx.z * kT0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nj = nc1 - j0 < kJ9 ? nc1 - j0 : kJ9;

  int ca, na;
  parent_window(t0.c, i0, kT0, n0, &ca, &na);
  // unreachable through the wrapper, which admits only the gate's
  // structure; a window past the staging capacity would write outside it
  if (na > kRows0) __trap();

  // stage 1: g2 rows (ca + a, j0 + b), a < na, b < nj; thread kk of k
  {
    const int kk = threadIdx.x % kT2;
    const int k = k0 + kk;
    const int ck = t2.c[k];
    int il = ck, ir = ck;
    float w = 0.0f;
    if (ck < 0) {
      il = t2.c[k - 1];
      ir = t2.c[k + 1];
      w = t2.w[k];
    }
    const int rows = na * nj;
#pragma unroll 4
    for (int q = threadIdx.x / kT2; q < rows; q += kProlongThreads / kT2) {
      const int a = q / nj, b = q - a * nj;
      const float* __restrict__ src =
          c + (static_cast<int64_t>(ca + a) * nc1 + j0 + b) * nc2;
      const float l = src[il], r = src[ir];
      g2s[a][b][kk] = ck >= 0 ? l : lerp_rn(w, l, r);
    }
  }
  __syncthreads();

  // stage 2: g0 at i (warp-uniform branch), stored 16 bytes a lane
  const int i = i0 + warp;
  const int ci = t0.c[i];
  float4* __restrict__ out4 = reinterpret_cast<float4*>(
      v0 + (static_cast<int64_t>(i) * nc1 + j0) * n2 + k0) + lane;
  if (ci >= 0) {
    for (int b = 0; b < nj; ++b) {
      out4[b * (n2 / 4)] =
          reinterpret_cast<const float4*>(g2s[ci - ca][b])[lane];
    }
  } else {
    const int sl = t0.c[i - 1] - ca, sr = t0.c[i + 1] - ca;
    const float w = t0.w[i];
    for (int b = 0; b < nj; ++b) {
      const float4 l = reinterpret_cast<const float4*>(g2s[sl][b])[lane];
      const float4 r = reinterpret_cast<const float4*>(g2s[sr][b])[lane];
      out4[b * (n2 / 4)] = lerp4_rn(w, l, r);
    }
  }
}

__global__ void dec_b1add_kernel(const float* __restrict__ v0,
                                 const float* __restrict__ detail,
                                 float* __restrict__ out, DimTable t1, int n2,
                                 int nc1) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int i = blockIdx.z;
  if (k >= n2) return;
  const int n1 = gridDim.y;
  const ExpandSource src{v0, t1.c, nc1, n2};
  const int64_t idx = (static_cast<int64_t>(i) * n1 + j) * n2 + k;
  out[idx] = __fadd_rn(g1(src, t1, i, j, k), detail[idx]);
}

constexpr int kThreads = 256;

cudaError_t grid_for(int n0, int n1, int n2, dim3* grid) {
  if (n0 > 65535 || n1 > 65535) return cudaErrorInvalidConfiguration;
  *grid = dim3((n2 + kThreads - 1) / kThreads, n1, n0);
  return cudaSuccess;
}

}  // namespace

extern "C" cudaError_t mgard_gpk_detail(
    const float* a, float* out, const float* w0, const int* c0,
    const float* w1, const int* c1, const float* w2, const int* c2, int n0,
    int n1, int n2, cudaStream_t stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0) return cudaSuccess;
  dim3 grid;
  const cudaError_t err = grid_for(n0, n1, n2, &grid);
  if (err != cudaSuccess) return err;
  gpk_detail_kernel<<<grid, kThreads, 0, stream>>>(
      a, out, DimTable{w0, c0}, DimTable{w1, c1}, DimTable{w2, c2}, n2);
  return cudaGetLastError();
}

// K6 takes the shapes the GPK gate admits (n0 % 8, n1 % 128 and
// n2 % 128 all 0) and refuses any other.
extern "C" cudaError_t mgard_gpk_prolong_add(
    const float* c, const float* detail, float* out, const float* w0,
    const int* c0, const float* w1, const int* c1, const float* w2,
    const int* c2, int n0, int n1, int n2, int nc1, int nc2,
    cudaStream_t stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0 || n0 % 8 || n1 % 128 || n2 % 128 ||
      n0 / kT0 > 65535 || n1 / kT1 > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(n2 / kT2, n1 / kT1, n0 / kT0);
  gpk_prolong_add_tiled_kernel<<<grid, kProlongThreads, 0, stream>>>(
      c, detail, out, DimTable{w0, c0}, DimTable{w1, c1}, DimTable{w2, c2},
      n0, n1, n2, nc1, nc2);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_b20(const float* a, float* v0, const float* w0,
                                 const int* c0, const float* w2,
                                 const int* c2, int n0, int n1, int n2,
                                 cudaStream_t stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0) return cudaSuccess;
  dim3 grid;
  const cudaError_t err = grid_for(n0, n1, n2, &grid);
  if (err != cudaSuccess) return err;
  b20_kernel<<<grid, kThreads, 0, stream>>>(a, v0, DimTable{w0, c0},
                                            DimTable{w2, c2}, n2);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_b1sub(const float* v0, const float* a,
                                   float* out, const float* w1,
                                   const int* c1, int n0, int n1, int n2,
                                   cudaStream_t stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0) return cudaSuccess;
  dim3 grid;
  const cudaError_t err = grid_for(n0, n1, n2, &grid);
  if (err != cudaSuccess) return err;
  b1sub_kernel<<<grid, kThreads, 0, stream>>>(v0, a, out, DimTable{w1, c1},
                                              n2);
  return cudaGetLastError();
}

// K9 takes the shapes the GPK gate admits (n0 % 8 and n2 % 128 both 0)
// and refuses any other.
extern "C" cudaError_t mgard_dec_b20(const float* c, float* v0,
                                     const float* w0, const int* c0,
                                     const float* w2, const int* c2, int n0,
                                     int nc1, int n2, int nc2,
                                     cudaStream_t stream) {
  if (n0 <= 0 || nc1 <= 0 || n2 <= 0 || n0 % kT0 || n2 % kT2 ||
      n0 / kT0 > 65535 || (nc1 + kJ9 - 1) / kJ9 > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(n2 / kT2, (nc1 + kJ9 - 1) / kJ9, n0 / kT0);
  dec_b20_tiled_kernel<<<grid, kProlongThreads, 0, stream>>>(
      c, v0, DimTable{w0, c0}, DimTable{w2, c2}, n0, nc1, n2, nc2);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_dec_b1add(const float* v0, const float* detail,
                                       float* out, const float* w1,
                                       const int* c1, int n0, int n1, int n2,
                                       int nc1, cudaStream_t stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0) return cudaSuccess;
  dim3 grid;
  const cudaError_t err = grid_for(n0, n1, n2, &grid);
  if (err != cudaSuccess) return err;
  dec_b1add_kernel<<<grid, kThreads, 0, stream>>>(
      v0, detail, out, DimTable{w1, c1}, n2, nc1);
  return cudaGetLastError();
}

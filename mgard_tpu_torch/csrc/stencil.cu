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
// is a small lerp tree over at most 8 source values, and one thread
// evaluates it for one element:
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
// reads C (1/8 of the values), detail, and writes the output.  The
// two-pass form moves V0 through device memory besides: K7 reads A and
// writes V0, K8 reads V0 and A and writes detail, K9 reads C and writes a
// V0 of half the values, K10 reads it and detail and writes the output.
// About 10 flops a value are far below the card's float32 rate.  Design:
// one thread per output element, k (the contiguous dim) across the
// threads of a block so that loads and stores coalesce; the neighbour
// reads at i +- 1 and j +- 1 hit rows that neighbouring blocks read too,
// which L1 and L2 serve.  Indices are 64-bit: 4096^3 overflows int32.  A
// tiled version with the halo staged in shared memory is later work.

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

// Source of K6: the coarse array C at the coarse indices of an
// all-parent position.
struct CoarseSource {
  const float* c;
  const int* c0;
  const int* c1;
  const int* c2;
  int nc1, nc2;
  __device__ __forceinline__ float operator()(int i, int j, int k) const {
    return c[(static_cast<int64_t>(c0[i]) * nc1 + c1[j]) * nc2 + c2[k]];
  }
};

// Source of K9: C at the coarse indices of dims 0 and 2, at column j of
// the coarse dim 1.
struct CoarseRowSource {
  const float* c;
  const int* c0;
  const int* c2;
  int nc1, nc2;
  __device__ __forceinline__ float operator()(int i, int j, int k) const {
    return c[(static_cast<int64_t>(c0[i]) * nc1 + j) * nc2 + c2[k]];
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

__global__ void gpk_prolong_add_kernel(const float* __restrict__ c,
                                       const float* __restrict__ detail,
                                       float* __restrict__ out, DimTable t0,
                                       DimTable t1, DimTable t2, int n2,
                                       int nc1, int nc2) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int i = blockIdx.z;
  if (k >= n2) return;
  const int n1 = gridDim.y;
  const CoarseSource src{c, t0.c, t1.c, t2.c, nc1, nc2};
  const int64_t idx = (static_cast<int64_t>(i) * n1 + j) * n2 + k;
  out[idx] = __fadd_rn(interp(src, t0, t1, t2, i, j, k), detail[idx]);
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

// One thread per element of V0 (n0, nc1, n2): j is a coarse column.
__global__ void dec_b20_kernel(const float* __restrict__ c,
                               float* __restrict__ v0, DimTable t0,
                               DimTable t2, int n2, int nc2) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const int i = blockIdx.z;
  if (k >= n2) return;
  const int nc1 = gridDim.y;
  const CoarseRowSource src{c, t0.c, t2.c, nc1, nc2};
  v0[(static_cast<int64_t>(i) * nc1 + j) * n2 + k] = g0(src, t0, t2, i, j, k);
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

extern "C" cudaError_t mgard_gpk_prolong_add(
    const float* c, const float* detail, float* out, const float* w0,
    const int* c0, const float* w1, const int* c1, const float* w2,
    const int* c2, int n0, int n1, int n2, int nc1, int nc2,
    cudaStream_t stream) {
  if (n0 <= 0 || n1 <= 0 || n2 <= 0) return cudaSuccess;
  dim3 grid;
  const cudaError_t err = grid_for(n0, n1, n2, &grid);
  if (err != cudaSuccess) return err;
  gpk_prolong_add_kernel<<<grid, kThreads, 0, stream>>>(
      c, detail, out, DimTable{w0, c0}, DimTable{w1, c1}, DimTable{w2, c2},
      n2, nc1, nc2);
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

extern "C" cudaError_t mgard_dec_b20(const float* c, float* v0,
                                     const float* w0, const int* c0,
                                     const float* w2, const int* c2, int n0,
                                     int nc1, int n2, int nc2,
                                     cudaStream_t stream) {
  if (n0 <= 0 || nc1 <= 0 || n2 <= 0) return cudaSuccess;
  dim3 grid;
  const cudaError_t err = grid_for(n0, nc1, n2, &grid);
  if (err != cudaSuccess) return err;
  dec_b20_kernel<<<grid, kThreads, 0, stream>>>(c, v0, DimTable{w0, c0},
                                                DimTable{w2, c2}, n2, nc2);
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

// K13 rm_dim0: R_l M_l (mass apply, then restriction) along dim 0 of a
// dense 3-D float32 level array, the LPK stage of the correction.
//
// Replaces mgard_tpu/ops/lpk_kernels.py:129 (rm_dim0, pallas_call :162).
// On a front-interleaved dim 0 with n0 = 2 * fc, the combined operator
// A = R M is 5-banded with its taps at fine rows 2j-2 .. 2j+2, so with E
// the even and O the odd dim-0 planes of B (E[j] = B[2j], O[j] = B[2j+1])
//
//   out[j]  = w0 E[j-1] + w1 O[j-1] + w2 E[j] + w3 O[j] + w4 E[j+1]  j < fc
//   out[fc] = t0 B[n0-4] + t1 B[n0-3] + t2 B[n0-2] + t3 B[n0-1]
//   out[j]  = 0                               fc < j < pad8(fc + 1)
//
// with the taps of row j in row j of the (pad8(fc + 1), 128) float32
// table (rm0_tables).  The sums run left to right, as the Pallas kernel
// accumulates them.  Row 0 reads E[0] and O[0] for its missing E[-1] and
// O[-1], and row fc-1 reads E[fc-1] for its missing E[fc], each times a
// zero weight: the Pallas kernel's clamped halo blocks read the same
// rows.  The pad rows are written as zeros (the Pallas kernel leaves
// finite garbage there): the zero columns of the padded M^-1 that follows
// annihilate only finite values.
//
// Float rule: every multiply and add is an _rn intrinsic, so nvcc cannot
// contract a product and a sum into an FMA; the taps of R M are not
// powers of two even on a uniform grid, so a contraction would show.
//
// Bound: bytes.  It reads B once (n0 planes) and writes pad8(fc + 1)
// planes; 9 float ops an output value are far below the card's float32
// rate.  Design: one thread per 4 consecutive values of a plane (float4
// loads and stores, 16 bytes a thread, coalesced), blockIdx.y the output
// row; the blocks of row j run before those of row j + 1, so the plane
// 2j + 2 that row j reads is still in L2 when row j + 1 reads it again.
// The Pallas kernel's 16-row main blocks, 2-row halo blocks and SMEM
// table blocks exist only for Mosaic's tiling.  Offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTableCols = 128;

__device__ __forceinline__ float4 ld4(const float* __restrict__ b,
                                      int64_t row, int64_t plane,
                                      int64_t p) {
  return *reinterpret_cast<const float4*>(b + row * plane + p);
}

__device__ __forceinline__ float4 mul4(float w, float4 x) {
  return make_float4(__fmul_rn(w, x.x), __fmul_rn(w, x.y),
                     __fmul_rn(w, x.z), __fmul_rn(w, x.w));
}

__device__ __forceinline__ float4 madd4(float4 acc, float w, float4 x) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(w, x.x)),
                     __fadd_rn(acc.y, __fmul_rn(w, x.y)),
                     __fadd_rn(acc.z, __fmul_rn(w, x.z)),
                     __fadd_rn(acc.w, __fmul_rn(w, x.w)));
}

__global__ void rm_dim0_kernel(const float* __restrict__ b,
                               const float* __restrict__ tab,
                               float* __restrict__ out, int fc,
                               int64_t plane) {
  const int64_t p =
      4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (p >= plane) return;
  const int j = blockIdx.y;
  const float* w = tab + static_cast<int64_t>(j) * kTableCols;
  float4 acc;
  if (j < fc) {
    const int64_t e = 2 * static_cast<int64_t>(j);
    acc = mul4(__ldg(w + 0), ld4(b, j > 0 ? e - 2 : 0, plane, p));
    acc = madd4(acc, __ldg(w + 1), ld4(b, j > 0 ? e - 1 : 1, plane, p));
    acc = madd4(acc, __ldg(w + 2), ld4(b, e, plane, p));
    acc = madd4(acc, __ldg(w + 3), ld4(b, e + 1, plane, p));
    acc = madd4(acc, __ldg(w + 4), ld4(b, j < fc - 1 ? e + 2 : e, plane, p));
  } else if (j == fc) {
    const int64_t n0 = 2 * static_cast<int64_t>(fc);
    acc = mul4(__ldg(w + 0), ld4(b, n0 - 4, plane, p));
    acc = madd4(acc, __ldg(w + 1), ld4(b, n0 - 3, plane, p));
    acc = madd4(acc, __ldg(w + 2), ld4(b, n0 - 2, plane, p));
    acc = madd4(acc, __ldg(w + 3), ld4(b, n0 - 1, plane, p));
  } else {
    acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  *reinterpret_cast<float4*>(out + static_cast<int64_t>(j) * plane + p) = acc;
}

}  // namespace

// b: (2 * fc, plane) float32; tab: (nc0p, 128) float32; out: (nc0p,
// plane) float32 with nc0p = pad8(fc + 1).  plane must be a multiple of 4
// and the pointers 16-byte aligned (the wrapper checks both).
extern "C" cudaError_t mgard_rm_dim0(const float* b, const float* tab,
                                     float* out, int fc, int nc0p,
                                     long long plane, cudaStream_t stream) {
  if (nc0p <= 0 || plane <= 0) return cudaSuccess;
  if (fc < 2 || nc0p <= fc || nc0p > 65535 || plane % 4) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = (plane / 4 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), nc0p);
  rm_dim0_kernel<<<grid, kThreads, 0, stream>>>(b, tab, out, fc, plane);
  return cudaGetLastError();
}

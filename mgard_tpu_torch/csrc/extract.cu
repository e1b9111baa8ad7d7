// K1: coarse-node extraction of a dense 3-D float32 level array.
//
// Replaces mgard_tpu/ops/extract_kernels.py:75 (extract_coarse_3d, whose
// Pallas kernel selects even sublanes in registers and the coarse lanes
// through a 0/1 HIGHEST dot).  On the GPU the same function is a plain
// gather: out[i0, i1, i2] = A[idx0[i0], idx1[i1], idx2[i2]], so the
// output is bit-identical to the source values by construction.
//
// Bound: bytes.  It reads the nc0 selected (n1, n2) source planes and
// writes the (nc0, nc1, nc2) output once.  Design: one thread per output
// element, the lane index running over i2, so that stores are coalesced;
// the loads of a warp span 64 consecutive floats of one source row (the
// coarse lanes are the even positions plus the last), so each source
// row that holds coarse nodes is read from DRAM about once.  The index
// vectors are small device arrays, so the kernel serves any coarse
// pattern; the Python gate (extract_supported) still decides when it is
// launched, as the JAX package's does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void extract_coarse_3d_kernel(const float* __restrict__ a,
                                         float* __restrict__ out,
                                         const int* __restrict__ idx0,
                                         const int* __restrict__ idx1,
                                         const int* __restrict__ idx2,
                                         int n1, int n2, int nc1, int nc2) {
  const int i2 = blockIdx.x * blockDim.x + threadIdx.x;
  const int i1 = blockIdx.y;
  const int i0 = blockIdx.z;
  if (i2 >= nc2) return;
  const size_t src = (static_cast<size_t>(idx0[i0]) * n1 + idx1[i1]) * n2
                     + idx2[i2];
  const size_t dst = (static_cast<size_t>(i0) * nc1 + i1) * nc2 + i2;
  out[dst] = a[src];
}

}  // namespace

extern "C" cudaError_t mgard_extract_coarse_3d(
    const float* a, float* out, const int* idx0, const int* idx1,
    const int* idx2, int n1, int n2, int nc0, int nc1, int nc2,
    cudaStream_t stream) {
  if (nc0 <= 0 || nc1 <= 0 || nc2 <= 0) return cudaSuccess;
  if (nc1 > 65535 || nc0 > 65535) return cudaErrorInvalidConfiguration;
  const int threads = 256;
  dim3 grid((nc2 + threads - 1) / threads, nc1, nc0);
  extract_coarse_3d_kernel<<<grid, threads, 0, stream>>>(
      a, out, idx0, idx1, idx2, n1, n2, nc1, nc2);
  return cudaGetLastError();
}

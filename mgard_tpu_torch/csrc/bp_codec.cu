// K2-K4, K11, K12, K14-K17: the chunked bitplane codec
// (ops/bitplane.py).
//
// A segment of n values is cut into chunks of 32*C values; value
// i*C + g of chunk c sits at row i, column g (values past n read as 0).
// Column g of a chunk is one 32-value group: its 32 zigzag words are
// bit-transposed so that plane word b holds bit b of the group's values
// (bit i of the word = bit b of value i*C + g).  Chunk c with exponent
// e_c emits planes 0..e_c-1 (LSB first), C words each, at rows
// offsets[c] .. offsets[c] + e_c - 1 of one shared stream.
//
// The transposing kernels map one thread to one column g of one chunk:
// the thread keeps its 32 words in registers, the 5-stage butterfly
// transposes them there, and the loads and stores of a warp touch 32
// consecutive words of one row, so all global traffic is coalesced.  All
// kernels are bound by bytes (a few integer operations per byte moved).
//
// K2 transposes nothing: it takes each chunk's largest zigzag word and
// its status, both order-free, and a chunk is a contiguous span of 32*C
// values.  So one block of 512 threads reads one chunk front to back
// with 16-byte loads (four in flight a thread; chunk starts are
// multiples of 32*C*4 bytes, a ragged tail or a base that is not 16-byte
// aligned is read value by value) and reduces in registers, then with
// warp reduces, then in shared memory, and writes its chunk's two words
// itself: no zero-filled outputs and no atomics.  One launch covers every
// segment of a pyramid: the segment table (base pointers, value counts,
// first chunks; at most 32 segments, and dims up to 4096 give at most 13
// levels) travels by value in the kernel's parameters, so nothing is
// copied to the device and nothing waits.  A block per chunk, not a few
// blocks per chunk with atomics: 1,204 chunks of 512 KB at 512^3 are
// 2.3 waves of 4 resident blocks an SM (30 registers a thread), and the
// 32 KB of loads each block keeps in flight are enough to keep the
// memory busy in the last, partial wave.  One launch a segment would cost 10 host round trips at
// 512^3 while the small segments' device work is microseconds, so the
// card would wait on the host.
//
//   K2 bp_quant_max             replaces mgard_tpu/ops/pallas_kernels.py:527
//   K3 bp_quant_condense        replaces mgard_tpu/ops/pallas_kernels.py:459
//   K4 bp_decode_condense_f32   replaces mgard_tpu/ops/pallas_kernels.py:605
//   K12 bp_encode_condense      replaces mgard_tpu/ops/pallas_kernels.py:293
//   K11 bp_decode_condense      replaces mgard_tpu/ops/pallas_kernels.py:690
//   K16 bp_quant_zigzag         replaces mgard_tpu/ops/pallas_kernels.py:371
//   K17 bp_condense_into        replaces mgard_tpu/ops/pallas_kernels.py:559
//   K14 bp_encode_core          replaces mgard_tpu/ops/pallas_kernels.py:83
//   K15 bp_decode_core          replaces mgard_tpu/ops/pallas_kernels.py:742
//
// K2-K4 read and write float32 segments (the PYRAMID_SEG layout, the
// quantizer fused in); K12 and K11 are K3 and K4 without it, on the flat
// stream's int32 zigzag words and int32 values.  K16 and K17 are the
// segmented encode's older two-kernel split, which K2 + K3 replaced in
// both packages and which nothing calls: K16 is K2 that also stores every
// zigzag word, K17 condenses those words into the shared stream.  In the
// port's in-place contract K17 computes K12's function (global row
// offsets into a buffer the caller owns), so its launcher launches K12's
// kernel; the Pallas kernel's total_rows and buffer aliasing exist only
// because a JAX array is immutable.
//
// K14 and K15 are the sign-magnitude cores, transpose only: a chunk is
// (32, 128) int32 values, no offsets and no condense.  K14 writes all 32
// magnitude planes, one sign word per column and the chunk's plane count;
// K15 inverts it.  No path of either package calls them.
//
// The TPU kernels' DMA loops, 33-way switches and SMEM meta packing exist
// only so that Mosaic issues copies at dynamic offsets; here a thread
// stores at a computed address instead.
//
// Rounding follows the JAX package's quantizer exactly: x * inv_q with
// __fmul_rn, |.| + 0.5 with __fadd_rn (no contraction into an FMA
// whatever -fmad says), truncation, sign restored, then zigzag.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Columns of a K14/K15 chunk: the JAX kernels' 128-lane blocks.
constexpr int kCoreLanes = 128;

template <int SH, uint32_t MASK>
__device__ __forceinline__ void butterfly_step(uint32_t (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i & SH) continue;
    const uint32_t a = r[i], b = r[i | SH];
    const uint32_t t = ((a >> SH) ^ b) & MASK;
    r[i] = a ^ (t << SH);
    r[i | SH] = b ^ t;
  }
}

// 32x32 bit-matrix transpose in registers; the same five masked
// shift/xor rounds as mgard_tpu/ops/pallas_kernels.py:48 (_butterfly_rows).
__device__ __forceinline__ void butterfly(uint32_t (&r)[32]) {
  butterfly_step<16, 0x0000FFFFu>(r);
  butterfly_step<8, 0x00FF00FFu>(r);
  butterfly_step<4, 0x0F0F0F0Fu>(r);
  butterfly_step<2, 0x33333333u>(r);
  butterfly_step<1, 0x55555555u>(r);
}

// Quantize one value; status 2 = non-finite input, 1 = |x*inv_q|+0.5
// reaches 2^31 (the int cast would be undefined, so no word is formed).
__device__ __forceinline__ uint32_t quant_zigzag(float v, float invq,
                                                 int& status) {
  const float xs = __fmul_rn(v, invq);
  const float a = __fadd_rn(fabsf(xs), 0.5f);
  if (!isfinite(v)) {
    status = 2;
    return 0u;
  }
  if (a >= 2147483648.0f) {
    status = status > 1 ? status : 1;
    return 0u;
  }
  const int t = static_cast<int>(truncf(a));
  const int q = xs < 0.0f ? -t : t;
  return (static_cast<uint32_t>(q) << 1) ^ static_cast<uint32_t>(q >> 31);
}

// K16's words: quant_zigzag where the status is 0; where it is not, the
// word that XLA's saturating float-to-int32 cast gives in the Pallas
// kernel (NaN -> 0, the int32 maximum or minimum past its range), so that
// the words equal the JAX kernel's everywhere.  K2 leaves such words out
// of its maximum; a nonzero status makes the compressor raise either way.
__device__ __forceinline__ uint32_t quant_zigzag_sat(float v, float invq,
                                                     int& status) {
  const uint32_t z = quant_zigzag(v, invq, status);
  const float xs = __fmul_rn(v, invq);
  if (__fadd_rn(fabsf(xs), 0.5f) < 2147483648.0f) return z;
  return isnan(xs) ? 0u : (xs < 0.0f ? 0xFFFFFFFFu : 0xFFFFFFFEu);
}

__device__ __forceinline__ void load_quant(const float* __restrict__ x,
                                           long long n, size_t base, int C,
                                           float invq, uint32_t (&r)[32],
                                           int& status) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const size_t k = base + static_cast<size_t>(i) * C;
    const float v = k < static_cast<size_t>(n) ? x[k] : 0.0f;
    r[i] = quant_zigzag(v, invq, status);
  }
}

// Planes 0..ec-1 of one column, LSB first, to stream rows row0...
__device__ __forceinline__ void store_planes(const uint32_t (&r)[32], int ec,
                                             size_t row0, int C, int g,
                                             uint32_t* __restrict__ words) {
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    if (b < ec) words[(row0 + b) * C + g] = r[b];
  }
}

// The inverse read: planes ec..31 are zero and their rows are not read.
__device__ __forceinline__ void load_planes(const uint32_t* __restrict__ words,
                                            int ec, size_t row0, int C, int g,
                                            uint32_t (&r)[32]) {
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    r[b] = b < ec ? words[(row0 + b) * C + g] : 0u;
  }
}

__device__ __forceinline__ int unzigzag(uint32_t z) {
  return static_cast<int>(z >> 1) ^ -static_cast<int>(z & 1u);
}

// K2 over every segment of a pyramid in one launch.  The segment table
// travels by value in the kernel's parameters (no copy to the device, no
// sync); a chunk is the contiguous span of 32*C values it is, so one
// block reads it front to back with 16-byte loads and reduces its
// maximum and status in registers, warps and shared memory.
constexpr int kMaxSegments = 32;
constexpr int kQuantMaxThreads = 512;

struct SegmentTable {
  const float* x[kMaxSegments];
  long long n[kMaxSegments];
  int first[kMaxSegments + 1];  // first global chunk of each segment
  int nseg;
};

__device__ __forceinline__ void quant_max4(const float4 f, float invq,
                                           uint32_t& m, int& st) {
  m = max(m, quant_zigzag(f.x, invq, st));
  m = max(m, quant_zigzag(f.y, invq, st));
  m = max(m, quant_zigzag(f.z, invq, st));
  m = max(m, quant_zigzag(f.w, invq, st));
}

__global__ void __launch_bounds__(kQuantMaxThreads)
bp_quant_max_segments_kernel(const SegmentTable t, int C, float invq,
                             uint32_t* __restrict__ zmax,
                             int* __restrict__ status) {
  __shared__ uint32_t warp_max[kQuantMaxThreads / 32];
  __shared__ int warp_status[kQuantMaxThreads / 32];
  const int chunk = blockIdx.x;
  int s = 0;
  while (s + 1 < t.nseg && chunk >= t.first[s + 1]) ++s;
  const int span = 32 * C;
  const long long start =
      static_cast<long long>(chunk - t.first[s]) * span;
  const long long left = t.n[s] - start;
  const int count = left <= 0 ? 0 : (left < span ? static_cast<int>(left)
                                                 : span);
  const float* __restrict__ x = t.x[s] + (count ? start : 0);
  const int step = blockDim.x;
  uint32_t m = 0u;
  int st = 0;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15u) == 0) {
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
    const int nvec = count / 4;
    int v = threadIdx.x;
    // four 16-byte loads in flight a thread before any is used
    for (; v + 3 * step < nvec; v += 4 * step) {
      const float4 a = x4[v], b = x4[v + step], c = x4[v + 2 * step],
                   d = x4[v + 3 * step];
      quant_max4(a, invq, m, st);
      quant_max4(b, invq, m, st);
      quant_max4(c, invq, m, st);
      quant_max4(d, invq, m, st);
    }
    for (; v < nvec; v += step) quant_max4(x4[v], invq, m, st);
    done = 4 * nvec;
  }
  // the ragged tail, or the whole chunk where its base is not 16-byte
  // aligned
  for (int k = done + threadIdx.x; k < count; k += step) {
    m = max(m, quant_zigzag(x[k], invq, st));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  st = __reduce_max_sync(0xffffffffu, st);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_max[warp] = m;
    warp_status[warp] = st;
  }
  __syncthreads();
  if (warp == 0) {
    const int lane = threadIdx.x;
    const bool live = lane < static_cast<int>(blockDim.x >> 5);
    m = __reduce_max_sync(0xffffffffu, live ? warp_max[lane] : 0u);
    st = __reduce_max_sync(0xffffffffu, live ? warp_status[lane] : 0);
    if (lane == 0) {
      zmax[chunk] = m;
      status[chunk] = st;
    }
  }
}

// K16: the column loads and quantizer of the transposing kernels, each
// chunk's max and status (a warp reduce and atomicMax into zero-filled
// outputs), plus a store of each word at its own position.
__global__ void bp_quant_zigzag_kernel(const float* __restrict__ x,
                                       long long n, int C, float invq,
                                       uint32_t* __restrict__ z,
                                       uint32_t* __restrict__ zmax,
                                       int* __restrict__ status) {
  const int c = blockIdx.x;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  uint32_t m = 0u;
  int st = 0;
  if (g < C) {
    const size_t base = static_cast<size_t>(c) * 32 * C + g;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const size_t k = base + static_cast<size_t>(i) * C;
      const float v = k < static_cast<size_t>(n) ? x[k] : 0.0f;
      const uint32_t w = quant_zigzag_sat(v, invq, st);
      z[k] = w;
      m = w > m ? w : m;
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  st = __reduce_max_sync(0xffffffffu, st);
  if ((threadIdx.x & 31) == 0) {
    if (m) atomicMax(zmax + c, m);
    if (st) atomicMax(status + c, st);
  }
}

__global__ void bp_quant_condense_kernel(const float* __restrict__ x,
                                         long long n, int C, float invq,
                                         const int* __restrict__ offsets,
                                         const int* __restrict__ e,
                                         uint32_t* __restrict__ words) {
  const int c = blockIdx.x;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  const int ec = e[c];
  if (g >= C || ec == 0) return;
  uint32_t r[32];
  int st = 0;
  load_quant(x, n, static_cast<size_t>(c) * 32 * C + g, C, invq, r, st);
  butterfly(r);
  store_planes(r, ec, static_cast<size_t>(offsets[c]), C, g, words);
}

__global__ void bp_decode_condense_f32_kernel(
    const uint32_t* __restrict__ words, int C,
    const int* __restrict__ offsets, const int* __restrict__ e,
    float quantum, float* __restrict__ out, long long n) {
  const int c = blockIdx.x;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= C) return;
  uint32_t r[32];
  load_planes(words, e[c], static_cast<size_t>(offsets[c]), C, g, r);
  butterfly(r);
  const size_t base = static_cast<size_t>(c) * 32 * C + g;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const size_t k = base + static_cast<size_t>(i) * C;
    if (k < static_cast<size_t>(n)) {
      out[k] = __fmul_rn(__int2float_rn(unzigzag(r[i])), quantum);
    }
  }
}

__global__ void bp_encode_condense_kernel(const uint32_t* __restrict__ z,
                                          int C,
                                          const int* __restrict__ offsets,
                                          const int* __restrict__ e,
                                          uint32_t* __restrict__ words) {
  const int c = blockIdx.x;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  const int ec = e[c];
  if (g >= C || ec == 0) return;
  const size_t base = static_cast<size_t>(c) * 32 * C + g;
  uint32_t r[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) r[i] = z[base + static_cast<size_t>(i) * C];
  butterfly(r);
  store_planes(r, ec, static_cast<size_t>(offsets[c]), C, g, words);
}

__global__ void bp_decode_condense_kernel(const uint32_t* __restrict__ words,
                                          int C,
                                          const int* __restrict__ offsets,
                                          const int* __restrict__ e,
                                          int* __restrict__ out,
                                          long long n) {
  const int c = blockIdx.x;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= C) return;
  uint32_t r[32];
  load_planes(words, e[c], static_cast<size_t>(offsets[c]), C, g, r);
  butterfly(r);
  const size_t base = static_cast<size_t>(c) * 32 * C + g;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const size_t k = base + static_cast<size_t>(i) * C;
    if (k < static_cast<size_t>(n)) out[k] = unzigzag(r[i]);
  }
}

// K14: one block of 128 threads per chunk, one thread per column.  The
// magnitude of a negative value is 0u - (uint32_t)q, which is 0x80000000
// for the int32 minimum (what jnp.abs then astype(uint32) gives; abs()
// of it is undefined in C).  Each thread ORs a mask of its non-zero
// planes; a warp reduce and four words of shared memory give the chunk's.
__global__ void __launch_bounds__(kCoreLanes)
bp_encode_core_kernel(const int* __restrict__ q,
                      uint32_t* __restrict__ planes,
                      uint32_t* __restrict__ sign, int* __restrict__ e) {
  __shared__ uint32_t warp_masks[kCoreLanes / 32];
  const int g = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * 32 * kCoreLanes + g;
  uint32_t r[32];
  uint32_t s = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int v = q[base + static_cast<size_t>(i) * kCoreLanes];
    r[i] = v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
    s |= static_cast<uint32_t>(v < 0) << i;
  }
  butterfly(r);
  uint32_t mask = 0u;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    planes[base + static_cast<size_t>(b) * kCoreLanes] = r[b];
    mask |= static_cast<uint32_t>(r[b] != 0u) << b;
  }
  sign[static_cast<size_t>(blockIdx.x) * kCoreLanes + g] = s;
  mask = __reduce_or_sync(0xffffffffu, mask);
  if ((g & 31) == 0) warp_masks[g >> 5] = mask;
  __syncthreads();
  if (g == 0) {
    uint32_t m = 0u;
#pragma unroll
    for (int w = 0; w < kCoreLanes / 32; ++w) m |= warp_masks[w];
    e[blockIdx.x] = 32 - __clz(m);
  }
}

// K15: the inverse; the negation wraps in uint32_t before the cast.
__global__ void __launch_bounds__(kCoreLanes)
bp_decode_core_kernel(const uint32_t* __restrict__ planes,
                      const uint32_t* __restrict__ sign,
                      int* __restrict__ out) {
  const int g = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * 32 * kCoreLanes + g;
  uint32_t r[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    r[b] = planes[base + static_cast<size_t>(b) * kCoreLanes];
  }
  butterfly(r);
  const uint32_t s = sign[static_cast<size_t>(blockIdx.x) * kCoreLanes + g];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t m = ((s >> i) & 1u) ? 0u - r[i] : r[i];
    out[base + static_cast<size_t>(i) * kCoreLanes] = static_cast<int>(m);
  }
}

dim3 codec_grid(int nchunks, int C, int threads) {
  return dim3(nchunks, (C + threads - 1) / threads);
}

int codec_threads(int C) { return C >= 256 ? 256 : ((C + 31) / 32) * 32; }

}  // namespace

// K2: one block per chunk of every segment.  x[s], n[s] and nchunks[s]
// are host arrays of nseg entries (at most kMaxSegments), copied into
// the kernel's parameters; zmax and status hold one entry per chunk of
// all segments, in segment order.
extern "C" cudaError_t mgard_bp_quant_max_segments(
    const float* const* x, const long long* n, const int* nchunks, int nseg,
    int C, float invq, uint32_t* zmax, int* status, cudaStream_t stream) {
  if (nseg < 0 || nseg > kMaxSegments || C <= 0 || C > (1 << 25)) {
    return cudaErrorInvalidValue;
  }
  SegmentTable t{};
  long long total = 0;
  for (int s = 0; s < nseg; ++s) {
    if (nchunks[s] < 0 || n[s] < 0 ||
        n[s] > static_cast<long long>(nchunks[s]) * 32 * C) {
      return cudaErrorInvalidValue;
    }
    t.x[s] = x[s];
    t.n[s] = n[s];
    t.first[s] = static_cast<int>(total);
    total += nchunks[s];
    if (total > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  t.first[nseg] = static_cast<int>(total);
  t.nseg = nseg;
  if (total == 0) return cudaSuccess;
  bp_quant_max_segments_kernel<<<static_cast<unsigned>(total),
                                 kQuantMaxThreads, 0, stream>>>(
      t, C, invq, zmax, status);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_bp_quant_condense(
    const float* x, long long n, int nchunks, int C, float invq,
    const int* offsets, const int* e, uint32_t* words, cudaStream_t stream) {
  if (nchunks <= 0) return cudaSuccess;
  const int threads = codec_threads(C);
  bp_quant_condense_kernel<<<codec_grid(nchunks, C, threads), threads, 0,
                             stream>>>(x, n, C, invq, offsets, e, words);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_bp_decode_condense_f32(
    const uint32_t* words, int nchunks, int C, const int* offsets,
    const int* e, float quantum, float* out, long long n,
    cudaStream_t stream) {
  if (nchunks <= 0) return cudaSuccess;
  const int threads = codec_threads(C);
  bp_decode_condense_f32_kernel<<<codec_grid(nchunks, C, threads), threads,
                                  0, stream>>>(words, C, offsets, e, quantum,
                                               out, n);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_bp_encode_condense(
    const uint32_t* z, int nchunks, int C, const int* offsets, const int* e,
    uint32_t* words, cudaStream_t stream) {
  if (nchunks <= 0) return cudaSuccess;
  const int threads = codec_threads(C);
  bp_encode_condense_kernel<<<codec_grid(nchunks, C, threads), threads, 0,
                              stream>>>(z, C, offsets, e, words);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_bp_decode_condense(
    const uint32_t* words, int nchunks, int C, const int* offsets,
    const int* e, int* out, long long n, cudaStream_t stream) {
  if (nchunks <= 0) return cudaSuccess;
  const int threads = codec_threads(C);
  bp_decode_condense_kernel<<<codec_grid(nchunks, C, threads), threads, 0,
                              stream>>>(words, C, offsets, e, out, n);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_bp_quant_zigzag(const float* x, long long n,
                                             int nchunks, int C, float invq,
                                             uint32_t* z, uint32_t* zmax,
                                             int* status,
                                             cudaStream_t stream) {
  if (nchunks <= 0) return cudaSuccess;
  const int threads = codec_threads(C);
  bp_quant_zigzag_kernel<<<codec_grid(nchunks, C, threads), threads, 0,
                           stream>>>(x, n, C, invq, z, zmax, status);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_bp_condense_into(
    const uint32_t* z, int nchunks, int C, const int* offsets, const int* e,
    uint32_t* words, cudaStream_t stream) {
  if (nchunks <= 0) return cudaSuccess;
  const int threads = codec_threads(C);
  bp_encode_condense_kernel<<<codec_grid(nchunks, C, threads), threads, 0,
                              stream>>>(z, C, offsets, e, words);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_bp_encode_core(const int* q, int nchunks,
                                            uint32_t* planes, uint32_t* sign,
                                            int* e, cudaStream_t stream) {
  if (nchunks <= 0) return cudaSuccess;
  bp_encode_core_kernel<<<nchunks, kCoreLanes, 0, stream>>>(q, planes, sign,
                                                            e);
  return cudaGetLastError();
}

extern "C" cudaError_t mgard_bp_decode_core(const uint32_t* planes,
                                            const uint32_t* sign, int nchunks,
                                            int* out, cudaStream_t stream) {
  if (nchunks <= 0) return cudaSuccess;
  bp_decode_core_kernel<<<nchunks, kCoreLanes, 0, stream>>>(planes, sign,
                                                            out);
  return cudaGetLastError();
}

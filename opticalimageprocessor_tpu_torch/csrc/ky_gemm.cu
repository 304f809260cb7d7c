// Kernel (g): the fast registration's ky contraction, every (tile, band) at
// once, in float32.
//
// Replaces no TPU kernel: the JAX package leaves this contraction to XLA
// (opticalimageprocessor_tpu/ops/phasecorr_pallas.py::
// windowed_crosspower_fused_tiles, two jnp.einsum at Precision.HIGHEST).
// For kernel (b)'s output D (2M rows: Re D over Im D; a column a window
// column of one (tile, band)), window row j = win_y + sigma holds
//
//   out[j, c] = sum_k cy_c[k, j] D[k, c] - cy_s[k, j] D[M + k, c]
//             = A(sigma, c) + B(sigma, c),
//   A(s, c) = sum_k cos(2 pi k s / M) D[k, c],
//   B(s, c) = sum_k sin(2 pi k s / M) D[M + k, c],
//
// and cos is even and sin odd (the evaluation matrices are so to the
// bit), so A(-s) = A(s) and B(-s) = -B(s): the kernel sums A and B for s
// = 0..64 once and forms out[win_y +- s] = A(s) +- B(s) -- the two sums
// of phasecorr.contract_rows, each taken once for +s and -s, which halves
// the work of the 129-row product.  ops/phasecorr_cuda.py::
// contract_rows_stacked divides by M * N.
//
// Why a kernel and not cuBLAS: cuBLAS chooses its split of K, and so the
// order of a column's sums, from the number of columns, so the same (tile,
// band) summed differently as one of the scene's 50 tiles than as one of a
// line-mesh shard's, and a mesh run's aligned MSS was no longer the single
// device's byte for byte.  Here a column's sums have one order whatever the
// number of columns.
//
// Bound on the H100 (160000-line scene: M = 16000, 25800 columns): 1.07e11
// float32 FLOP (2 x 64 rows x M, and the s = 0 row) = 1.59 ms at 67
// TFLOP/s, against 3.3 GB of D read once (0.99 ms).  Design (SIMT FFMA:
// float32 stays float32):
//
// * A block of 128 threads takes 128 columns, one half of D (A: the real
//   rows, B: the imaginary ones) and one of ``splits`` equal slices of its
//   M rows (a count from M alone, so that the scene's 202 x 2 column-half
//   blocks give 132 SMs near-even work).  Each thread accumulates an 8 x 8
//   tile of rows s = 1..64 (4tr.. and 32+4tr..) by columns (4tc.. and
//   64+4tc..) from float4 shared-memory reads; in the A half each thread
//   also sums its own column's s = 0 row (weights cos 0 = 1).
// * Stages of 8 rows of W^T ((2M, 68): cos / sin of s = 1..64, then s = 0)
//   and D run through a 3-stage cp.async ring: no registers hold a stage
//   in flight.
// * Each slice's sums land in a workspace; ky_gemm_combine adds the slices
//   in their order and forms A +- B.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBN = 128;            // columns of a block
constexpr int kBK = 8;              // rows of D a stage
constexpr int kS = 64;              // shifts s = 1..64 in the register tiles
constexpr int kWP = 68;             // W^T columns: s = 1..64, s = 0, padding
constexpr int kWS = kS + 1;         // workspace rows: s = 1..64, then s = 0
constexpr int kStages = 3;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ``bytes`` (4 or 16) from global to shared, zero-filled past ``valid``
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid)
                 : "memory");
  }
}

// vec: the columns are a multiple of 4, so every row of D is 16-byte aligned
template <bool vec>
__global__ void __launch_bounds__(kThreads, 4) ky_gemm_kernel(
    const float* __restrict__ wt,   // (2M, kWP)
    const float* __restrict__ d,    // (2M, ncols)
    float* __restrict__ ws,         // (2, splits, kWS, ncols)
    int M, int ncols, int splits) {
  __shared__ __align__(16) float sw[kStages][kBK][kWP];
  __shared__ __align__(16) float sd[kStages][kBK][kBN];
  const int tid = threadIdx.x;
  const int tr = tid >> 4;          // rows 4tr.., 32 + 4tr..
  const int tc = tid & 15;          // columns 4tc.., 64 + 4tc..
  const int c0 = blockIdx.x * kBN;
  const int half = blockIdx.y & 1;  // 0: A over Re D, 1: B over Im D
  const int split = blockIdx.y >> 1;
  const int stages = (M + kBK - 1) / kBK;
  const int st0 = (int)((long long)stages * split / splits);
  const int st1 = (int)((long long)stages * (split + 1) / splits);
  const size_t k_base = (size_t)half * M;

  // stage st into ring slot ``slot``: D, 8 rows x 128 columns; W^T, 8 rows
  // x 68 columns; rows past M and columns past ncols zero
  auto issue = [&](int st, int slot) {
    const int k0 = st * kBK;
    if (vec) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {         // 256 float4, two a thread
        const int e = tid + kThreads * j;
        const int r = e >> 5, c = (e & 31) * 4;
        const bool in = k0 + r < M && c0 + c < ncols;
        const float* src = in ? d + (k_base + k0 + r) * ncols + c0 + c : d;
        cp_async<16>(&sd[slot][r][c], src, in ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBK; ++j) {       // a row of 128 floats each
        const int c = tid;
        const bool in = k0 + j < M && c0 + c < ncols;
        const float* src = in ? d + (k_base + k0 + j) * ncols + c0 + c : d;
        cp_async<4>(&sd[slot][j][c], src, in ? 4 : 0);
      }
    }
    for (int e = tid; e < kBK * kWP / 4; e += kThreads) {   // 136 float4
      const int r = e / (kWP / 4), c = (e % (kWP / 4)) * 4;
      const bool in = k0 + r < M;
      const float* src = in ? wt + (k_base + k0 + r) * kWP + c : wt;
      cp_async<16>(&sw[slot][r][c], src, in ? 16 : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float zero_row = 0.0f;            // s = 0 of column c0 + tid (A half)

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (st0 + p < st1) issue(st0 + p, p);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int st = st0; st < st1; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    // the slot read at st - 1 is free once every thread passed the barrier
    const int ahead = st + kStages - 1;
    if (ahead < st1) issue(ahead, (ahead - st0) % kStages);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int slot = (st - st0) % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sw[slot][kk][4 * tr]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sw[slot][kk][32 + 4 * tr]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sd[slot][kk][4 * tc]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sd[slot][kk][64 + 4 * tc]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (half == 0) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk)
        zero_row = fmaf(sw[slot][kk][kS], sd[slot][kk][tid], zero_row);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  float* out = ws + ((size_t)half * splits + split) * kWS * ncols;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* orow = out + (size_t)((i < 4 ? 0 : 32) + 4 * tr + (i & 3)) * ncols;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 64 * h + 4 * tc;
      if (vec && c + 3 < ncols) {
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < ncols) orow[c + e] = acc[i][4 * h + e];
      }
    }
  }
  if (c0 + tid < ncols) out[(size_t)kS * ncols + c0 + tid] = zero_row;
}

// out[win_y + sigma, c] = A(|sigma|, c) + sign(sigma) B(|sigma|, c), each
// of A and B the slices' sums added in slice order
__global__ void ky_gemm_combine_kernel(const float* __restrict__ ws,
                                       float* __restrict__ out, int ncols,
                                       int splits, int win_y) {
  const long long n = (long long)(2 * win_y + 1) * ncols;
  const size_t slice = (size_t)kWS * ncols;
  const float* wb = ws + (size_t)splits * slice;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(i / ncols);
    const int c = (int)(i - (long long)j * ncols);
    const int sigma = j - win_y;
    const int s = sigma < 0 ? -sigma : sigma;
    const size_t at = (size_t)(s == 0 ? kS : s - 1) * ncols + c;
    float a = ws[at];
    for (int p = 1; p < splits; ++p) a += ws[p * slice + at];
    if (s == 0) {
      out[i] = a;
    } else {
      float b = wb[at];
      for (int p = 1; p < splits; ++p) b += wb[p * slice + at];
      out[i] = sigma > 0 ? a + b : a - b;
    }
  }
}

}  // namespace

// wt: (2M, 68) float32: row k < M holds cos(2 pi k s / M) for s = 1..64 in
// columns 0..63 and 1 in column 64, row M + k sin(2 pi k s / M) and 0;
// zero past win_y and in columns 65..67.  d: (2M, ncols) float32.  ws:
// (2, splits, 65, ncols) float32 scratch.  out: (2 win_y + 1, ncols)
// float32.  All contiguous, wt 16-byte aligned; win_y <= 64.  splits
// slices each half of d (ops/phasecorr_cuda.py::ky_gemm_splits).
extern "C" int oip_ky_gemm(const void* wt, const void* d, void* ws,
                           void* out, int M, int ncols, int splits,
                           int win_y, void* stream) {
  if (M < 1 || ncols < 0 || splits < 1 || 2 * splits > 65535 ||
      win_y < 0 || win_y > kS ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ncols == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ncols % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  const dim3 grid((ncols + kBN - 1) / kBN, 2 * splits);
  if (vec) {
    ky_gemm_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(wt), static_cast<const float*>(d),
        static_cast<float*>(ws), M, ncols, splits);
  } else {
    ky_gemm_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(wt), static_cast<const float*>(d),
        static_cast<float*>(ws), M, ncols, splits);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = (long long)(2 * win_y + 1) * ncols;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  ky_gemm_combine_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), ncols, splits,
      win_y);
  return static_cast<int>(cudaGetLastError());
}

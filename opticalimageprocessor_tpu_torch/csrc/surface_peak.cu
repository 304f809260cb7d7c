// Kernel (k): the arg-max of full cv::phaseCorrelate surfaces in their
// fftshifted order, read from the unshifted surfaces the inverse transform
// wrote, so that no shifted copy is made.
//
// Replaces no TPU kernel: the JAX package's full surface is jnp.fft,
// jnp.fft.fftshift and jnp.argmax left to XLA
// (opticalimageprocessor_tpu/ops/phasecorr.py:59-77).  The port ran
// torch.fft.fftshift (a roll: one read and one write of every surface)
// and torch.argmax on the copy.
//
// The answer is torch.argmax's on the shifted copy: fftshift rolls by
// (M / 2, N / 2) rounded down, so the element at (y, x) sits at shifted
// ((y + M / 2) mod M, (x + N / 2) mod N); each surface's result is the
// first maximum in shifted row-major order, a NaN counting above every
// number and ties going to the smaller shifted index.  That order is total
// on (value, shifted index), so the result does not depend on how the
// surface is split or reduced: deterministic, with no atomics.
//
// Bound on the H100: device-memory bandwidth, every surface read once (4
// bytes a sample; 320 MB, 0.096 ms at 3.35 TB/s for a parity tile's 4
// surfaces of 16000 x 1250).  Design: two stages in one call.  Stage 1:
// a block takes a slice of rows_per_block rows of one surface (a multiple
// of 4, so a slice starts on a 16-byte boundary), its threads read it in
// 16-byte loads, four in flight, compare values first and work out a
// sample's shifted index only when it could win; a warp then a block
// reduce, and the block writes its (value, index) to the scratch.  Stage
// 2: one block a surface reduces its slices' candidates and writes the
// shifted linear index.  4-byte loads where a surface holds no whole number
// of 16-byte words or the surfaces start off a 16-byte boundary.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// whether (v, i) comes before (bv, bi) in torch.argmax's order
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  if (isnan(v)) return !isnan(bv) || i < bi;
  if (isnan(bv)) return false;
  return v > bv || (v == bv && i < bi);
}

struct Peak {
  float v;
  int i;
};

__device__ __forceinline__ void offer(Peak& best, float v, int f, int cols,
                                      int rows, int half_rows,
                                      int half_cols) {
  if (v < best.v) return;  // neither NaN, and smaller: cannot win
  const int y = f / cols;
  int sy = y + half_rows;
  if (sy >= rows) sy -= rows;
  int sx = f - y * cols + half_cols;
  if (sx >= cols) sx -= cols;
  const int s = sy * cols + sx;
  if (beats(v, s, best.v, best.i)) best = Peak{v, s};
}

// the block's best, in thread 0
__device__ __forceinline__ Peak block_best(Peak p) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xFFFFFFFFu, p.v, off);
    const int oi = __shfl_down_sync(0xFFFFFFFFu, p.i, off);
    if (beats(ov, oi, p.v, p.i)) p = Peak{ov, oi};
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sv[warp] = p.v;
    si[warp] = p.i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (beats(sv[w], si[w], p.v, p.i)) p = Peak{sv[w], si[w]};
    }
  }
  __syncthreads();  // the next call may write sv and si
  return p;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    surface_peak_slices_kernel(const float* __restrict__ surf,
                               float* __restrict__ part_v,
                               int* __restrict__ part_i, int surfaces,
                               int rows, int cols, int rows_per_block) {
  const int r0 = blockIdx.x * rows_per_block;
  const int f0 = r0 * cols;
  const int f1 = min(rows, r0 + rows_per_block) * cols;
  const int hr = rows / 2;
  const int hc = cols / 2;
  for (int g = blockIdx.y; g < surfaces; g += gridDim.y) {
    const float* s = surf + (long long)g * rows * cols;
    Peak best{-INFINITY, INT_MAX};
    if constexpr (VEC) {
      const float4* p = reinterpret_cast<const float4*>(s);
      const int q1 = f1 / 4;
      for (int q = f0 / 4 + threadIdx.x; q < q1; q += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (q + u * kThreads < q1) v[u] = __ldcs(p + q + u * kThreads);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (q + u * kThreads >= q1) break;
          const int f = 4 * (q + u * kThreads);
          offer(best, v[u].x, f, cols, rows, hr, hc);
          offer(best, v[u].y, f + 1, cols, rows, hr, hc);
          offer(best, v[u].z, f + 2, cols, rows, hr, hc);
          offer(best, v[u].w, f + 3, cols, rows, hr, hc);
        }
      }
    } else {
      for (int f = f0 + threadIdx.x; f < f1; f += kThreads) {
        offer(best, __ldcs(s + f), f, cols, rows, hr, hc);
      }
    }
    best = block_best(best);
    if (threadIdx.x == 0) {
      const long long k = (long long)g * gridDim.x + blockIdx.x;
      part_v[k] = best.v;
      part_i[k] = best.i;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    surface_peak_final_kernel(const float* __restrict__ part_v,
                              const int* __restrict__ part_i,
                              long long* __restrict__ out, int chunks) {
  const long long k0 = (long long)blockIdx.x * chunks;
  Peak best{-INFINITY, INT_MAX};
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const long long k = k0 + c;
    if (beats(part_v[k], part_i[k], best.v, best.i)) {
      best = Peak{part_v[k], part_i[k]};
    }
  }
  best = block_best(best);
  if (threadIdx.x == 0) out[blockIdx.x] = best.i;
}

}  // namespace

// surf: (surfaces, rows, cols) float32, contiguous, rows * cols <= 2^30;
// scratch: 2 * surfaces * chunks 4-byte words (the slices' values, then
// their indices); out: (surfaces,) int64, each surface's first maximum as
// its linear index in the fftshifted surface.  rows_per_block is a
// multiple of 4 and chunks = ceil(rows / rows_per_block).
extern "C" int oip_surface_peak(const void* surf, void* scratch, void* out,
                                int surfaces, int rows, int cols,
                                int rows_per_block, int chunks,
                                void* stream) {
  if (surfaces == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  float* part_v = static_cast<float*>(scratch);
  int* part_i = static_cast<int*>(scratch) + (long long)surfaces * chunks;
  const bool vec = reinterpret_cast<uintptr_t>(surf) % 16 == 0 &&
                   (long long)rows * cols % 4 == 0 && rows_per_block % 4 == 0;
  const dim3 grid(chunks, surfaces < 65535 ? surfaces : 65535);
  const float* s = static_cast<const float*>(surf);
  if (vec) {
    surface_peak_slices_kernel<true><<<grid, kThreads, 0, st>>>(
        s, part_v, part_i, surfaces, rows, cols, rows_per_block);
  } else {
    surface_peak_slices_kernel<false><<<grid, kThreads, 0, st>>>(
        s, part_v, part_i, surfaces, rows, cols, rows_per_block);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  surface_peak_final_kernel<<<surfaces, kThreads, 0, st>>>(
      part_v, part_i, static_cast<long long*>(out), chunks);
  return static_cast<int>(cudaGetLastError());
}

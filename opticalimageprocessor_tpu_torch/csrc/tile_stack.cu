// Kernel (h): the registration's float32 tile stack, written once from the
// uint16 rows: the RRC where parameters are given (rrc.cuh, kernel (a)'s
// function, so the values are kernel (a)'s to the bit), the conversion to
// float32 and the tile layout, in one pass.
//
// Replaces no TPU kernel: the JAX package's registration cut its tiles with
// dynamic_slice, ran _rrc_math on them and cast them inside one jitted
// function (models/device_pipeline.py), which XLA fused into the FFT's
// input.  The port ran kernel (a) into a uint16 block, a cast, a torch.cat
// of the sections' tiles and a zero-width pad (a clone) before cuFFT: the
// stack written four times.  This kernel writes it once.
//
// The work: a run of n tiles of one section (its rows [a, a + rows), its
// columns [c0, c0 + n * cols) of a strip, with a leading band axis or
// none) goes to tiles [t0, t0 + n) of one contiguous (T, bands, rows, cols)
// float32 stack; pixel (band, r, j) of the run lands in tile j / cols,
// column j % cols.
//
// Bound on the H100: device-memory bandwidth, 2 bytes read and 4 written a
// pixel (the float64 RRC is a few operations a pixel, far below the card's
// float64 rate).  Design: a block takes one tile (of one band) and a chunk
// of kRowsPerBlock rows, whose float32 output is one contiguous run of the
// stack, and walks it linearly, four outputs an item stored as 16 bytes
// (the wrapper asks for an aligned stack and rows * cols divisible by 4),
// fed by one 8-byte load for the PAN (1228-px tiles, 8-byte aligned) and
// by 2-byte loads that step across the row ends for the 307-px band tiles
// (only 2-byte aligned).  The tile's columns' (k, b) are staged in shared
// memory once a block.  Walking the output, and not the source's columns
// across many tiles at once, keeps each block's writes in one stream: a
// column-per-thread form ran at ~45% of the bound at the scene's shapes.
// The grid covers (tiles x bands, row chunks).  Blocks of 512 threads and
// four items in flight a thread were the best of a sweep at the scene's
// shapes (256 / 512 / 1024 threads, 16 / 32 / 64 rows, unrolled 1 / 2 / 4
// times), ~2% ahead of the next.

#include <cuda_runtime.h>

#include <cstdint>

#include "rrc.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerBlock = 32;

// a uint16 value as float32, exactly: 2^23 + v as bits, less 2^23 (one
// float add in place of an integer-to-float conversion)
__device__ __forceinline__ float u16_to_f32(uint32_t v) {
  return __int_as_float(0x4B000000u | v) - 8388608.0f;
}

// VLOAD: an item's four sources are one aligned 8-byte word of one row
template <bool VLOAD, bool RRC>
__global__ void __launch_bounds__(kThreads)
    tile_stack_kernel(const uint16_t* __restrict__ src,
                      float* __restrict__ dst, const double* __restrict__ k,
                      const double* __restrict__ b, int bands, int rows,
                      int cols, long long src_row_stride,
                      long long src_band_stride, long long param_band_stride) {
  extern __shared__ double kb[];  // the tile's k, then its b
  const int tile = blockIdx.x / bands;
  const int band = blockIdx.x - tile * bands;
  const long long c0 = (long long)tile * cols;  // in the run's row
  if constexpr (RRC) {
    const long long p0 = band * param_band_stride + c0;
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      kb[c] = k[p0 + c];
      kb[cols + c] = b[p0 + c];
    }
    __syncthreads();
  }
  for (int r0 = blockIdx.y * kRowsPerBlock; r0 < rows;
       r0 += gridDim.y * kRowsPerBlock) {
    const uint16_t* s = src + band * src_band_stride +
                        (long long)r0 * src_row_stride + c0;
    float4* d = reinterpret_cast<float4*>(
        dst + (((size_t)tile * bands + band) * rows + r0) * cols);
    const int items = min(kRowsPerBlock, rows - r0) * cols / 4;
    // four items' loads in flight a thread
#pragma unroll 4
    for (int i = threadIdx.x; i < items; i += kThreads) {
      int r = i * 4 / cols;
      int c = i * 4 - r * cols;
      uint32_t v[4];
      int vc[4];
      if constexpr (VLOAD) {
        const uint2 w = __ldg(
            reinterpret_cast<const uint2*>(s + r * src_row_stride + c));
        v[0] = w.x & 0xFFFFu;
        v[1] = w.x >> 16;
        v[2] = w.y & 0xFFFFu;
        v[3] = w.y >> 16;
#pragma unroll
        for (int e = 0; e < 4; ++e) vc[e] = c + e;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = __ldg(s + r * src_row_stride + c);
          vc[e] = c;
          if (++c == cols) {
            c = 0;
            ++r;
          }
        }
      }
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[e] = u16_to_f32(RRC ? oip_rrc_pixel(static_cast<uint16_t>(v[e]),
                                              kb[vc[e]], kb[cols + vc[e]])
                              : v[e]);
      }
      d[i] = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
}

template <bool VLOAD, bool RRC>
int launch(const void* src, void* dst, const void* k, const void* b,
           int bands, int rows, int cols, int tiles, long long sr,
           long long sb, long long pb, cudaStream_t stream) {
  const int smem = RRC ? 16 * cols : 0;
  auto kernel = tile_stack_kernel<VLOAD, RRC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int row_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  dim3 grid(tiles * bands, row_blocks < 65535 ? row_blocks : 65535);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(src), static_cast<float*>(dst),
      static_cast<const double*>(k), static_cast<const double*>(b), bands,
      rows, cols, sr, sb, pb);
  return static_cast<int>(cudaGetLastError());
}

template <bool RRC>
int dispatch(const void* src, void* dst, const void* k, const void* b,
             int bands, int rows, int cols, int tiles, long long sr,
             long long sb, long long pb, cudaStream_t stream) {
  // 8-byte loads where every tile row starts aligned for them
  if (cols % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 8 == 0 &&
      sr % 4 == 0 && sb % 4 == 0) {
    return launch<true, RRC>(src, dst, k, b, bands, rows, cols, tiles, sr,
                             sb, pb, stream);
  }
  return launch<false, RRC>(src, dst, k, b, bands, rows, cols, tiles, sr, sb,
                            pb, stream);
}

}  // namespace

// src: a run's rows, (bands, rows, tiles * cols) uint16 with the given row
// and band strides (in elements, columns contiguous); dst: the run's first
// tile of a contiguous (T, bands, rows, cols) float32 stack, 16-byte
// aligned, with rows * cols divisible by 4 (tiles tiles are written); k, b:
// (bands, tiles * cols) float64 with band stride param_band_stride (0: one
// row of parameters for every band, columns contiguous), or both null for
// no RRC.  The RRC's (k, b) of a tile are staged in 16 * cols bytes of
// shared memory.
extern "C" int oip_tile_stack(const void* src, void* dst, const void* k,
                              const void* b, int bands, int rows, int cols,
                              int tiles, long long src_row_stride,
                              long long src_band_stride,
                              long long param_band_stride, void* stream) {
  if (bands == 0 || rows == 0 || tiles == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  return k != nullptr
             ? dispatch<true>(src, dst, k, b, bands, rows, cols, tiles,
                              src_row_stride, src_band_stride,
                              param_band_stride, st)
             : dispatch<false>(src, dst, k, b, bands, rows, cols, tiles,
                               src_row_stride, src_band_stride,
                               param_band_stride, st);
}

// Kernel (a): relative radiometric correction, dst = uint16(trunc(k*s + b))
// per column, with k and b float64.
//
// Replaces: opticalimageprocessor_tpu/ops/rrc.py::_rrc_pallas (body
// _rrc_kernel, math _rrc_math).  The TPU kernel rebuilt the double-precision
// result from float32 pieces (double-word arithmetic) because the TPU has no
// float64; Hopper has native float64, so this kernel evaluates the
// reference's expression directly (rrc.cuh) and takes k, b as doubles.
//
// Bound on the H100: device-memory bandwidth.  Each pixel is 2 bytes read
// and 2 bytes written, with one float64 multiply-add per pixel (the card's
// float64 rate is far above what the bytes need).  Design: one thread per
// column walks a run of rows, so k and b are loaded once into registers and
// a warp reads and writes 64 contiguous bytes per row; the grid covers
// (column blocks, row runs, batch).  The source may be a strided view of a
// strip (row and batch strides), so the registration tiles are corrected
// straight out of the raw strips without a copy.

#include <cuda_runtime.h>

#include "rrc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 32;

__global__ void __launch_bounds__(kThreads)
    rrc_kernel(const uint16_t* __restrict__ src, uint16_t* __restrict__ dst,
               const double* __restrict__ k, const double* __restrict__ b,
               int rows, int cols, long long src_row_stride,
               long long src_batch_stride) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  const int bi = blockIdx.z;
  const double kc = k[(size_t)bi * cols + c];
  const double bc = b[(size_t)bi * cols + c];
  const uint16_t* s = src + bi * src_batch_stride + c;
  uint16_t* d = dst + (size_t)bi * rows * cols + c;
  for (int r0 = blockIdx.y * kRowsPerBlock; r0 < rows;
       r0 += gridDim.y * kRowsPerBlock) {
    const int r1 = min(r0 + kRowsPerBlock, rows);
    for (int r = r0; r < r1; ++r) {
      d[(size_t)r * cols] = oip_rrc_pixel(s[r * src_row_stride], kc, bc);
    }
  }
}

}  // namespace

// src: (batch, rows, cols) uint16 with the given row/batch strides (in
// elements, last dimension contiguous); dst: contiguous (batch, rows, cols);
// k, b: contiguous (batch, cols) float64.
extern "C" int oip_rrc(const void* src, void* dst, const void* k,
                       const void* b, int batch, int rows, int cols,
                       long long src_row_stride, long long src_batch_stride,
                       void* stream) {
  if (batch == 0 || rows == 0 || cols == 0) return 0;
  const int row_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  dim3 grid((cols + kThreads - 1) / kThreads,
            row_blocks < 65535 ? row_blocks : 65535, batch);
  rrc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(src), static_cast<uint16_t*>(dst),
      static_cast<const double*>(k), static_cast<const double*>(b), rows,
      cols, src_row_stride, src_batch_stride);
  return static_cast<int>(cudaGetLastError());
}

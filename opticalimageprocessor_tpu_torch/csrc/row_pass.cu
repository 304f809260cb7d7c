// Kernel (e): the vertical row pass of the staged band remap.
//
// Replaces: opticalimageprocessor_tpu/ops/resample.py::_fast_row_pass_pallas
// (its plain form _fast_row_pass_from_cu).  For output (y, x):
//
//   out[y, x] = sum_{v=0}^{U-1} cu[v, x] * padded[y + v, x]
//
// with padded (rows + U - 1, W) float32 (the column-interpolated strip with
// its row_bound + 1 rows above and row_bound + 2 below), cu (U, W) float32
// per-column weights, U = 2*row_bound + 4, out (rows, W) float32.  The sum
// starts from 0 and runs in v order with __fmul_rn/__fadd_rn, so nvcc
// cannot contract a multiply and an add into an FMA: the kernel rounds
// exactly like the plain PyTorch version (mul, then add, per v).
//
// The staged route carries the row bounds the fused kernel (c) cannot
// (row_bound > 6: the prestitch of a CMOS pair mounted more than 5 px
// apart vertically), so U has no compile-time limit here.
//
// Bound on the H100: device-memory bandwidth, ~4 bytes read and 4 written
// per output pixel (the (U-1)-row overlap of neighbouring row tiles adds
// (U-1)/kTileRows).  Design: a block owns kThreads columns and a tile of
// kTileRows output rows; a thread owns one column.  The block stages its
// columns' U weights in shared memory once, then each thread walks its
// rows reading padded[y + v, x] along x (a warp reads 128 contiguous bytes
// per row), the U-fold reuse of each input row served by L1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;

__global__ void __launch_bounds__(kThreads)
    row_pass_kernel(const float* __restrict__ padded,
                    const float* __restrict__ cu, float* __restrict__ out,
                    int rows, int width, int n_taps) {
  extern __shared__ float w_s[];   // (n_taps, kThreads)
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const bool col_ok = x < width;
  for (int v = 0; v < n_taps; ++v) {
    w_s[v * kThreads + threadIdx.x] =
        col_ok ? cu[(size_t)v * width + x] : 0.0f;
  }
  if (!col_ok) return;   // no barrier below: each thread reads its own column

  for (int r0 = blockIdx.y * kTileRows; r0 < rows;
       r0 += gridDim.y * kTileRows) {
    const int r_end = min(r0 + kTileRows, rows);
    for (int y = r0; y < r_end; ++y) {
      const float* p = padded + (size_t)y * width + x;
      float acc = 0.0f;
      for (int v = 0; v < n_taps; ++v) {
        acc = __fadd_rn(acc, __fmul_rn(p[(size_t)v * width],
                                       w_s[v * kThreads + threadIdx.x]));
      }
      out[(size_t)y * width + x] = acc;
    }
  }
}

}  // namespace

// padded: contiguous (rows + n_taps - 1, width) float32; cu: contiguous
// (n_taps, width) float32; out: contiguous (rows, width) float32.
extern "C" int oip_row_pass(const void* padded, const void* cu, void* out,
                            int rows, int width, int n_taps, void* stream) {
  if (rows < 0 || width < 0 || n_taps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || width == 0) return 0;
  const size_t smem = (size_t)n_taps * kThreads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int row_tiles = (rows + kTileRows - 1) / kTileRows;
  dim3 grid((width + kThreads - 1) / kThreads,
            row_tiles < 65535 ? row_tiles : 65535);
  row_pass_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(padded), static_cast<const float*>(cu),
      static_cast<float*>(out), rows, width, n_taps);
  return static_cast<int>(cudaGetLastError());
}

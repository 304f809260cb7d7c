// Kernel (c): band alignment remap, one launch per band.
//
// Replaces: opticalimageprocessor_tpu/ops/resample.py::_remap_fused_pallas
// (the contract of remap_band_fast_chunked; JAX's default
// _remap_fast_over_padded computes the same math).  For output (y, x):
//
//   colg[r, x] = sum_b wx_b(x) * src[r, tap0(x) + b]          column cubic
//   out[y, x]  = sum_a wy_a(x) * colg[y + floor(G(x)) + a - 1, x]
//
// with mapx = (cx1*xx + cx0 + xx)/4, G(x) = (cy2*xx*xx + cy1*xx + cy0)/4,
// xx = 4x, rows outside the strip reading 0, then rint (half to even),
// clip to [0, 65535] and uint16.  The TPU kernel ran the column pass as a
// banded (B+2H) x B matrix on its matrix unit; here each output column
// takes its 4 taps directly, with the matrix's semantics kept: a tap
// outside the image or outside its block's [start-H, start+B+H) window is
// dropped, and a vertical tap whose offset floor(G)+a-1 falls outside
// [-row_bound-1, row_bound+2] is dropped like the TPU kernel's U vertical
// weights.
//
// Bound on the H100: device-memory bandwidth (2 bytes read and 2 written
// per pixel; ~30 float32 operations per pixel).  Design: one launch covers
// the whole band with a grid over (column blocks, row tiles).  A block
// stages its (tile+U-1) x (B+2H) uint16 source window in shared memory
// (so overlapping neighbours' taps are read from device memory once per
// block), runs the column pass once per window row into a shared float32
// buffer, then the 4 vertical taps per output pixel.  One thread per
// column computes that column's taps and weights once.

#include <cuda_runtime.h>

#include <cstdint>

#include "remap_common.cuh"

namespace {

constexpr int kTileRows = 32;

__global__ void remap_band_kernel(const uint16_t* __restrict__ src,
                                  uint16_t* __restrict__ dst, int rows,
                                  int width, int block, int halo,
                                  int row_bound,
                                  const float* __restrict__ cx,
                                  const float* __restrict__ cy) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_taps_v = 2 * row_bound + 4;           // U
  const int win_rows = kTileRows + n_taps_v - 1;
  const int win_cols = block + 2 * halo;
  uint16_t* win = reinterpret_cast<uint16_t*>(smem);
  const int win_bytes = ((win_rows * win_cols * 2) + 15) / 16 * 16;
  float* colg = reinterpret_cast<float*>(smem + win_bytes);

  const int r0 = blockIdx.y * kTileRows;
  const int c0 = blockIdx.x * block - halo;
  const int top = r0 - row_bound - 1;   // strip row of window row 0
  for (int i = threadIdx.x; i < win_rows * win_cols; i += blockDim.x) {
    const int r = top + i / win_cols;
    const int c = c0 + i % win_cols;
    win[i] = (r >= 0 && r < rows && c >= 0 && c < width)
                 ? src[(size_t)r * width + c]
                 : static_cast<uint16_t>(0);
  }
  __syncthreads();

  const float cx0 = cx[0], cx1 = cx[1];
  const float cy0 = cy[0], cy1 = cy[1], cy2 = cy[2];
  const int x = blockIdx.x * block + threadIdx.x;
  float wx[4];
  const int loc0 = oip_col_taps(x, cx0, cx1, width, block, halo, wx);
  for (int wr = 0; wr < win_rows; ++wr) {
    colg[wr * block + threadIdx.x] =
        oip_col_interp(win + wr * win_cols, loc0, wx, win_cols);
  }

  // per-column vertical offset G(x) and its 4 weights
  const float xx = __fmul_rn(static_cast<float>(x), 4.0f);
  const float g = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(cy2, xx), xx), __fmul_rn(cy1, xx)),
                cy0),
      4.0f);
  const float gf = floorf(g);
  const int iy0 = static_cast<int>(gf);
  float wy[4];
  oip_cubic_weights(__fsub_rn(g, gf), wy);
  int off[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int u = iy0 + a - 1;
    if (u < -row_bound - 1 || u > row_bound + 2) {
      wy[a] = 0.0f;
      off[a] = 0;
    } else {
      off[a] = u + row_bound + 1;   // window row of output row 0's tap
    }
  }
  const int r_end = min(kTileRows, rows - r0);
  for (int r = 0; r < r_end; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      acc = __fadd_rn(acc, __fmul_rn(colg[(r + off[a]) * block + threadIdx.x],
                                     wy[a]));
    }
    dst[(size_t)(r0 + r) * width + x] = oip_round_u16(acc);
  }
}

}  // namespace

// src, dst: contiguous (rows, width) uint16; width % block == 0.
// cx (2,), cy (3,): the fitted float32 coefficients, in device memory (so
// a transform never waits for them on the host).
extern "C" int oip_remap_band(const void* src, void* dst, int rows, int width,
                              int block, int halo, int row_bound,
                              const void* cx, const void* cy, void* stream) {
  if (block < 1 || block > 1024 || width % block != 0 || halo < 0 ||
      row_bound < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int win_rows = kTileRows + 2 * row_bound + 3;
  const int win_cols = block + 2 * halo;
  const size_t smem = (size_t)((win_rows * win_cols * 2) + 15) / 16 * 16 +
                      (size_t)win_rows * block * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        remap_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(width / block, (rows + kTileRows - 1) / kTileRows);
  remap_band_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(src), static_cast<uint16_t*>(dst), rows,
      width, block, halo, row_bound, static_cast<const float*>(cx),
      static_cast<const float*>(cy));
  return static_cast<int>(cudaGetLastError());
}

// Kernel (d): the dual-CMOS stitch tail in one launch.
//
// Replaces: opticalimageprocessor_tpu/ops/resample.py::
// _stitch_prestt_fused_pallas plus the seam concat of
// remap_const_stitch_chunked.  Writes the stitched (rows, 2*(W-fold))
// raster directly:
//
//   stitched[y, c] = RRC(PAN1)[y, c]                 for c <  W - fold
//   stitched[y, c] = prestt[y, c - W + 2*fold]       for c >= W - fold
//   prestt[y, x]   = u16(rint(sum_a wy_a * colg[y + iy0 + a - 1, x]))
//   colg[r, x]     = column cubic of RRC(PAN2) row r at mapx = x + dx
//
// with iy0 = floor(dy), wy from dy - iy0, the column taps of kernel (c)
// with cx = [4*dx, 0], and strip rows outside [0, rows) reading 0 AFTER
// the RRC (the reference's BORDER_CONSTANT on the corrected image).  The
// RRC is kernel (a)'s per-pixel function (rrc.cuh), exact float64.  An
// optional second output (nullable pointer) receives prestt itself.
//
// Bound on the H100: device-memory bandwidth (PAN1 and PAN2 read once,
// the stitched raster written once: ~6 bytes per output pixel pair).
// Design: the grid's first column blocks copy RRC(PAN1) into the left half
// (one thread per column, params in registers); the others stage a
// (tile+3) x (B+2H) window of RRC'd PAN2 in shared memory at the row offset
// iy0 (so the traced shift costs nothing), run the column pass once per
// window row and the 4 vertical taps per output pixel.  The corrected
// strips and the prestitched PAN2 never reach device memory unless asked.

#include <cuda_runtime.h>

#include <cstdint>

#include "remap_common.cuh"
#include "rrc.cuh"

namespace {

constexpr int kTileRows = 32;

__global__ void stitch_tail_kernel(
    const uint16_t* __restrict__ pan1, const uint16_t* __restrict__ pan2,
    const double* __restrict__ k1, const double* __restrict__ b1,
    const double* __restrict__ k2, const double* __restrict__ b2,
    uint16_t* __restrict__ stitched, uint16_t* __restrict__ prestt, int rows,
    int width, int fold, int block, int halo, int n_left, float dx,
    float dy) {
  const int r0 = blockIdx.y * kTileRows;
  const int r_end = min(kTileRows, rows - r0);
  const int out_w = 2 * (width - fold);

  if (static_cast<int>(blockIdx.x) < n_left) {
    // left half: RRC(PAN1) columns [0, W - fold)
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= width - fold) return;
    const double kc = k1[c];
    const double bc = b1[c];
    for (int r = 0; r < r_end; ++r) {
      stitched[(size_t)(r0 + r) * out_w + c] =
          oip_rrc_pixel(pan1[(size_t)(r0 + r) * width + c], kc, bc);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const int win_rows = kTileRows + 3;
  const int win_cols = block + 2 * halo;
  float* win = reinterpret_cast<float*>(smem);
  float* colg = win + win_rows * win_cols;

  const int nb = blockIdx.x - n_left;
  const float dyf = floorf(dy);
  const int iy0 = static_cast<int>(dyf);
  const int top = r0 + iy0 - 1;        // strip row of window row 0
  const int c0 = nb * block - halo;
  for (int i = threadIdx.x; i < win_rows * win_cols; i += blockDim.x) {
    const int r = top + i / win_cols;
    const int c = c0 + i % win_cols;
    float v = 0.0f;
    if (r >= 0 && r < rows && c >= 0 && c < width) {
      v = static_cast<float>(
          oip_rrc_pixel(pan2[(size_t)r * width + c], k2[c], b2[c]));
    }
    win[i] = v;
  }
  __syncthreads();

  const int x = nb * block + threadIdx.x;
  float wx[4];
  const int loc0 = oip_col_taps(x, __fmul_rn(4.0f, dx), 0.0f, width, block,
                                halo, wx);
  for (int wr = 0; wr < win_rows; ++wr) {
    colg[wr * block + threadIdx.x] =
        oip_col_interp(win + wr * win_cols, loc0, wx, win_cols);
  }
  float wy[4];
  oip_cubic_weights(__fsub_rn(dy, dyf), wy);
  for (int r = 0; r < r_end; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      acc = __fadd_rn(acc,
                      __fmul_rn(colg[(r + a) * block + threadIdx.x], wy[a]));
    }
    const uint16_t v = oip_round_u16(acc);
    if (prestt != nullptr) prestt[(size_t)(r0 + r) * width + x] = v;
    if (x >= fold) {
      stitched[(size_t)(r0 + r) * out_w + (width - fold) + (x - fold)] = v;
    }
  }
}

}  // namespace

// pan1, pan2: contiguous (rows, width) uint16; k1, b1, k2, b2: (width,)
// float64; stitched: contiguous (rows, 2*(width-fold)) uint16; prestt:
// contiguous (rows, width) uint16 or null.  width % block == 0.
extern "C" int oip_stitch_tail(const void* pan1, const void* pan2,
                               const void* k1, const void* b1, const void* k2,
                               const void* b2, void* stitched, void* prestt,
                               int rows, int width, int fold, int block,
                               int halo, float dx, float dy, void* stream) {
  if (block < 1 || block > 1024 || width % block != 0 || halo < 0 ||
      fold < 0 || fold >= width)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int win_rows = kTileRows + 3;
  const size_t smem =
      (size_t)win_rows * (block + 2 * halo) * 4 + (size_t)win_rows * block * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stitch_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_left = (width - fold + block - 1) / block;
  dim3 grid(n_left + width / block, (rows + kTileRows - 1) / kTileRows);
  stitch_tail_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(pan1), static_cast<const uint16_t*>(pan2),
      static_cast<const double*>(k1), static_cast<const double*>(b1),
      static_cast<const double*>(k2), static_cast<const double*>(b2),
      static_cast<uint16_t*>(stitched), static_cast<uint16_t*>(prestt), rows,
      width, fold, block, halo, n_left, dx, dy);
  return static_cast<int>(cudaGetLastError());
}

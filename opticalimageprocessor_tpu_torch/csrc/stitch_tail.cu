// Kernel (d): the dual-CMOS stitch tail in one launch, as a streaming pass.
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
// with cx = [4*dx, 0] (taps outside the image or outside the column's
// block +- halo window dropped: the reference's banded column matrix), and
// strip rows outside [0, rows) reading 0 AFTER the RRC (the reference's
// BORDER_CONSTANT on the corrected image).  The RRC is kernel (a)'s
// per-pixel function (rrc.cuh), exact float64.  An optional second output
// (nullable pointer) receives prestt itself.
//
// Bound on the H100: device memory.  PAN1 and PAN2 are read once and the
// stitched raster written once: at 32768 x 12288, 1.61 GB read and 1.58 GB
// written, 0.95 ms at 3.35 TB/s.  Design:
//
// * Every thread owns 8 adjacent columns: 16-byte loads of PAN1 and PAN2
//   and 16-byte stores of the stitched row (scalar stores only where a row
//   segment is not 16-byte aligned or is cut by the seam, e.g. the right
//   half's first columns, or every row for a fold with W - fold not a
//   multiple of 4).  Their RRC parameters stay in registers.
// * Blocks of 256 threads walk tiles of 128 rows.  Left-half blocks stream
//   RRC(PAN1), 2048 columns, 4 rows at a time.  Right-half blocks keep the
//   4 vertical taps as a rolling window of column-interpolated rows in
//   registers.  Their warps split in two: 4 stager warps RRC one 1024-column
//   PAN2 row segment into shared memory per step, loading two rows ahead;
//   4 interpolator warps take the column cubic of the row staged one step
//   earlier (tap weights computed once, in registers) and emit one output
//   row of the segment's 1024 - 2 * reach inner columns (reach: the column
//   reach of dx, 16 for |dx| < 14).  One barrier a step; the 3 halo rows
//   cost 3/131 of the tile, the reach 2*reach/1024 of the columns.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "remap_common.cuh"
#include "rrc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLeftSpan = 8 * kThreads;   // left-half columns per block
constexpr int kGroup = 128;               // stager / interpolator threads
constexpr int kSeg = 8 * kGroup;          // staged PAN2 columns per block
constexpr int kTileRows = 128;            // output rows per block
constexpr int kMaxReach = 128;            // columns staged beyond each side

// staged segment element p -> shared-memory float index (one pad word per
// 8: threads reading 8-apart elements hit distinct banks)
__device__ __forceinline__ int seg_addr(int p) { return p + (p >> 3); }

__device__ __forceinline__ uint4 ld16(const uint16_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(uint4 v, uint16_t s[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[2 * i] = static_cast<uint16_t>(w[i] & 0xFFFF);
    s[2 * i + 1] = static_cast<uint16_t>(w[i] >> 16);
  }
}

__device__ __forceinline__ uint4 pack8(const uint16_t s[8]) {
  return make_uint4(s[0] | (uint32_t(s[1]) << 16), s[2] | (uint32_t(s[3]) << 16),
                    s[4] | (uint32_t(s[5]) << 16), s[6] | (uint32_t(s[7]) << 16));
}

// row[col + e] = v[e] for the e with lo <= col + e < hi: one 16-byte store
// when all 8 are in range and the address is aligned, else scalar stores
__device__ __forceinline__ void store8(uint16_t* row, int col,
                                       const uint16_t v[8], int lo, int hi) {
  uint16_t* p = row + col;
  if (col >= lo && col + 8 <= hi &&
      (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = pack8(v);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (col + e >= lo && col + e < hi) p[e] = v[e];
  }
}

// the block-wide barrier, in its non-aligned form: the stager and the
// interpolator warps reach it from different code (bar.sync, which
// __syncthreads compiles to, requires one and the same instruction)
__device__ __forceinline__ void block_barrier() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

// RRC(PAN2) of 8 columns [c, c + 8) of strip row sr into the staged
// segment at element p (0 outside the strip or the image)
__device__ __forceinline__ void stage8(float* dst, int p, uint4 raw, bool in,
                                       const double k[8], const double b[8]) {
  uint16_t s[8];
  unpack8(raw, s);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dst[seg_addr(p + e)] =
        in ? static_cast<float>(oip_rrc_pixel(s[e], k[e], b[e])) : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, 2) stitch_tail_kernel(
    const uint16_t* __restrict__ pan1, const uint16_t* __restrict__ pan2,
    const double* __restrict__ k1, const double* __restrict__ b1,
    const double* __restrict__ k2, const double* __restrict__ b2,
    uint16_t* __restrict__ stitched, uint16_t* __restrict__ prestt, int rows,
    int width, int fold, int block, int halo, int n_left, int reach,
    float dx, float dy) {
  const int r0 = blockIdx.y * kTileRows;
  const int r_end = min(r0 + kTileRows, rows);
  const int left_w = width - fold;
  const size_t out_w = 2 * static_cast<size_t>(left_w);
  const int tid = threadIdx.x;

  if (static_cast<int>(blockIdx.x) < n_left) {
    // left half: RRC(PAN1) columns [0, W - fold), 8 a thread, 4 rows a step
    const int c = blockIdx.x * kLeftSpan + 8 * tid;
    if (c >= left_w) return;
    double kc[8], bc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      kc[e] = k1[c + e];
      bc[e] = b1[c + e];
    }
    for (int y = r0; y < r_end; y += 4) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (y + u < r_end) raw[u] = ld16(pan1 + (size_t)(y + u) * width + c);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (y + u >= r_end) break;
        uint16_t s[8];
        unpack8(raw[u], s);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e] = oip_rrc_pixel(s[e], kc[e], bc[e]);
        store8(stitched + (size_t)(y + u) * out_w, c, s, 0, left_w);
      }
    }
    return;
  }

  // right half: prestt columns [x_block, x_block + span), span = 1024 -
  // 2 * reach, from the staged segment [x_block - reach, x_block - reach +
  // 1024).  Step j stages strip row r0 + iy0 - 1 + j (threads 0-127, one
  // 8-column chunk each) while the interpolators (threads 128-255) take the
  // column cubic of the row staged at step j - 1 and, from the 4th row on,
  // emit one output row.
  extern __shared__ __align__(16) float smem[];
  const int seg_floats = seg_addr(kSeg);
  const int span = kSeg - 2 * reach;
  const int x_block = (blockIdx.x - n_left) * span;
  const int seg_start = x_block - reach;           // a multiple of 8
  const float dyf = floorf(dy);
  const int iy0 = static_cast<int>(dyf);
  const int n_steps = (r_end - r0) + 3;            // strip rows to stage

  if (tid < kGroup) {
    // stager: chunk tid, segment columns [8 tid, 8 tid + 8)
    const int c = seg_start + 8 * tid;
    const bool c_in = c >= 0 && c < width;
    double kc[8], bc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      kc[e] = c_in ? k2[c + e] : 0.0;
      bc[e] = c_in ? b2[c + e] : 0.0;
    }
    auto load = [&](int j, int col) -> uint4 {
      const int sr = r0 + iy0 - 1 + j;
      if (sr < 0 || sr >= rows || col < 0 || col >= width)
        return make_uint4(0, 0, 0, 0);
      return ld16(pan2 + (size_t)sr * width + col);
    };
    auto row_in = [&](int j) {
      const int sr = r0 + iy0 - 1 + j;
      return sr >= 0 && sr < rows;
    };
    uint4 ahead0 = load(0, c);
    uint4 ahead1 = n_steps > 1 ? load(1, c) : make_uint4(0, 0, 0, 0);
    for (int j = 0; j <= n_steps; ++j) {
      if (j < n_steps) {
        const uint4 cur = ahead0;
        ahead0 = ahead1;
        if (j + 2 < n_steps) ahead1 = load(j + 2, c);
        float* buf = smem + (j & 1) * seg_floats;
        stage8(buf, 8 * tid, cur, c_in && row_in(j), kc, bc);
      }
      block_barrier();
    }
    return;
  }

  // interpolator: column taps of its 8 columns, in registers: weights and
  // the first tap relative to the segment
  const int x0 = x_block + 8 * (tid - kGroup);
  const bool x_ok = 8 * (tid - kGroup) < span && x0 < width;
  int p0[8];
  float w[8][4];
  {
    const float cx0 = __fmul_rn(4.0f, dx);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int x = x_ok ? min(x0 + e, width - 1) : x_block;
      const int loc0 = oip_col_taps(x, cx0, 0.0f, width, block, halo, w[e]);
      p0[e] = loc0 + (x / block) * block - halo - seg_start;
    }
  }
  float wy[4];
  oip_cubic_weights(__fsub_rn(dy, dyf), wy);
  // rolling window of column-interpolated rows (initialised: its first
  // rotations read entries no row has filled yet)
  float win[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int e = 0; e < 8; ++e) win[a][e] = 0.0f;
  }
  for (int j = 0; j <= n_steps; ++j) {
    if (j >= 1) {
      const float* buf = smem + ((j - 1) & 1) * seg_floats;
      // column cubic of strip row j - 1 (every tap lies in the segment)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // recompute the 4 tap addresses every step rather than keep 32 of
        // them live across the loop
        int q = p0[e];
        asm volatile("" : "+r"(q));
        float acc = 0.0f;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc = __fadd_rn(acc, __fmul_rn(buf[seg_addr(q + b)], w[e][b]));
        }
        win[0][e] = win[1][e];
        win[1][e] = win[2][e];
        win[2][e] = win[3][e];
        win[3][e] = acc;
      }
      if (j >= 4 && x_ok) {
        // output row y from the 4 window rows, in tap order from 0
        const int y = r0 + j - 4;
        uint16_t v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float acc = 0.0f;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc = __fadd_rn(acc, __fmul_rn(win[a][e], wy[a]));
          }
          v[e] = oip_round_u16(acc);
        }
        if (prestt != nullptr) {
          store8(prestt + (size_t)y * width, x0, v, 0, width);
        }
        // prestt column x lands at stitched column x - fold + (W - fold)
        store8(stitched + (size_t)y * out_w + left_w, x0 - fold, v, 0, left_w);
      }
    }
    block_barrier();
  }
}

}  // namespace

// pan1, pan2: contiguous (rows, width) uint16; k1, b1, k2, b2: (width,)
// float64; stitched: contiguous (rows, 2*(width-fold)) uint16; prestt:
// contiguous (rows, width) uint16 or null.  width % block == 0, width % 8
// == 0, |dx| < 120.
extern "C" int oip_stitch_tail(const void* pan1, const void* pan2,
                               const void* k1, const void* b1, const void* k2,
                               const void* b2, void* stitched, void* prestt,
                               int rows, int width, int fold, int block,
                               int halo, float dx, float dy, void* stream) {
  if (block < 1 || width % block != 0 || width % 8 != 0 || halo < 0 ||
      fold < 0 || fold >= width || !(fabsf(dx) < 120.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  // a tap of column x lies within floor(dx) - 1 .. floor(dx) + 2 of x
  const int reach = ((static_cast<int>(fabsf(floorf(dx))) + 3 + 7) / 8) * 8;
  if (reach > kMaxReach) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * (size_t)(kSeg + kSeg / 8) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stitch_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_left = (width - fold + kLeftSpan - 1) / kLeftSpan;
  const int span = kSeg - 2 * reach;
  const int n_right = (width + span - 1) / span;
  dim3 grid(n_left + n_right, (rows + kTileRows - 1) / kTileRows);
  stitch_tail_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(pan1), static_cast<const uint16_t*>(pan2),
      static_cast<const double*>(k1), static_cast<const double*>(b1),
      static_cast<const double*>(k2), static_cast<const double*>(b2),
      static_cast<uint16_t*>(stitched), static_cast<uint16_t*>(prestt), rows,
      width, fold, block, halo, n_left, reach, dx, dy);
  return static_cast<int>(cudaGetLastError());
}

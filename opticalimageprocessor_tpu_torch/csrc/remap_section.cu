// Kernel (f): the parity remap of one section, cv::remap INTER_CUBIC /
// BORDER_CONSTANT(0) on uint16 with float32 maps.
//
// Replaces: opticalimageprocessor_tpu/ops/resample.py::_remap_section_math
// (run by _remap_section_jit as one XLA program a section; the TPU has no
// Pallas kernel for it).  The contract is the port's plain version,
// ops/resample.py::_remap_section_plain.  For output row y of [first,
// first + count) of a (rows, W) section whose row 0 is map row origin, and
// column x, with Y = y + origin:
//
//   v  = float32((double)Y + g[x])                       the reference's mapy
//   quantized:  s = rint(32 v), iy = clamp(s >> 5, -32768, 32767),
//               fy = (s & 31) / 32                       (OpenCV <= 4.x)
//   continuous: iy = floor(v), fy = v - floor(v)         (OpenCV 5.x)
//   out = sum_a sum_b src[iy - origin - 1 + a, tap0[x] + b]
//                     * float32(wy_a(fy) * wx[b, x])
//
// each tap row summed ((p0 + p1) + p2) + p3 and the rows in order, then
// rint (half to even), clip to [0, 65535] and uint16.  Taps outside the
// section's rows or columns read 0.  A pixel whose row offset iy - Y lies
// outside [r_lo, r_hi] (the plan's row_offsets; only rows where quantized
// coordinates saturate at int16) is 0, the JAX package's rule.  Every
// operation is one IEEE-rounded intrinsic in the plain version's order, so
// nvcc cannot contract a multiply and an add into an FMA: the kernel is bit
// for bit the plain version, and with it the numpy cv::remap oracle.
//
// Bound on the H100: device-memory bytes, 2 read and 2 written a pixel
// (0.440 ms for a 30000 x 12288 section at 3.35 TB/s), with its ~75
// float32 operations a pixel (0.41 ms at 67 TFLOP/s) close behind.
//
// Design (right and simple first; no shape limit): a thread owns one
// column and loads that column's plan values (tap0, the 4 column weights,
// g, which taps lie inside the width) once; it then walks kRows output rows.
// Neighbouring threads own neighbouring columns, so each of a pixel's 16
// uint16 tap reads is coalesced across the warp, and L1 / L2 serve the 4x
// reuse of each source row by the rows below it.  The row tiles stride
// over gridDim.y, so any row count is taken.  uint16 -> float goes
// through a float bit trick, exact, instead of a conversion instruction.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 7):
// 4.29 ms a 30000 x 12288 section, 10% of the byte bound.  It is
// issue-bound: the per-tap bounds predicates and 64-bit addresses make
// ~300 instructions a pixel.  A staged shared-memory tile that reads each
// 4x4 support once, with no per-tap bounds, is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "remap_common.cuh"

namespace {

constexpr int kThreads = 128;   // columns a block
constexpr int kRows = 16;       // output rows a thread walks
constexpr int kMaxGridY = 65535;

// float(u) for a uint16 u, exactly: the float 2^23 + u minus 2^23
__device__ __forceinline__ float u16_to_float(uint32_t u) {
  return __fsub_rn(__uint_as_float(0x4B000000u | u), 8388608.0f);
}

__global__ void __launch_bounds__(kThreads)
    remap_section_kernel(const uint16_t* __restrict__ src,
                         const int* __restrict__ col_tap0,
                         const float* __restrict__ wx,
                         const double* __restrict__ g,
                         uint16_t* __restrict__ out, int rows, int width,
                         long long first, long long count, long long origin,
                         int quantized, int r_lo, int r_hi) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= width) return;
  const int c0 = col_tap0[x];
  float w[4];
  bool col_in[4];
  int col[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    w[b] = wx[static_cast<size_t>(b) * width + x];
    col_in[b] = c0 + b >= 0 && c0 + b < width;
    col[b] = col_in[b] ? c0 + b : 0;
  }
  const double gx = g[x];
  const long long n_tiles = (count + kRows - 1) / kRows;
  for (long long tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const long long y_end = min(count, (tile + 1) * kRows);
    for (long long k = tile * kRows; k < y_end; ++k) {
      const long long y = first + k;        // the section's row
      const long long Y = y + origin;       // its map row
      const float v =
          __double2float_rn(__dadd_rn(static_cast<double>(Y), gx));
      long long iy;
      float fy;
      if (quantized) {
        const long long s =
            static_cast<long long>(rintf(__fmul_rn(v, 32.0f)));
        iy = min(max(s >> 5, -32768LL), 32767LL);
        fy = __fmul_rn(static_cast<float>(static_cast<int>(s & 31)),
                       1.0f / 32.0f);
      } else {
        const float fl = floorf(v);
        iy = static_cast<long long>(fl);
        fy = __fsub_rn(v, fl);
      }
      float acc = 0.0f;
      const long long r_off = iy - Y;
      if (r_off >= r_lo && r_off <= r_hi) {
        float wy[4];
        oip_cubic_weights(fy, wy);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const long long r = iy - origin - 1 + a;   // the section's row
          const bool row_in = r >= 0 && r < rows;
          const uint16_t* line = src + (row_in ? r : 0) * width;
          float p[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t u = row_in && col_in[b] ? line[col[b]] : 0u;
            p[b] = __fmul_rn(u16_to_float(u), __fmul_rn(wy[a], w[b]));
          }
          const float t = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), p[2]),
                                    p[3]);
          acc = a == 0 ? t : __fadd_rn(acc, t);
        }
      }
      out[k * width + x] = oip_round_u16(acc);
    }
  }
}

}  // namespace

// src (rows, width) uint16; col_tap0 (width,) int32; wx (4, width) float32;
// g (width,) float64; out (count, width) uint16 = output rows [first,
// first + count) of the section.  Returns the launch's cudaError_t.
extern "C" int oip_remap_section(const void* src, const void* col_tap0,
                                 const void* wx, const void* g, void* out,
                                 int rows, int width, long long first,
                                 long long count, long long origin,
                                 int quantized, int r_lo, int r_hi,
                                 void* stream) {
  if (rows < 0 || width < 0 || first < 0 || count < 0 ||
      first + count > rows || r_lo > r_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0 || width == 0) return 0;
  const long long n_tiles = (count + kRows - 1) / kRows;
  const dim3 grid((width + kThreads - 1) / kThreads,
                  static_cast<unsigned>(n_tiles < kMaxGridY ? n_tiles
                                                            : kMaxGridY));
  remap_section_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(src), static_cast<const int*>(col_tap0),
      static_cast<const float*>(wx), static_cast<const double*>(g),
      static_cast<uint16_t*>(out), rows, width, first, count, origin,
      quantized, r_lo, r_hi);
  return static_cast<int>(cudaGetLastError());
}

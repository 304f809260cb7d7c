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
// (0.440 ms for a 30000 x 12288 section at 3.35 TB/s).  The least float32
// work a pixel is 16 products, 15 sums and the rounding, ~34 operations;
// none may fuse into an FMA, so each is one instruction at half the 67
// TFLOP/s that counts an FMA as two (0.37 ms for that section).
//
// Design.  The first version (a thread a column, 16 taps read straight from
// device memory behind bounds selects, 64-bit addresses) took ~300
// instructions a pixel and was issue-bound.  This one removes the work that
// repeats down a column:
//
// * A block owns 256 output columns (2 adjacent ones a thread, stored as
//   one 4-byte word) and a chunk of output rows, walked in bands.  Each
//   band's source window -- the rows its pixels' row offsets can reach
//   and the columns from the block's least tap to its greatest plus 3,
//   from the host's table (ops/resample.py::remap_section_geometry) -- is
//   copied once into shared memory as uint16 with 16-byte cp.async copies,
//   zeros where it leaves the section, while the band before it is
//   computed (two buffers).  Taps are then read with 32-bit shared offsets
//   and no bounds predicate.
// * Rows reused down a column: a thread keeps its columns' 4 x 4 converted
//   taps in a register ring.  When a row's iy is the previous row's plus
//   one (its row offset unchanged) it reads and converts the one new
//   source row's 4 taps; any other step reloads the ring.  The loop is
//   unrolled by 4 so that the ring's slots are static registers.
// * Coordinates and weights reused down a column: the 16 tap weights
//   W[a][b] are recomputed only when a row's fy (its float bits;
//   quantized, its table index s & 31) differs from the previous row's,
//   and the ring reloaded only when its row offset differs.  A row's map
//   coordinate is computed exactly, as the plain version does, only where
//   it may have changed: in the binade of |Y + g| (float32 steps of at
//   most 1/2) Y is an even number of steps, so v - Y, and with it iy - Y
//   and fy, stay the same until Y + g leaves the binade (settle() below);
//   the thread counts down the rows that certainly stay and runs four such
//   rows at a time with no coordinate work and no per-row branch.  The
//   weights are a pure function of fy, so this is exact whatever g is.
//   Quantized row weights come from a 32-entry table that the host builds
//   with the plain version's own arithmetic.
// * Narrow coordinates (|mapy| < 2^22 continuous, < 2^17 quantized, decided
//   on the host) take floor and rint by adding 1.5 * 2^23 in the float
//   unit (rounding down, or to nearest even) instead of conversion
//   instructions, and round the output the same way; uint16 -> float is a
//   float bit trick too.  Other coordinates take the generic conversions
//   and every row's exact coordinate (a template instance).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/remap_section_times.py): 0.82-0.85 ms a 30000 x 12288 section
// (the first version 4.4-4.7 ms), ~54 SASS instructions a pixel on the
// path of four staged rows, no FFMA.
//
// A column block whose double-buffered window does not fit in its shared
// memory budget takes fewer rows a band (down to 4); one that does not fit
// even so (a plan whose taps spread over hundreds of rows or columns in
// 256 output columns) reads its taps from device memory with bounds
// checks.  Sections of 2^31 elements or more take 64-bit element offsets.
// No shape is refused.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "remap_common.cuh"

namespace {

constexpr int kThreads = 128;            // a block; 2 columns a thread
constexpr int kCols = 2 * kThreads;      // output columns a block
constexpr int kSentinel = INT_MIN;       // the ring holds no rows
constexpr int kOutside = INT_MIN + 1;    // a row offset beyond the plan's
constexpr float kMagic = 12582912.0f;    // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;   // its float bits

// float(u) for a uint16 u, exactly: the float 2^23 + u minus 2^23
__device__ __forceinline__ float u16_to_float(uint32_t u) {
  return __fsub_rn(__uint_as_float(0x4B000000u | u), 8388608.0f);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One output column's state down its rows.
struct Column {
  float ring[4][4];   // converted taps: [slot][b]; support row a of output
                      // row k sits in slot (k + a) & 3
  float w[4][4];      // W[a][b] = float32(wy[a] * wx[b])
  double gx;          // g[x]
  int x;              // the column (clamped to the width)
  int tap0;           // its first column tap
  int colofs;         // bytes from the window's first column to tap0
  int off;            // bytes from a band row to the support's row 0
  int fro;            // the row offset it fetches at (staged: off's)
  int roff;           // the ring's row offset iy - Y, or kSentinel
  int key;            // what w was computed for: fy's bits or s & 31
};

struct Args {
  const uint16_t* src;
  const int* col_tap0;
  const float* wx;
  const double* g;
  const float* wy_table;   // (32, 4) quantized row weights
  const int* table;        // (column blocks, 5) window geometry
  uint16_t* out;
  long long rows, first, count, origin;
  int width, r_lo, r_hi, chunk, stage16;
};

// The 4 taps of one source row.  Staged: from the shared window at
// shared-space address addr (volatile: a band's loads stay between its
// barriers).  Direct: section row r from device memory, 0 outside.
template <bool kDirect, typename Off>
__device__ __forceinline__ void fetch(const Args& p, const Column& c,
                                      uint32_t addr, long long r,
                                      float dst[4]) {
  if constexpr (!kDirect) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      unsigned short u;
      asm volatile("ld.shared.u16 %0, [%1];\n"
                   : "=h"(u)
                   : "r"(addr + 2 * b)
                   : "memory");
      dst[b] = u16_to_float(u);
    }
  } else {
    const bool row_in = r >= 0 && r < p.rows;
    const uint16_t* line =
        p.src + static_cast<Off>(row_in ? r : 0) * static_cast<Off>(p.width);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = c.tap0 + b;
      const bool in = row_in && col >= 0 && col < p.width;
      dst[b] = u16_to_float(in ? line[in ? col : 0] : 0u);
    }
  }
}

template <bool kQuant>
__device__ __forceinline__ void set_weights(const Args& p, Column& c,
                                            int key) {
  float wy[4];
  if constexpr (kQuant) {
#pragma unroll
    for (int a = 0; a < 4; ++a) wy[a] = __ldg(p.wy_table + 4 * key + a);
  } else {
    oip_cubic_weights(__int_as_float(key), wy);
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float wxb = __ldg(p.wx + static_cast<size_t>(b) * p.width + c.x);
#pragma unroll
    for (int a = 0; a < 4; ++a) c.w[a][b] = __fmul_rn(wy[a], wxb);
  }
}

// The exact coordinate of map row y_map (section row y) in column c, the
// plain version's arithmetic: updates c's weights where fy changed and its
// ring's rows 0-2 (phase J) where the row offset changed; a pixel whose
// offset leaves [r_lo, r_hi] gets weights 0 (its value is 0) and a fetch
// address inside the window.  -> how many of the following rows certainly
// keep this row's offset and fy.
//
// Why they keep them: in the binade [2^e, 2^(e+1)) of |y_map + g|, with
// e <= 21, the float32 (and float64) grid step u is at most 1/2, so y_map
// is an even number of steps and rounding y_map + g gives y_map plus g
// rounded on that grid, whatever y_map is: v - y_map, hence iy - y_map and
// fy, and quantized s - 32 y_map, stay the same while y_map + g stays in
// the binade.  The count keeps a row's margin to its edge, and is 0 where
// v is a power of two (it may have been rounded up out of the binade
// below), below 1 in magnitude, quantized rows where iy saturates, and for
// coordinates that are not narrow.
template <int J, bool kQuant, bool kNarrow, bool kDirect, typename Off>
__device__ __forceinline__ int settle(const Args& p, Column& c,
                                      uint32_t rowpart, int pitch_b, int wlo,
                                      long long y_map, long long y) {
  const float v =
      __double2float_rn(__dadd_rn(static_cast<double>(y_map), c.gx));
  int roff, key, keep = 0;
  if constexpr (kNarrow) {
    const int yi = static_cast<int>(y_map);
    int sat = INT_MAX;
    if constexpr (kQuant) {
      const int s =
          __float_as_int(__fadd_rn(__fmul_rn(v, 32.0f), kMagic)) - kMagicBits;
      const int iy = s >> 5;
      const int iyc = min(max(iy, -32768), 32767);
      roff = iyc - yi;
      key = s & 31;
      sat = iyc == iy ? 32767 - iy : 0;
    } else {
      const float t = __fadd_rd(v, kMagic);   // floor(v) + 1.5 * 2^23
      roff = __float_as_int(t) - (kMagicBits + yi);
      key = __float_as_int(__fsub_rn(v, __fsub_rn(t, kMagic)));
    }
    const float av = fabsf(v);
    const int bits = __float_as_int(av);
    if (av >= 1.0f && (bits & 0x7FFFFF) != 0) {
      const float pw = __int_as_float(bits & 0x7F800000);   // 2^e
      const float d = v > 0.0f ? __fsub_rn(__fadd_rn(pw, pw), av)
                               : __fsub_rn(av, pw);          // exact
      keep = min(max(static_cast<int>(d) - 1, 0), sat);
    }
  } else {
    long long iy;
    if constexpr (kQuant) {
      const long long s = static_cast<long long>(rintf(__fmul_rn(v, 32.0f)));
      iy = min(max(s >> 5, -32768LL), 32767LL);
      key = static_cast<int>(s & 31);
    } else {
      const float fl = floorf(v);
      iy = static_cast<long long>(fl);
      key = __float_as_int(__fsub_rn(v, fl));
    }
    const long long r = iy - y_map;
    roff = r >= p.r_lo && r <= p.r_hi ? static_cast<int>(r) : kOutside;
  }
  if (roff < p.r_lo || roff > p.r_hi) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) c.w[a][b] = 0.0f;
    }
    c.roff = kSentinel;
    c.key = -1;
    c.fro = wlo;
    c.off = c.colofs;
    return 0;
  }
  if (key != c.key) {
    set_weights<kQuant>(p, c, key);
    c.key = key;
  }
  if (roff != c.roff) {
    c.roff = c.fro = roff;
    c.off = (roff - wlo) * pitch_b + c.colofs;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      fetch<kDirect, Off>(p, c, rowpart + a * pitch_b + c.off,
                          y + roff - 1 + a, c.ring[(J + a) & 3]);
  }
  return keep;
}

// Row 3 of the support into the ring, then the pixel: -> the rounded
// value in the low 16 bits.
template <int J, bool kDirect, typename Off>
__device__ __forceinline__ uint32_t pixel(const Args& p, Column& c,
                                          uint32_t rowpart, int pitch_b,
                                          long long y) {
  fetch<kDirect, Off>(p, c, rowpart + 3 * pitch_b + c.off, y + c.fro + 2,
                      c.ring[(J + 3) & 3]);
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* t = c.ring[(J + a) & 3];
    const float s = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(t[0], c.w[a][0]),
                            __fmul_rn(t[1], c.w[a][1])),
                  __fmul_rn(t[2], c.w[a][2])),
        __fmul_rn(t[3], c.w[a][3]));
    acc = a == 0 ? s : __fadd_rn(acc, s);
  }
  // rint of the clipped sum (the clip bounds are integers, so this is the
  // clip of the rint): 1.5 * 2^23 + n holds n in its low 16 bits
  return static_cast<uint32_t>(__float_as_int(
      __fadd_rn(fminf(fmaxf(acc, 0.0f), 65535.0f), kMagic)));
}

// Where a thread is in a band: the band row's shared address (staged)
// and the output row's two columns.
struct Cursor {
  uint32_t rowpart;
  uint16_t* out;
};

// The pixels of one output row, ring phase J, of the thread's two columns,
// stored; then the cursor moves down a row.  y: the section row.
template <int J, bool kDirect, bool kVec, typename Off>
__device__ __forceinline__ void finish(const Args& p, Column (&c)[2],
                                       Cursor& u, int pitch_b, long long y,
                                       bool ok0, bool ok1) {
  const uint32_t v0 = pixel<J, kDirect, Off>(p, c[0], u.rowpart, pitch_b, y);
  const uint32_t v1 = pixel<J, kDirect, Off>(p, c[1], u.rowpart, pitch_b, y);
  if constexpr (kVec) {
    if (ok0) *reinterpret_cast<uint32_t*>(u.out) = __byte_perm(v0, v1, 0x5410);
  } else {
    if (ok0) u.out[0] = static_cast<uint16_t>(v0);
    if (ok1) u.out[1] = static_cast<uint16_t>(v1);
  }
  u.out += p.width;
  u.rowpart += pitch_b;
}

// One output row, ring phase J, whose coordinates may have changed: fast
// counts the rows left that certainly keep the previous row's.
template <int J, bool kQuant, bool kNarrow, bool kDirect, bool kVec,
          typename Off>
__device__ __forceinline__ void row(const Args& p, Column (&c)[2], Cursor& u,
                                    int& fast, int pitch_b, int wlo,
                                    long long y, bool ok0, bool ok1) {
  if (fast > 0) {
    --fast;
  } else {
    const long long y_map = y + p.origin;
    const int k0 = settle<J, kQuant, kNarrow, kDirect, Off>(
        p, c[0], u.rowpart, pitch_b, wlo, y_map, y);
    const int k1 = settle<J, kQuant, kNarrow, kDirect, Off>(
        p, c[1], u.rowpart, pitch_b, wlo, y_map, y);
    fast = min(k0, k1);
  }
  finish<J, kDirect, kVec, Off>(p, c, u, pitch_b, y, ok0, ok1);
}

// Output rows [ka, kb) (ka a multiple of 4) of the thread's two columns;
// window: the band's shared-space address (staged).  Four rows whose
// coordinates are known to stay run straight through.
template <bool kQuant, bool kNarrow, bool kDirect, bool kVec, typename Off>
__device__ __forceinline__ void run_rows(const Args& p, uint32_t window,
                                         Column (&c)[2], int& fast,
                                         long long ka, long long kb,
                                         int pitch_b, int wlo, int x0) {
  Cursor u;
  u.rowpart = window;
  u.out = p.out + static_cast<Off>(ka) * static_cast<Off>(p.width) + x0;
  const bool ok0 = x0 < p.width, ok1 = x0 + 1 < p.width;
  const long long y0 = p.first + ka;
  const int n = static_cast<int>(kb - ka);
  for (int i = 0; i < n; i += 4) {
    const long long y = y0 + i;
    if (fast >= 4 && i + 4 <= n) {
      fast -= 4;
      finish<0, kDirect, kVec, Off>(p, c, u, pitch_b, y, ok0, ok1);
      finish<1, kDirect, kVec, Off>(p, c, u, pitch_b, y + 1, ok0, ok1);
      finish<2, kDirect, kVec, Off>(p, c, u, pitch_b, y + 2, ok0, ok1);
      finish<3, kDirect, kVec, Off>(p, c, u, pitch_b, y + 3, ok0, ok1);
      continue;
    }
    row<0, kQuant, kNarrow, kDirect, kVec, Off>(p, c, u, fast, pitch_b, wlo,
                                                y, ok0, ok1);
    if (i + 1 >= n) break;
    row<1, kQuant, kNarrow, kDirect, kVec, Off>(p, c, u, fast, pitch_b, wlo,
                                                y + 1, ok0, ok1);
    if (i + 2 >= n) break;
    row<2, kQuant, kNarrow, kDirect, kVec, Off>(p, c, u, fast, pitch_b, wlo,
                                                y + 2, ok0, ok1);
    if (i + 3 >= n) break;
    row<3, kQuant, kNarrow, kDirect, kVec, Off>(p, c, u, fast, pitch_b, wlo,
                                                y + 3, ok0, ok1);
  }
}

// Copy the window of the band of output rows [ka, kb) to the shared-space
// address buf: window row i is section row first + ka + wlo - 1 + i, its
// element j column cw0 + j; zeros outside the section.
template <typename Off>
__device__ __forceinline__ void stage(const Args& p, uint32_t buf,
                                      long long ka, long long kb, int cw0,
                                      int pitch, int wlo, int whi) {
  const long long r0 = p.first + ka + wlo - 1;
  const int n_rows = static_cast<int>(kb - ka) + whi - wlo + 3;
  // a thread's elements (16-byte chunks, or single elements) go by kThreads
  // through the rows: (i, j) steps by (di, dj) with a carry
  const int unit = p.stage16 ? 8 : 1;
  const int per_row = pitch / unit;
  int i = threadIdx.x / per_row, j = threadIdx.x - i * per_row;
  const int di = kThreads / per_row, dj = kThreads - di * per_row;
  while (i < n_rows) {
    const long long r = r0 + i;
    const int col = cw0 + unit * j;
    // with 16-byte chunks the width and cw0 are multiples of 8, so a chunk
    // lies wholly inside the section's columns or wholly outside
    const bool in = r >= 0 && r < p.rows && col >= 0 && col < p.width;
    const uint16_t* src =
        p.src + (in ? static_cast<Off>(r) * static_cast<Off>(p.width) + col
                    : 0);
    const uint32_t dst = buf + 2 * (i * pitch + unit * j);
    if (p.stage16) {
      cp_async16(dst, src, in ? 16 : 0);
    } else {
      const unsigned short u = in ? *src : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(u)
                   : "memory");
    }
    j += dj;
    i += di;
    if (j >= per_row) {
      j -= per_row;
      ++i;
    }
  }
}

template <bool kQuant, bool kNarrow, bool kVec, typename Off>
__global__ void __launch_bounds__(kThreads, 4)
    remap_section_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* geo = p.table + 5 * blockIdx.x;
  const int cw0 = geo[0], pitch = geo[1], wlo = geo[2], whi = geo[3];
  const int band = geo[4];
  const int pitch_b = 2 * pitch;
  const int x0 = blockIdx.x * kCols + 2 * threadIdx.x;
  Column c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    c[i].x = min(x0 + i, p.width - 1);
    c[i].tap0 = p.col_tap0[c[i].x];
    c[i].gx = p.g[c[i].x];
    c[i].colofs = 2 * (c[i].tap0 - cw0);
    c[i].off = c[i].colofs;
    c[i].fro = wlo;
    c[i].key = -1;   // neither a table index nor the bits of an fy
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        c[i].ring[a][b] = 0.0f;
        c[i].w[a][b] = 0.0f;
      }
    }
  }
  const long long n_chunks = (p.count + p.chunk - 1) / p.chunk;
  const int buf_b = (band + whi - wlo + 3) * pitch_b;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  for (long long ch = blockIdx.y; ch < n_chunks; ch += gridDim.y) {
    const long long ka0 = ch * p.chunk;
    const long long kend = min(p.count, ka0 + p.chunk);
    c[0].roff = c[1].roff = kSentinel;
    int fast = 0;
    if (band == 0) {
      run_rows<kQuant, kNarrow, true, kVec, Off>(p, 0, c, fast, ka0, kend,
                                                pitch_b, wlo, x0);
      continue;
    }
    const int nb = static_cast<int>((kend - ka0 + band - 1) / band);
    stage<Off>(p, sbase, ka0, min(kend, ka0 + band), cw0, pitch, wlo, whi);
    cp_async_commit();
    for (int i = 0; i < nb; ++i) {
      const long long ka = ka0 + static_cast<long long>(i) * band;
      const long long kb = min(kend, ka + band);
      if (i + 1 < nb) {
        stage<Off>(p, sbase + ((i + 1) & 1) * buf_b, kb, min(kend, kb + band),
                   cw0, pitch, wlo, whi);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      run_rows<kQuant, kNarrow, false, kVec, Off>(
          p, sbase + (i & 1) * buf_b, c, fast, ka, kb, pitch_b, wlo, x0);
      __syncthreads();
    }
  }
}

template <bool kQuant, bool kNarrow, bool kVec, typename Off>
int launch(const Args& a, int grid_x, int grid_y, int smem,
           cudaStream_t stream) {
  auto kernel = remap_section_kernel<kQuant, kNarrow, kVec, Off>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instance: quantized or continuous coordinates, narrow or not, 4-byte
// stores of a column pair (an even width) or 2-byte ones, 32- or 64-bit
// element offsets.
template <bool kQuant>
int dispatch(const Args& a, bool narrow, bool vec, bool wide_offsets,
             int grid_x, int grid_y, int smem, cudaStream_t stream) {
#define OIP_SECTION_LAUNCH(N, V, O) \
  if (narrow == N && vec == V && wide_offsets == (sizeof(O) == 8)) \
    return launch<kQuant, N, V, O>(a, grid_x, grid_y, smem, stream);
  OIP_SECTION_LAUNCH(true, true, int)
  OIP_SECTION_LAUNCH(true, false, int)
  OIP_SECTION_LAUNCH(false, true, int)
  OIP_SECTION_LAUNCH(false, false, int)
  OIP_SECTION_LAUNCH(true, true, long long)
  OIP_SECTION_LAUNCH(true, false, long long)
  OIP_SECTION_LAUNCH(false, true, long long)
  OIP_SECTION_LAUNCH(false, false, long long)
#undef OIP_SECTION_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// src (rows, width) uint16; col_tap0 (width,) int32; wx (4, width) float32;
// g (width,) float64; wy_table (32, 4) float32; table (grid_x, 5) int32;
// out (count, width) uint16 = output rows [first, first + count) of the
// section.  chunk, grid, smem, narrow, wide_offsets and stage16 come from
// ops/resample.py::remap_section_geometry.  Returns the launch's
// cudaError_t.
extern "C" int oip_remap_section(
    const void* src, const void* col_tap0, const void* wx, const void* g,
    const void* wy_table, const void* table, void* out, long long rows,
    int width, long long first, long long count, long long origin,
    int quantized, int r_lo, int r_hi, int chunk, int grid_x, int grid_y,
    int smem, int narrow, int wide_offsets, int stage16, void* stream) {
  if (rows < 0 || width < 1 || first < 0 || count < 0 ||
      first + count > rows || r_lo > r_hi || r_lo <= kOutside ||
      chunk < 4 || chunk % 4 || grid_x != (width + kCols - 1) / kCols ||
      grid_y < 1 || grid_y > 65535 || smem < 0 || smem > 227 * 1024 ||
      (!wide_offsets && rows * width >= (1LL << 31)) ||
      (stage16 && (width % 8 || (reinterpret_cast<uintptr_t>(src) & 15))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  Args a;
  a.src = static_cast<const uint16_t*>(src);
  a.col_tap0 = static_cast<const int*>(col_tap0);
  a.wx = static_cast<const float*>(wx);
  a.g = static_cast<const double*>(g);
  a.wy_table = static_cast<const float*>(wy_table);
  a.table = static_cast<const int*>(table);
  a.out = static_cast<uint16_t*>(out);
  a.rows = rows;
  a.first = first;
  a.count = count;
  a.origin = origin;
  a.width = width;
  a.r_lo = r_lo;
  a.r_hi = r_hi;
  a.chunk = chunk;
  a.stage16 = stage16;
  const bool vec =
      width % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quantized ? dispatch<true>(a, narrow, vec, wide_offsets, grid_x,
                                    grid_y, smem, s)
                   : dispatch<false>(a, narrow, vec, wide_offsets, grid_x,
                                     grid_y, smem, s);
}

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
// stitched raster written once: at 160000 x 12288, 7.86 GB read and 7.80 GB
// written, 4.68 ms at 3.35 TB/s (with prestt 3.93 GB more, 5.85 ms).  What
// kept the previous design at ~47% of it was the rate of type conversions
// (a quarter of the float32 rate: five to six a pixel of the right half)
// and too few bytes in flight (loads two rows ahead, one block-wide barrier
// a row).  Design:
//
// * Every warp works alone on one item: a tile of rows of one column span,
//   of the left half or of the right half; a block is kWarps warps and no
//   warp waits for another.  Tile rows and the grid follow the launch's
//   shape (oip_stitch_tail): as many rows as keep four warps waiting for
//   every one the card holds.
// * One type conversion a pixel: the RRC (st_rrc) enters float64 by the
//   identity 2^52 + s - 2^52 and keeps its one float64 -> int32 truncation
//   (a round-toward-zero add of 2^52 in its place ran 2-5% slower on an
//   H100: more instructions where the right half is issue-bound);
//   a uint16 enters float32 as 2^23 + s - 2^23 (st_u16f); an output is
//   rounded by the clamp, then + 1.5 * 2^23 and the low 16 bits
//   (oip_round_u16_bits, as kernel (c)).  Each is exact
//   (tests/test_torch_stitch_tail.py).
// * Left half: a lane owns 8 adjacent columns of a 256-column span and
//   keeps kLeftRows 16-byte loads of PAN1 in flight.
// * Right half: a lane owns kPx adjacent columns (Right<kPx>: 8 when the
//   launch writes prestt too, so that both outputs take 16-byte stores,
//   else 4, which keeps 20 warps an SM resident at 96 registers).  A warp
//   stages the 32 kPx columns that its lanes' taps reach, in 16-byte
//   chunks, in a ring of kRing rows in shared memory that cp.async fills
//   kRing - 1 rows ahead.  Each lane RRCs its kPx staged pixels once into a
//   float row that the warp shares (a __syncwarp a row, no other barrier),
//   and 30 or 31 lanes take the column cubic of their kPx output columns
//   from it.  A column's first tap lies at a fixed offset from the column
//   except, for some dx, across one binade edge of x + dx: a warp whose
//   lanes read taps at one offset takes them at fixed addresses, another
//   one computes each address (computed addresses alone took ~24% longer
//   without prestt on an H100, ~2% with it).  The float row has one pad
//   word per kPx (after the readers' first taps), so that lanes reading
//   kPx floats apart hit distinct banks.  The 4 vertical taps are a rolling
//   window of column-cubic rows in registers.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "remap_common.cuh"

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kLeftSpan = 256;            // left-half columns a warp: 8 a lane
constexpr int kLeftRows = 8;              // PAN1 rows in flight a lane
constexpr int kRing = 16;                 // staged rows a right warp
constexpr int kMaxTileRows = 128;
constexpr int kMaxDevices = 64;           // devices whose occupancy is kept
static_assert((kRing & (kRing - 1)) == 0, "the ring's slot is j & (kRing - 1)");

// The right half's geometry for kPx columns a lane (4 or 8).
template <int kPx>
struct Right {
  static_assert(kPx == 4 || kPx == 8, "a lane takes 8 or 16 bytes a row");
  static constexpr int kWin = 32 * kPx;   // staged PAN2 columns a warp
  // a warp stages its window in 16-byte chunks from a multiple of 8
  // columns: one chunk more than the window holds when kPx < 8
  static constexpr int kChunks = kWin / 8 + (kPx < 8 ? 1 : 0);
  static constexpr int kRowBytes = 16 * kChunks;   // a warp's staged row
  // a warp's RRC'd row: shifted window position q at float q + q / kPx
  // (one pad word per kPx); lanes past the outputs read up to 33 kPx + 2
  static constexpr int kFbQ = 34 * kPx;
  static constexpr int kFb = (kFbQ + kFbQ / kPx + 4) / 4 * 4;
  static constexpr int kWarpSmem = kRing * kRowBytes + 2 * kFb * 4;
  // registers: 96 a thread for kPx 4, 168 for kPx 8
  static constexpr int kBlocksPerSm = kPx == 4 ? 5 : 3;
};

// RRC of one pixel: rrc.cuh's oip_rrc_pixel, the same float64 multiply and
// add and the same result (the low 16 bits of int32(trunc(v)), 0 for |v| >=
// 2^31 or NaN), with one type conversion: s enters float64 exactly as
// (2^52 + s) - 2^52.  The result is in the low 16 bits.
__device__ __forceinline__ uint32_t st_rrc(uint32_t s, double k, double b) {
  const double sd = __dsub_rn(__hiloint2double(0x43300000, static_cast<int>(s)),
                              4503599627370496.0);
  const double v = __dadd_rn(__dmul_rn(k, sd), b);
  return fabs(v) < 2147483648.0 ? static_cast<uint32_t>(__double2int_rz(v))
                                : 0u;
}

// the low 16 bits of r as a float32: (2^23 + s) - 2^23, exact (one byte
// permute puts s under the exponent of 2^23)
__device__ __forceinline__ float st_u16f(uint32_t r) {
  return __fsub_rn(__uint_as_float(__byte_perm(r, 0x4B000000u, 0x7410)),
                   8388608.0f);
}

// the low halves of a and b as one word, a first
__device__ __forceinline__ uint32_t pack2(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5410);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled past ``valid`` bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

// N / 2 words of uint16 pairs from shared memory
template <int N>
__device__ __forceinline__ void lds_words(uint32_t addr, uint32_t (&w)[N / 2]) {
  if constexpr (N == 8)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(addr));
  else
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w[0]), "=r"(w[1])
                 : "r"(addr));
}

// N / 2 words of uint16 pairs to p in one vector store
template <int N>
__device__ __forceinline__ void stg_words(uint16_t* p,
                                          const uint32_t (&w)[N / 2]) {
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// row[col + e] = the e-th uint16 of w for the e < N with lo <= col + e < hi
template <int N>
__device__ __forceinline__ void put_scalar(uint16_t* row, int col,
                                           const uint32_t (&w)[N / 2], int lo,
                                           int hi) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (col + e >= lo && col + e < hi)
      row[col + e] = static_cast<uint16_t>(w[e >> 1] >> (16 * (e & 1)));
  }
}

// whether p and every row after it, ``pitch`` elements apart, start on a
// ``bytes`` boundary
__device__ __forceinline__ bool aligned(const uint16_t* p, size_t pitch,
                                        int bytes) {
  return ((reinterpret_cast<uintptr_t>(p) | (2 * pitch)) & (bytes - 1)) == 0;
}

struct Args {
  const uint16_t* pan1;
  const uint16_t* pan2;
  const double* k1;
  const double* b1;
  const double* k2;
  const double* b2;
  uint16_t* stitched;
  uint16_t* prestt;
  int rows, width, fold, block, halo;
  float dx, dy;
  int tile_rows, n_left, n_right, n_items;
  int out_lanes;    // right half: lanes with output columns (30 or 31)
};

// RRC(PAN1) of columns [c, c + 8) of rows [r0, r_end) into the left half
__device__ __forceinline__ void left_warp(const Args& a, int span, int r0,
                                          int r_end) {
  const int lane = threadIdx.x & 31;
  const int left_w = a.width - a.fold;
  const int c = span * kLeftSpan + 8 * lane;
  if (c >= left_w) return;
  const size_t out_w = 2 * static_cast<size_t>(left_w);
  double kc[8], bc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    kc[e] = a.k1[c + e];
    bc[e] = a.b1[c + e];
  }
  const uint16_t* src = a.pan1 + static_cast<size_t>(r0) * a.width + c;
  uint16_t* dst = a.stitched + static_cast<size_t>(r0) * out_w + c;
  const bool vec = c + 8 <= left_w && aligned(dst, out_w, 16);
  for (int y = r0; y < r_end; y += kLeftRows) {
    uint4 raw[kLeftRows];
#pragma unroll
    for (int u = 0; u < kLeftRows; ++u) {
      if (y + u < r_end)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(src + u * a.width));
    }
#pragma unroll
    for (int u = 0; u < kLeftRows; ++u) {
      if (y + u >= r_end) break;
      const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i] = pack2(st_rrc(w[i] & 0xFFFFu, kc[2 * i], bc[2 * i]),
                     st_rrc(w[i] >> 16, kc[2 * i + 1], bc[2 * i + 1]));
      }
      if (vec)
        stg_words<8>(dst, o);
      else
        put_scalar<8>(dst - c, c, o, 0, left_w);
      dst += out_w;
    }
    src += static_cast<size_t>(kLeftRows) * a.width;
  }
}

// float-row index of a shifted window position q: one pad word per kPx
template <int kPx>
__device__ __forceinline__ int fb_index(int q) {
  return q + q / kPx;
}

// prestt columns [xo, xo + kPx * out_lanes) of rows [r0, r_end), from the
// staged PAN2 columns [ws, ws + kWin), ws = xo + floor(dx) - 1 rounded down
// to a multiple of kPx
template <int kPx>
__device__ __forceinline__ void right_warp(const Args& a, int span, int r0,
                                           int r_end, char* wsm) {
  using R = Right<kPx>;
  constexpr int kChunks = R::kChunks;
  constexpr int kRowBytes = R::kRowBytes, kFb = R::kFb;
  const int lane = threadIdx.x & 31;
  const int W = a.width;
  const int fdx = static_cast<int>(floorf(a.dx));
  const int xo = span * kPx * a.out_lanes;
  const int ws = (xo + fdx - 1) - ((xo + fdx - 1) % kPx + kPx) % kPx;
  // staged chunk of this lane: columns [g, g + kPx), wholly in or out of
  // the image (W % 8 == 0); out of it its weights are 0, so any value will do
  const int g = ws + kPx * lane;
  const bool g_in = g >= 0 && g < W;
  double kc[kPx], bc[kPx];
#pragma unroll
  for (int e = 0; e < kPx; ++e) {
    kc[e] = g_in ? a.k2[g + e] : 0.0;
    bc[e] = g_in ? a.b2[g + e] : 0.0;
  }
  // output columns of this lane: [x0, x0 + kPx); lanes past out_lanes take
  // lane 0's taps (in the window) and store nothing
  const bool out_lane = lane < a.out_lanes;
  const int x0 = xo + kPx * lane;
  const bool x_ok = out_lane && x0 < W;
  float w[kPx][4];
  int pos[kPx];   // window position of each column's first tap
  {
    const float cx0 = __fmul_rn(4.0f, a.dx);
#pragma unroll
    for (int e = 0; e < kPx; ++e) {
      const int x = (out_lane ? x0 : xo) + e;
      const int loc0 = oip_col_taps(x, cx0, 0.0f, W, a.block, a.halo, w[e]);
      pos[e] = loc0 + (x / a.block) * a.block - a.halo - ws;
    }
  }
  // a warp is regular when every output lane's first taps are base + kPx
  // lane + e for one base (0..kPx): its reads then sit at fixed offsets
  const int base = __shfl_sync(0xFFFFFFFFu, pos[0], 0);
  bool mine = true;
#pragma unroll
  for (int e = 0; e < kPx; ++e) mine &= pos[e] == base + kPx * lane + e;
  const bool regular = __all_sync(0xFFFFFFFFu, mine || !out_lane);

  // shared memory of this warp: the ring of raw rows, then two float rows.
  // Lane c < kChunks copies columns [ws8 + 8 c, ws8 + 8 c + 8) of a row,
  // wholly in or out of the image; this lane reads its columns at ``rd_off``
  const int ws8 = ws - ((ws % 8 + 8) % 8);
  const uint32_t ring = smem_addr(wsm);
  const uint32_t cp_dst = ring + 16 * lane;
  const uint32_t rd_off = 2 * (ws - ws8 + kPx * lane);
  float* fb = reinterpret_cast<float*>(wsm + kRing * kRowBytes);
  // window position p sits at float fb_index(p + kPx - base)
  int wa[kPx];
#pragma unroll
  for (int e = 0; e < kPx; ++e)
    wa[e] = fb_index<kPx>(kPx * lane + e + kPx - base);

  const float dyf = floorf(a.dy);
  const int iy0 = static_cast<int>(dyf);
  float wy[4];
  oip_cubic_weights(__fsub_rn(a.dy, dyf), wy);
  const int n_steps = (r_end - r0) + 3;      // strip rows to stage
  const int sr0 = r0 + iy0 - 1;              // strip row of step 0
  const int gc = ws8 + 8 * lane;
  const bool gc_in = lane < kChunks && gc >= 0 && gc < W;
  const uint16_t* src = a.pan2 + (gc_in ? gc : 0);
  const int valid = gc_in ? 16 : 0;
  auto copy_row = [&](int j) {
    const int sr = sr0 + j;
    if (lane < kChunks && j < n_steps && sr >= 0 && sr < a.rows)
      cp_async16(cp_dst + kRowBytes * (j & (kRing - 1)),
                 src + static_cast<size_t>(sr) * W, valid);
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kRing - 1; ++j) copy_row(j);

  const int left_w = W - a.fold;
  const size_t out_w = 2 * static_cast<size_t>(left_w);
  // output row r0 of this lane's columns: prestt column x lands at
  // stitched column x - fold + (W - fold)
  const int sc = x0 - a.fold;
  uint16_t* st_p =
      a.stitched + static_cast<size_t>(r0) * out_w + left_w + sc;
  uint16_t* pre_p = a.prestt != nullptr
                        ? a.prestt + static_cast<size_t>(r0) * W + x0
                        : nullptr;
  const bool st_any = x_ok && x0 + kPx > a.fold;
  const bool st_vec = x_ok && sc >= 0 && sc + kPx <= left_w &&
                      aligned(st_p, out_w, 2 * kPx);
  const bool pre_vec = x_ok && pre_p != nullptr && aligned(pre_p, W, 2 * kPx);
  // rolling window of column-cubic rows (initialised: its first rotations
  // read entries no row has filled yet)
  float win[4][kPx];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int e = 0; e < kPx; ++e) win[r][e] = 0.0f;
  }

  // step j: stage strip row sr0 + j, take its column cubic into win[j & 3]
  // and, from j = 3 on, emit output row r0 + j - 3
  auto step = [&](int j, auto jj, auto reg) {
    constexpr int J = decltype(jj)::value;
    constexpr bool kRegular = decltype(reg)::value;
    copy_row(j + kRing - 1);
    cp_async_wait_ring();
    // another lane's copies are read: their waits come first
    if constexpr (kPx < 8) __syncwarp();
    const int sr = sr0 + j;
    const bool in = sr >= 0 && sr < a.rows;
    float* buf = fb + (J & 1) * kFb;
    if (in) {
      uint32_t rw[kPx / 2];
      lds_words<kPx>(ring + kRowBytes * (j & (kRing - 1)) + rd_off, rw);
#pragma unroll
      for (int i = 0; i < kPx / 2; ++i) {
        buf[wa[2 * i]] = st_u16f(st_rrc(rw[i] & 0xFFFFu, kc[2 * i], bc[2 * i]));
        buf[wa[2 * i + 1]] =
            st_u16f(st_rrc(rw[i] >> 16, kc[2 * i + 1], bc[2 * i + 1]));
      }
    }
    __syncwarp();
    if (in) {
      if (kRegular) {
        // taps of column e: floats e .. e + 3 after this lane's base
        const float* rd = buf + (kPx + 1) * (lane + 1);
        float t[kPx + 3];
#pragma unroll
        for (int i = 0; i < kPx + 3; ++i) t[i] = rd[i + i / kPx];
#pragma unroll
        for (int e = 0; e < kPx; ++e) {
          float acc = __fmul_rn(t[e], w[e][0]);
#pragma unroll
          for (int b = 1; b < 4; ++b)
            acc = __fadd_rn(acc, __fmul_rn(t[e + b], w[e][b]));
          win[J][e] = acc;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kPx; ++e) {
          const int q = pos[e] + kPx - base;
          float acc = __fmul_rn(buf[fb_index<kPx>(q)], w[e][0]);
#pragma unroll
          for (int b = 1; b < 4; ++b)
            acc = __fadd_rn(acc,
                            __fmul_rn(buf[fb_index<kPx>(q + b)], w[e][b]));
          win[J][e] = acc;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPx; ++e) win[J][e] = 0.0f;
    }
    if (j >= 3 && x_ok) {
      // the output row from the window rows j - 3 .. j, in tap order
      uint32_t o[kPx / 2];
#pragma unroll
      for (int i = 0; i < kPx / 2; ++i) {
        uint32_t h[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * i + u;
          float acc = __fmul_rn(win[(J + 1) & 3][e], wy[0]);
          acc = __fadd_rn(acc, __fmul_rn(win[(J + 2) & 3][e], wy[1]));
          acc = __fadd_rn(acc, __fmul_rn(win[(J + 3) & 3][e], wy[2]));
          acc = __fadd_rn(acc, __fmul_rn(win[J][e], wy[3]));
          h[u] = oip_round_u16_bits(acc);
        }
        o[i] = pack2(h[0], h[1]);
      }
      if (pre_vec)
        stg_words<kPx>(pre_p, o);
      else if (pre_p != nullptr)
        put_scalar<kPx>(pre_p - x0, x0, o, 0, W);
      if (st_vec)
        stg_words<kPx>(st_p, o);
      else if (st_any)
        put_scalar<kPx>(st_p - sc, sc, o, 0, left_w);
    }
    if (j >= 3) {
      st_p += out_w;
      if (pre_p != nullptr) pre_p += W;
    }
  };
  auto run = [&](auto reg) {
    using I0 = std::integral_constant<int, 0>;
    using I1 = std::integral_constant<int, 1>;
    using I2 = std::integral_constant<int, 2>;
    using I3 = std::integral_constant<int, 3>;
    for (int j = 0; j < n_steps; j += 4) {
      step(j, I0{}, reg);
      if (j + 1 < n_steps) step(j + 1, I1{}, reg);
      if (j + 2 < n_steps) step(j + 2, I2{}, reg);
      if (j + 3 < n_steps) step(j + 3, I3{}, reg);
    }
  };
  if (regular)
    run(std::true_type{});
  else
    run(std::false_type{});
  // leave no copy in flight (the steps past the tile committed empty groups)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int kPx>
__global__ void __launch_bounds__(kThreads, Right<kPx>::kBlocksPerSm)
    stitch_tail_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5;
  const int item = blockIdx.x * kWarps + warp;
  if (item >= a.n_items) return;
  const int per_tile = a.n_left + a.n_right;
  const int tile = item / per_tile;
  const int span = item - tile * per_tile;
  const int r0 = tile * a.tile_rows;
  const int r_end = min(r0 + a.tile_rows, a.rows);
  if (span < a.n_left)
    left_warp(a, span, r0, r_end);
  else
    right_warp<kPx>(a, span - a.n_left, r0, r_end,
                    smem + warp * Right<kPx>::kWarpSmem);
}

// geometry of a launch with kPx columns a right-half lane, and the launch
template <int kPx>
int launch(Args a, cudaStream_t stream) {
  using R = Right<kPx>;
  // a right warp's window starts o = (floor(dx) - 1) mod kPx columns before
  // its first column's taps; the taps of its last lane reach kPx out_lanes
  // + o + 3 of its kWin columns
  const int o = ((static_cast<int>(floorf(a.dx)) - 1) % kPx + kPx) % kPx;
  a.out_lanes = (R::kWin - 4 - o) / kPx;
  a.n_right = (a.width + kPx * a.out_lanes - 1) / (kPx * a.out_lanes);
  a.n_left = (a.width - a.fold + kLeftSpan - 1) / kLeftSpan;
  const int smem = kWarps * R::kWarpSmem;
  // the warps the card holds at once, read once a device
  static std::atomic<int> resident_of[kMaxDevices];   // 0: not read yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int resident = dev < kMaxDevices
                     ? resident_of[dev].load(std::memory_order_relaxed)
                     : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stitch_tail_kernel<kPx>, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = sms * per_sm * kWarps;
    if (dev < kMaxDevices)
      resident_of[dev].store(resident, std::memory_order_relaxed);
  }
  // tile rows: halve from kMaxTileRows (3 halo rows a right tile) while the
  // items would not keep four waiting for every warp the card holds
  int tile = kMaxTileRows;
  while (tile > 16 &&
         static_cast<long long>((a.rows + tile - 1) / tile) *
                 (a.n_left + a.n_right) < 4LL * resident)
    tile /= 2;
  a.tile_rows = tile;
  const long long items =
      static_cast<long long>((a.rows + tile - 1) / tile) *
      (a.n_left + a.n_right);
  if (items > 0x7FFFFFFFLL - kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  a.n_items = static_cast<int>(items);
  const int grid = (a.n_items + kWarps - 1) / kWarps;
  stitch_tail_kernel<kPx><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pan1, pan2: contiguous (rows, width) uint16, 16-byte aligned; k1, b1, k2,
// b2: (width,) float64; stitched: contiguous (rows, 2*(width-fold)) uint16;
// prestt: contiguous (rows, width) uint16 or null.  width % block == 0,
// width % 8 == 0, |dx| < 120.
extern "C" int oip_stitch_tail(const void* pan1, const void* pan2,
                               const void* k1, const void* b1, const void* k2,
                               const void* b2, void* stitched, void* prestt,
                               int rows, int width, int fold, int block,
                               int halo, float dx, float dy, void* stream) {
  if (block < 1 || width % block != 0 || width % 8 != 0 || halo < 0 ||
      fold < 0 || fold >= width || !(fabsf(dx) < 120.0f) ||
      (reinterpret_cast<uintptr_t>(pan1) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(pan2) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  Args a{static_cast<const uint16_t*>(pan1), static_cast<const uint16_t*>(pan2),
         static_cast<const double*>(k1),     static_cast<const double*>(b1),
         static_cast<const double*>(k2),     static_cast<const double*>(b2),
         static_cast<uint16_t*>(stitched),   static_cast<uint16_t*>(prestt),
         rows, width, fold, block, halo, dx, dy};
  // the right half's lanes take 8 columns when they write prestt too
  // (16-byte stores of both outputs), else 4 (more warps resident)
  return prestt != nullptr ? launch<8>(a, static_cast<cudaStream_t>(stream))
                           : launch<4>(a, static_cast<cudaStream_t>(stream));
}


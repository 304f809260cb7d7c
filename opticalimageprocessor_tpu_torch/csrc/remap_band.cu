// Kernel (c): band alignment remap as one streaming pass over a stack of
// bands, writing the pixel-interleaved raster.
//
// Replaces: opticalimageprocessor_tpu/ops/resample.py::_remap_fused_pallas
// (the contract of remap_band_fast_chunked; JAX's default
// _remap_fast_over_padded computes the same math).  For band b and output
// (y, x):
//
//   colg[r, x] = sum_k wx_k(x) * src[b, r, tap0(x) + k]        column cubic
//   out[y, x, b] = sum_a wy_a(x) * colg[y + floor(G(x)) + a - 1, x]
//
// with mapx = (cx1*xx + cx0 + xx)/4, G(x) = (cy2*xx*xx + cy1*xx + cy0)/4,
// xx = 4x, each band's own (cx, cy), rows outside the strip reading 0, then
// rint (half to even), clip to [0, 65535] and uint16.  The output pixel
// (y, x) holds its bands side by side: dst[(y*W + x)*bands + b] (one band:
// a plain (rows, W) raster).  The semantics of the TPU kernel's banded
// column matrix are kept: a tap outside the image or outside its column
// block's [start-H, start+B+H) window is dropped, and a vertical tap whose
// offset floor(G)+a-1 falls outside [-row_bound-1, row_bound+2] is dropped
// like the TPU kernel's U vertical weights.
//
// Bound on the H100: device-memory bandwidth (2 bytes read and 2 written
// per pixel and band), with ~30 instructions a pixel close behind: the
// kernel is as much issue-bound as memory-bound.  Design:
//
// * A block owns a segment of S output columns (a whole number of column
//   blocks, so every tap that is not dropped lies in [x0-H, x0+S+H)) and a
//   tile of rows, for all bands.  It streams the source rows of the tile,
//   plus the 2*row_bound + 3 rows its vertical taps reach, through a ring
//   of 2*row_bound + 1 + kAhead rows in shared memory: each row's segment
//   [x0-H, x0+S+H) of every band, staged by 16-byte cp.async kAhead rows
//   ahead of use (rows and chunks outside the image are zero-filled).  Each
//   thread stages one fixed chunk of a row (the geometry makes S wide
//   enough), so staging costs a few instructions and no division.  One
//   barrier a row.
// * A thread owns kPairs (column, band) outputs: 4/bands adjacent columns
//   of every band, i.e. 8 contiguous output bytes.  Their column taps
//   (moved to start inside the staged segment; the taps moved out are
//   dropped ones), column weights and vertical weights sit in registers,
//   computed once.  The vertical taps are a 4-row window per output,
//   starting at offset o = clamp(floor(G) - 1, -rb-1, rb-1) so it covers
//   every tap that is not dropped; at each row step the thread takes the
//   column cubic of the window's newest row from the ring into window slot
//   step mod 4 (the window is initialised to 0; the step loop is unrolled by
//   4, so no register moves) and emits one output row with an 8-byte store.
// * uint16 -> float and the final rint/clip/uint16 go through float bit
//   tricks, exact, instead of conversion instructions (those run at a
//   quarter of the float rate).

#include <cuda_runtime.h>

#include <cstdint>

#include "remap_common.cuh"

namespace {

constexpr int kPairs = 4;        // (column, band) outputs a thread
constexpr int kAhead = 8;        // source rows in flight beyond the newest read
constexpr int kMaxThreads = 512;
constexpr int kMaxRowBound = 6;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest kAhead - 1 staged rows have landed
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

// float(u) for a uint16 u, exactly, without a conversion instruction (those
// run at a quarter of the float rate): the float 2^23 + u minus 2^23
__device__ __forceinline__ float u16_to_float(uint32_t u) {
  return __fsub_rn(__uint_as_float(0x4B000000u | u), 8388608.0f);
}

// oip_round_u16 (rint, clip to [0, 65535]) as bits in the low half of the
// result: clipping first is the same on [0, 65535], and adding 1.5 * 2^23
// rounds half to even into the low mantissa bits
__device__ __forceinline__ uint32_t round_u16_bits(float v) {
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(v, 0.0f), 65535.0f), 12582912.0f));
}

// w[s] <- w[s + k] (0 where s + k leaves [0, 4)): the taps of a window
// that starts k columns later
__device__ __forceinline__ void shift_weights(float w[4], int k) {
  float v[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    v[s] = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b == s + k) v[s] = w[b];
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) w[s] = v[s];
}

// stage stream row i (strip row s0 + i, if it exists) into the ring slot
// at slot: this thread's 16-byte chunk of it (sm_off < 0: none), whose
// source gsrc is the chunk's first column in strip row 0 and gc that
// column (width % 8 == 0: a chunk lies wholly inside or outside the
// image).  One commit group per call, empty or not.
__device__ __forceinline__ void stage(uint16_t* slot, int sm_off,
                                      const uint16_t* gsrc, int gc, int i,
                                      int s0, int n_stream, int rows,
                                      int width) {
  const int r = s0 + i;
  if (i < n_stream && sm_off >= 0) {
    uint16_t* d = slot + sm_off;
    if (r >= 0 && r < rows && gc >= 0 && gc < width) {
      cp_async16(d, gsrc + (size_t)r * width);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
}

// the per-thread state of its kPairs outputs: ring index of the next
// column tap, column and vertical weights, and the 4-row window, whose
// slot J = step mod 4 takes the step's row (so no register moves)
struct Pairs {
  int q[kPairs];
  float wx[kPairs][4], wv[kPairs][4], win[kPairs][4];
};

// row step k's compute: the column cubic of every window's newest row
// from the ring and, with EMIT, the output row's kPairs values written at
// d with one 8-byte store (null: columns outside the image)
template <int J, bool EMIT>
__device__ __forceinline__ void compute_row(const uint16_t* ring, Pairs& P,
                                            int row_pitch, int ring_size,
                                            uint16_t* d) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const uint16_t* t = ring + P.q[p];
    // the reference's sum from 0 in tap order (0 + x is x up to the sign
    // of a zero, which no rounded uint16 sees)
    float acc = __fmul_rn(u16_to_float(t[0]), P.wx[p][0]);
#pragma unroll
    for (int b = 1; b < 4; ++b) {
      acc = __fadd_rn(acc, __fmul_rn(u16_to_float(t[b]), P.wx[p][b]));
    }
    P.win[p][J] = acc;
    P.q[p] += row_pitch;
    if (P.q[p] >= ring_size) P.q[p] -= ring_size;
  }
  if (EMIT && d != nullptr) {
    // output row from the window rows y + o .. y + o + 3, oldest first
    uint32_t v[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      float acc = __fmul_rn(P.win[p][(J + 1) & 3], P.wv[p][0]);
      acc = __fadd_rn(acc, __fmul_rn(P.win[p][(J + 2) & 3], P.wv[p][1]));
      acc = __fadd_rn(acc, __fmul_rn(P.win[p][(J + 3) & 3], P.wv[p][2]));
      acc = __fadd_rn(acc, __fmul_rn(P.win[p][J], P.wv[p][3]));
      v[p] = round_u16_bits(acc);
    }
    *reinterpret_cast<uint2*>(d) = make_uint2(
        __byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410));
  }
}

template <int NB>
__global__ void __launch_bounds__(kMaxThreads) remap_bands_kernel(
    const uint16_t* __restrict__ src, uint16_t* __restrict__ dst, int rows,
    int width, int block, int halo, int row_bound,
    const float* __restrict__ cx, const float* __restrict__ cy, int seg,
    int tile, int pitch) {
  constexpr int kCols = kPairs / NB;   // adjacent columns a thread
  extern __shared__ __align__(16) uint16_t ring[];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * seg;
  const int r0 = blockIdx.y * tile;
  const int t_rows = min(tile, rows - r0);
  // staged columns [a8, a8 + 8 * nchunk): [x0 - H, x0 + S + H) widened to
  // whole 16-byte chunks; thread t stages chunk t of a row's NB * nchunk
  const int lo = x0 - halo;
  const int a8 = lo - (((lo % 8) + 8) % 8);
  const int nchunk = (x0 + seg + halo - a8 + 7) / 8;
  const int row_pitch = NB * pitch;
  const int ring_size = (2 * row_bound + 1 + kAhead) * row_pitch;
  const int s0 = r0 - row_bound - 1;        // strip row of stream row 0
  const int n_stream = t_rows + 2 * row_bound + 3;
  const int c_band = tid / nchunk, c_col = tid - c_band * nchunk;
  const int sm_off = tid < NB * nchunk ? c_band * pitch + 8 * c_col : -1;
  const int gc = a8 + 8 * c_col;
  const uint16_t* gsrc = src + (size_t)min(c_band, NB - 1) * rows * width + gc;

  // issue the prologue's loads first, then set up the taps while they fly
  int slot = 0;                             // ring offset of the next row
  for (int i = 0; i < 2 * row_bound + kAhead; ++i) {
    stage(ring + slot, sm_off, gsrc, gc, i, s0, n_stream, rows, width);
    slot += row_pitch;
  }

  const int xt = x0 + tid * kCols;      // this thread's first column
  Pairs P;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int band = p % NB;
    const int x = min(xt + p / NB, width - 1);
    const int loc0 = oip_col_taps(x, cx[2 * band], cx[2 * band + 1], width,
                                  block, halo, P.wx[p]);
    // first tap inside the staged segment; taps outside it are dropped ones
    int p0 = loc0 + (x / block) * block - halo - a8;
    const int p_max = 8 * nchunk - 4;
    const int k = p0 < 0 ? -p0 : (p0 > p_max ? p_max - p0 : 0);
    if (k != 0) {
      shift_weights(P.wx[p], k);
      p0 += k;
    }
    // vertical offset G(x), its weights, the window offset o
    const float c0 = cy[3 * band], c1 = cy[3 * band + 1], c2 = cy[3 * band + 2];
    const float xx = __fmul_rn(static_cast<float>(x), 4.0f);
    const float g = __fdiv_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(c2, xx), xx), __fmul_rn(c1, xx)),
                  c0),
        4.0f);
    const float gf = floorf(g);
    const int iy0 = static_cast<int>(gf);
    float wy[4];
    oip_cubic_weights(__fsub_rn(g, gf), wy);
    const int o = min(max(iy0 - 1, -row_bound - 1), row_bound - 1);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // initialised: the first 3 steps read window slots no row has filled
      P.win[p][s] = 0.0f;
      P.wv[p][s] = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int u = iy0 + a - 1;
        if (u == o + s && u >= -row_bound - 1 && u <= row_bound + 2)
          P.wv[p][s] = wy[a];
      }
    }
    // step 0 reads stream row o + rb + 1 (strip row r0 + o)
    P.q[p] = (o + row_bound + 1) * row_pitch + band * pitch + p0;
  }

  // this thread's output at row r0 (null when its columns lie outside;
  // width % 8 == 0, so a thread's columns lie all inside or all outside)
  uint16_t* d = xt < width ? dst + ((size_t)r0 * width + xt) * NB : nullptr;
  const size_t d_step = (size_t)width * NB;
  // row step k: wait for its source rows and sync, stage stream row k +
  // 2 rb + kAhead into the slot of row k - 1 (which every thread is done
  // with), then compute; steps 0-2 fill the window, step k >= 3 emits
  // output row r0 + k - 3 (t_rows >= 1, so steps 0-3 exist)
#define OIP_REMAP_STEP(J, EMIT, K)                                          \
  do {                                                                      \
    cp_async_wait_ahead();                                                  \
    __syncthreads();                                                        \
    stage(ring + slot, sm_off, gsrc, gc, (K) + 2 * row_bound + kAhead, s0,  \
          n_stream, rows, width);                                           \
    slot += row_pitch;                                                      \
    if (slot == ring_size) slot = 0;                                        \
    compute_row<J, EMIT>(ring, P, row_pitch, ring_size, d);                 \
    if (EMIT && d != nullptr) d += d_step;                                  \
  } while (0)
  OIP_REMAP_STEP(0, false, 0);
  OIP_REMAP_STEP(1, false, 1);
  OIP_REMAP_STEP(2, false, 2);
  const int n_steps = t_rows + 3;
  for (int k = 3; k < n_steps; k += 4) {
    OIP_REMAP_STEP(3, true, k);
    if (k + 1 >= n_steps) break;
    OIP_REMAP_STEP(0, true, k + 1);
    if (k + 2 >= n_steps) break;
    OIP_REMAP_STEP(1, true, k + 2);
    if (k + 3 >= n_steps) break;
    OIP_REMAP_STEP(2, true, k + 3);
  }
#undef OIP_REMAP_STEP
}

template <int NB>
int launch(const void* src, void* dst, int rows, int width, int block,
           int halo, int row_bound, const void* cx, const void* cy, int seg,
           int tile, int pitch, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        remap_bands_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((width + seg - 1) / seg, (rows + tile - 1) / tile);
  const int threads = seg / (kPairs / NB);
  remap_bands_kernel<NB><<<grid, threads, smem, stream>>>(
      static_cast<const uint16_t*>(src), static_cast<uint16_t*>(dst), rows,
      width, block, halo, row_bound, static_cast<const float*>(cx),
      static_cast<const float*>(cy), seg, tile, pitch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: contiguous (bands, rows, width) uint16, 16-byte aligned; dst:
// contiguous (rows, width, bands) uint16 (for one band, (rows, width)),
// 8-byte aligned; cx (bands, 2), cy (bands, 3): the fitted float32
// coefficients in device memory (a transform never waits for them on the
// host).  bands is 1 or 4; width % block == 0, width % 8 == 0; row_bound
// <= 6.  seg (output columns a block; a multiple of block and of 4 / bands,
// at most 512 threads, each staging at most one chunk of a row) and tile
// (rows a block) come from the caller's geometry
// (ops/resample.py::remap_geometry).
extern "C" int oip_remap_bands(const void* src, void* dst, int bands,
                               int rows, int width, int block, int halo,
                               int row_bound, const void* cx, const void* cy,
                               int seg, int tile, void* stream) {
  if ((bands != 1 && bands != 4) || rows < 0 || width < 1 || width % 8 ||
      block < 1 || width % block != 0 || halo < 0 || row_bound < 0 ||
      row_bound > kMaxRowBound || tile < 1 || seg < 1 || seg % block != 0 ||
      seg % (kPairs / bands) != 0 || seg / (kPairs / bands) > kMaxThreads ||
      (reinterpret_cast<uintptr_t>(src) & 15) ||
      (reinterpret_cast<uintptr_t>(dst) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int pitch = 8 * ((seg + 2 * halo + 14) / 8);
  if (bands * pitch > 8 * (seg / (kPairs / bands)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (size_t)(2 * row_bound + 1 + kAhead) * bands * pitch * sizeof(uint16_t);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bands == 1)
    return launch<1>(src, dst, rows, width, block, halo, row_bound, cx, cy,
                     seg, tile, pitch, smem, s);
  return launch<4>(src, dst, rows, width, block, halo, row_bound, cx, cy,
                   seg, tile, pitch, smem, s);
}

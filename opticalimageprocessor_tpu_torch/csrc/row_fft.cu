// Kernel (i): the registration's row DFTs, straight from the float32 tile
// stacks that kernel (h) writes, each row read once and its bins written
// once: a PAN row of 1228 = 4 x 307 floats -> its 615 rfft bins, two band
// rows of 307 floats -> their 307 fft bins each, written column-major (a
// bin's column of each tile contiguous), so that cuFFT's column transforms
// (torch.fft.fft over the last axis of this storage, ops/row_fft.py) take
// them with no copy.
//
// Replaces no TPU kernel: the JAX package's registration took its spectra
// from ops/fft_mxu (the DFT done as matrix products), and the port called
// torch.fft.rfft2 / fft2, in which cuFFT takes the prime factor 307 by
// Bluestein's algorithm (a 614-point complex transform on 1296 points and
// an R2C post-pass for the PAN, 625 points for the bands, and a real ->
// complex cast of the band stack first), several passes over device memory.
//
// The algorithm (ops/row_fft.py, whose plain version follows it): a PAN
// row x is split by Good-Thomas, 1228 = 4 x 307, n = (307 n1 + 4 n2) mod
// 1228: the four-point DFT of each n2 gives Y0 and Y2 (real) and Y1 (Y3 =
// conj Y1); one complex 307-point DFT of Y0 + i Y2 and one of Y1 give every
// bin k = CRT(k mod 4, k mod 307).  Two band rows make one complex row.  A
// 307-point DFT is Rader's: X[0] = sum u, and X[g^-q] = u[0] + sum_p u[g^p]
// b[q - p] (g = 5, b[j] = W^(g^-j)), a cyclic convolution of 306 points done
// as a forward DFT, the product with b's DFT (a table) and an inverse DFT;
// 306 = 18 x 17 by Good-Thomas again (no twiddles): 17-point DFTs on each of
// 18 threads, an exchange in shared memory, 18-point DFTs (2 x 9) on 17 of
// them, the product, the inverse 18-point DFTs in the same registers, an
// exchange, the inverse 17-point DFTs.  The small DFTs are direct, on the
// cosines and sines of the pairs n, L - n (about 340 instructions the
// 17-point one); their constants are kernel parameters (constant bank
// operands).  Every table is built on the host in float64 and stored as
// float32; the sums of a row run in one order whatever block takes it.
//
// Bound on the H100 (the 160000-line scene's registration: 800000 PAN rows,
// 800000 band rows): device memory, 7.87 GB for the PAN (1228 floats in,
// 615 complex out a row) and 2.95 GB for the bands = 2.35 + 0.88 ms at
// 3.35 TB/s.  The arithmetic is ~29000 instructions a 307-point DFT, 2 a PAN
// row and 1 a band row pair (~1.9 ms of the card's float32 issue), and the
// shared-memory traffic ~2 ms; the design keeps the three in flight
// together:
//
// * A unit of 18 threads takes one 307-point DFT; a block of kUnits units
//   takes a group of kUnits / 2 PAN rows or 2 kUnits band rows, and walks
//   the groups of the stack (a persistent grid; Shape).  A PAN row's two
//   units are neighbours, so that a warp's reads of the staged row are
//   broadcasts.
// * The group's rows are one contiguous span of the stack: 16-byte
//   cp.async copies bring the next group's span into a linear buffer while
//   this group is computed, and the staging step stores it to the units'
//   regions already in the order they read it (the staging tables): a PAN
//   row's fours of (n1 = 0..3) for each slot (p1, p2) of the split, a band
//   pair's (row a, row b).  (Staged at once from loads into registers,
//   the bands took 1.78 ms against 1.10 with the copies in flight; a
//   register prefetch during the stores ran the PAN at 4.6 against 4.8
//   but spilled in the bands' kernel.)
// * A unit's shared-memory region holds in turn its staged input, the two
//   exchanges (17 rows of 18 complex at a pitch of 19, so that the 18-point
//   pass reads without bank conflicts) and its 307 output bins, with a
//   barrier between.
// * The bins are written from shared memory column-major: a matrix of m
//   rows (a PAN tile, M = 16000; a band of a tile, 4000) -> (K, m), K = 615
//   or 307, so that a group's rows of one bin are one run (64 bytes for the
//   PAN's 16 rows, 256 for the bands' 32), a thread keeping one row, and the
//   columns are cuFFT's contiguous batched case with one batch stride (a
//   cuFFT plan of strided columns, row stride 615, ran 5-8x slower: 21.6 ms
//   for the 50 PAN tiles against 3.0).  Kernel (b) reads this layout.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kP = 307;               // the prime width
constexpr int kN = kP - 1;            // Rader's convolution: 306 = 18 x 17
constexpr int kF1 = 18;               // threads of a unit; 18 = 2 x 9
constexpr int kF2 = 17;
constexpr int kPanCols = 4 * kP;      // 1228
constexpr int kPanKeep = 2 * kP + 1;  // 615
constexpr int kPitch = 19;            // complex of an exchange row
constexpr int kRegion = kF2 * kPitch * 2;   // floats of a unit's region
// tables (ops/row_fft.py::kernel_tables): byte offsets
constexpr int kTabStage = 0, kTabSlot = 2456, kTabOut = 3072,
              kTabBhat = 3696, kTabBytes = 6144;

static_assert(kF1 * kF2 == kN, "306 = 18 x 17");
static_assert(kRegion >= 2 * kP, "a region holds a pair's 307 complex");
static_assert(2 * kRegion >= kPanCols, "two regions hold a PAN row");

// A block of kUnits units, kMinBlocks an SM: the PAN's 32 (16 rows a
// group, so that a bin's rows go out as 128-byte runs: 4.52 ms against 4.80
// with 16 units), the bands' 16 (32 rows, 256-byte runs; 1.11 against 1.14
// with 32).  A group spans kSpan4 float4 of the stack, and kGroup * 8
// bytes hold its rows' output offsets.
template <bool PAN>
struct Shape {
  static constexpr int kUnits = PAN ? 32 : 16;
  static constexpr int kMinBlocks = PAN ? 1 : 2;
  static constexpr int kThreads = kUnits * kF1;
  static constexpr int kRows = PAN ? kUnits / 2 : 2 * kUnits;
  static constexpr int kSpan4 = kUnits / 2 * kP;
  static constexpr int kSmem = kTabBytes + kRows * 8 + kSpan4 * 16 +
                               kUnits * kRegion * 4;
  static_assert(kUnits % 2 == 0, "a PAN row takes two units");
  static_assert(kSpan4 * 4 == kRows * (PAN ? kPanCols : kP),
                "a group's rows span kSpan4 float4");
  static_assert(kThreads % kRows == 0 && (!PAN || kThreads / kRows % 4 == 0),
                "a thread keeps one row of a group (and the PAN's k mod 4)");
};

// the small DFTs' constants (ops/row_fft.py::kernel_consts)
struct Consts {
  float c17[kF2], s17[kF2], c9[9], s9[9];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// y = the L-point DFT (L odd) of x, exponent sign - (INV false) or +, from
// c[m] = cos(2 pi m / L) and s[m] = sin(2 pi m / L): pairs n, L - n as sums
// s_n and differences d_n, then for k = 1 .. (L - 1) / 2
// A = x0 + sum c[nk] s_n and B = sum s[nk] d_n give y[k] = A -+ i B and
// y[L - k] = A +- i B.
template <int L, bool INV>
__device__ __forceinline__ void dft_odd(const float2 (&x)[L], float2 (&y)[L],
                                        const float (&c)[L],
                                        const float (&s)[L]) {
  constexpr int H = (L - 1) / 2;
  float2 sp[H], dm[H];
#pragma unroll
  for (int n = 1; n <= H; ++n) {
    sp[n - 1] = cadd(x[n], x[L - n]);
    dm[n - 1] = csub(x[n], x[L - n]);
  }
  float2 y0 = x[0];
#pragma unroll
  for (int n = 0; n < H; ++n) y0 = cadd(y0, sp[n]);
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float ar = x[0].x, ai = x[0].y, br = 0.0f, bi = 0.0f;
#pragma unroll
    for (int n = 1; n <= H; ++n) {
      const int m = (n * k) % L;
      ar = fmaf(c[m], sp[n - 1].x, ar);
      ai = fmaf(c[m], sp[n - 1].y, ai);
      br = fmaf(s[m], dm[n - 1].x, br);
      bi = fmaf(s[m], dm[n - 1].y, bi);
    }
    if (INV) {
      y[k] = make_float2(ar - bi, ai + br);
      y[L - k] = make_float2(ar + bi, ai - br);
    } else {
      y[k] = make_float2(ar + bi, ai - br);
      y[L - k] = make_float2(ar - bi, ai + br);
    }
  }
  y[0] = y0;
}

// the 18-point DFT by Good-Thomas, 18 = 2 x 9: n = (9 n1 + 2 n2) mod 18,
// output k from (k mod 2, k mod 9)
template <bool INV>
__device__ __forceinline__ void dft18(const float2 (&x)[kF1], float2 (&y)[kF1],
                                      const Consts& cs) {
  float2 t0[9], t1[9], u0[9], u1[9];
#pragma unroll
  for (int n2 = 0; n2 < 9; ++n2) {
    const float2 a = x[(2 * n2) % 18], b = x[(9 + 2 * n2) % 18];
    t0[n2] = cadd(a, b);
    t1[n2] = csub(a, b);
  }
  dft_odd<9, INV>(t0, u0, cs.c9, cs.s9);
  dft_odd<9, INV>(t1, u1, cs.c9, cs.s9);
#pragma unroll
  for (int k = 0; k < kF1; ++k) y[k] = (k % 2) ? u1[k % 9] : u0[k % 9];
}

// PAN: the unit's 307-point input from a staged four (x at n1 = 0..3):
// Y0 + i Y2 for the first unit of a row, Y1 for the second
__device__ __forceinline__ float2 pan_input(float4 v, bool y1) {
  const float s = v.x + v.z, t = v.y + v.w;
  return y1 ? make_float2(v.x - v.z, v.w - v.y) : make_float2(s + t, s - t);
}

// from A = Z[k], B = Z[-k] of Z = DFT(x + i y), x and y real: DFT(x)[k] =
// (A + conj B) / 2, DFT(y)[k] = (A - conj B) / 2i
__device__ __forceinline__ float2 half_of(float2 a, float2 b, bool second) {
  return second ? make_float2((a.y + b.y) * 0.5f, (b.x - a.x) * 0.5f)
                : make_float2((a.x + b.x) * 0.5f, (a.y - b.y) * 0.5f);
}

// 16-byte asynchronous copy global -> shared of the first `bytes` (0..16)
// bytes at src, zeros after them
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

template <bool PAN>
__global__ void __launch_bounds__(Shape<PAN>::kThreads,
                                  Shape<PAN>::kMinBlocks)
    row_fft_kernel(const float* __restrict__ src, float2* __restrict__ dst,
                   const uint8_t* __restrict__ tabs,
                   const __grid_constant__ Consts cs, int rows, int m) {
  constexpr int kUnits = Shape<PAN>::kUnits;
  constexpr int kThreads = Shape<PAN>::kThreads;
  constexpr int kRows = Shape<PAN>::kRows;   // rows of a group
  constexpr int kSpan4 = Shape<PAN>::kSpan4;
  extern __shared__ __align__(16) uint8_t smem[];
  for (int i = threadIdx.x; i < kTabBytes / 16; i += kThreads)
    reinterpret_cast<int4*>(smem)[i] = reinterpret_cast<const int4*>(tabs)[i];
  const ushort4* stage = reinterpret_cast<const ushort4*>(smem + kTabStage);
  const uint16_t* slot = reinterpret_cast<const uint16_t*>(smem + kTabSlot);
  const uint16_t* outi = reinterpret_cast<const uint16_t*>(smem + kTabOut);
  const float2* bhat = reinterpret_cast<const float2*>(smem + kTabBhat);
  // a group row's output offset: its matrix and its row, at bin 0
  long long* orow = reinterpret_cast<long long*>(smem + kTabBytes);
  // the next group's span as it lies in the stack, then the units' regions
  float4* lin = reinterpret_cast<float4*>(smem + kTabBytes + kRows * 8);
  float* reg = reinterpret_cast<float*>(lin + kSpan4);

  constexpr int kW = PAN ? kPanCols : kP;
  // PAN units in pairs: unit u takes row u / 2, Y0 + i Y2 for even u and Y1
  // for odd (a warp's two chains read the same staged values: broadcasts)
  const int unit = threadIdx.x / kF1;
  const int lane = threadIdx.x - unit * kF1;   // p1; q2 in the 18-point pass
  float2* ureg = reinterpret_cast<float2*>(reg + unit * kRegion);
  const int groups = (rows + kRows - 1) / kRows;

  // a group's span into lin, zeros past the stack's end (a band group
  // starts at a multiple of 32 rows: 16-byte aligned); it lands while the
  // group before is computed
  auto fetch = [&](int grp) {
    const float* gs = src + (size_t)grp * kRows * kW;
    const int nbytes = min(kRows, rows - grp * kRows) * kW * 4;
    for (int i = threadIdx.x; i < kSpan4; i += kThreads) {
      const int b = max(0, min(16, nbytes - 16 * i));
      cp_async16(lin + i, b ? gs + 4 * i : gs, b);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (blockIdx.x < groups) fetch(blockIdx.x);

  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int row0 = grp * kRows;
    const int nrows = min(kRows, rows - row0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // ---- stage the group's rows in the order the units read them ----
    for (int i = threadIdx.x; i < kSpan4; i += kThreads) {
      const float4 v = lin[i];
      const float e[4] = {v.x, v.y, v.z, v.w};
      if (PAN) {
        const int r = i / kP;
        const ushort4 d = stage[i - r * kP];
        float* rb = reg + 2 * r * kRegion;
        rb[d.x] = e[0];
        rb[d.y] = e[1];
        rb[d.z] = e[2];
        rb[d.w] = e[3];
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int f = 4 * i + c;
          const int r = f / kP;
          reg[(r >> 1) * kRegion + 2 * slot[f - r * kP] + (r & 1)] = e[c];
        }
      }
    }
    if (threadIdx.x < nrows) {
      // row i of matrix q (a PAN tile, a band of a tile): bin k at
      // (q K + k) m + i
      const int rr = row0 + threadIdx.x, q = rr / m;
      orow[threadIdx.x] = (long long)q * (PAN ? kPanKeep : kP) * m + rr - q * m;
    }
    __syncthreads();
    if (grp + gridDim.x < groups) fetch(grp + gridDim.x);

    // ---- the 17-point DFTs over p2 of slot row p1 = lane ----
    float2 a[kF2], u0;
    if (PAN) {
      const float4* rb =
          reinterpret_cast<const float4*>(reg + 2 * (unit >> 1) * kRegion);
      const bool y1 = unit & 1;
#pragma unroll
      for (int p2 = 0; p2 < kF2; ++p2)
        a[p2] = pan_input(rb[p2 * kF1 + lane], y1);
      u0 = pan_input(rb[kN], y1);
    } else {
#pragma unroll
      for (int p2 = 0; p2 < kF2; ++p2) a[p2] = ureg[p2 * kF1 + lane];
      u0 = ureg[kN];
    }
    float2 A[kF2];
    dft_odd<kF2, false>(a, A, cs.c17, cs.s17);
    __syncthreads();   // every staged row is read: the regions take row q2
#pragma unroll
    for (int q2 = 0; q2 < kF2; ++q2) ureg[q2 * kPitch + lane] = A[q2];
    __syncthreads();

    // ---- the 18-point DFTs over p1 of column q2, the product with b's
    //      DFT, the inverse 18-point DFTs (lane 17 idles on a copy) ----
    const int q2 = min(lane, kF2 - 1);
    float2 b[kF1], B[kF1];
#pragma unroll
    for (int p1 = 0; p1 < kF1; ++p1) b[p1] = ureg[q2 * kPitch + p1];
    dft18<false>(b, B, cs);
    const float2 x0 = cadd(u0, B[0]);   // X[0], on lane 0
#pragma unroll
    for (int q1 = 0; q1 < kF1; ++q1) B[q1] = cmul(B[q1], bhat[q1 * kF2 + q2]);
    dft18<true>(B, b, cs);
    __syncthreads();
    if (lane < kF2) {
#pragma unroll
      for (int p1 = 0; p1 < kF1; ++p1) ureg[q2 * kPitch + p1] = b[p1];
    }
    __syncthreads();

    // ---- the inverse 17-point DFTs over q2 of row p1 = lane, and the
    //      bins X[g^-j] = u[0] + c[j] into the region, in bin order ----
#pragma unroll
    for (int k = 0; k < kF2; ++k) a[k] = ureg[k * kPitch + lane];
    dft_odd<kF2, true>(a, A, cs.c17, cs.s17);
    __syncthreads();
#pragma unroll
    for (int p2 = 0; p2 < kF2; ++p2)
      ureg[outi[p2 * kF1 + lane]] = cadd(u0, A[p2]);
    if (lane == 0) ureg[0] = x0;
    __syncthreads();

    // ---- the bins out, a bin's rows of the group together ----
    // a thread keeps one row of the group (kThreads is a multiple of
    // kRows) and steps its bins by kThreads / kRows (a multiple of 4: the
    // PAN's k mod 4 stays too)
    {
      constexpr int kStep = kThreads / kRows;
      const int r = threadIdx.x % kRows;
      const int k0 = threadIdx.x / kRows;
      float2* out = dst + orow[r] + (long long)k0 * m;
      const long long step = (long long)kStep * m;
      if (r < nrows) {
        if (PAN) {
          // Y0 + i Y2's spectrum for even k mod 4, Y1's for odd
          const int k1 = k0 & 3;
          const float2* z = reinterpret_cast<const float2*>(
              reg + (2 * r + (k1 & 1)) * kRegion);
          int k2 = k0;
          for (int k = k0; k < kPanKeep; k += kStep, out += step) {
            const int mk = k2 ? kP - k2 : 0;
            const float2 zk = z[k2], zm = z[mk];
            *out = (k1 & 1) ? (k1 == 1 ? zk : make_float2(zm.x, -zm.y))
                            : half_of(zk, zm, k1 == 2);
            k2 += kStep;
            if (k2 >= kP) k2 -= kP;
          }
        } else {
          const float2* z =
              reinterpret_cast<const float2*>(reg + (r >> 1) * kRegion);
          for (int k = k0; k < kP; k += kStep, out += step)
            *out = half_of(z[k], z[k ? kP - k : 0], r & 1);
        }
      }
    }
  }
}

template <bool PAN>
int launch(const void* src, void* dst, const void* tabs, const Consts& cs,
           int rows, int m, cudaStream_t stream) {
  using S = Shape<PAN>;
  auto kernel = row_fft_kernel<PAN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, S::kThreads, S::kSmem)) != cudaSuccess)
    return static_cast<int>(e);
  const int groups = (rows + S::kRows - 1) / S::kRows;
  const int grid = min(groups, sms * max(per_sm, 1));
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(
      static_cast<const float*>(src), static_cast<float2*>(dst),
      static_cast<const uint8_t*>(tabs), cs, rows, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: rows of a contiguous float32 stack, 16-byte aligned: PAN rows of 1228
// (pan != 0) or band rows of 307, in matrices of m rows; dst: complex64, each
// matrix's bins column-major, (615, m) rfft bins or (307, m) fft bins; tabs:
// ops/row_fft.py::kernel_tables on the device; consts: host pointer to
// kernel_consts' 52 floats.  rows * 615 below 2^31.
extern "C" int oip_row_fft(const void* src, void* dst, const void* tabs,
                           const void* consts, int pan, long long rows, int m,
                           void* stream) {
  if (rows <= 0) return 0;
  if (rows * kPanKeep >= (1LL << 31) || m < 1 ||
      reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(tabs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Consts cs;
  const float* c = static_cast<const float*>(consts);
  for (int i = 0; i < kF2; ++i) cs.c17[i] = c[i], cs.s17[i] = c[kF2 + i];
  for (int i = 0; i < 9; ++i) cs.c9[i] = c[2 * kF2 + i], cs.s9[i] = c[2 * kF2 + 9 + i];
  const auto st = static_cast<cudaStream_t>(stream);
  return pan ? launch<true>(src, dst, tabs, cs, (int)rows, m, st)
             : launch<false>(src, dst, tabs, cs, (int)rows, m, st);
}

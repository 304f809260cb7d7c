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
// apart vertically), so U has no compile-time limit here, and any row count
// and width are taken.
//
// Bound on the H100: device-memory bytes, ~4 read and 4 written an output
// pixel, with the float pipe close behind: without FMAs an output costs 2U
// float instructions (U = 24: ~0.15 ms of issue for an 8192 x 12288 chunk
// against its 0.24 ms byte bound).
//
// Design: register-blocked outputs.  A thread owns V adjacent columns and,
// in turn, groups of K consecutive output rows of its block's row tile,
// with K x V accumulators in registers.  The taps run in the outer loop:
// tap t adds cu[t] * p[y + k + t] to accumulator k for every k, so each
// accumulator receives its taps in ascending v, the plain version's order,
// while the tap costs one input-row load and one weight load for K x V
// outputs.  The input rows sit in a ring of R = K + D registers (V floats
// each): after tap t row y + t is dead and its slot takes row y + t + R,
// first read D + 1 taps later.  The tap loop is unrolled by R, so every
// ring index is static: no register moves and no dynamic indexing.  U
// stays a runtime value (taps past U are skipped), so any row bound works.
// Each input row is read once from device memory and (K + U - 1) / K times
// from L1 / L2 (the next group re-reads the U - 1 halo rows), against U
// times in the first version of this kernel.  A block stages its columns'
// weights in shared memory once (in chunks of taps when U is too large for
// 48 KB, re-staged for each group), and each thread reads a tap's weights
// one tap ahead.  K = 16 and D = 8 (a 24-slot ring); V is 2 where the
// width and the pointers allow 8-byte vectors, else 1.
// ops/resample.row_pass_geometry picks V, the threads a block, the row
// tile (a multiple of K) and the weight chunk.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 48 * 1024;   // the weights a block stages
constexpr int K = 16;   // output rows a thread sums at once
constexpr int D = 8;    // taps between a row's load and its first use, - 1
constexpr int R = K + D;   // input ring slots, the tap loop's unroll

// V adjacent float columns, loaded and stored as one 4V-byte vector
template <int V> struct Vec { float v[V]; };
template <> struct __align__(8) Vec<2> { float v[2]; };

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  return *reinterpret_cast<const Vec<V>*>(p);
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
    row_pass_kernel(const float* __restrict__ padded,
                    const float* __restrict__ cu, float* __restrict__ out,
                    int rows, int width, int n_taps, int tile_rows,
                    int chunk) {
  extern __shared__ float w_s[];   // (chunk, cols): taps [c0, c0 + chunk)
  const int cols = blockDim.x * V;
  const int col0 = blockIdx.x * cols;
  // a thread past the width recomputes the last columns and stores nothing,
  // so every thread reaches the block's barriers
  const bool store = col0 + static_cast<int>(threadIdx.x) * V < width;
  const int x = min(col0 + static_cast<int>(threadIdx.x) * V, width - V);
  const int n_cols = min(cols, width - col0);   // the block's real columns
  const size_t ld = width;
  const float* pcol = padded + x;
  int staged = -1;   // first tap of the chunk in w_s
  const int n_tiles = (rows + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int r_end = min((tile + 1) * tile_rows, rows);
    for (int y = tile * tile_rows; y < r_end; y += K) {
      const int nk = min(K, r_end - y);
      // taps t < row_lim refill the ring: input rows below
      // y + nk + n_taps - 1 are read
      const int row_lim = nk + n_taps - 1 - R;
      float acc[K][V];
      Vec<V> win[R];
      const float* p = pcol + y * ld;
#pragma unroll
      for (int s = 0; s < R; ++s) {
#pragma unroll
        for (int c = 0; c < V; ++c)
          win[s].v[c] = 0.0f;   // the slots no output reads stay defined
        if (s < row_lim + R) win[s] = load<V>(p + s * ld);
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int c = 0; c < V; ++c) acc[k][c] = 0.0f;
      p += R * ld;                         // row y + R, tap 0's refill
      for (int c0 = 0; c0 < n_taps; c0 += chunk) {
        const int c_end = min(c0 + chunk, n_taps);
        if (c0 != staged) {   // uniform: every thread runs the same loops
          __syncthreads();
          for (int i = threadIdx.x; i < (c_end - c0) * n_cols;
               i += blockDim.x) {
            const int t = i / n_cols, c = i - t * n_cols;
            w_s[t * cols + c] = cu[(c0 + t) * ld + col0 + c];
          }
          __syncthreads();
          staged = c0;
        }
        // slot s of win holds row y + t with t = s (mod R); w[t % 2] the
        // weights of tap t, read from w_s one tap ahead
        const float* pw = w_s + (x - col0);
        Vec<V> w[2];
        w[0] = load<V>(pw);
        w[1] = w[0];
        pw += cols;
        for (int t0 = c0; t0 < c_end; t0 += R) {
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int t = t0 + j;
            if (t >= c_end) break;
            if (t + 1 < c_end) w[(j + 1) % 2] = load<V>(pw);
            pw += cols;
#pragma unroll
            for (int k = 0; k < K; ++k)
#pragma unroll
              for (int c = 0; c < V; ++c)
                acc[k][c] = __fadd_rn(
                    acc[k][c],
                    __fmul_rn(win[(j + k) % R].v[c], w[j % 2].v[c]));
            // row y + t is dead: its slot takes row y + t + R, first read
            // D + 1 taps later
            if (t < row_lim) win[j] = load<V>(p);
            p += ld;
          }
        }
      }
      if (store) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k < nk) {
            Vec<V> o;
#pragma unroll
            for (int c = 0; c < V; ++c) o.v[c] = acc[k][c];
            *reinterpret_cast<Vec<V>*>(out + (y + k) * ld + x) = o;
          }
        }
      }
    }
  }
}

template <int V>
int launch(const float* padded, const float* cu, float* out, int rows,
           int width, int n_taps, int threads, int tile_rows, int chunk,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * chunk * threads * V;
  const int n_tiles = (rows + tile_rows - 1) / tile_rows;
  const int cols = threads * V;
  const dim3 grid((width + cols - 1) / cols,
                  n_tiles < 65535 ? n_tiles : 65535);
  row_pass_kernel<V><<<grid, threads, smem, stream>>>(
      padded, cu, out, rows, width, n_taps, tile_rows, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// padded: contiguous (rows + n_taps - 1, width) float32; cu: contiguous
// (n_taps, width) float32; out: contiguous (rows, width) float32.  vec: the
// adjacent columns a thread owns, 1 or 2 (width and the three pointers must
// be multiples of vec floats); threads: a multiple of 32 up to 256;
// tile_rows: the rows a block owns, a multiple of K = 16; chunk: the taps
// whose weights a block stages in shared memory at once, a multiple of
// R = 24 (chunk * threads * vec floats, at most 48 KB).
extern "C" int oip_row_pass(const void* padded, const void* cu, void* out,
                            int rows, int width, int n_taps, int vec,
                            int threads, int tile_rows, int chunk,
                            void* stream) {
  if (rows < 0 || width < 0 || n_taps < 1 || (vec != 1 && vec != 2) ||
      width % vec || threads < 32 || threads > kMaxThreads || threads % 32 ||
      tile_rows < K || tile_rows % K || chunk < R || chunk % R ||
      sizeof(float) * chunk * threads * vec > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {padded, cu, static_cast<const void*>(out)})
    if (reinterpret_cast<size_t>(ptr) % (4 * vec))
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows == 0 || width == 0) return 0;
  const auto* p = static_cast<const float*>(padded);
  const auto* c = static_cast<const float*>(cu);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec == 2
      ? launch<2>(p, c, o, rows, width, n_taps, threads, tile_rows, chunk, s)
      : launch<1>(p, c, o, rows, width, n_taps, threads, tile_rows, chunk, s);
}

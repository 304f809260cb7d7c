// Kernel (j): the whitened cross-power of the full-surface
// cv::phaseCorrelate, C = Fa conj(Fb) / |Fa conj(Fb)| (|C| == 0: divided by
// 1), in one pass over the half spectra.
//
// Replaces no TPU kernel: the JAX package's full surface is jnp.fft, a
// product and jnp.fft.fftshift left to XLA
// (opticalimageprocessor_tpu/ops/phasecorr.py:59-77).  The port ran
// ops/phasecorr.whitened_crosspower there, ~16 plain-torch passes over the
// (T, B, M, K) complex64 stack, each reading the interleaved spectra
// through stride-2 views, Fa once a band where it is broadcast over the
// bands (phase_correlate_tiles' one PAN tile against 4 band tiles).
//
// The arithmetic is whitened_crosspower's, operation for operation, each
// rounded once as PyTorch's elementwise kernels round it: the products,
// sums and differences as __fmul_rn / __fadd_rn / __fsub_rn (which nvcc
// never contracts into an FMA), an IEEE square root and division (the
// build has no --use_fast_math), so C's bits, and the inverse transform's
// after it, are the plain version's.
//
// Bound on the H100: device-memory bandwidth.  Fa read once (8 bytes a
// bin), each band's Fb read once and its C written once (16 bytes a bin
// and band); at the parity registration's tile, (1, 4, 16000, 626), 721 MB,
// 0.215 ms at 3.35 TB/s; at the stt's 10 windows, (10, 16000, 101), 388
// MB.  The ~12 floating-point operations a bin are far below the card's
// float32 rate.  Design: a thread takes two neighbouring bins (one
// 16-byte load of Fa), then loops over the bands, one 16-byte load of Fb
// and one 16-byte store of C a band, so Fa is read once whatever the band
// count; 8-byte items where a plane holds an odd number of bins or a
// pointer is off a 16-byte boundary.  The grid covers (items, outer
// groups), striding where either exceeds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 whiten(float2 a, float2 b) {
  const float pr = __fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  const float pi = __fsub_rn(__fmul_rn(a.y, b.x), __fmul_rn(a.x, b.y));
  const float mag =
      __fsqrt_rn(__fadd_rn(__fmul_rn(pr, pr), __fmul_rn(pi, pi)));
  const float den = mag == 0.0f ? 1.0f : mag;
  return make_float2(__fdiv_rn(pr, den), __fdiv_rn(pi, den));
}

// an item: VEC two bins (float4), else one (float2)
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    surface_whiten_kernel(const float2* __restrict__ fa,
                          const float2* __restrict__ fb,
                          float2* __restrict__ out, int outer, int bands,
                          long long plane) {
  const long long items = VEC ? plane / 2 : plane;
  const long long step = (long long)gridDim.x * kThreads;
  for (int o = blockIdx.y; o < outer; o += gridDim.y) {
    const long long a0 = (long long)o * plane;
    const long long b0 = a0 * bands;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < items; i += step) {
      if constexpr (VEC) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(fa + a0) + i);
        const float4* pb = reinterpret_cast<const float4*>(fb + b0) + i;
        float4* po = reinterpret_cast<float4*>(out + b0) + i;
#pragma unroll 4
        for (int b = 0; b < bands; ++b) {
          const float4 v = __ldcs(pb + b * (plane / 2));
          const float2 lo = whiten(make_float2(a.x, a.y),
                                   make_float2(v.x, v.y));
          const float2 hi = whiten(make_float2(a.z, a.w),
                                   make_float2(v.z, v.w));
          __stcs(po + b * (plane / 2), make_float4(lo.x, lo.y, hi.x, hi.y));
        }
      } else {
        const float2 a = __ldg(fa + a0 + i);
#pragma unroll 4
        for (int b = 0; b < bands; ++b) {
          out[b0 + b * plane + i] = whiten(a, __ldcs(fb + b0 + b * plane + i));
        }
      }
    }
  }
}

template <bool VEC>
int launch(const void* fa, const void* fb, void* out, int outer, int bands,
           long long plane, cudaStream_t stream) {
  const long long items = VEC ? plane / 2 : plane;
  const long long blocks = (items + kThreads - 1) / kThreads;
  dim3 grid(static_cast<unsigned>(blocks < (1LL << 30) ? blocks : 1LL << 30),
            outer < 65535 ? outer : 65535);
  surface_whiten_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const float2*>(fa), static_cast<const float2*>(fb),
      static_cast<float2*>(out), outer, bands, plane);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fa: (outer, plane) complex64; fb and out: (outer, bands, plane) complex64,
// all contiguous, out a buffer of its own (fa and fb are only read).  Each
// of the outer groups' Fa is whitened against its bands' Fb: with bands 1,
// pair against pair; with bands > 1, one spectrum against several.
extern "C" int oip_surface_crosspower(const void* fa, const void* fb,
                                      void* out, int outer, int bands,
                                      long long plane, void* stream) {
  if (outer == 0 || bands == 0 || plane == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(fa) | reinterpret_cast<uintptr_t>(fb) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  return aligned && plane % 2 == 0
             ? launch<true>(fa, fb, out, outer, bands, plane, st)
             : launch<false>(fa, fb, out, outer, bands, plane, st);
}

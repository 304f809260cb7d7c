// Cubic weights, column taps and the rounding of a resampled value, shared
// by the band remap (remap_band.cu), the parity remap (remap_section.cu)
// and the stitch tail (stitch_tail.cu).
//
// Every float32 operation is written as an _rn intrinsic so that nvcc
// cannot contract a multiply and an add into an FMA: the weights and
// coordinates must round exactly like the float32 reference expressions
// (opticalimageprocessor_tpu/ops/resample.py::_cubic_weights_f32 and
// ::_col_interp_matrix), or taps move by an ulp and outputs by a DN.
#pragma once

// OpenCV interpolateCubic (A = -0.75) in the reference's expression order.
__device__ __forceinline__ void oip_cubic_weights(float t, float w[4]) {
  const float A = -0.75f;
  const float tp1 = __fadd_rn(t, 1.0f);
  // w0 = ((A*tp1 - 5A)*tp1 + 8A)*tp1 - 4A
  w[0] = __fsub_rn(
      __fmul_rn(
          __fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(A, tp1), 5.0f * A), tp1),
                    8.0f * A),
          tp1),
      4.0f * A);
  // w1 = ((A+2)*t - (A+3))*t*t + 1
  w[1] = __fadd_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(A + 2.0f, t), A + 3.0f), t), t),
      1.0f);
  const float omt = __fsub_rn(1.0f, t);
  w[2] = __fadd_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(A + 2.0f, omt), A + 3.0f), omt),
                omt),
      1.0f);
  w[3] = __fsub_rn(__fsub_rn(__fsub_rn(1.0f, w[0]), w[1]), w[2]);
}

// Column taps of output column x: mapx = (cx1*xx + cx0 + xx)/4 with
// xx = 4x, first tap floor(mapx) - 1, weights from the fraction.  Returns
// the first tap's index inside the block window [block_start - halo,
// block_start + block + halo) and zeroes the weight of every tap that the
// banded column matrix drops: taps outside the image (border value 0) and
// taps outside the block window (|mapx - x| beyond the halo).
__device__ __forceinline__ int oip_col_taps(int x, float cx0, float cx1,
                                            int width, int block, int halo,
                                            float w[4]) {
  const float xx = __fmul_rn(static_cast<float>(x), 4.0f);
  const float mapx =
      __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(cx1, xx), cx0), xx), 4.0f);
  const float fl = floorf(mapx);
  oip_cubic_weights(__fsub_rn(mapx, fl), w);
  const int tap0 = static_cast<int>(fl) - 1;
  const int loc0 = tap0 - ((x / block) * block - halo);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int a = tap0 + b;
    const int l = loc0 + b;
    if (a < 0 || a >= width || l < 0 || l >= block + 2 * halo) w[b] = 0.0f;
  }
  return loc0;
}

// The reference's rounding of a resampled value, (uint16) clip(rint(v), 0,
// 65535), in the low 16 bits of the result: clipping first is the same on
// [0, 65535] (NaN -> 0), and adding 1.5 * 2^23 rounds half to even into
// the low mantissa bits (no type conversion)
__device__ __forceinline__ unsigned int oip_round_u16_bits(float v) {
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(v, 0.0f), 65535.0f), 12582912.0f));
}

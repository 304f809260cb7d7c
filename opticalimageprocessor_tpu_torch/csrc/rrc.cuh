// Relative radiometric correction of one pixel, shared by the RRC kernel
// (rrc.cu) and the stitch tail (stitch_tail.cu).
//
// Reference semantics (imageop.h:129-138): dst = (uint16_t)(k * src + b)
// with k, b C doubles on an x86-64 build: a double multiply, then a double
// add (the reference build does not contract them into an FMA, and nvcc
// would, hence the explicit _rn intrinsics), truncation toward zero through
// an int32 conversion whose low 16 bits are kept (negative values wrap two's
// complement), and cvttsd2si's out-of-range result 0x80000000 for
// |v| >= 2^31 or NaN, whose low 16 bits are 0.  __double2int_rz is not used
// on out-of-range values because it saturates instead.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint16_t oip_rrc_pixel(uint16_t s, double k,
                                                  double b) {
  const double v = __dadd_rn(__dmul_rn(k, static_cast<double>(s)), b);
  if (!(fabs(v) < 2147483648.0)) return 0;
  return static_cast<uint16_t>(static_cast<int32_t>(trunc(v)));
}

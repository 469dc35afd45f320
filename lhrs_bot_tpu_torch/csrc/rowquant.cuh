// The symmetric int8 code of one value of a row, shared by kernel A
// (ln_quant.cu) and K3's fused mode (w4a8_matmul.cu), which must give the
// same bits as `quantize_activation`: s = amax / 127 (1 where amax is 0),
// code = clip(rint(h / s), -127, 127), with h / s rounded to nearest as an
// IEEE division.
//
// __fdiv_rn(h, s) for every element costs a range check and a call to a
// slow path, whose registers limit the rows in flight. The scale is one per
// row, so its correctly rounded reciprocal y = RN(1 / s) is taken once and
// each quotient is q0 = RN(h y), then two steps q = RN(q + r y) on the
// remainder r = h - s q (exact by FMA): the first makes q faithful, and
// with y within half an ulp of 1 / s the second gives RN(h / s) exactly
// (Markstein's theorem), barring underflow. No overflow can occur (|h| <=
// amax, so |h / s| <= 127 or so). Underflow: where |h / s| >= 1/4 (the
// only quotients whose code can be other than 0) and s >= 2^-64, |h| >=
// 2^-66 and the remainders, multiples of ulp(h) / 2^24 or so, stay far
// above 2^-126; where |h / s| < 1/4 every approximation gives code 0 as the
// true quotient does. A row with s < 2^-64 has h and s both scaled by
// 2^100 first (s then lies in [2^-49, 2^36)), which is exact and leaves the
// quotient as it was.

#pragma once

#include <stdint.h>

struct RowScale {
  float s;    // the row's scale
  float pre;  // 1, or 2^100 where s < 2^-64: h * pre / (s * pre) = h / s
  float sp;   // s * pre, at least 2^-64
  float y;    // RN(1 / sp)
};

// from a scale already formed
__device__ __forceinline__ RowScale row_scale_of(float s) {
  RowScale r;
  r.s = s;
  r.pre = s < __int_as_float(0x1f800000)     // 2^-64
              ? __int_as_float(0x71800000)  // 2^100
              : 1.f;
  r.sp = __fmul_rn(s, r.pre);
  r.y = __frcp_rn(r.sp);
  return r;
}

// from the row's amax
__device__ __forceinline__ RowScale row_scale(float amax) {
  return row_scale_of(amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f));
}

// RN(a / sp) for y = RN(1 / sp), |a| <= 127 sp or so: q0 = RN(a y), then
// two remainder steps
__device__ __forceinline__ float quotient_steps(float a, float sp, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-q, sp, a), y, q);
  return __fmaf_rn(__fmaf_rn(-q, sp, a), y, q);
}

// RN(h / s) for |h| <= 127 s or so
__device__ __forceinline__ float row_quotient(float h, const RowScale& r) {
  // exact: a power of two, no overflow
  return quotient_steps(__fmul_rn(h, r.pre), r.sp, r.y);
}

// The codes of 4 values of the row, packed into a word (the first value
// in the low byte). The clip to [-127, 127] never binds, so none is made:
// |h| <= amax, and s = RN(amax / 127) >= (amax / 127) (1 - 2^-24), so
// |h / s| < 127.0001 and rounds to at most 127 in magnitude.
__device__ __forceinline__ uint32_t row_codes4(const float (&h)[4],
                                               const RowScale& r) {
  const int c0 = __float2int_rn(row_quotient(h[0], r));  // half to even
  const int c1 = __float2int_rn(row_quotient(h[1], r));
  const int c2 = __float2int_rn(row_quotient(h[2], r));
  const int c3 = __float2int_rn(row_quotient(h[3], r));
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                     0x5410);
}

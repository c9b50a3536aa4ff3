// Two-float f32 arithmetic of the f32 spectrum, shared by B3-f32
// (csrc/amplify.cu) and B4-f32 (csrc/emissivity.cu): the device form of
// raytrace_tpu_torch/ops/twofloat.py, operation by operation.
//
// An error-free transform is error-free only where no product and sum are
// fused into one rounding: the library is compiled with -fmad=false, so
// every product and sum here rounds on its own, as the twin's separate
// PyTorch operations do.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kLog2e = 0x1.715476p+0f;   // f32(log2 e)
constexpr float kLn2Hi = 0x1.62e4p-1f;     // ln2's high part, 12 zero bits
constexpr float kLn2Lo = 0x1.7f7d1cp-20f;  // ln2 - kLn2Hi in f32
// f32(ln2 / 2): the bound of expm1's direct polynomial
constexpr float kHalfLn2 = 0x1.62e43p-2f;
// |n| past this scales to 0 or inf, as the true result does
constexpr float kNMax = 252.0f;

// Knuth's two-sum: a + b = s + err exactly
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& err) {
  s = a + b;
  const float bb = s - a;
  err = (a - (s - bb)) + (b - bb);
}

// 2^n for n in [-126, 127]
__device__ __forceinline__ float pow2(int n) {
  return __int_as_float((n + 127) << 23);
}

// 1 + f/2 (1 + f/3 (... (1 + f/7))) with the f32 reciprocals 1/k: the
// Taylor series' tail
__device__ __forceinline__ float horner(float f) {
  float e = 1.0f + f * 0x1.24924ap-3f;             // 1/7
  e = 1.0f + (f * 0x1.555556p-3f) * e;             // 1/6
  e = 1.0f + (f * 0x1.99999ap-3f) * e;             // 1/5
  e = 1.0f + (f * 0x1p-2f) * e;                    // 1/4
  e = 1.0f + (f * 0x1.555556p-2f) * e;             // 1/3
  return 1.0f + (f * 0x1p-1f) * e;                 // 1/2
}

// exp(hi + lo): n = round(hi log2e) (half to even), f = ((hi - n ln2_hi)
// + lo) - n ln2_lo, e^f = 1 + f horner(f), scaled by 2^n as two exact
// powers of two (one rounding, overflow to inf and gradual underflow as
// ldexp). n is clamped to [-kNMax, kNMax] and a NaN n scales by 1, as the
// twin's ldexp_f32 (fminf and fmaxf alone would take a NaN n to -kNMax)
__device__ __forceinline__ float exp_fast2(float hi, float lo) {
  const float n = rintf(hi * kLog2e);
  const float f = ((hi - n * kLn2Hi) + lo) - n * kLn2Lo;
  const float e = 1.0f + f * horner(f);
  const int ni = n == n ? (int)fminf(fmaxf(n, -kNMax), kNMax) : 0;
  const int n1 = ni >> 1;  // floor(ni / 2)
  return (e * pow2(n1)) * pow2(ni - n1);
}

// expm1(hi + lo) given e = exp_fast2(hi, lo): the direct polynomial where
// |hi| <= ln2 / 2 (no cancellation), e - 1 elsewhere
__device__ __forceinline__ float expm1_from_exp(float e, float hi, float lo) {
  if (fabsf(hi) <= kHalfLn2) {
    const float f = hi + lo;
    return f * horner(f);
  }
  return e - 1.0f;
}

}  // namespace

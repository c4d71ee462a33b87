// Error-free float32 arithmetic shared by the power-sum kernels.
//
// CUDA counterpart of repro_torch/kernels/sampled_agg/compensated.py.  The
// intrinsics __fadd_rn / __fsub_rn / __fmul_rn round to nearest and are
// never contracted into an FMA or reassociated by nvcc, so the (hi, lo)
// pairs stay error-free transformations whatever the optimisation level.
#pragma once

// Knuth two-sum: s = fl(a + b), s + e == a + b exactly.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bp = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bp)), __fsub_rn(b, bp));
}

// Associative combine of (hi, lo) pairs, a preceding b (the scan operator).
__device__ __forceinline__ void comp_combine(float a_hi, float a_lo, float b_hi,
                                             float b_lo, float& hi, float& lo) {
  float s, e;
  two_sum(a_hi, b_hi, s, e);
  hi = s;
  lo = __fadd_rn(__fadd_rn(a_lo, b_lo), e);
}

// The four shifted powers u, u^2, u^3, u^4 of one value.
__device__ __forceinline__ void powers4(float v, float shift, float p[4]) {
  const float u = __fsub_rn(v, shift);
  const float u2 = __fmul_rn(u, u);
  p[0] = u;
  p[1] = u2;
  p[2] = __fmul_rn(u2, u);
  p[3] = __fmul_rn(u2, u2);
}

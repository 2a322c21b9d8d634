// Device code shared by K1 (matern32_gram.cu) and K2 (matern32_gram_vjp.cu):
// the raw distance, S, the product and sum over dimensions, and C0.
//
//   S_t  = |x1[i,t] - x2[j,t]| * inv_l[k,t]        (subtract first)
//   prod = prod_t (1 + S_t),  ssum = sum_t S_t,  C0 = prod * exp(-ssum)
//
// Both kernels form C0 with these functions, and every step is an
// explicitly rounded operation (__dmul_rn, __dadd_rn, fma), so the compiler
// cannot contract them differently in the two files: K2's recomputed C0 is
// K1's bit for bit.  The product runs as prod = fma(prod, S, prod), one
// rounding per factor where prod * (1 + S) takes two.
//
// Subtracting first makes the same-point Gram exactly symmetric: |a - b|
// and |b - a| are the same IEEE value, and so is every step after it, so
// one triangle of tiles determines the other.
#pragma once

#include <cuda_runtime.h>

namespace lcgp {

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float exp_t(float v) { return expf(v); }

// The raw distance in one dimension.
template <typename T>
__device__ __forceinline__ T absdiff(T a, T b) {
  return fabs(add_rn(a, -b));
}

// From the d raw distances and the component's 1/l row: s[t] = S_t,
// pre[t] = prod_{u < t} (1 + S_u) (the prefix products K2 needs; K1 leaves
// them dead), prod = prod_t (1 + S_t) and ssum = sum_t S_t.  Entries t >= d
// are left unset.
template <typename T, int MAXD>
__device__ __forceinline__ void factors(const T (&diff)[MAXD], const T* inv,
                                        int d, T (&s)[MAXD], T (&pre)[MAXD],
                                        T& prod, T& ssum) {
  prod = T(1);
  ssum = T(0);
#pragma unroll
  for (int t = 0; t < MAXD; ++t) {
    if (t < d) {
      s[t] = mul_rn(diff[t], inv[t]);
      pre[t] = prod;
      prod = fma_rn(prod, s[t], prod);
      ssum = add_rn(ssum, s[t]);
    }
  }
}

// exp(-sum_t S_t)
template <typename T>
__device__ __forceinline__ T decay(T ssum) {
  return exp_t(-ssum);
}

// C0 from the product and the decay.
template <typename T>
__device__ __forceinline__ T c0_of(T prod, T e) {
  return mul_rn(prod, e);
}

// The tile (ti, tj) of block b.  A same-point Gram walks the lower triangle
// of tiles (ti >= tj) row by row, b = ti (ti + 1) / 2 + tj; a cross Gram
// walks the whole rectangle of ntj tile columns row by row.
__device__ __forceinline__ void tile_of(long long b, int same, int ntj,
                                        int& ti, int& tj) {
  if (same) {
    long long t = (long long)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
    while (t * (t + 1) / 2 > b) --t;
    while ((t + 1) * (t + 2) / 2 <= b) ++t;
    ti = (int)t;
    tj = (int)(b - t * (t + 1) / 2);
  } else {
    ti = (int)(b / ntj);
    tj = (int)(b % ntj);
  }
}

}  // namespace lcgp

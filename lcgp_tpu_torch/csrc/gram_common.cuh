// Device code shared by the Gram kernels (gram_kernel.cuh: K1 and K4's
// forward; matern52_gram_kernel.cuh: K3's) and the Gram-VJP kernels
// (gram_vjp_kernel.cuh: K2; matern52_gram_vjp_kernel.cuh: K3's and K4's;
// gram_vjp_x_kernel.cuh: K5): explicitly rounded arithmetic, the raw
// distance, the three kernel families as policies, and the triangle walk
// over tiles.
//
// Every family is separable in the scaled distances
//
//   S_t  = |x1[i,t] - x2[j,t]| * inv_l[k,t]        (subtract first)
//
// and its correlation is a product of per-dimension factors times one decay:
//
//   Matern32: C0 = prod_t (1 + S_t)                      * exp(-sum_t S_t)
//   Matern52: C0 = prod_t (1 + sqrt5 S_t + 5/3 S_t^2)    * exp(-sqrt5 sum_t S_t)
//   SE:       C0 =                                          exp(-1/2 sum_t S_t^2)
//
// A policy supplies what differs: the factor (grow: prod times the factor,
// one rounding through an fma; kFactor false where there is none), the
// decay (accum, decay), and the two VJPs' per-dimension terms, formed
// without a division from the prefix product of the factors below t and a
// suffix product started at the cotangent times the decay:
//
// - the lengthscale term cbar C0 dlnC0/dlnS_t: K2's lens_term (the suffix
//   recomputes each factor), or lens_step (the factor's product Q_t and its
//   step G_t = f_t - 1 kept, so that the suffix sweep is two fmas a
//   dimension; K3's VJP).  SE's VJP (K4's, matern52_gram_vjp_kernel.cuh)
//   forms its term cbar e S_t^2 from the raw differences itself;
// - the position term M C0 g(S_t) sign(x1 - x2), dC0/dS_t = -C0 g(S_t):
//   x_step (K5), from the signed scaled difference, so that it is 0 at
//   S_t = 0 and needs no sign test;
//
// and lens_sum, a constant factor of both terms applied once to a reduced
// sum.
//
// Both kernels of a family form C0 with these functions, and every step is
// an explicitly rounded operation (__dmul_rn, __dadd_rn, fma), so the
// compiler cannot contract them differently in the two files: the VJP's
// recomputed C0 is the forward's bit for bit.
//
// Subtracting first makes the same-point Gram exactly symmetric: |a - b|
// and |b - a| are the same IEEE value, and so is every step after it, so
// one triangle of tiles determines the other.  On the diagonal every S_t is
// exactly 0, so C0 is exactly 1 in every family and the lengthscale terms
// vanish.
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

// sqrt(5) and 5/3 rounded to double, as Python's math.sqrt(5.0) and
// 5.0 / 3.0 give them to the plain versions; the f32 instantiations round
// these once more.
constexpr double SQRT5 = 0x1.1e3779b97f4a8p+1;
constexpr double FIVE_THIRDS = 0x1.aaaaaaaaaaaabp+0;

// Matern 3/2: factor 1 + S, decay exp(-sum S), lengthscale term
// cbar C0 S^2 / (1 + S).
struct Matern32 {
  static constexpr bool kFactor = true;
  static constexpr bool kGuardUnderflow = false;
  // the forward's blocks per SM: its registers at 256 threads a block
  static constexpr int fwd_min_blocks(int maxd) { return maxd <= 8 ? 3 : 2; }
  template <typename T>
  static __device__ __forceinline__ T grow(T prod, T s) {
    return fma_rn(prod, s, prod);
  }
  template <typename T>
  static __device__ __forceinline__ T accum(T ssum, T s) {
    return add_rn(ssum, s);
  }
  // accum(0, s), exactly (S is never -0), without the addition
  template <typename T>
  static __device__ __forceinline__ T accum0(T s) {
    return s;
  }
  template <typename T>
  static __device__ __forceinline__ T decay(T ssum) {
    return exp_t(-ssum);
  }
  template <typename T>
  static __device__ __forceinline__ T c0(T prod, T e) {
    return mul_rn(prod, e);
  }
  // (cbar e prod_{u>t}) (prod_{u<t}) S_t^2
  template <typename T>
  static __device__ __forceinline__ T lens_term(T pre, T suf, T s) {
    return (pre * suf) * s * s;
  }
  // g = S / (1 + S): M C0 g sign = (M e prod_{u>t}) (prod_{u<t}) sd, with
  // sd the signed S; G = f - 1 = S
  template <typename T>
  static __device__ __forceinline__ void x_step(T sd, T s, T& prod, T& Q,
                                                T& G) {
    Q = prod * sd;
    G = s;
    prod = fma_rn(prod, s, prod);
  }
  static __device__ __forceinline__ double lens_sum(double g) { return g; }
};

// Matern 5/2: factor 1 + sqrt5 S + 5/3 S^2 = 1 + S (sqrt5 + 5/3 S), decay
// exp(-sqrt5 sum S), lengthscale term cbar C0 5/3 S^2 (1 + sqrt5 S) / factor.
// In f32 the product overflows where the decay has underflowed to 0 (it
// never does before: ln(factor) <= sqrt5 S), so C0 is 0 there, not inf * 0.
struct Matern52 {
  static constexpr bool kFactor = true;
  static constexpr bool kGuardUnderflow = true;
  template <typename T>
  static __device__ __forceinline__ T grow(T prod, T s) {
    const T g = mul_rn(fma_rn(T(FIVE_THIRDS), s, T(SQRT5)), s);
    return fma_rn(prod, g, prod);
  }
  template <typename T>
  static __device__ __forceinline__ T accum(T ssum, T s) {
    return add_rn(ssum, s);
  }
  // accum(0, s), exactly (S is never -0), without the addition
  template <typename T>
  static __device__ __forceinline__ T accum0(T s) {
    return s;
  }
  template <typename T>
  static __device__ __forceinline__ T decay(T ssum) {
    return exp_t(mul_rn(T(-SQRT5), ssum));
  }
  template <typename T>
  static __device__ __forceinline__ T c0(T prod, T e) {
    return e == T(0) ? T(0) : mul_rn(prod, e);
  }
  // The lengthscale term's sweep: Q = (prod_{u<t} f_u) S^2 (1 + sqrt5 S),
  // G = f - 1 (the factor as grow forms it, once), and prod grown by f; the
  // term is (cbar e prod_{u>t} f_u) Q, and 5/3 goes once on the sum
  // (lens_sum)
  template <typename T>
  static __device__ __forceinline__ void lens_step(T s, T& prod, T& Q,
                                                   T& G) {
    const T gt = mul_rn(fma_rn(T(FIVE_THIRDS), s, T(SQRT5)), s);
    const T hs = fma_rn(T(SQRT5), s, T(1));
    Q = prod * ((s * s) * hs);
    G = gt;
    prod = fma_rn(prod, gt, prod);
  }
  // g = 5/3 S (1 + sqrt5 S) / factor: the products times sd (1 + sqrt5 S),
  // and 5/3 once on the sum
  template <typename T>
  static __device__ __forceinline__ void x_step(T sd, T s, T& prod, T& Q,
                                                T& G) {
    const T gt = mul_rn(fma_rn(T(FIVE_THIRDS), s, T(SQRT5)), s);
    const T hs = fma_rn(T(SQRT5), s, T(1));
    Q = prod * (sd * hs);
    G = gt;
    prod = fma_rn(prod, gt, prod);
  }
  static __device__ __forceinline__ double lens_sum(double g) {
    return FIVE_THIRDS * g;
  }
};

// Squared exponential: no factor (prod stays 1, and there are no prefix or
// suffix products), decay exp(-1/2 sum S^2), lengthscale term cbar C0 S^2,
// position term M C0 sd.
struct SE {
  static constexpr bool kFactor = false;
  static constexpr bool kGuardUnderflow = false;
  // f32 at MAXD 16 needs more registers than 2 blocks leave
  static constexpr int fwd_min_blocks(int maxd) { return maxd <= 8 ? 3 : 1; }
  template <typename T>
  static __device__ __forceinline__ T grow(T prod, T) {
    return prod;
  }
  template <typename T>
  static __device__ __forceinline__ T accum(T ssum, T s) {
    return fma_rn(s, s, ssum);
  }
  template <typename T>
  static __device__ __forceinline__ T accum0(T s) {
    return mul_rn(s, s);
  }
  template <typename T>
  static __device__ __forceinline__ T decay(T ssum) {
    return exp_t(mul_rn(T(-0.5), ssum));
  }
  template <typename T>
  static __device__ __forceinline__ T c0(T, T e) {
    return e;
  }
  // g = S: the term is (M e) sd
  template <typename T>
  static __device__ __forceinline__ void x_step(T sd, T, T&, T& Q, T&) {
    Q = sd;
  }
  static __device__ __forceinline__ double lens_sum(double g) { return g; }
};

// From the d raw distances and the component's 1/l row: s[t] = S_t,
// pre[t] = the product of the factors below t (the prefix products the VJP
// needs; the forward leaves them dead), prod = the product of all d factors
// and ssum = the decay's sum.  Entries t >= d are left unset.
template <typename P, typename T, int MAXD>
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
      prod = P::grow(prod, s[t]);
      ssum = P::accum(ssum, s[t]);
    }
  }
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

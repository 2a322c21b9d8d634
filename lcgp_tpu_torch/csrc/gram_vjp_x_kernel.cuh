// K5: the Gram-stack VJP with respect to the points of the second operand,
// for Hopper (sm_90a), one template for the three kernel families
// (gram_common.cuh's policies), instantiated in gram_vjp_x.cu.
//
// For a cotangent M (q, n1, n2) of C = gram(x1, x2) it computes
//
//   gx2[b,t] = sum_k sum_a M[k,a,b] dC[k,a,b]/dx2[b,t]
//            = sum_k amp_k (1 - eta_k) inv_l[k,t]
//                    sum_a M[k,a,b] C0[k,a,b] g(S_t) sign(x1[a,t] - x2[b,t])
//
// with S_t = |x1[a,t] - x2[b,t]| inv_l[k,t] and dC0/dS_t = -C0 g(S_t)
// (Matern 3/2: g = S / (1 + S); Matern 5/2: g = 5/3 S (1 + sqrt5 S) /
// (1 + sqrt5 S + 5/3 S^2); SE: g = S).  The nugget's diagonal does not
// depend on x, so there is no nugget term.  The gradient with respect to
// x1 is the same function of (x2, x1, M^T).
//
// No TPU kernel: lcgp_tpu gets this gradient from jax.grad through its jnp
// Gram (lcgp_tpu/models/sparse.py, used by LCGP.refine_inducing), and the
// retired Pallas kernel's custom_vjp returned zeros for x.
//
// C0 g(S_t) is formed without a division, with the prefix products of
// factors() and a suffix product started at M amp (1 - eta) e
// (gram_common.cuh's x_term),
// so it is exactly 0 where S_t = 0 (coincident points, Kmm's diagonal).
//
// What bounds it on the card: the read of M (each entry once) against
// about 9d + 18 instructions per entry and component (Matern 3/2): at
// (4, 50000, 256), d = 2, f64, 0.12 ms to read M and 0.11 ms of f64
// arithmetic.  This first version is simple: a block owns 64 columns
// (points of x2) and 128 rows (points of x1); a thread owns one column and
// every fourth row, so a warp reads 32 consecutive entries of M; the
// block's x1 rows and x2 columns are staged in shared memory.  Each entry's
// terms are formed in T with the component's amp (1 - eta) and 1/l_t
// folded in, and each thread sums them in f64 over its rows and the
// components.
//
// The column reduction is deterministic, with no atomics: the four row
// groups of a block are summed in shared memory in a fixed order, every
// block writes its (64, d) f64 partial sums to a scratch buffer the caller
// allocates (one row of blocks per 128 rows of x1), and a second kernel
// sums each output's partials in a fixed order.  The same shapes give the
// same bits on every run.
//
// The launchers launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launches.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "gram_common.cuh"

namespace {

constexpr int XC = 64;              // columns of a block: one per thread
constexpr int XBY = 4;              // row groups: rows ty + XBY m
constexpr int XNT = XC * XBY;
constexpr int XR = 128;             // rows of a block

inline long long vjpx_row_blocks(int n1) { return (n1 + XR - 1) / XR; }
inline long long vjpx_col_blocks(int n2) { return (n2 + XC - 1) / XC; }

// the row groups' sums of one t, the block's rows of x1, and its columns'
// x2 at an odd pitch (51.7 KB at MAXD 32 in f64: dynamic shared memory)
template <typename T, int MAXD>
constexpr size_t vjpx_smem_bytes() {
  return sizeof(double) * XBY * XC + sizeof(T) * (XR * MAXD + XC * (MAXD + 1));
}

template <typename T, int MAXD, typename P>
__global__ void __launch_bounds__(XNT, MAXD <= 8 ? 2 : 1)
gram_vjp_x_partials_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                           const T* __restrict__ inv_l,
                           const T* __restrict__ amp,
                           const T* __restrict__ nug,
                           const T* __restrict__ M, int q, int n1, int n2,
                           int d, double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_red = reinterpret_cast<double*>(smem);   // [XBY][XC]
  T* s_x1 = reinterpret_cast<T*>(s_red + XBY * XC);  // [XR][MAXD]
  T* s_x2 = s_x1 + XR * MAXD;                         // [XC][MAXD + 1]

  const int tid = threadIdx.x;
  const int tx = tid % XC, ty = tid / XC;
  const int a0 = blockIdx.x * XR;
  const int b = blockIdx.y * XC + tx;
  const bool col = b < n2;
  const long long plane = (long long)n1 * n2;

  for (int e = tid; e < XR * MAXD; e += XNT) {
    const int r = e / MAXD, t = e % MAXD;
    s_x1[e] = (t < d && a0 + r < n1) ? x1[(long long)(a0 + r) * d + t] : T(0);
  }
  for (int e = tid; e < XC * MAXD; e += XNT) {
    const int c = e / MAXD, t = e % MAXD;
    const int g = blockIdx.y * XC + c;
    s_x2[c * (MAXD + 1) + t] =
        (t < d && g < n2) ? x2[(long long)g * d + t] : T(0);
  }
  __syncthreads();
  const T* xb = s_x2 + tx * (MAXD + 1);

  double acc[MAXD];
#pragma unroll
  for (int t = 0; t < MAXD; ++t) acc[t] = 0.0;

  const int rows = min(XR, n1 - a0);
  for (int k = 0; k < q; ++k) {
    T inv[MAXD];
#pragma unroll
    for (int t = 0; t < MAXD; ++t) {
      inv[t] = t < d ? inv_l[(long long)k * d + t] : T(0);
    }
    const T* Mk = M + k * plane;
    // amp (1 - eta), folded into the start of the suffix product
    const T ck = amp[k] * (T(1) - nug[k] / (T(1) + nug[k]));
    for (int r = ty; col && r < rows; r += XBY) {
      const T* xa = s_x1 + r * MAXD;
      const T m = Mk[(long long)(a0 + r) * n2 + b];
      T diff[MAXD], s[MAXD], pre[MAXD], prod, ssum;
#pragma unroll
      for (int t = 0; t < MAXD; ++t) diff[t] = lcgp::absdiff(xa[t], xb[t]);
      lcgp::factors<P, T, MAXD>(diff, inv, d, s, pre, prod, ssum);
      const T e = P::decay(ssum);
      // C0 == 0: every term is 0, and a prefix product may have overflowed
      // (Matern 5/2 in f32)
      if (P::kGuardUnderflow && e == T(0)) continue;
      T suf = (m * ck) * e;   // M amp (1 - eta) decay prod_{u > t} f_u
#pragma unroll
      for (int t = MAXD - 1; t >= 0; --t) {
        if (t < d) {
          // times the sign of x1 - x2, from the subtraction absdiff rounded
          const T term = P::x_term(pre[t], suf, s[t]) * inv[t];
          acc[t] += (double)(lcgp::add_rn(xa[t], -xb[t]) < T(0) ? -term
                                                                 : term);
          suf = P::grow(suf, s[t]);
        }
      }
    }
  }

  double* out = partials + (long long)blockIdx.x * n2 * d;
#pragma unroll
  for (int t = 0; t < MAXD; ++t) {
    if (t < d) {
      s_red[ty * XC + tx] = acc[t];
      __syncthreads();
      if (ty == 0 && col) {
        double tot = 0.0;
#pragma unroll
        for (int g = 0; g < XBY; ++g) tot += s_red[g * XC + tx];
        out[(long long)b * d + t] = P::lens_sum(tot);
      }
      __syncthreads();
    }
  }
}

// One thread per output (b, t): sums its partials over the row blocks in
// order.
template <typename T>
__global__ void __launch_bounds__(XNT)
gram_vjp_x_finish_kernel(const double* __restrict__ partials, long long nrb,
                         long long nout, T* __restrict__ gx) {
  const long long o = (long long)blockIdx.x * XNT + threadIdx.x;
  if (o >= nout) return;
  double tot = 0.0;
  for (long long r = 0; r < nrb; ++r) tot += partials[r * nout + o];
  gx[o] = T(tot);
}

template <typename P, typename T, int MAXD>
int vjpx_launch_maxd(const T* x1, const T* x2, const T* inv_l, const T* amp,
                     const T* nug, const T* M, int q, int n1, int n2, int d,
                     double* partials, T* gx, cudaStream_t stream) {
  auto kernel = gram_vjp_x_partials_kernel<T, MAXD, P>;
  constexpr size_t bytes = vjpx_smem_bytes<T, MAXD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long nrb = vjpx_row_blocks(n1);
  const dim3 grid((unsigned)nrb, (unsigned)vjpx_col_blocks(n2));
  kernel<<<grid, XNT, bytes, stream>>>(x1, x2, inv_l, amp, nug, M, q, n1, n2,
                                       d, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nout = (long long)n2 * d;
  gram_vjp_x_finish_kernel<T><<<(unsigned)((nout + XNT - 1) / XNT), XNT, 0,
                                stream>>>(partials, nrb, nout, gx);
  return (int)cudaGetLastError();
}

// The body of every lcgp_<family>_gram_vjp_x_{f64,f32} C entry point.
template <typename P, typename T>
int vjpx_launch(const void* x1, const void* x2, const void* inv_l,
                const void* amp, const void* nug, const void* M, int q,
                int n1, int n2, int d, void* partials, void* gx,
                void* stream) {
  if (q <= 0 || n1 <= 0 || n2 <= 0 || d <= 0 || d > 32 ||
      vjpx_row_blocks(n1) > 0x7fffffffLL || vjpx_col_blocks(n2) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto maxd_tag) {
    constexpr int MD = decltype(maxd_tag)::value;
    return vjpx_launch_maxd<P, T, MD>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(inv_l), static_cast<const T*>(amp),
        static_cast<const T*>(nug), static_cast<const T*>(M), q, n1, n2, d,
        static_cast<double*>(partials), static_cast<T*>(gx), s);
  };
  if (d <= 4) return run(std::integral_constant<int, 4>{});
  if (d <= 8) return run(std::integral_constant<int, 8>{});
  if (d <= 16) return run(std::integral_constant<int, 16>{});
  return run(std::integral_constant<int, 32>{});
}

}  // namespace

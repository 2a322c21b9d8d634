// K2's Gram-stack VJP for Hopper (sm_90a): this template instantiated on
// gram_common.cuh's Matern32 policy (matern32_gram_vjp.cu).  K3's and K4's
// VJPs have their own template (matern52_gram_vjp_kernel.cuh), and share
// this file's finish kernel (gram_vjp_finish_kernel, with the policy's
// lens_sum), scratch layout, tile walk and warp_sum.
//
// It reads the cotangent of the Gram stack as
//
//   cbar[k,i,j] = alpha_k * M[k,i,j] + beta * w[k,i] * w[k,j]
//
// and never writes it.  On the loss path M = B^{-1}, alpha = D/2,
// beta = -1/2 and w = B^{-1} a; the generic mode (alpha = 1, no w) takes
// any cotangent M, same-point or cross.  Per component it reduces d + 2
// sums over all (i, j):
//
//   G0[k]    = sum cbar * C0
//   G1[k]    = sum_i cbar[k,i,i]                      (same-point only)
//   G2+t[k]  = sum cbar * C0 * dlnC0/dlnS_t,          t = 0..d-1
//
// (Matern 3/2: S_t^2 / (1 + S_t)) and an epilogue turns them into the
// gradients of amp, nug and the lengthscales, as
// lcgp_tpu/ops/matern.py:126-147 does:
//
//   gamp  = (1 - eta) G0 + eta G1
//   gnug  = amp (G1 - G0) / (1 + nug)^2
//   glens = amp (1 - eta) G2+t / l_t
//
// C0 is recomputed from the distances, as the Pallas _bwd_kernel did,
// rather than read from a stored stack: the training forward then never
// writes C0 (a 2.7 GB f64 stack at q=20, n=4096).  It is formed with the
// forward's device code (gram_common.cuh), so it equals the forward's bit
// for bit.  The quotient by the factor costs no division: with the prefix
// products of factors() and suffix products started at cbar * decay,
// cbar C0 / f_t = [cbar decay prod_{u>t} f_u] prod_{u<t} f_u.  The suffix
// recomputes f_u from S_u rather than keep a third MAXD array in
// registers.
//
// What bounds it on the card: f64 arithmetic, with the read of M just under
// it.  Each entry and component costs about 8d + 20 f64 instructions (84 at
// d = 8); over one triangle of (20, 4096, 4096) that is 0.83 ms at the f64
// peak of 17e12 instructions/s, and reading M once is 2.7 GB, 0.80 ms at
// 3.35 TB/s.
// The design:
//
// - One triangle when same.  The summand f_ij is symmetric, so
//   sum_{i != j} cbar_ij f_ij = sum_{i > j} (cbar_ij + cbar_ji) f_ij, exact
//   for any M.  The grid walks the tile pairs (ti >= tj) of 64 x 64 tiles;
//   a block reads its tile of M and the transposed tile M[k, tj, ti], and
//   sums (cbar_ij + cbar_ji) f_ij, in the fused mode
//   alpha_k (M_ij + M_ji) + 2 beta w_i w_j.  A diagonal tile takes i > j in
//   pairs and i == j once (C0 = 1 exactly there, and the lengthscale terms
//   vanish).  A cross cotangent (same = 0) walks every tile, unpaired.
// - Latency hiding.  A block walks its tile for every component in stages
//   of 16 rows: a stage is the 16 x 64 strip of M, the 64 x 16 strip of the
//   transposed tile, the strips of w and the component's 1/l row.  Stages
//   are copied with cp.async into a ring of three shared-memory buffers, two
//   ahead of the one being summed, so HBM latency hides behind the
//   arithmetic.  The transposed strip is stored with an odd pitch, so its
//   column reads are free of bank conflicts while both global reads stay
//   coalesced.
// - Occupancy.  A thread owns one column and four rows of a stage: four
//   independent entries whose S/product/exp chains interleave.  It keeps
//   only its d + 2 accumulators across a component, so (f64, d <= 8) two
//   blocks of 256 threads fit an SM.  The tile's x rows are staged once per
//   block, not per component.
// - The block reduces its accumulators once per component (four stages,
//   4096 entries), a few percent of the arithmetic.
//
// The reduction across blocks is deterministic, with no atomics: each
// thread accumulates in f64 registers (in both instantiations), a warp
// shuffle and a shared-memory pass reduce the block, every block writes its
// (d + 2) partial sums per component to a scratch buffer the caller
// allocates, and a second small kernel sums the partials of each component
// in a fixed order and applies the epilogue.  The same shapes give the same
// bits on every run.  A NaN in M (a failed factor) gives NaN gradients, not
// a fault.
//
// The launchers launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launches.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "async_copy.cuh"
#include "gram_common.cuh"

namespace {

constexpr int TT = 64;                // tile side
constexpr int SR = 16;                // rows of a stage's strip
constexpr int NSTRIP = TT / SR;       // stages per component
constexpr int BX = 64;                // threads along j: one column each
constexpr int BY = 4;                 // threads along i: rows ty + BY m
constexpr int VNT = BX * BY;
constexpr int NWARP = VNT / 32;
constexpr int RPT = SR / BY;          // entries per thread and stage
constexpr int BP = SR + 1;            // pitch of the transposed strip
constexpr int NSTAGE = 3;             // ring of stages in shared memory

// One stage in shared memory, offsets in elements of T.
template <int MAXD>
struct Stage {
  static constexpr int A = 0;                  // [SR][TT]  M[k, i0+r, j0+c]
  static constexpr int B = A + SR * TT;        // [TT][BP]  M[k, j0+c, i0+r]
  static constexpr int WI = B + TT * BP;       // [SR]      w[k, i0+r]
  static constexpr int WJ = WI + SR;           // [TT]      w[k, j0+c]
  static constexpr int INV = WJ + TT;          // [MAXD]    1/l row of k
  static constexpr int ALPHA = INV + MAXD;     // [1]       alpha_k
  static constexpr int SIZE = (ALPHA + 2) & ~1;
};

template <typename T, int MAXD>
constexpr size_t vjp_smem_bytes() {
  return sizeof(double) * NWARP * (MAXD + 2)          // block reduction
         + sizeof(T) * TT * (MAXD + 1)                // x of the tile's rows
         + sizeof(T) * MAXD * TT                      // x of its columns
         + sizeof(T) * NSTAGE * Stage<MAXD>::SIZE;    // the ring
}

inline long long vjp_tiles(int n) { return (n + TT - 1) / TT; }

inline long long vjp_block_count(int same, int n1, int n2) {
  return same ? vjp_tiles(n1) * (vjp_tiles(n1) + 1) / 2
              : vjp_tiles(n1) * vjp_tiles(n2);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T, int MAXD, typename P>
__global__ void __launch_bounds__(VNT, MAXD <= 8 ? 2 : 1)
gram_vjp_partials_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                         const T* __restrict__ inv_l,
                         const T* __restrict__ M, const T* __restrict__ w,
                         const T* __restrict__ alpha, T beta, int same,
                         int q, int n1, int n2, int d,
                         double* __restrict__ partials) {
  using S = Stage<MAXD>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_red = reinterpret_cast<double*>(smem);           // [NWARP][MAXD+2]
  T* s_xi = reinterpret_cast<T*>(s_red + NWARP * (MAXD + 2));  // [TT][MAXD+1]
  T* s_xj = s_xi + TT * (MAXD + 1);                          // [MAXD][TT]
  T* s_ring = s_xj + MAXD * TT;                              // [NSTAGE][SIZE]

  const int tid = threadIdx.x;
  const int tx = tid % BX, ty = tid / BX;
  int ti, tj;
  lcgp::tile_of(blockIdx.x, same, (int)((n2 + TT - 1) / TT), ti, tj);
  const int i0 = ti * TT, j0 = tj * TT;
  const long long plane = (long long)n1 * n2;
  const int nv = d + 2;

  for (int e = tid; e < TT * MAXD; e += VNT) {
    const int r = e / MAXD, t = e % MAXD;
    s_xi[r * (MAXD + 1) + t] =
        (t < d && i0 + r < n1) ? x1[(long long)(i0 + r) * d + t] : T(0);
  }
  for (int e = tid; e < MAXD * TT; e += VNT) {
    const int t = e / TT, c = e % TT;
    s_xj[t * TT + c] =
        (t < d && j0 + c < n2) ? x2[(long long)(j0 + c) * d + t] : T(0);
  }

  // stage st: component st / NSTRIP, rows (st % NSTRIP) * SR.. of the tile
  auto prefetch = [&](int st) {
    T* buf = s_ring + (st % NSTAGE) * S::SIZE;
    const int k = st / NSTRIP;
    const int r0 = i0 + (st % NSTRIP) * SR;
    const T* Mk = M + k * plane;
    for (int e = tid; e < SR * TT; e += VNT) {
      const int r = e / TT, c = e % TT;
      const bool ok = r0 + r < n1 && j0 + c < n2;
      cp_async(buf + S::A + e,
               ok ? Mk + (long long)(r0 + r) * n2 + (j0 + c) : M, ok);
    }
    if (same) {
      for (int e = tid; e < TT * SR; e += VNT) {
        const int c = e / SR, r = e % SR;
        const bool ok = j0 + c < n1 && r0 + r < n1;
        cp_async(buf + S::B + c * BP + r,
                 ok ? Mk + (long long)(j0 + c) * n2 + (r0 + r) : M, ok);
      }
    }
    if (w) {
      const T* wk = w + (long long)k * n1;
      for (int e = tid; e < SR + TT; e += VNT) {
        const int g = e < SR ? r0 + e : j0 + (e - SR);
        const bool ok = g < n1;
        cp_async(buf + (e < SR ? S::WI + e : S::WJ + (e - SR)),
                 ok ? wk + g : w, ok);
      }
    }
    if (tid < d) cp_async(buf + S::INV + tid, inv_l + (long long)k * d + tid,
                          true);
    if (tid == VNT - 1) {
      if (alpha) {
        cp_async(buf + S::ALPHA, alpha + k, true);
      } else {
        buf[S::ALPHA] = T(1);
      }
    }
  };

  double acc[MAXD + 2];
#pragma unroll
  for (int v = 0; v < MAXD + 2; ++v) acc[v] = 0.0;

  const int nst = q * NSTRIP;
#pragma unroll
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < nst) prefetch(p);
    cp_async_commit();
  }

  for (int st = 0; st < nst; ++st) {
    if (st + NSTAGE - 1 < nst) prefetch(st + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();

    const T* buf = s_ring + (st % NSTAGE) * S::SIZE;
    const T a_k = buf[S::ALPHA];
    const int rs = (st % NSTRIP) * SR;    // first row of the strip in the tile
    // two entries at a time: their chains interleave within 128 registers
#pragma unroll 2
    for (int m = 0; m < RPT; ++m) {
      const int r = ty + BY * m;
      const int i = i0 + rs + r, j = j0 + tx;
      // same: i > j in pairs, i == j once, i < j left to the pair
      const bool active = i < n1 && j < n2 && (!same || i >= j);
      const bool on_diag = same && i == j;
      const bool pair = same && i > j;
      T mv = buf[S::A + r * TT + tx];
      if (pair) mv = mv + buf[S::B + tx * BP + r];
      T cb = a_k * mv;
      if (w) {
        const T bw = pair ? T(2) * beta : beta;
        cb = cb + (bw * buf[S::WI + r]) * buf[S::WJ + tx];
      }
      cb = active ? cb : T(0);

      T diff[MAXD], s[MAXD], pre[MAXD], prod, ssum;
#pragma unroll
      for (int t = 0; t < MAXD; ++t) {
        diff[t] = lcgp::absdiff(s_xi[(rs + r) * (MAXD + 1) + t],
                                s_xj[t * TT + tx]);
      }
      lcgp::factors<P, T, MAXD>(diff, buf + S::INV, d, s, pre, prod, ssum);
      const T e = P::decay(ssum);
      acc[0] += (double)(cb * P::c0(prod, e));
      acc[1] += on_diag ? (double)cb : 0.0;
      T suf = cb * e;   // cbar decay prod_{u > t} f_u
#pragma unroll
      for (int t = MAXD - 1; t >= 0; --t) {
        if (t < d) {
          acc[2 + t] += (double)P::lens_term(pre[t], suf, s[t]);
          suf = P::grow(suf, s[t]);
        }
      }
    }

    if (st % NSTRIP == NSTRIP - 1) {
      // the component is summed over the tile: reduce the block
      const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
      for (int v = 0; v < MAXD + 2; ++v) {
        if (v < nv) {
          const double tot = warp_sum(acc[v]);
          if (lane == 0) s_red[warp * (MAXD + 2) + v] = tot;
        }
        acc[v] = 0.0;
      }
      __syncthreads();
      if (tid < nv) {
        double tot = 0.0;
#pragma unroll
        for (int wp = 0; wp < NWARP; ++wp) tot += s_red[wp * (MAXD + 2) + tid];
        const int k = st / NSTRIP;
        partials[((long long)k * nv + tid) * gridDim.x + blockIdx.x] = tot;
      }
    }
    __syncthreads();
  }
}

// One block per component: sums its (d + 2) rows of partials in a fixed
// order, then applies the epilogue.
template <typename T, typename P>
__global__ void __launch_bounds__(VNT)
gram_vjp_finish_kernel(const double* __restrict__ partials, long long nblk,
                       const T* __restrict__ inv_l, const T* __restrict__ amp,
                       const T* __restrict__ nug, int same, int d,
                       T* __restrict__ glens, T* __restrict__ gamp,
                       T* __restrict__ gnug) {
  __shared__ double s_warp[NWARP];
  __shared__ double s_tot[32 + 2];
  const int k = blockIdx.x;
  const int nv = d + 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int v = 0; v < nv; ++v) {
    const double* p = partials + ((long long)k * nv + v) * nblk;
    double s = 0.0;
    for (long long b = threadIdx.x; b < nblk; b += VNT) s += p[b];
    s = warp_sum(s);
    if (lane == 0) s_warp[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      double tot = 0.0;
      for (int wp = 0; wp < NWARP; ++wp) tot += s_warp[wp];
      s_tot[v] = tot;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double a = amp[k], nu = nug[k];
    const double eta = nu / (1.0 + nu);
    const double g0 = s_tot[0];
    const double g1 = same ? s_tot[1] : 0.0;
    gamp[k] = T((1.0 - eta) * g0 + eta * g1);
    gnug[k] = T(a * (g1 - g0) / ((1.0 + nu) * (1.0 + nu)));
    for (int t = 0; t < d; ++t) {
      glens[(long long)k * d + t] =
          T(P::lens_sum(s_tot[2 + t]) * (a * (1.0 - eta)) *
            (double)inv_l[(long long)k * d + t]);
    }
  }
}

template <typename P, typename T, int MAXD>
int vjp_launch_maxd(const T* x1, const T* x2, const T* inv_l, const T* amp,
                    const T* nug, const T* M, const T* w, const T* alpha,
                    T beta, int same, int q, int n1, int n2, int d,
                    double* partials, T* glens, T* gamp, T* gnug,
                    cudaStream_t stream) {
  auto kernel = gram_vjp_partials_kernel<T, MAXD, P>;
  constexpr size_t bytes = vjp_smem_bytes<T, MAXD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long nblk = vjp_block_count(same, n1, n2);
  kernel<<<(unsigned)nblk, VNT, bytes, stream>>>(
      x1, x2, inv_l, M, w, alpha, beta, same, q, n1, n2, d, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_vjp_finish_kernel<T, P><<<q, VNT, 0, stream>>>(
      partials, nblk, inv_l, amp, nug, same, d, glens, gamp, gnug);
  return (int)cudaGetLastError();
}

// The body of every lcgp_<family>_gram_vjp_{f64,f32} C entry point.
template <typename P, typename T>
int vjp_launch(const void* x1, const void* x2, const void* inv_l,
               const void* amp, const void* nug, const void* M,
               const void* w, const void* alpha, double beta, int same, int q,
               int n1, int n2, int d, void* partials, void* glens, void* gamp,
               void* gnug, void* stream) {
  if (q <= 0 || n1 <= 0 || n2 <= 0 || d <= 0 || d > 32 ||
      (w && n1 != n2) || (same && n1 != n2) ||
      vjp_block_count(same, n1, n2) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto maxd_tag) {
    constexpr int MD = decltype(maxd_tag)::value;
    return vjp_launch_maxd<P, T, MD>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(inv_l), static_cast<const T*>(amp),
        static_cast<const T*>(nug), static_cast<const T*>(M),
        static_cast<const T*>(w), static_cast<const T*>(alpha), T(beta), same,
        q, n1, n2, d, static_cast<double*>(partials), static_cast<T*>(glens),
        static_cast<T*>(gamp), static_cast<T*>(gnug), s);
  };
  if (d <= 4) return run(std::integral_constant<int, 4>{});
  if (d <= 8) return run(std::integral_constant<int, 8>{});
  if (d <= 16) return run(std::integral_constant<int, 16>{});
  return run(std::integral_constant<int, 32>{});
}

}  // namespace

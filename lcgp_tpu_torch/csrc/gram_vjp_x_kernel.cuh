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
// C0 g(S_t) sign is formed without a division and without a sign test,
// from the signed scaled difference sd_t = (x1 - x2) inv_l (|sd_t| = S_t,
// bit for bit): the policy's x_step keeps Q_t = (prod_{u<t} f_u) sd_t
// (times 1 + sqrt5 S_t for Matern 5/2; SE: sd_t) and the factor's step
// G_t = f_t - 1, and a suffix product started at M e gives the term
// (M e prod_{u>t} f_u) Q_t with one fma, the suffix's step with another.
// So the term is exactly 0 where S_t = 0 (coincident points, Kmm's
// diagonal).  amp (1 - eta) inv_l and the family's constant (lens_sum) go
// on once a panel.  The first dimension starts the decay's sum without an
// addition (accum0).
//
// What bounds it on the card: the read of M (each entry once) against the
// arithmetic, 7d + 20 f64 instructions an entry for Matern 3/2 (at
// (4, 50000, 256), d = 2, f64: 0.12 ms to read M, 0.10 ms of f64
// arithmetic).  So the loads must stay in flight without taking the
// threads' issue slots, and the grid's fixed costs must be small.  The
// first version lost on both: each thread loaded its entries of M straight
// from global memory and used them at once, in a short block of a large
// grid that staged its x rows, took two barriers per dimension and wrote
// partials that one narrow serial pass summed.  The design:
//
// - A persistent column reduction over panels of M.  A panel is 32 KB of
//   whole rows of one component, 256 columns wide: 16 rows in f64, 32 in
//   f32.  A block's 256 threads own one column b of x2 each (its x2 row in
//   registers), so a warp reads 32 consecutive entries of a row and the
//   rows of x1 are read by every thread at once.  The grid is fixed by the
//   shape alone: one column of blocks per 256 columns of x2, and in each
//   about 264 / (columns of blocks) blocks (two on each of the H100's 132
//   SMs; one above MAXD 8; at most one per panel), each walking a fixed,
//   strided set of row panels for every component in turn.
// - The loads run ahead behind mbarriers.  Lane 0 of warp 0 loads each
//   panel with one tensor copy (cp.async.bulk.tensor, a 256 x 16 (f64) or
//   256 x 32 (f32) box of the (q, n1, n2) stack, contiguous when n2 = 256;
//   rows past n1 and columns past n2 arrive as zeros) into a ring of three
//   shared-memory slots, two panels ahead, and lanes 1-31 the panel's x1
//   rows with cp.async, zero past d and past n1.  Each slot has a `full`
//   mbarrier (the copy's bytes and those lanes' arrivals) and an `empty`
//   one (one arrival per warp).  No block barrier is taken after the
//   start.
// - No branch on t < d: past d, x and 1/l are 0, so those dimensions give
//   S_t = 0 (a factor of exactly 1, terms of exactly 0); MAXD 2, 4, 8, 16
//   and 32 instantiations, so FITC's d = 2 pays for two.  The entries of a
//   panel interleave where there are few dimensions (eight in f64 at
//   MAXD 2, four up to MAXD 4), so that their exp chains overlap.
// - f32 sums per panel: a thread sums its entries' terms in T (in f32, 32
//   eps_32 of their magnitude at most, far under the 1e-5 bound), then
//   adds them, times amp (1 - eta) inv_l, to its f64 accumulators once a
//   panel.
// - The underflow guard (Matern 5/2, C0 == 0: the product may have
//   overflowed in f32) selects the old sum instead of skipping the entry.
// - The reduction is deterministic, with no atomics: after its last panel
//   each thread writes one f64 partial per dimension of its column; a
//   second kernel gives each output (b, t) one warp, which sums that
//   output's partials, laid out contiguously, over its lanes and then by a
//   fixed shuffle tree.  The grid, and so the order, depends only on the
//   shape: the same inputs give the same bits.
// - Shapes the tensor copy cannot take (n2 * sizeof(T) not a multiple of
//   16, M not 16-byte aligned) go to a second kernel on the same body,
//   gram_vjp_x_copy_kernel, whose threads all load each panel with
//   element-wise cp.async into the same layout, completing on the same
//   mbarriers.  A tensor map that does not encode fails the launch.
//
// The launchers launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launches.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "gram_common.cuh"
#include "tensor_map.cuh"

namespace {
namespace k5 {

constexpr int NTH = 256;           // threads: one column of x2 each
constexpr int W = NTH;             // columns of a panel
constexpr int NW = NTH / 32;       // warps
constexpr int PANEL_BYTES = 32768;
constexpr int NS = 3;              // ring slots
constexpr int SMS = 132;           // the H100's streaming multiprocessors

// Rows of a panel: 16 in f64, 32 in f32; each thread sums that many
// entries of its column per panel.
template <typename T>
__host__ __device__ constexpr int rows() {
  return PANEL_BYTES / (W * (int)sizeof(T));
}

// Blocks an SM holds (the kernel's launch bounds) and the grid aims for:
// two up to MAXD 8, one above.
__host__ __device__ constexpr int blocks_per_sm(int maxd) {
  return maxd <= 8 ? 2 : 1;
}
inline int maxd_of(int d) {
  return d <= 2 ? 2 : d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16 : 32;
}

template <typename T>
__host__ __device__ inline int panels(int n1) {
  return (n1 + rows<T>() - 1) / rows<T>();
}
__host__ __device__ inline int col_blocks(int n2) {
  return (n2 + W - 1) / W;
}

// Blocks per column of blocks: from the shape alone (d sets MAXD), so
// that the order of the sums never depends on the card.  f64's panels
// are the shorter, so its count bounds f32's (the scratch size).
template <typename T>
inline int row_blocks(int n1, int n2, int d) {
  const int target = SMS * blocks_per_sm(maxd_of(d));
  const int per = (target + col_blocks(n2) - 1) / col_blocks(n2);
  return std::min(panels<T>(n1), std::max(1, per));
}

// The block's shared memory, in bytes from its 128-aligned start.
template <typename T, int MAXD>
struct Layout {
  static constexpr int R = rows<T>();
  static constexpr int XS = NS * PANEL_BYTES;  // after [NS][R][W] of M:
  //                                              [NS][R][MAXD] x1 rows
  static constexpr int BARS = (XS + NS * R * MAXD * (int)sizeof(T) + 7) / 8
                              * 8;
  static constexpr int BYTES = BARS + 2 * NS * 8;  // full[NS], empty[NS]
};

template <typename T, int MAXD>
constexpr size_t smem_bytes() {
  return 128 + (size_t)Layout<T, MAXD>::BYTES;   // with alignment slack
}

// The kernel's body.  TMA: M by tensor copies (lane 0 of warp 0), else by
// every thread's element-wise cp.async.
template <bool TMA, typename T, int MAXD, typename P>
__device__ __forceinline__ void body(
    const CUtensorMap& map, const T* __restrict__ x1,
    const T* __restrict__ x2, const T* __restrict__ inv_l,
    const T* __restrict__ amp, const T* __restrict__ nug,
    const T* __restrict__ M, int q, int n1, int n2, int d,
    double* __restrict__ partials) {
  using L = Layout<T, MAXD>;
  constexpr int R = L::R;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  T* s_x = reinterpret_cast<T*>(ring + L::XS);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::BARS);
  uint64_t* empty = full + NS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rb = blockIdx.x, nrb = gridDim.x;
  const int c0 = blockIdx.y * W;
  // this block's panels of a component: rb, rb + nrb, ...
  const int per = (panels<T>(n1) - rb + nrb - 1) / nrb;
  const int nst = q * per;
  const long long plane = (long long)n1 * n2;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      // tensor copies: warp 0's lanes arrive; element copies: every thread
      mbar_init(&full[s], TMA ? 32 : NTH);
      mbar_init(&empty[s], NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- the loads: warp 0 with tensor copies, every thread without ----
  const bool producer = !TMA || warp == 0;
  auto fill = [&](int st) {
    const int k = st / per, r0 = (rb + (st % per) * nrb) * R;
    const int slot = st % NS;
    if (st >= NS) mbar_wait(&empty[slot], ((st / NS) - 1) & 1);
    unsigned char* buf = ring + slot * PANEL_BYTES;
    T* xs = s_x + slot * R * MAXD;
    int first = tid, step = NTH;
    if constexpr (TMA) {
      first = lane - 1;
      step = 31;
      if (lane == 0) {
        mbar_arrive_tx(&full[slot], (unsigned)PANEL_BYTES);
        tma_load(buf, &map, c0, r0, k, &full[slot]);
      }
    } else {
      const T* Mk = M + k * plane;
      for (int e = tid; e < R * W; e += NTH) {
        const int r = e / W, c = e % W;
        const bool ok = r0 + r < n1 && c0 + c < n2;
        cp_async(reinterpret_cast<T*>(buf) + e,
                 ok ? Mk + (long long)(r0 + r) * n2 + (c0 + c) : M, ok);
      }
    }
    // the panel's x1 rows, zero past d and past n1 (lanes 1-31 of warp 0
    // with tensor copies)
    for (int e = first; e >= 0 && e < R * MAXD; e += step) {
      const int r = e / MAXD, t = e % MAXD;
      const bool ok = t < d && r0 + r < n1;
      cp_async(xs + e, ok ? x1 + (long long)(r0 + r) * d + t : x1, ok);
    }
    if (!TMA || lane > 0) mbar_arrive_cp_async(&full[slot]);
  };
  if (producer) {
    for (int p = 0; p < NS - 1 && p < nst; ++p) fill(p);
  }

  // ---- the sums, every warp: this thread's column b ----
  const int b = c0 + tid;
  T xb[MAXD], inv[MAXD];
  double acc[MAXD], ck = 0.0;
#pragma unroll
  for (int t = 0; t < MAXD; ++t) {
    xb[t] = (t < d && b < n2) ? x2[(long long)b * d + t] : T(0);
    acc[t] = 0.0;
  }

  for (int st = 0; st < nst; ++st) {
    const int k = st / per;
    const int slot = st % NS;
    if (producer && st + NS - 1 < nst) fill(st + NS - 1);
    if (st % per == 0) {
      // component k: its 1/l row (zero past d) and amp (1 - eta)
      const double a = amp[k], nu = nug[k];
      ck = a * (1.0 - nu / (1.0 + nu));
#pragma unroll
      for (int t = 0; t < MAXD; ++t) {
        inv[t] = t < d ? inv_l[(long long)k * d + t] : T(0);
      }
    }
    mbar_wait(&full[slot], (st / NS) & 1);
    const T* sM = reinterpret_cast<const T*>(ring + slot * PANEL_BYTES);
    const T* xs = s_x + slot * R * MAXD;
    T sacc[MAXD];
#pragma unroll
    for (int t = 0; t < MAXD; ++t) sacc[t] = T(0);

    // the panel's rows, interleaved where there are few dimensions
#pragma unroll (MAXD <= 2 && sizeof(T) == 8 ? 8 : MAXD <= 4 ? 4 : 1)
    for (int r = 0; r < R; ++r) {
      const T m = sM[r * W + tid];
      const T* xa = xs + r * MAXD;
      T Q[MAXD], G[MAXD];
      T prod = T(1), ssum;
#pragma unroll
      for (int t = 0; t < MAXD; ++t) {
        // (x1 - x2) / l, signed: its magnitude is the forward's S_t
        const T sd = lcgp::mul_rn(lcgp::add_rn(xa[t], -xb[t]), inv[t]);
        const T s = fabs(sd);
        P::x_step(sd, s, prod, Q[t], G[t]);
        ssum = t == 0 ? P::accum0(s) : P::accum(ssum, s);
      }
      const T e = P::decay(ssum);
      // C0 == 0: every term is 0, and the product may have overflowed
      // (Matern 5/2 in f32): the sums keep their values, by select
      const bool live = !P::kGuardUnderflow || e != T(0);
      T suf = m * e;   // M decay prod_{u > t} f_u
#pragma unroll
      for (int t = MAXD - 1; t >= 0; --t) {
        const T nxt = lcgp::fma_rn(suf, Q[t], sacc[t]);
        sacc[t] = live ? nxt : sacc[t];
        if constexpr (P::kFactor) suf = lcgp::fma_rn(suf, G[t], suf);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    // times amp (1 - eta) 1/l and the family's constant
#pragma unroll
    for (int t = 0; t < MAXD; ++t) {
      acc[t] = lcgp::fma_rn((double)sacc[t],
                            P::lens_sum(ck * (double)inv[t]), acc[t]);
    }
  }

  // this block's partial of each of its column's outputs
  if (b < n2) {
#pragma unroll
    for (int t = 0; t < MAXD; ++t) {
      if (t < d) partials[((long long)b * d + t) * nrb + rb] = acc[t];
    }
  }
}

template <typename T, int MAXD, typename P>
__global__ void __launch_bounds__(NTH, blocks_per_sm(MAXD))
gram_vjp_x_tma_kernel(const __grid_constant__ CUtensorMap map,
                      const T* __restrict__ x1, const T* __restrict__ x2,
                      const T* __restrict__ inv_l, const T* __restrict__ amp,
                      const T* __restrict__ nug, const T* __restrict__ M,
                      int q, int n1, int n2, int d,
                      double* __restrict__ partials) {
  body<true, T, MAXD, P>(map, x1, x2, inv_l, amp, nug, M, q, n1, n2, d,
                         partials);
}

// Shapes the tensor copy cannot address (odd n2 in f64, n2 not a multiple
// of 4 in f32, a misaligned M).
template <typename T, int MAXD, typename P>
__global__ void __launch_bounds__(NTH, 1)
gram_vjp_x_copy_kernel(const __grid_constant__ CUtensorMap map,
                       const T* __restrict__ x1, const T* __restrict__ x2,
                       const T* __restrict__ inv_l, const T* __restrict__ amp,
                       const T* __restrict__ nug, const T* __restrict__ M,
                       int q, int n1, int n2, int d,
                       double* __restrict__ partials) {
  body<false, T, MAXD, P>(map, x1, x2, inv_l, amp, nug, M, q, n1, n2, d,
                          partials);
}

// One warp per output (b, t): its nrb partials, contiguous, summed over
// the lanes in order and then by a fixed shuffle tree.
template <typename T>
__global__ void __launch_bounds__(NTH)
gram_vjp_x_finish_kernel(const double* __restrict__ partials, int nrb,
                         long long nout, T* __restrict__ gx) {
  const long long o = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (o >= nout) return;
  const double* p = partials + o * nrb;
  double s = 0.0;
  for (int r = lane; r < nrb; r += 32) s += p[r];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) gx[o] = T(s);
}

template <typename P, typename T, int MAXD>
int launch_maxd(const T* x1, const T* x2, const T* inv_l, const T* amp,
                const T* nug, const T* M, int q, int n1, int n2, int d,
                double* partials, T* gx, cudaStream_t stream) {
  CUtensorMap map{};
  const bool tma = tmap::addressable<T>(M, n2);
  auto kernel = tma ? gram_vjp_x_tma_kernel<T, MAXD, P>
                    : gram_vjp_x_copy_kernel<T, MAXD, P>;
  constexpr size_t bytes = smem_bytes<T, MAXD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (tma && !tmap::encode_stack<T>(&map, M, q, n1, n2, W, rows<T>(),
                                    CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nrb = row_blocks<T>(n1, n2, d);
  const dim3 grid((unsigned)nrb, (unsigned)col_blocks(n2));
  kernel<<<grid, NTH, bytes, stream>>>(map, x1, x2, inv_l, amp, nug, M, q,
                                       n1, n2, d, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nout = (long long)n2 * d;
  gram_vjp_x_finish_kernel<T><<<(unsigned)((nout + NW - 1) / NW), NTH, 0,
                                stream>>>(partials, nrb, nout, gx);
  return (int)cudaGetLastError();
}

// The body of every lcgp_<family>_gram_vjp_x_{f64,f32} C entry point.
template <typename P, typename T>
int launch(const void* x1, const void* x2, const void* inv_l,
           const void* amp, const void* nug, const void* M, int q, int n1,
           int n2, int d, void* partials, void* gx, void* stream) {
  if (q <= 0 || n1 <= 0 || n2 <= 0 || d <= 0 || d > 32 ||
      col_blocks(n2) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto maxd_tag) {
    constexpr int MD = decltype(maxd_tag)::value;
    return launch_maxd<P, T, MD>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(inv_l), static_cast<const T*>(amp),
        static_cast<const T*>(nug), static_cast<const T*>(M), q, n1, n2, d,
        static_cast<double*>(partials), static_cast<T*>(gx), s);
  };
  if (d <= 2) return run(std::integral_constant<int, 2>{});
  if (d <= 4) return run(std::integral_constant<int, 4>{});
  if (d <= 8) return run(std::integral_constant<int, 8>{});
  if (d <= 16) return run(std::integral_constant<int, 16>{});
  return run(std::integral_constant<int, 32>{});
}

}  // namespace k5
}  // namespace

// K3's Gram-stack VJP, designed for Hopper (sm_90a): the Matern 5/2 VJP on
// its own template, which only matern52_gram_vjp.cu instantiates
// (lcgp::Matern52).  It reduces what gram_vjp_kernel.cuh reduces, for the
// same cotangent
//
//   cbar[k,i,j] = alpha_k * M[k,i,j] + beta * w[k,i] * w[k,j]
//
// into the same (d + 2) sums per component and tile, written to the same
// partials and finished by the same gram_vjp_finish_kernel: G0 = sum cbar
// C0, G1 = sum_i cbar[k,i,i] and G2+t = sum cbar C0 dlnC0/dlnS_t.  C0 is
// formed with the forward's operations in the forward's order
// (gram_common.cuh), so it is the forward's bit for bit.
//
// What bounds it on the card.  Over one triangle of (20, 4096, 4096) at
// d = 8 the function needs 12d + 20 f64 instructions an entry, 1.15 ms at
// 17e12/s, against 0.80 ms to read M once: the f64 pipe.  The template K2
// and K4 share reached 33% of that here.  Its SASS and ptxas show why:
//
// - a block barrier for every four entries a thread sums (a 16-row stage),
//   and twelve element-wise cp.async copies a thread and stage, each with
//   its address arithmetic and bounds test, in the issue slots of the f64
//   work;
// - a branch on t < d around every factor of every entry, and the suffix
//   recomputing each factor (14d + 20 f64 instructions, not 12d + 20);
// - 124 registers for two interleaved entries, two blocks an SM;
// - in f32, every term converted to f64 and added there (d + 2 F2F and f64
//   adds an entry, on the slow f64 pipe);
// - the underflow guard's `continue`, on which a warp diverges.
//
// The design:
//
// - Tensor-copy loads behind mbarriers.  Lane 0 of warp 0 loads each stage
//   (the 32 x 64 strip of M and the 64 x 32 strip of the transposed tile)
//   into a ring of shared-memory slots with Hopper's tensor copies
//   (cp.async.bulk.tensor: one for the strip, one per 128 bytes of the
//   transposed strip's rows), two stages ahead, and lanes 1-31 the small
//   operands (the strips of w, the component's 1/l row, alpha) with
//   cp.async.  Each slot has a `full` mbarrier (the copies' bytes and those
//   lanes' arrivals) and an `empty` one (one arrival per warp).  No block
//   barrier is taken after the start, and no thread issues a load of M.
//   (A separate producer warp would make blocks of 288 threads, for which
//   ptxas allows 96 registers at two blocks an SM, and the factors spill;
//   256 threads get 128.)
// - The transposed strip is loaded with the 128-byte swizzle, so that the
//   lanes of a warp, which read one row's column each, spread over eight
//   16-byte chunks of the banks: a 4-way conflict, not the 32-way one of a
//   dense layout.
// - Longer stages: 32 rows, eight entries a thread between two arrivals.
// - The factors once: the forward sweep keeps, per dimension, the factor
//   g_t = f_t - 1 and Q_t = (prod_{u<t} f_u) S_t^2 (1 + sqrt5 S_t); the
//   suffix sweep is then two fmas a dimension (the term into its sum, the
//   factor into the suffix): 12d + 26 f64 instructions an entry (122 at
//   d = 8 in the SASS), the function's 12d + 20 and the exp's range
//   handling.  No branch on t < d: past d, x and 1/l are 0 in
//   shared memory, so those dimensions change nothing (S_t = 0: a factor
//   of exactly 1, terms of exactly 0); a MAXD 2 instantiation keeps FITC's
//   d = 2 from paying for four.
// - f32 sums per stage: in the f32 instantiation the eight terms of a
//   stage are summed in f32 (8 eps_32 of their magnitude at most, far under
//   the 1e-5 bound) and added to the f64 accumulators once a stage; and
//   two entries interleave (f64 keeps one: two entries' factors would
//   spill at 128 registers).
// - The underflow guard (C0 == 0: a prefix product may have overflowed in
//   f32) selects the old sum instead of skipping the entry: no divergence.
// - The reduction per component: each warp shuffles its sums and writes
//   them to one of four shared buffers; warp 0, two components later, sums
//   the eight warps' values in a fixed order into the partials.
//   The same inputs give the same bits, with no atomics.
// - Shapes the tensor copy cannot take (n2 * sizeof(T) not a multiple of
//   16, M not 16-byte aligned) go to a second kernel on the same body,
//   gram_vjp_copy_kernel, whose threads all load with element-wise
//   cp.async into the same swizzled layout, completing on the same
//   mbarriers; it runs one block an SM, so that its address arithmetic
//   has registers without spilling.  A tensor map that does not encode
//   fails the launch.
//
// The launcher encodes the tensor maps on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint: no link against the driver
// library), launches on the caller's stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() after the launches.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "gram_common.cuh"
#include "gram_vjp_kernel.cuh"
#include "tensor_map.cuh"

namespace {
namespace k3v {

constexpr int TT = 64;                 // tile side
constexpr int SR = 32;                 // rows of a stage's strip
constexpr int NSTRIP = TT / SR;        // stages per component and tile
constexpr int BX = 64;                 // threads along j
constexpr int BY = 4;                  // threads along i
constexpr int NTH = BX * BY;
constexpr int NW = NTH / 32;           // warps
constexpr int NRED = 4;                // buffers of per-warp sums

// ring slots: three at MAXD <= 8, two above (shared memory)
template <int MAXD>
__host__ __device__ constexpr int nslot() {
  return MAXD <= 8 ? 3 : 2;
}

// One slot: the strips in bytes from its 1024-aligned start, and the small
// operands in bytes from the slot's part of a separate array.
template <typename T, int MAXD>
struct Slot {
  static constexpr int SZ = (int)sizeof(T);
  static constexpr int BW = 128 / SZ;         // columns a swizzled box spans
  static constexpr int NB = SR / BW;          // boxes of the transposed strip
  static constexpr int B = 0;                 // [NB][TT rows][128 B] swizzled
  static constexpr int A = B + TT * SR * SZ;  // [SR][TT]  M[k, r0+r, j0+c]
  static constexpr int SIZE = A + SR * TT * SZ;  // a multiple of 1024
  static constexpr int WI = 0;                 // [SR]  w[k, r0+r]
  static constexpr int WJ = WI + SR * SZ;      // [TT]  w[k, j0+c]
  static constexpr int INV = WJ + TT * SZ;     // [MAXD]  1/l row of k
  static constexpr int ALPHA = INV + MAXD * SZ;  // alpha_k
  static constexpr int SMALL = (ALPHA + SZ + 15) / 16 * 16;
};

// The block's shared memory, in bytes from the 1024-aligned ring: every
// part at a constant offset, so that one base register addresses them all.
template <typename T, int MAXD>
struct Layout {
  using S = Slot<T, MAXD>;
  static constexpr int NS = nslot<MAXD>();
  static constexpr int NV = MAXD + 2;
  static constexpr int SMALL = NS * S::SIZE;          // [NS][S::SMALL]
  static constexpr int RED = SMALL + NS * S::SMALL;   // [NRED][NW][NV] f64
  static constexpr int XI = RED + NRED * NW * NV * 8;  // [TT][MAXD+1]  x1
  static constexpr int XJ = XI + TT * (MAXD + 1) * S::SZ;  // [MAXD][TT]  x2
  static constexpr int BARS = (XJ + MAXD * TT * S::SZ + 7) / 8 * 8;
  // mbarriers: full[NS], empty[NS], red[NRED]
  static constexpr int BYTES = BARS + (2 * NS + NRED) * 8;
};

template <typename T, int MAXD>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (size_t)Layout<T, MAXD>::BYTES;   // with alignment slack
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// The arrival of this thread, once its earlier cp.async copies are done.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  const unsigned a = smem_u32(b);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// A 3-D tensor copy of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// Byte offset of element (row c, column r) of the transposed strip, in
// the tensor copy's 128-byte swizzle.
template <typename T, int MAXD>
__device__ __forceinline__ int b_offset(int c, int r) {
  return Slot<T, MAXD>::B + tmap::swizzled(c, r, TT, (int)sizeof(T));
}

// The kernel's body.  TMA: M by tensor copies (lane 0 of warp 0), else by
// every thread's element-wise cp.async; two kernels, so that the copies'
// address arithmetic does not take registers from the tensor-copy path.
template <bool TMA, typename T, int MAXD, typename P>
__device__ __forceinline__ void vjp_body(
    const CUtensorMap& map_a, const CUtensorMap& map_b,
    const T* __restrict__ x1, const T* __restrict__ x2,
    const T* __restrict__ inv_l, const T* __restrict__ M,
    const T* __restrict__ w, const T* __restrict__ alpha, T beta, int same,
    int q, int n1, int n2, int d, double* __restrict__ partials) {
  using S = Slot<T, MAXD>;
  constexpr int NS = nslot<MAXD>();
  constexpr int NV = MAXD + 2;
  extern __shared__ unsigned char smem_raw[];
  using L = Layout<T, MAXD>;
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* small = ring + L::SMALL;
  double* s_red = reinterpret_cast<double*>(ring + L::RED);
  T* s_xi = reinterpret_cast<T*>(ring + L::XI);
  T* s_xj = reinterpret_cast<T*>(ring + L::XJ);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::BARS);
  uint64_t* empty = full + NS;
  uint64_t* red = full + 2 * NS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int ti, tj;
  lcgp::tile_of(blockIdx.x, same, (n2 + TT - 1) / TT, ti, tj);
  const int i0 = ti * TT, j0 = tj * TT;
  const long long plane = (long long)n1 * n2;
  const int nv = d + 2;
  const int nst = q * NSTRIP;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      // tensor copies: warp 0's lanes arrive; element copies: every thread
      mbar_init(&full[s], TMA ? 32 : NTH);
      mbar_init(&empty[s], NW);
    }
    for (int s = 0; s < NRED; ++s) mbar_init(&red[s], NW);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < TT * MAXD; e += NTH) {
    const int r = e / MAXD, t = e % MAXD;
    s_xi[r * (MAXD + 1) + t] =
        (t < d && i0 + r < n1) ? x1[(long long)(i0 + r) * d + t] : T(0);
  }
  for (int e = tid; e < MAXD * TT; e += NTH) {
    const int t = e / TT, c = e % TT;
    s_xj[t * TT + c] =
        (t < d && j0 + c < n2) ? x2[(long long)(j0 + c) * d + t] : T(0);
  }
  __syncthreads();

  // ---- the loads: warp 0 with tensor copies, every thread without ----
  const bool producer = !TMA || warp == 0;
  const unsigned tx_bytes =
      (unsigned)((SR * TT + (same ? TT * SR : 0)) * S::SZ);
  auto fill = [&](int st) {
    const int k = st / NSTRIP, h = st % NSTRIP;
    const int slot = st % NS;
    if (st >= NS) mbar_wait(&empty[slot], ((st / NS) - 1) & 1);
    unsigned char* buf = ring + slot * S::SIZE;
    unsigned char* sm = small + slot * S::SMALL;
    const int r0 = i0 + h * SR;
    const T* Mk = M + k * plane;
    if constexpr (TMA) {
      if (lane == 0) {
        mbar_arrive_tx(&full[slot], tx_bytes);
        tma_load(buf + S::A, &map_a, j0, r0, k, &full[slot]);
        if (same) {
#pragma unroll
          for (int b = 0; b < S::NB; ++b) {
            tma_load(buf + S::B + b * TT * 128, &map_b, r0 + b * S::BW, j0,
                     k, &full[slot]);
          }
        }
      }
    } else {
      for (int e = tid; e < SR * TT; e += NTH) {
        const int r = e / TT, c = e % TT;
        const bool ok = r0 + r < n1 && j0 + c < n2;
        cp_async(reinterpret_cast<T*>(buf + S::A) + e,
                 ok ? Mk + (long long)(r0 + r) * n2 + (j0 + c) : M, ok);
      }
      if (same) {
        for (int e = tid; e < TT * SR; e += NTH) {
          const int c = e / SR, r = e % SR;
          const bool ok = j0 + c < n1 && r0 + r < n1;
          cp_async(reinterpret_cast<T*>(buf + b_offset<T, MAXD>(c, r)),
                   ok ? Mk + (long long)(j0 + c) * n2 + (r0 + r) : M, ok);
        }
      }
    }
    if (warp == 0 && lane > 0) {
      // w's strips, the 1/l row (zero past d) and alpha, on lanes 1..31
      const int items = (w ? SR + TT : 0) + MAXD + (alpha ? 1 : 0);
      for (int e = lane - 1; e < items; e += 31) {
        T* dst;
        const T* src;
        bool ok = true;
        int e2 = e;
        if (w && e2 < SR + TT) {
          const int g = e2 < SR ? r0 + e2 : j0 + (e2 - SR);
          ok = g < n1;
          dst = reinterpret_cast<T*>(sm + (e2 < SR ? S::WI : S::WJ)) +
                (e2 < SR ? e2 : e2 - SR);
          src = ok ? w + (long long)k * n1 + g : w;
        } else {
          e2 -= w ? SR + TT : 0;
          if (e2 < MAXD) {
            ok = e2 < d;
            dst = reinterpret_cast<T*>(sm + S::INV) + e2;
            src = ok ? inv_l + (long long)k * d + e2 : inv_l;
          } else {
            dst = reinterpret_cast<T*>(sm + S::ALPHA);
            src = alpha + k;
          }
        }
        cp_async(dst, src, ok);
      }
    }
    if (!TMA || lane > 0) mbar_arrive_cp_async(&full[slot]);
  };
  // component c's sums, by warp 0: the warps' values in a fixed order
  auto reduce = [&](int c) {
    mbar_wait(&red[c % NRED], (c / NRED) & 1);
    const double* src = s_red + (c % NRED) * NW * NV;
    for (int v = lane; v < nv; v += 32) {
      double tot = 0.0;
#pragma unroll
      for (int wp = 0; wp < NW; ++wp) tot += src[wp * NV + v];
      partials[((long long)c * nv + v) * gridDim.x + blockIdx.x] = tot;
    }
  };
  if (producer) {
    for (int p = 0; p < NS - 1 && p < nst; ++p) fill(p);
  }

  // ---- the sums, every warp ----
  const int tx = tid % BX, ty = tid / BX;
  const int j = j0 + tx;
  double acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.0;

  for (int st = 0; st < nst; ++st) {
    const int k = st / NSTRIP, h = st % NSTRIP;
    const int slot = st % NS;
    // warp 0 finishes component k - 2 (its buffer is reused at k + 2),
    // then the loads run NS - 1 stages ahead
    if (warp == 0 && h == 0 && k >= 2) reduce(k - 2);
    if (producer && st + NS - 1 < nst) fill(st + NS - 1);
    mbar_wait(&full[slot], (st / NS) & 1);
    const unsigned char* buf = ring + slot * S::SIZE;
    const unsigned char* sm = small + slot * S::SMALL;
    const T* sA = reinterpret_cast<const T*>(buf + S::A);
    const T* sWI = reinterpret_cast<const T*>(sm + S::WI);
    const T* sWJ = reinterpret_cast<const T*>(sm + S::WJ);
    const T* sInv = reinterpret_cast<const T*>(sm + S::INV);
    const T a_k = alpha ? *reinterpret_cast<const T*>(sm + S::ALPHA) : T(1);
    const T wj = w ? sWJ[tx] : T(0);
    // f32: the stage's terms are summed in f32, then added in f64
    T sacc[NV] = {};

    // rows ty, ty + BY, ... of the strip.  f64: one entry at a time (two
    // entries' factors would not fit the 128 registers of two blocks an
    // SM); f32: two, interleaved
#pragma unroll (sizeof(T) == 4 ? 2 : 1)
    for (int r = ty; r < SR; r += BY) {
      const int rt = h * SR + r;          // row in the tile
      const int i = i0 + rt;
      // same: i > j in pairs, i == j once, i < j left to the pair
      const bool active = i < n1 && j < n2 && (!same || i >= j);
      const bool on_diag = same && i == j;
      const bool pair = same && i > j;
      T mv = sA[r * TT + tx];
      if (pair) {
        mv = mv + *reinterpret_cast<const T*>(buf +
                                              b_offset<T, MAXD>(tx, r));
      }
      T cb = a_k * mv;
      if (w) {
        const T bw = pair ? T(2) * beta : beta;
        cb = cb + (bw * sWI[r]) * wj;
      }
      cb = active ? cb : T(0);

      T Q[MAXD], G[MAXD];
      T prod = T(1), ssum = T(0);
      const T* xi = s_xi + rt * (MAXD + 1);
      // every dimension up to MAXD: past d, x and 1/l are 0, so S_t = 0
      // leaves the product and the sum exact and adds 0 to the sums
#pragma unroll
      for (int t = 0; t < MAXD; ++t) {
        const T s = lcgp::mul_rn(
            lcgp::absdiff(xi[t], s_xj[t * TT + tx]), sInv[t]);
        // P::grow(prod, s), with its factor kept: the same operations
        const T gt = lcgp::mul_rn(
            lcgp::fma_rn(T(lcgp::FIVE_THIRDS), s, T(lcgp::SQRT5)), s);
        const T hs = lcgp::fma_rn(T(lcgp::SQRT5), s, T(1));
        Q[t] = prod * ((s * s) * hs);
        G[t] = gt;
        prod = lcgp::fma_rn(prod, gt, prod);
        ssum = P::accum(ssum, s);
      }
      const T e = P::decay(ssum);
      const T c0 = P::c0(prod, e);
      // C0 == 0: every lengthscale term is 0, and a prefix product may
      // have overflowed (f32): the sums keep their values, by select
      const bool live = !P::kGuardUnderflow || e != T(0);
      T suf = cb * e;   // cbar decay prod_{u > t} f_u
      if constexpr (std::is_same<T, double>::value) {
        acc[0] = lcgp::fma_rn(cb, c0, acc[0]);
        acc[1] += on_diag ? cb : 0.0;
#pragma unroll
        for (int t = MAXD - 1; t >= 0; --t) {
          const double nxt = lcgp::fma_rn(suf, Q[t], acc[2 + t]);
          acc[2 + t] = live ? nxt : acc[2 + t];
          suf = lcgp::fma_rn(suf, G[t], suf);
        }
      } else {
        sacc[0] = lcgp::fma_rn(cb, c0, sacc[0]);
        sacc[1] += on_diag ? cb : T(0);
#pragma unroll
        for (int t = MAXD - 1; t >= 0; --t) {
          const T nxt = lcgp::fma_rn(suf, Q[t], sacc[2 + t]);
          sacc[2 + t] = live ? nxt : sacc[2 + t];
          suf = lcgp::fma_rn(suf, G[t], suf);
        }
      }
    }
    if constexpr (!std::is_same<T, double>::value) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v < nv) acc[v] += (double)sacc[v];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);

    if (h == NSTRIP - 1) {
      // the component is summed over this warp's part of the tile
      double* dst = s_red + (k % NRED) * NW * NV + warp * NV;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v < nv) {
          const double tot = warp_sum(acc[v]);
          if (lane == 0) dst[v] = tot;
        }
        acc[v] = 0.0;
      }
      if (lane == 0) mbar_arrive(&red[k % NRED]);
    }
  }
  if (warp == 0) {
    for (int c = max(0, q - 2); c < q; ++c) reduce(c);
  }
}

template <typename T, int MAXD, typename P>
__global__ void __launch_bounds__(NTH, MAXD <= 8 ? 2 : 1)
gram_vjp_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const T* __restrict__ x1, const T* __restrict__ x2,
                    const T* __restrict__ inv_l, const T* __restrict__ M,
                    const T* __restrict__ w, const T* __restrict__ alpha,
                    T beta, int same, int q, int n1, int n2, int d,
                    double* __restrict__ partials) {
  vjp_body<true, T, MAXD, P>(map_a, map_b, x1, x2, inv_l, M, w, alpha, beta,
                             same, q, n1, n2, d, partials);
}

// Shapes the tensor copy cannot address (rare: odd n2, a misaligned M).
template <typename T, int MAXD, typename P>
__global__ void __launch_bounds__(NTH, 1)
gram_vjp_copy_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ inv_l, const T* __restrict__ M,
                     const T* __restrict__ w, const T* __restrict__ alpha,
                     T beta, int same, int q, int n1, int n2, int d,
                     double* __restrict__ partials) {
  vjp_body<false, T, MAXD, P>(map_a, map_b, x1, x2, inv_l, M, w, alpha,
                              beta, same, q, n1, n2, d, partials);
}

template <typename P, typename T, int MAXD>
int vjp_launch_maxd(const T* x1, const T* x2, const T* inv_l, const T* amp,
                    const T* nug, const T* M, const T* w, const T* alpha,
                    T beta, int same, int q, int n1, int n2, int d,
                    double* partials, T* glens, T* gamp, T* gnug,
                    cudaStream_t stream) {
  // the strip (TT columns, SR rows) and the transposed strip (128 bytes of
  // columns, TT rows, swizzled)
  CUtensorMap map_a{}, map_b{};
  const bool tma = tmap::addressable<T>(M, n2);
  auto kernel = tma ? gram_vjp_tma_kernel<T, MAXD, P>
                    : gram_vjp_copy_kernel<T, MAXD, P>;
  constexpr size_t bytes = smem_bytes<T, MAXD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (tma &&
      !(tmap::encode_stack<T>(&map_a, M, q, n1, n2, TT, SR,
                              CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tmap::encode_stack<T>(&map_b, M, q, n1, n2, 128 / sizeof(T), TT,
                              CU_TENSOR_MAP_SWIZZLE_128B))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nblk = vjp_block_count(same, n1, n2);
  kernel<<<(unsigned)nblk, NTH, bytes, stream>>>(
      map_a, map_b, x1, x2, inv_l, M, w, alpha, beta, same, q, n1, n2, d,
      partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_vjp_finish_kernel<T, P><<<q, VNT, 0, stream>>>(
      partials, nblk, inv_l, amp, nug, same, d, glens, gamp, gnug);
  return (int)cudaGetLastError();
}

// The body of the lcgp_matern52_gram_vjp_{f64,f32} C entry points.
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
  if (d <= 2) return run(std::integral_constant<int, 2>{});
  if (d <= 4) return run(std::integral_constant<int, 4>{});
  if (d <= 8) return run(std::integral_constant<int, 8>{});
  if (d <= 16) return run(std::integral_constant<int, 16>{});
  return run(std::integral_constant<int, 32>{});
}

}  // namespace k3v
}  // namespace

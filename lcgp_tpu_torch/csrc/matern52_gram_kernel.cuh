// K3's Gram stack / factorization target, designed for Hopper (sm_90a):
// the Matern 5/2 Gram kernel on its own template, which only
// matern52_gram.cu instantiates (lcgp::Matern52).  It computes what
// gram_kernel.cuh computes, with the same device code for each entry, so
// C0 is the value K3's VJP recomputes, bit for bit:
//
//   C0[k,i,j]  = prod_t (1 + sqrt5 S_t + 5/3 S_t^2) exp(-sqrt5 sum_t S_t),
//                S_t = |x1[i,t] - x2[j,t]| * inv_l[k,t]
//   C[k,i,j]   = amp_k * ((1 - eta_k) * C0 + eta_k * [same && i == j])
//   epilogue:    out = row_scale_k * C + [i == j] * diag_vec[k,i]
//
// What bounds it on the card.  At q = 20, n = 4096, d = 8 the square stack
// is 2.7 GB of writes, 0.80 ms at 3.35 TB/s, and one triangle of its f64
// arithmetic (5d + 20 instructions an entry) 0.59 ms at 17e12/s: the two
// must overlap.  The template K1 and K4 share (gram_kernel.cuh) reached 42%
// of the byte bound here, held by three things its SASS and ptxas show:
//
// - registers: it keeps every S_t of four entries live (122 registers, two
//   blocks of 256 threads an SM), and at two blocks the two barriers it
//   takes per component to mirror a tile through shared memory idle half
//   the SM's warps;
// - issue slots: a branch on t < d around every factor of every entry, and
//   the address arithmetic and bounds tests of each thread's stores;
// - the stores themselves, issued by the threads in bursts between the
//   barriers, rather than behind the arithmetic.
//
// The design:
//
// - Streamed factors.  The four entries of a thread (rows ty, ty + 16,
//   columns tx, tx + 16 of a 32 x 32 tile) fold each dimension's S_t into
//   their running product and sum at once, so only two values an entry stay
//   live: three blocks of 256 threads an SM (<= 80 registers), 24 warps.
//   The x rows come from shared memory, zero past d, and so does 1/l: every
//   dimension up to MAXD is computed, with no branch on t < d (a zero S_t
//   multiplies the product by exactly 1 and adds exactly 0 to the sum, so
//   C0 keeps its bits).  A MAXD 2 instantiation keeps FITC's d = 2 from
//   paying for four dimensions.
// - Stores off the threads.  Each component's tile, and in a same-point
//   Gram its mirror (tj, ti), and C0 and its mirror when asked for, are
//   written into a ring of three staging buffers in shared memory, laid out
//   in the 128-byte swizzle (the threads' writes of a tile and of its
//   mirror both spread over the banks), and written to global memory by
//   Hopper's tensor copies: one cp.async.bulk.tensor store per 128 bytes of
//   a tile's rows (two per f64 tile, one per f32 tile), which also clips
//   the ragged edges.  The copy engine takes the writes off the threads'
//   issue slots and overlaps them with the next components' arithmetic.
//   The one barrier a component takes publishes the staged tile; a buffer
//   is refilled three components later, after its copies have read it
//   (cp.async.bulk.wait_group.read by the thread that issued them, one
//   component later, before the next barrier).
// - An output the tensor copy cannot address (n2 * sizeof(T) not a
//   multiple of 16, or not 16-byte aligned) goes out from the same staging
//   buffers with plain coalesced stores: the same kernel, a flag apart.  A
//   tensor map that does not encode fails the launch.
//
// The triangle walk, the component split over a second grid dimension for
// few tiles, and the symmetry argument are gram_kernel.cuh's: the mirrored
// value is the one computed at (i, j), bit for bit what (j, i) gives.
//
// The launcher returns cudaGetLastError() after the launch; it launches on
// the caller's stream, allocates nothing and does not synchronise.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "gram_common.cuh"
#include "tensor_map.cuh"

namespace {
namespace k3 {

using lcgp::add_rn;
using lcgp::mul_rn;

constexpr int TS = 32;                  // tile side
constexpr int TX = 16;                  // threads along j: columns tx, tx+16
constexpr int TY = 16;                  // threads along i: rows ty, ty+16
constexpr int NT = TX * TY;
constexpr int KC = 32;                  // components staged at a time
constexpr int NBUF = 3;                 // ring of staged components
constexpr long long MIN_BLOCKS = 1024;  // blocks a launch aims for

// A staged tile: TS x TS elements in the 128-byte swizzle, boxes of
// BOXC columns.
template <typename T>
struct Tile {
  static constexpr int BOXC = 128 / (int)sizeof(T);
  static constexpr int NBOX = TS / BOXC;
  static constexpr int BYTES = TS * TS * (int)sizeof(T);
};

template <typename T>
__host__ __device__ constexpr size_t stage_bytes(bool with_c0) {
  return 1024 + (size_t)NBUF * (with_c0 ? 4 : 2) * Tile<T>::BYTES;
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stores one box of a staged tile with the tensor copy, in the issuing
// thread's current bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(s), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's newest bulk groups still read
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <typename T, int MAXD, typename P>
__global__ void __launch_bounds__(NT, MAXD <= 16 ? 3 : 2)
gram_staged_kernel(const __grid_constant__ CUtensorMap map_out,
                   const __grid_constant__ CUtensorMap map_c0, int tma,
                   const T* __restrict__ x1, const T* __restrict__ x2,
                   const T* __restrict__ inv_l, const T* __restrict__ amp,
                   const T* __restrict__ nug,
                   const T* __restrict__ row_scale,
                   const T* __restrict__ diag_vec, int same, int q, int kb,
                   int n1, int n2, int d, T* __restrict__ out,
                   T* __restrict__ c0_out) {
  using TL = Tile<T>;
  constexpr int SZ = (int)sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  // the staging ring, 1024-byte aligned for the swizzle:
  // [NBUF][ntile][TL::BYTES]
  unsigned char* s_stage =
      smem_raw +
      ((1024 - (static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)) &
                1023)) &
       1023);
  __shared__ T s_x1[TS][MAXD + 1];           // x rows of the tile's rows
  __shared__ T s_x2[MAXD][TS];               // x rows of its columns, by dim
  __shared__ T s_inv[KC][MAXD];
  __shared__ T s_amp[KC];
  __shared__ T s_ome[KC];                    // 1 - eta
  __shared__ T s_rs[KC];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  int ti, tj;
  lcgp::tile_of(blockIdx.x, same, (n2 + TS - 1) / TS, ti, tj);
  const int i0 = ti * TS, j0 = tj * TS;
  const bool mirror = same && ti != tj;
  const bool epilogue = row_scale != nullptr;
  const int ntile = c0_out ? 4 : 2;   // out, its mirror, C0, its mirror
  const long long plane = (long long)n1 * n2;

  for (int e = tid; e < TS * MAXD; e += NT) {
    const int r = e / MAXD, t = e % MAXD;
    s_x1[r][t] = (t < d && i0 + r < n1) ? x1[(long long)(i0 + r) * d + t]
                                         : T(0);
  }
  for (int e = tid; e < MAXD * TS; e += NT) {
    const int t = e / TS, c = e % TS;
    s_x2[t][c] = (t < d && j0 + c < n2) ? x2[(long long)(j0 + c) * d + t]
                                         : T(0);
  }

  // the tensor store a thread issues for each staged component: box `cbox`
  // of staged tile `ctile` (even: the tile, odd: its mirror)
  const int ctile = tid / TL::NBOX, cbox = tid % TL::NBOX;
  const bool issuer = tma && tid < ntile * TL::NBOX;
  const bool copies = issuer && (!(ctile & 1) || mirror);
  const int cx = ((ctile & 1) ? i0 : j0) + cbox * TL::BOXC;
  const int cy = (ctile & 1) ? j0 : i0;

  int slot = 0;
  const int k_end = min(q, (int)(blockIdx.y + 1) * kb);
  for (int k0 = blockIdx.y * kb; k0 < k_end; k0 += KC) {
    const int kc = min(KC, k_end - k0);
    __syncthreads();
    for (int e = tid; e < kc * MAXD; e += NT) {
      const int kk = e / MAXD, t = e % MAXD;
      s_inv[kk][t] = t < d ? inv_l[(long long)(k0 + kk) * d + t] : T(0);
    }
    if (tid < kc) {
      const T nu = nug[k0 + tid];
      const T eta = nu / (T(1) + nu);
      s_amp[tid] = amp[k0 + tid];
      s_ome[tid] = T(1) - eta;
      s_rs[tid] = row_scale ? row_scale[k0 + tid] : T(1);
    }
    __syncthreads();

    for (int kk = 0; kk < kc; ++kk) {
      const int k = k0 + kk;
      T prod[2][2], ssum[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          prod[a][b] = T(1);
          ssum[a][b] = T(0);
        }
      }
      // every dimension up to MAXD: past d, S_t = 0 leaves both exact
#pragma unroll
      for (int t = 0; t < MAXD; ++t) {
        const T iv = s_inv[kk][t];
        const T xa[2] = {s_x1[ty][t], s_x1[ty + TY][t]};
        const T xb[2] = {s_x2[t][tx], s_x2[t][tx + TX]};
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const T s = mul_rn(lcgp::absdiff(xa[a], xb[b]), iv);
            prod[a][b] = P::grow(prod[a][b], s);
            ssum[a][b] = P::accum(ssum[a][b], s);
          }
        }
      }

      unsigned char* buf = s_stage + slot * ntile * TL::BYTES;
      const T amp_k = s_amp[kk], ome_k = s_ome[kk], rs_k = s_rs[kk];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = ty + a * TY;
        const int i = i0 + r;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = tx + b * TX;
          const int j = j0 + c;
          const T c0 = P::c0(prod[a][b], P::decay(ssum[a][b]));
          // on the diagonal of a same-point Gram every S_t is exactly 0, so
          // C0 == 1 and C == amp exactly
          const bool on_diag = same && i == j && i < n1;
          T v = on_diag ? amp_k : mul_rn(amp_k, mul_rn(ome_k, c0));
          if (epilogue) {
            v = mul_rn(rs_k, v);
            if (diag_vec && on_diag) {
              v = add_rn(v, diag_vec[(long long)k * n1 + i]);
            }
          }
          const int at = tmap::swizzled(r, c, TS, SZ);
          const int at_t = tmap::swizzled(c, r, TS, SZ);
          *reinterpret_cast<T*>(buf + at) = v;
          if (mirror) *reinterpret_cast<T*>(buf + TL::BYTES + at_t) = v;
          if (c0_out) {
            *reinterpret_cast<T*>(buf + 2 * TL::BYTES + at) = c0;
            if (mirror) {
              *reinterpret_cast<T*>(buf + 3 * TL::BYTES + at_t) = c0;
            }
          }
        }
      }
      if (tma) fence_async_shared();
      __syncthreads();

      if (tma) {
        if (copies) {
          tma_store(ctile < 2 ? &map_out : &map_c0,
                    buf + ctile * TL::BYTES + cbox * TS * 128, cx, cy, k);
        }
        if (issuer) {
          bulk_commit();
          // the copies of the component before this one have read their
          // buffer, which the component after next refills
          bulk_wait_read<NBUF - 2>();
        }
      } else {
        T* out_k = out + k * plane;
        T* c0_k = c0_out ? c0_out + k * plane : nullptr;
        for (int e = tid; e < TS * TS; e += NT) {
          const int r = e / TS, c = e % TS;
          const int at = tmap::swizzled(r, c, TS, SZ);
          if (i0 + r < n1 && j0 + c < n2) {
            const long long g = (long long)(i0 + r) * n2 + (j0 + c);
            out_k[g] = *reinterpret_cast<const T*>(buf + at);
            if (c0_k) {
              c0_k[g] = *reinterpret_cast<const T*>(buf + 2 * TL::BYTES + at);
            }
          }
          if (mirror && j0 + r < n1 && i0 + c < n2) {
            const long long g = (long long)(j0 + r) * n2 + (i0 + c);
            out_k[g] = *reinterpret_cast<const T*>(buf + TL::BYTES + at);
            if (c0_k) {
              c0_k[g] = *reinterpret_cast<const T*>(buf + 3 * TL::BYTES + at);
            }
          }
        }
      }
      slot = slot == NBUF - 1 ? 0 : slot + 1;
    }
  }
  if (issuer) bulk_wait_read<0>();
}

template <typename P, typename T, int MAXD>
int gram_launch_maxd(const T* x1, const T* x2, const T* inv_l, const T* amp,
                     const T* nug, const T* row_scale, const T* diag_vec,
                     int same, int q, int n1, int n2, int d, T* out,
                     T* c0_out, cudaStream_t stream) {
  auto kernel = gram_staged_kernel<T, MAXD, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)stage_bytes<T>(true));
  if (err != cudaSuccess) return (int)err;
  const long long ti = (n1 + TS - 1) / TS, tj = (n2 + TS - 1) / TS;
  const long long blocks = same ? ti * (ti + 1) / 2 : ti * tj;
  // few tiles (a request's 64 x n cross-covariance): split the components
  // over a second grid dimension, so that the card gets enough blocks
  const long long chunks = std::min<long long>(
      q, (MIN_BLOCKS + blocks - 1) / blocks);
  const int kb = (int)((q + chunks - 1) / chunks);
  CUtensorMap map_out{}, map_c0{};
  const bool tma = tmap::addressable<T>(out, n2) &&
                   (!c0_out || tmap::addressable<T>(c0_out, n2));
  if (tma) {
    const bool ok =
        tmap::encode_stack<T>(&map_out, out, q, n1, n2, Tile<T>::BOXC, TS,
                              CU_TENSOR_MAP_SWIZZLE_128B) &&
        (!c0_out ||
         tmap::encode_stack<T>(&map_c0, c0_out, q, n1, n2, Tile<T>::BOXC, TS,
                               CU_TENSOR_MAP_SWIZZLE_128B));
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)blocks, (unsigned)((q + kb - 1) / kb));
  kernel<<<grid, NT, stage_bytes<T>(c0_out != nullptr), stream>>>(
      map_out, map_c0, (int)tma, x1, x2, inv_l, amp, nug, row_scale,
      diag_vec, same, q, kb, n1, n2, d, out, c0_out);
  return (int)cudaGetLastError();
}

// The body of the lcgp_matern52_gram_{f64,f32} C entry points.
template <typename P, typename T>
int gram_launch(const void* x1, const void* x2, const void* inv_l,
                const void* amp, const void* nug, const void* row_scale,
                const void* diag_vec, int same, int q, int n1, int n2, int d,
                void* out, void* c0_out, void* stream) {
  if (q <= 0 || n1 <= 0 || n2 <= 0 || d <= 0 || d > 32 ||
      (same && n1 != n2)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ti = (n1 + TS - 1) / TS, tj = (n2 + TS - 1) / TS;
  if ((same ? ti * (ti + 1) / 2 : ti * tj) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto maxd_tag) {
    constexpr int M = decltype(maxd_tag)::value;
    return gram_launch_maxd<P, T, M>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(inv_l), static_cast<const T*>(amp),
        static_cast<const T*>(nug), static_cast<const T*>(row_scale),
        static_cast<const T*>(diag_vec), same, q, n1, n2, d,
        static_cast<T*>(out), static_cast<T*>(c0_out), s);
  };
  if (d <= 2) return run(std::integral_constant<int, 2>{});
  if (d <= 4) return run(std::integral_constant<int, 4>{});
  if (d <= 8) return run(std::integral_constant<int, 8>{});
  if (d <= 16) return run(std::integral_constant<int, 16>{});
  return run(std::integral_constant<int, 32>{});
}

}  // namespace k3
}  // namespace

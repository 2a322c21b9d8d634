// The batched Gram stack / factorization target for Hopper (sm_90a), one
// template for two kernel families (gram_common.cuh's policies): K1
// (matern32_gram.cu) and K4's forward (rbf_gram.cu) are its instantiations.
// K3 (Matern 5/2) has its own template, matern52_gram_kernel.cuh.
//
//   C0[k,i,j]  = the family's correlation of S_t = |x1[i,t] - x2[j,t]| * inv_l[k,t]
//   C[k,i,j]   = amp_k * ((1 - eta_k) * C0 + eta_k * [same && i == j]),
//                eta_k = nug_k / (1 + nug_k)
//   epilogue:    out = row_scale_k * C + [i == j] * diag_vec[k,i]
//
// What bounds it on the card: the writes.  Each output entry and component
// costs a few f64 operations per dimension plus one f64 exp (3d + 18 for
// Matern 3/2, 2d + 19 for SE) and is written once: at q = 20, n = 4096 the
// square stack is 2.7 GB, 0.80 ms at 3.35 TB/s, while one triangle of the
// arithmetic is 0.35-0.41 ms at the f64 peak (d = 8).  So the design halves the arithmetic and keeps the stores
// coalesced and wide:
//
// - A same-point Gram is exactly symmetric (gram_common.cuh), so the grid
//   walks the lower triangle of 32 x 32 tiles.  A block computes tile
//   (ti, tj), ti >= tj, for every component, stores it directly, and stores
//   the mirrored tile (tj, ti) through a padded shared-memory transpose, so
//   both stores are coalesced.  The mirrored value is the one computed at
//   (i, j), which is bit for bit what (j, i) would give.  A diagonal tile is
//   computed whole and needs no mirror; the nugget and diag_vec land only
//   there.  A cross Gram (same = 0: a request's cross-covariance) walks
//   every tile of its rectangle, with no mirror.
// - Each thread owns two rows and two adjacent columns of a tile: four
//   independent entries whose chains interleave, and whose pairs of
//   columns go out as one 16-byte store (8-byte in f32) where n2 is even.
// - The distances are formed from the tile's x rows staged in shared
//   memory; the per-component scalars (inv_l row, amp, 1 - eta, row_scale)
//   are staged in chunks of KC components.  C is never written apart from
//   the epilogue's B, and C0 only when the caller asks for it.
// - A launch with few tiles (a request's 64 x n cross-covariance: 256
//   tiles) splits the components over a second grid dimension, so that the
//   card gets about MIN_BLOCKS blocks.
//
// The squared exponential is computed from the subtracted distances too,
// not in the GEMM form |u|^2 + |v|^2 - 2 u.v: with d = 8 the contraction is
// too short for the tensor cores to pay, the writes bound the kernel
// anyway, and the GEMM form's cancellation would put eps |u|^2 into every
// entry (and C0 != 1 on the diagonal).
//
// The launchers return cudaGetLastError() after the launch; they launch on
// the caller's stream, allocate nothing and do not synchronise.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "gram_common.cuh"

namespace {

using lcgp::add_rn;
using lcgp::mul_rn;

constexpr int TS = 32;      // tile side
constexpr int TX = 16;      // threads along j, each owning columns 2tx, 2tx+1
constexpr int TY = 16;      // threads along i, each owning rows ty, ty+16
constexpr int NT = TX * TY;
constexpr int TP = TS + 1;  // pitch of the transpose buffers
constexpr int KC = 32;      // components staged in shared memory at a time
constexpr long long MIN_BLOCKS = 1024;  // blocks a launch aims for

template <typename T>
struct Vec2;
template <>
struct Vec2<double> {
  using type = double2;
};
template <>
struct Vec2<float> {
  using type = float2;
};

// Stores entries (row, col) and (row, col + 1) of a row-major plane with
// n_cols columns; as one vector store when `vec` (n_cols even, 16-byte
// aligned base), else as the scalars that fall inside the plane.
template <typename T>
__device__ __forceinline__ void store_pair(T* plane, long long row, int col,
                                           int n_cols, bool vec, T a, T b) {
  using V2 = typename Vec2<T>::type;
  T* p = plane + row * n_cols + col;
  if (vec) {
    V2 v;
    v.x = a;
    v.y = b;
    *reinterpret_cast<V2*>(p) = v;
  } else {
    if (col < n_cols) p[0] = a;
    if (col + 1 < n_cols) p[1] = b;
  }
}

// Entry value of the Gram or factor target at (i, j) from its distances;
// c0 receives C0.
template <typename P, typename T, int MAXD>
__device__ __forceinline__ T entry(const T (&diff)[MAXD], const T* inv,
                                   int d, T amp_k, T ome_k, T rs_k,
                                   bool epilogue, const T* dv, bool on_diag,
                                   T& c0) {
  T s[MAXD], pre[MAXD], prod, ssum;
  lcgp::factors<P, T, MAXD>(diff, inv, d, s, pre, prod, ssum);
  c0 = P::c0(prod, P::decay(ssum));
  // on the diagonal of a same-point Gram every S_t is exactly 0, so C0 == 1
  // and C == amp exactly
  const T cv = on_diag ? amp_k : mul_rn(amp_k, mul_rn(ome_k, c0));
  if (!epilogue) return cv;
  const T v = mul_rn(rs_k, cv);
  return (dv && on_diag) ? add_rn(v, *dv) : v;
}

template <typename T, int MAXD, typename P>
__global__ void __launch_bounds__(NT, P::fwd_min_blocks(MAXD))
gram_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
            const T* __restrict__ inv_l, const T* __restrict__ amp,
            const T* __restrict__ nug, const T* __restrict__ row_scale,
            const T* __restrict__ diag_vec, int same, int q, int kb, int n1,
            int n2, int d, int vec, T* __restrict__ out,
            T* __restrict__ c0_out) {
  using V2 = typename Vec2<T>::type;
  __shared__ T s_x1[TS][MAXD + 1];            // x rows of the tile's rows
  __shared__ __align__(16) T s_x2[MAXD][TS];  // x rows of its columns, by dim
  __shared__ T s_tr[2][TS][TP];               // transposes of out and C0
  __shared__ T s_inv[KC][MAXD];
  __shared__ T s_amp[KC];
  __shared__ T s_ome[KC];                 // 1 - eta
  __shared__ T s_rs[KC];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  int ti, tj;
  lcgp::tile_of(blockIdx.x, same, (n2 + TS - 1) / TS, ti, tj);
  const int i0 = ti * TS, j0 = tj * TS;
  const bool mirror = same && ti != tj;
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

  // this block's components: chunk blockIdx.y of kb
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
      T o[2][2], c0s[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = ty + a * TY;
        const int i = i0 + r;
        T d0[MAXD], d1[MAXD];   // columns 2tx and 2tx + 1
#pragma unroll
        for (int t = 0; t < MAXD; ++t) {
          const T xr = s_x1[r][t];
          const V2 xc = *reinterpret_cast<const V2*>(&s_x2[t][2 * tx]);
          d0[t] = lcgp::absdiff(xr, xc.x);
          d1[t] = lcgp::absdiff(xr, xc.y);
        }
        const T* dv = diag_vec ? diag_vec + (long long)k * n1 + i : nullptr;
        const int j = j0 + 2 * tx;
        o[a][0] = entry<P, T, MAXD>(d0, s_inv[kk], d, s_amp[kk], s_ome[kk],
                                    s_rs[kk], row_scale != nullptr, dv,
                                    same && i == j && i < n1, c0s[a][0]);
        o[a][1] = entry<P, T, MAXD>(d1, s_inv[kk], d, s_amp[kk], s_ome[kk],
                                    s_rs[kk], row_scale != nullptr, dv,
                                    same && i == j + 1 && i < n1, c0s[a][1]);
      }

      T* out_k = out + k * plane;
      T* c0_k = c0_out ? c0_out + k * plane : nullptr;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = i0 + ty + a * TY;
        if (i < n1) {
          store_pair(out_k, i, j0 + 2 * tx, n2, vec && j0 + 2 * tx < n2,
                     o[a][0], o[a][1]);
          if (c0_k) {
            store_pair(c0_k, i, j0 + 2 * tx, n2, vec && j0 + 2 * tx < n2,
                       c0s[a][0], c0s[a][1]);
          }
        }
      }
      if (mirror) {
        // tile (tj, ti): row j0 + c holds column i0 + r of the tile above
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            s_tr[0][2 * tx + b][ty + a * TY] = o[a][b];
            s_tr[1][2 * tx + b][ty + a * TY] = c0s[a][b];
          }
        }
        __syncthreads();
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int r = ty + a * TY;
          const int row = j0 + r;
          const int col = i0 + 2 * tx;
          if (row < n1) {
            store_pair(out_k, row, col, n2, vec && col < n2,
                       s_tr[0][r][2 * tx], s_tr[0][r][2 * tx + 1]);
            if (c0_k) {
              store_pair(c0_k, row, col, n2, vec && col < n2,
                         s_tr[1][r][2 * tx], s_tr[1][r][2 * tx + 1]);
            }
          }
        }
        __syncthreads();
      }
    }
  }
}

template <typename P, typename T, int MAXD>
void gram_launch_maxd(const T* x1, const T* x2, const T* inv_l, const T* amp,
                      const T* nug, const T* row_scale, const T* diag_vec,
                      int same, int q, int n1, int n2, int d, T* out,
                      T* c0_out, cudaStream_t stream) {
  using V2 = typename Vec2<T>::type;
  const long long ti = (n1 + TS - 1) / TS, tj = (n2 + TS - 1) / TS;
  const long long blocks = same ? ti * (ti + 1) / 2 : ti * tj;
  // few tiles (a request's 64 x n cross-covariance): split the components
  // over a second grid dimension, so that the card gets enough blocks
  const long long chunks = std::min<long long>(
      q, (MIN_BLOCKS + blocks - 1) / blocks);
  const int kb = (int)((q + chunks - 1) / chunks);
  const bool vec =
      n2 % 2 == 0 && reinterpret_cast<size_t>(out) % sizeof(V2) == 0 &&
      reinterpret_cast<size_t>(c0_out) % sizeof(V2) == 0;
  const dim3 grid((unsigned)blocks, (unsigned)((q + kb - 1) / kb));
  gram_kernel<T, MAXD, P><<<grid, NT, 0, stream>>>(
      x1, x2, inv_l, amp, nug, row_scale, diag_vec, same, q, kb, n1, n2, d,
      (int)vec, out, c0_out);
}

// The body of every lcgp_<family>_gram_{f64,f32} C entry point.
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
  auto args = [&](auto maxd_tag) {
    constexpr int M = decltype(maxd_tag)::value;
    gram_launch_maxd<P, T, M>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(inv_l), static_cast<const T*>(amp),
        static_cast<const T*>(nug), static_cast<const T*>(row_scale),
        static_cast<const T*>(diag_vec), same, q, n1, n2, d,
        static_cast<T*>(out), static_cast<T*>(c0_out), s);
  };
  if (d <= 4) {
    args(std::integral_constant<int, 4>{});
  } else if (d <= 8) {
    args(std::integral_constant<int, 8>{});
  } else if (d <= 16) {
    args(std::integral_constant<int, 16>{});
  } else {
    args(std::integral_constant<int, 32>{});
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Batched Matern 3/2 Gram stack / factorization target for Hopper (sm_90a).
//
// Replaces the TPU kernel lcgp_tpu/ops/matern_pallas.py::_fwd_call (deleted
// in commit b21a99c; its pallas_call and _fwd_kernel body are the spec) and
// its live jnp successors lcgp_tpu/ops/matern.py::matern32_gram and
// lcgp_tpu/ops/gram.py::gram_factor_target.
//
//   C0[k,i,j]  = prod_t (1 + S_t) * exp(-sum_t S_t),  S_t = |x1[i,t] - x2[j,t]| * inv_l[k,t]
//   C[k,i,j]   = amp_k * ((1 - eta_k) * C0 + eta_k * [same && i == j]),
//                eta_k = nug_k / (1 + nug_k)
//   epilogue:    out = row_scale_k * C + [i == j] * diag_vec[k,i]
//
// What bounds it on the card: f64 arithmetic.  Each output entry costs about
// 3d floating-point operations plus one f64 exp per component, and is
// written once (q*n1*n2 values: 2.7 GB at q=20, n=4096 in f64).  Measured
// on an H100 (700 W) at that shape, writing C0 as well (twice the bytes)
// costs no extra time, so the stores are not the limit; the exp and the
// per-dimension products are.  The design keeps that arithmetic to its
// minimum with the insight of the Pallas kernel: the raw distance
// |x1[i,t] - x2[j,t]| does not depend on k.  Each thread owns one (i, j)
// entry, keeps its d raw abs-differences in registers, and walks all q
// components, so the distances are formed once and only the k-dependent
// scaling, the product, the exp and the store are paid per component.
// (A same-point Gram is symmetric; computing one triangle would halve the
// arithmetic and is the next step.)  The per-component scalars
// (inv_l row, amp, 1-eta, row_scale) are staged in shared memory in chunks
// of KC components.  Threads along x own consecutive j, so every store of
// out[k, i, :] is coalesced.  The epilogue writes B directly: C is never
// written separately, and C0 only when the caller asks for it.
//
// The C entry points return cudaGetLastError() after the launch; they launch
// on the caller's stream, allocate nothing and do not synchronise.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int BX = 32;   // threads along j (one warp: coalesced stores)
constexpr int BY = 8;    // threads along i
constexpr int KC = 32;   // components staged in shared memory at a time
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float exp_t(float v) { return expf(v); }

template <typename T, int MAXD>
__global__ void __launch_bounds__(BX * BY)
matern32_gram_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ inv_l, const T* __restrict__ amp,
                     const T* __restrict__ nug,
                     const T* __restrict__ row_scale,
                     const T* __restrict__ diag_vec,
                     int same, int q, int n1, int n2, int d,
                     T* __restrict__ out, T* __restrict__ c0_out) {
  __shared__ T s_inv[KC][MAXD];
  __shared__ T s_amp[KC];
  __shared__ T s_ome[KC];   // 1 - eta
  __shared__ T s_rs[KC];

  const int tid = threadIdx.y * BX + threadIdx.x;
  const int j = blockIdx.x * BX + threadIdx.x;
  const long long plane = (long long)n1 * n2;

  // grid-stride over row tiles; the loop bound is uniform across the block,
  // so every thread reaches each __syncthreads below
  for (int i0 = blockIdx.y * BY; i0 < n1; i0 += gridDim.y * BY) {
    const int i = i0 + threadIdx.y;
    const bool active = (i < n1) && (j < n2);
    const bool on_diag = same && (i == j);

    T diff[MAXD];
#pragma unroll
    for (int t = 0; t < MAXD; ++t) {
      diff[t] = T(0);
      if (active && t < d) {
        diff[t] = fabs(x1[(long long)i * d + t] - x2[(long long)j * d + t]);
      }
    }
    const long long ij = (long long)i * n2 + j;

    for (int k0 = 0; k0 < q; k0 += KC) {
      const int kc = min(KC, q - k0);
      __syncthreads();
      for (int e = tid; e < kc * MAXD; e += BX * BY) {
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
      if (!active) continue;

      for (int kk = 0; kk < kc; ++kk) {
        const int k = k0 + kk;
        T prod = T(1), ssum = T(0);
#pragma unroll
        for (int t = 0; t < MAXD; ++t) {
          if (t < d) {
            const T s = diff[t] * s_inv[kk][t];
            prod = prod * (T(1) + s);
            ssum = ssum + s;
          }
        }
        const T c0 = prod * exp_t(-ssum);
        // on the diagonal of a same-point Gram every S_t is exactly 0, so
        // C0 == 1 and C == amp exactly
        const T c = on_diag ? s_amp[kk] : s_amp[kk] * (s_ome[kk] * c0);
        T o = c;
        if (row_scale) {
          o = s_rs[kk] * c;
          if (diag_vec && i == j) o = o + diag_vec[(long long)k * n1 + i];
        }
        out[k * plane + ij] = o;
        if (c0_out) c0_out[k * plane + ij] = c0;
      }
    }
  }
}

template <typename T, int MAXD>
void launch_maxd(const T* x1, const T* x2, const T* inv_l, const T* amp,
                 const T* nug, const T* row_scale, const T* diag_vec,
                 int same, int q, int n1, int n2, int d, T* out, T* c0_out,
                 cudaStream_t stream) {
  const int gy = (n1 + BY - 1) / BY;
  dim3 grid((n2 + BX - 1) / BX, gy < MAX_GRID_Y ? gy : MAX_GRID_Y);
  dim3 block(BX, BY);
  matern32_gram_kernel<T, MAXD><<<grid, block, 0, stream>>>(
      x1, x2, inv_l, amp, nug, row_scale, diag_vec, same, q, n1, n2, d, out,
      c0_out);
}

template <typename T>
int launch(const void* x1, const void* x2, const void* inv_l, const void* amp,
           const void* nug, const void* row_scale, const void* diag_vec,
           int same, int q, int n1, int n2, int d, void* out, void* c0_out,
           void* stream) {
  if (q <= 0 || n1 <= 0 || n2 <= 0 || d <= 0 || d > 32) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto maxd_tag) {
    constexpr int M = decltype(maxd_tag)::value;
    launch_maxd<T, M>(static_cast<const T*>(x1), static_cast<const T*>(x2),
                      static_cast<const T*>(inv_l), static_cast<const T*>(amp),
                      static_cast<const T*>(nug),
                      static_cast<const T*>(row_scale),
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

extern "C" {

int lcgp_matern32_gram_f64(const void* x1, const void* x2, const void* inv_l,
                           const void* amp, const void* nug,
                           const void* row_scale, const void* diag_vec,
                           int same, int q, int n1, int n2, int d, void* out,
                           void* c0_out, void* stream) {
  return launch<double>(x1, x2, inv_l, amp, nug, row_scale, diag_vec, same, q,
                        n1, n2, d, out, c0_out, stream);
}

int lcgp_matern32_gram_f32(const void* x1, const void* x2, const void* inv_l,
                           const void* amp, const void* nug,
                           const void* row_scale, const void* diag_vec,
                           int same, int q, int n1, int n2, int d, void* out,
                           void* c0_out, void* stream) {
  return launch<float>(x1, x2, inv_l, amp, nug, row_scale, diag_vec, same, q,
                       n1, n2, d, out, c0_out, stream);
}

}  // extern "C"

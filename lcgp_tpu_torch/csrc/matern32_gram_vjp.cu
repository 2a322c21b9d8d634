// Matern 3/2 Gram-stack VJP (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel lcgp_tpu/ops/matern_pallas.py::_bwd_call (deleted
// in commit b21a99c; its pallas_call and _bwd_kernel body are the spec), the
// backward of K1 (csrc/matern32_gram.cu), and its live jnp successors
// lcgp_tpu/ops/matern.py::matern32_gram_vjp and the cotangent assembly of
// lcgp_tpu/models/likelihood.py::_full_terms_fwd_impl.
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
//   G2+t[k]  = sum cbar * C0 * S_t^2 / (1 + S_t),     t = 0..d-1
//
// and an epilogue turns them into the gradients of amp, nug and the
// lengthscales, as lcgp_tpu/ops/matern.py:126-147 does:
//
//   gamp  = (1 - eta) G0 + eta G1
//   gnug  = amp (G1 - G0) / (1 + nug)^2
//   glens = amp (1 - eta) G2+t / l_t
//
// C0 is recomputed from the distances, as the Pallas _bwd_kernel did,
// rather than read from a stored stack: the training forward then never
// writes C0 (a 2.7 GB f64 stack at q=20, n=4096).  Each distance is formed
// the way K1 forms it, |x1 - x2| * (1/l) (subtract first), so the recomputed
// C0 equals K1's bit for bit.  The quotient S^2/(1+S) costs no division:
// with prefix and suffix products of the (1 + S_u),
// C0 S_t^2/(1+S_t) = exp(-sum S) * S_t^2 * prod_{u != t} (1 + S_u).
//
// What bounds it on the card: f64 arithmetic.  It reads M once (2.7 GB at
// q=20, n=4096 in f64, ~0.8 ms at 3.35 TB/s), but each entry and
// component costs about 11 d flops plus one f64 exp, more than K1's
// 3 d + exp, and K1 is already arithmetic bound at that shape.  The layout
// is K1's: threads along x own consecutive j, so the reads of M[k,i,:] are
// coalesced; a thread keeps its d raw distances in registers for each row
// and walks the KC components of its block (blockIdx.z picks the chunk);
// the chunk's 1/l rows and alphas sit in shared memory, and the block's
// x2 rows are staged there too.  Summing one triangle of the symmetric
// same-point cbar * C0 would halve the work; that is left for later.
//
// The reduction across blocks is deterministic, with no atomics: each
// thread accumulates in f64 registers (in both instantiations), a warp
// shuffle and a shared-memory pass reduce the block, every block writes its
// (KC, d + 2) partial sums to a scratch buffer the caller allocates, and a
// second small kernel sums the partials of each component in a fixed order
// and applies the epilogue.  The same shapes give the same bits on every
// run.  A NaN in M (a failed factor) gives NaN gradients, not a fault.
//
// The C entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int BX = 32;               // threads along j (one warp: coalesced)
constexpr int BY = 8;                // threads along i
constexpr int NT = BX * BY;
constexpr int NWARP = NT / 32;
constexpr int ROWS_PER_THREAD = 16;  // rows a thread walks, to amortise the
                                     // block reduction
constexpr int MAX_GRID_Y = 65535;
constexpr int MAX_GRID_Z = 65535;

__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float exp_t(float v) { return expf(v); }

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// components per block: the accumulators take KC * (MAXD + 2) f64 registers
template <int MAXD>
constexpr int comps_per_block() {
  return MAXD <= 16 ? 2 : 1;
}

struct Grid {
  int gx, gy;
  long long blocks() const { return (long long)gx * gy; }
};

Grid partial_grid(int n1, int n2) {
  const int gy = (n1 + BY * ROWS_PER_THREAD - 1) / (BY * ROWS_PER_THREAD);
  return Grid{(n2 + BX - 1) / BX, gy < MAX_GRID_Y ? gy : MAX_GRID_Y};
}

template <typename T, int MAXD, int KC>
__global__ void __launch_bounds__(NT)
matern32_vjp_partials_kernel(const T* __restrict__ x1,
                             const T* __restrict__ x2,
                             const T* __restrict__ inv_l,
                             const T* __restrict__ M,
                             const T* __restrict__ w,
                             const T* __restrict__ alpha, T beta, int same,
                             int q, int n1, int n2, int d,
                             double* __restrict__ partials) {
  constexpr int NV = MAXD + 2;
  __shared__ T s_x2[MAXD][BX];
  __shared__ T s_inv[KC][MAXD];
  __shared__ T s_alpha[KC];
  __shared__ double s_red[NWARP][KC * NV];

  const int tid = threadIdx.y * BX + threadIdx.x;
  const int j = blockIdx.x * BX + threadIdx.x;
  const int k0 = blockIdx.z * KC;
  const int kc = min(KC, q - k0);
  const long long plane = (long long)n1 * n2;

  for (int e = tid; e < MAXD * BX; e += NT) {
    const int t = e / BX, c = e % BX;
    const int jj = blockIdx.x * BX + c;
    s_x2[t][c] = (t < d && jj < n2) ? x2[(long long)jj * d + t] : T(0);
  }
  for (int e = tid; e < KC * MAXD; e += NT) {
    const int kk = e / MAXD, t = e % MAXD;
    s_inv[kk][t] =
        (kk < kc && t < d) ? inv_l[(long long)(k0 + kk) * d + t] : T(0);
  }
  if (tid < KC) {
    s_alpha[tid] = (tid < kc && alpha) ? alpha[k0 + tid] : T(1);
  }
  __syncthreads();

  double acc[KC][NV];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[kk][v] = 0.0;
  }

  if (j < n2) {
    T wj[KC];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      wj[kk] = (w && kk < kc) ? w[(long long)(k0 + kk) * n2 + j] : T(0);
    }
    for (int i = blockIdx.y * BY + threadIdx.y; i < n1;
         i += gridDim.y * BY) {
      T diff[MAXD];
#pragma unroll
      for (int t = 0; t < MAXD; ++t) {
        diff[t] = t < d ? fabs(x1[(long long)i * d + t] - s_x2[t][threadIdx.x])
                        : T(0);
      }
      const bool on_diag = same && (i == j);
      const long long ij = (long long)i * n2 + j;

#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        if (kk < kc) {
          const int k = k0 + kk;
          T cb = s_alpha[kk] * M[k * plane + ij];
          if (w) cb = cb + beta * w[(long long)k * n1 + i] * wj[kk];
          if (on_diag) {
            // every S_t is exactly 0 on a same-point diagonal: C0 == 1 and
            // the lengthscale terms vanish
            acc[kk][0] += (double)cb;
            acc[kk][1] += (double)cb;
          } else {
            // pre[t] = prod_{u < t} (1 + S_u); prod and ssum in K1's order
            T pre[MAXD];
            T prod = T(1), ssum = T(0);
#pragma unroll
            for (int t = 0; t < MAXD; ++t) {
              if (t < d) {
                const T s = diff[t] * s_inv[kk][t];
                pre[t] = prod;
                prod = prod * (T(1) + s);
                ssum = ssum + s;
              }
            }
            const T e = exp_t(-ssum);
            const T c0 = prod * e;
            const T ce = cb * e;
            acc[kk][0] += (double)(cb * c0);
            T suf = T(1);   // prod_{u > t} (1 + S_u)
#pragma unroll
            for (int t = MAXD - 1; t >= 0; --t) {
              if (t < d) {
                const T s = diff[t] * s_inv[kk][t];
                acc[kk][2 + t] += (double)(ce * (s * s) * (pre[t] * suf));
                suf = suf * (T(1) + s);
              }
            }
          }
        }
      }
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const double s = warp_sum(acc[kk][v]);
      if (lane == 0) s_red[warp][kk * NV + v] = s;
    }
  }
  __syncthreads();
  const long long nblk = (long long)gridDim.x * gridDim.y;
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const int nv = d + 2;
  for (int e = tid; e < kc * nv; e += NT) {
    const int kk = e / nv, v = e % nv;
    double s = 0.0;
#pragma unroll
    for (int wp = 0; wp < NWARP; ++wp) s += s_red[wp][kk * NV + v];
    partials[((long long)(k0 + kk) * nv + v) * nblk + blk] = s;
  }
}

// One block per component: sums its (d + 2) rows of partials in a fixed
// order, then applies the epilogue.
template <typename T>
__global__ void __launch_bounds__(NT)
matern32_vjp_finish_kernel(const double* __restrict__ partials,
                           long long nblk, const T* __restrict__ inv_l,
                           const T* __restrict__ amp,
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
    for (long long b = threadIdx.x; b < nblk; b += NT) s += p[b];
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
          T(s_tot[2 + t] * (a * (1.0 - eta)) * (double)inv_l[(long long)k * d + t]);
    }
  }
}

template <typename T, int MAXD>
int launch_maxd(const T* x1, const T* x2, const T* inv_l, const T* amp,
                const T* nug, const T* M, const T* w, const T* alpha, T beta,
                int same, int q, int n1, int n2, int d, double* partials,
                T* glens, T* gamp, T* gnug, cudaStream_t stream) {
  constexpr int KC = comps_per_block<MAXD>();
  const int gz = (q + KC - 1) / KC;
  if (gz > MAX_GRID_Z) return (int)cudaErrorInvalidValue;
  const Grid g = partial_grid(n1, n2);
  matern32_vjp_partials_kernel<T, MAXD, KC>
      <<<dim3(g.gx, g.gy, gz), dim3(BX, BY), 0, stream>>>(
          x1, x2, inv_l, M, w, alpha, beta, same, q, n1, n2, d, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  matern32_vjp_finish_kernel<T><<<q, NT, 0, stream>>>(
      partials, g.blocks(), inv_l, amp, nug, same, d, glens, gamp, gnug);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x1, const void* x2, const void* inv_l, const void* amp,
           const void* nug, const void* M, const void* w, const void* alpha,
           double beta, int same, int q, int n1, int n2, int d,
           void* partials, void* glens, void* gamp, void* gnug,
           void* stream) {
  if (q <= 0 || n1 <= 0 || n2 <= 0 || d <= 0 || d > 32 ||
      (w && n1 != n2)) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto maxd_tag) {
    constexpr int MD = decltype(maxd_tag)::value;
    return launch_maxd<T, MD>(
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

extern "C" {

// Number of f64 scratch entries the caller allocates for the partial sums.
long long lcgp_matern32_gram_vjp_scratch(int q, int n1, int n2, int d) {
  return (long long)q * (d + 2) * partial_grid(n1, n2).blocks();
}

int lcgp_matern32_gram_vjp_f64(const void* x1, const void* x2,
                               const void* inv_l, const void* amp,
                               const void* nug, const void* M, const void* w,
                               const void* alpha, double beta, int same,
                               int q, int n1, int n2, int d, void* partials,
                               void* glens, void* gamp, void* gnug,
                               void* stream) {
  return launch<double>(x1, x2, inv_l, amp, nug, M, w, alpha, beta, same, q,
                        n1, n2, d, partials, glens, gamp, gnug, stream);
}

int lcgp_matern32_gram_vjp_f32(const void* x1, const void* x2,
                               const void* inv_l, const void* amp,
                               const void* nug, const void* M, const void* w,
                               const void* alpha, double beta, int same,
                               int q, int n1, int n2, int d, void* partials,
                               void* glens, void* gamp, void* gnug,
                               void* stream) {
  return launch<float>(x1, x2, inv_l, amp, nug, M, w, alpha, beta, same, q,
                       n1, n2, d, partials, glens, gamp, gnug, stream);
}

}  // extern "C"

// K5: the Gram-stack VJP with respect to the points of x2, for the three
// kernel families, gram_vjp_x_kernel.cuh instantiated on lcgp::Matern32,
// lcgp::Matern52 and lcgp::SE, f64 and f32.
//
// No TPU kernel: replaces the part of jax.grad through lcgp_tpu's jnp Gram
// (lcgp_tpu/ops/matern.py:27, matern52.py:27, rbf.py:22) that
// LCGP.refine_inducing (lcgp_tpu/models/lcgp.py:930-987) takes with respect
// to the inducing points of lcgp_tpu/models/sparse.py.  What bounds it on
// the card: the read of M; see gram_vjp_x_kernel.cuh.

#include "gram_vjp_x_kernel.cuh"

#define LCGP_VJP_X_ENTRY(family, policy, suffix, T)                          \
  int lcgp_##family##_gram_vjp_x_##suffix(                                   \
      const void* x1, const void* x2, const void* inv_l, const void* amp,    \
      const void* nug, const void* M, int q, int n1, int n2, int d,          \
      void* partials, void* gx, void* stream) {                              \
    return k5::launch<lcgp::policy, T>(x1, x2, inv_l, amp, nug, M, q, n1,    \
                                       n2, d, partials, gx, stream);         \
  }

extern "C" {

// Number of f64 scratch entries the caller allocates for the partial sums:
// one per output (n2 * d) and block of its column of blocks, for every
// family and dtype.
long long lcgp_gram_vjp_x_scratch(int n1, int n2, int d) {
  return (long long)k5::row_blocks<double>(n1, n2, d) * n2 * d;
}

LCGP_VJP_X_ENTRY(matern32, Matern32, f64, double)
LCGP_VJP_X_ENTRY(matern32, Matern32, f32, float)
LCGP_VJP_X_ENTRY(matern52, Matern52, f64, double)
LCGP_VJP_X_ENTRY(matern52, Matern52, f32, float)
LCGP_VJP_X_ENTRY(rbf, SE, f64, double)
LCGP_VJP_X_ENTRY(rbf, SE, f32, float)

}  // extern "C"

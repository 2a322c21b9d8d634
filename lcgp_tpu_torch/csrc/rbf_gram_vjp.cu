// K4's VJP: the squared-exponential Gram-stack VJP for Hopper (sm_90a),
// matern52_gram_vjp_kernel.cuh (K3's VJP template) instantiated on
// lcgp::SE, finished by gram_vjp_kernel.cuh's gram_vjp_finish_kernel.
//
// No TPU kernel: replaces the jnp lcgp_tpu/ops/rbf.py::rbf_gram_vjp
// (:57-104) and the cotangent assembly of
// lcgp_tpu/models/likelihood.py::_full_terms_fwd_impl for kernel='rbf'.
//
//   G2+t[k] = sum cbar * C0 * S_t^2
//
// There is no factor, so there are no prefix or suffix products: each
// entry takes four operations a dimension on the raw differences, and its
// decay on the template's lean loop comes from exp_lean (see
// matern52_gram_vjp_kernel.cuh).  What bounds it on the card: reading M
// (2.7 GB, 0.80 ms at 3.35 TB/s for (20, 4096, 4096) f64), above the
// arithmetic (4d + 15 f64 instructions per entry, 0.46 ms over one
// triangle at d = 8).  So M comes by tensor copies that lane 0 of warp 0
// issues, into a ring behind mbarriers, and the threads spend their issue
// slots on the arithmetic.  The launches use the scratch size of
// lcgp_matern32_gram_vjp_scratch.

#include "matern52_gram_vjp_kernel.cuh"

extern "C" {

int lcgp_rbf_gram_vjp_f64(const void* x1, const void* x2, const void* inv_l,
                          const void* amp, const void* nug, const void* M,
                          const void* w, const void* alpha, double beta,
                          int same, int q, int n1, int n2, int d,
                          void* partials, void* glens, void* gamp, void* gnug,
                          void* stream) {
  return k3v::vjp_launch<lcgp::SE, double>(x1, x2, inv_l, amp, nug, M, w,
                                           alpha, beta, same, q, n1, n2, d,
                                           partials, glens, gamp, gnug,
                                           stream);
}

int lcgp_rbf_gram_vjp_f32(const void* x1, const void* x2, const void* inv_l,
                          const void* amp, const void* nug, const void* M,
                          const void* w, const void* alpha, double beta,
                          int same, int q, int n1, int n2, int d,
                          void* partials, void* glens, void* gamp, void* gnug,
                          void* stream) {
  return k3v::vjp_launch<lcgp::SE, float>(x1, x2, inv_l, amp, nug, M, w,
                                          alpha, beta, same, q, n1, n2, d,
                                          partials, glens, gamp, gnug,
                                          stream);
}

}  // extern "C"

// K3's VJP: the Matern 5/2 Gram-stack VJP for Hopper (sm_90a),
// matern52_gram_vjp_kernel.cuh instantiated on lcgp::Matern52, finished by
// gram_vjp_kernel.cuh's gram_vjp_finish_kernel.
//
// No TPU kernel: replaces the jnp lcgp_tpu/ops/matern52.py::matern52_gram_vjp
// (:63-123) and the cotangent assembly of
// lcgp_tpu/models/likelihood.py::_full_terms_fwd_impl for kernel='matern52'.
//
//   G2+t[k] = sum cbar * C0 * 5/3 S_t^2 (1 + sqrt5 S_t) / (1 + sqrt5 S_t + 5/3 S_t^2)
//           = 5/3 sum [cbar e prod_{u>t} f_u] prod_{u<t} f_u S_t^2 (1 + sqrt5 S_t)
//
// with no division.  What bounds it on the card: f64 arithmetic (the
// function's 12d + 20 instructions an entry: 1.15 ms over one triangle of
// (20, 4096, 4096) at d = 8, against 0.80 ms to read M).  Its own template:
// lane 0 of warp 0 loads M with tensor copies into a ring behind mbarriers,
// so the threads spend their issue slots on the f64 work, and each factor
// is computed once (see matern52_gram_vjp_kernel.cuh).  The launches use
// the scratch size of lcgp_matern32_gram_vjp_scratch.

#include "matern52_gram_vjp_kernel.cuh"

extern "C" {

int lcgp_matern52_gram_vjp_f64(const void* x1, const void* x2,
                               const void* inv_l, const void* amp,
                               const void* nug, const void* M, const void* w,
                               const void* alpha, double beta, int same,
                               int q, int n1, int n2, int d, void* partials,
                               void* glens, void* gamp, void* gnug,
                               void* stream) {
  return k3v::vjp_launch<lcgp::Matern52, double>(
      x1, x2, inv_l, amp, nug, M, w, alpha, beta, same, q, n1, n2, d,
      partials, glens, gamp, gnug, stream);
}

int lcgp_matern52_gram_vjp_f32(const void* x1, const void* x2,
                               const void* inv_l, const void* amp,
                               const void* nug, const void* M, const void* w,
                               const void* alpha, double beta, int same,
                               int q, int n1, int n2, int d, void* partials,
                               void* glens, void* gamp, void* gnug,
                               void* stream) {
  return k3v::vjp_launch<lcgp::Matern52, float>(
      x1, x2, inv_l, amp, nug, M, w, alpha, beta, same, q, n1, n2, d,
      partials, glens, gamp, gnug, stream);
}

}  // extern "C"

// K1: the batched Matern 3/2 Gram stack / factorization target for Hopper
// (sm_90a), gram_kernel.cuh instantiated on lcgp::Matern32.
//
// Replaces the TPU kernel lcgp_tpu/ops/matern_pallas.py::_fwd_call (deleted
// in commit b21a99c; its pallas_call and _fwd_kernel body are the spec) and
// its live jnp successors lcgp_tpu/ops/matern.py::matern32_gram and
// lcgp_tpu/ops/gram.py::gram_factor_target.
//
//   C0[k,i,j] = prod_t (1 + S_t) * exp(-sum_t S_t),  S_t = |x1[i,t] - x2[j,t]| * inv_l[k,t]
//
// What bounds it on the card: the writes (3d + 18 f64 instructions per entry
// against 8 bytes written; see gram_kernel.cuh for the design).

#include "gram_kernel.cuh"

extern "C" {

int lcgp_matern32_gram_f64(const void* x1, const void* x2, const void* inv_l,
                           const void* amp, const void* nug,
                           const void* row_scale, const void* diag_vec,
                           int same, int q, int n1, int n2, int d, void* out,
                           void* c0_out, void* stream) {
  return gram_launch<lcgp::Matern32, double>(x1, x2, inv_l, amp, nug,
                                             row_scale, diag_vec, same, q, n1,
                                             n2, d, out, c0_out, stream);
}

int lcgp_matern32_gram_f32(const void* x1, const void* x2, const void* inv_l,
                           const void* amp, const void* nug,
                           const void* row_scale, const void* diag_vec,
                           int same, int q, int n1, int n2, int d, void* out,
                           void* c0_out, void* stream) {
  return gram_launch<lcgp::Matern32, float>(x1, x2, inv_l, amp, nug,
                                            row_scale, diag_vec, same, q, n1,
                                            n2, d, out, c0_out, stream);
}

}  // extern "C"

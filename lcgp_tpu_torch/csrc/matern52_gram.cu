// K3: the batched Matern 5/2 Gram stack / factorization target for Hopper
// (sm_90a), gram_kernel.cuh instantiated on lcgp::Matern52.
//
// No TPU kernel: replaces the jnp lcgp_tpu/ops/matern52.py::matern52_gram
// (:27-60) and its factor-target epilogue in lcgp_tpu/ops/gram.py:74-96.
//
//   C0[k,i,j] = prod_t (1 + sqrt5 S_t + 5/3 S_t^2) * exp(-sqrt5 sum_t S_t),
//   S_t = |x1[i,t] - x2[j,t]| * inv_l[k,t]
//
// What bounds it on the card: the writes, as for K1 (5d + 20 f64
// instructions per entry against 8 bytes written: at q = 20, n = 4096 and
// d = 8 one triangle of the arithmetic is 0.59 ms at the f64 peak, the
// square stack 0.80 ms at 3.35 TB/s).

#include "gram_kernel.cuh"

extern "C" {

int lcgp_matern52_gram_f64(const void* x1, const void* x2, const void* inv_l,
                           const void* amp, const void* nug,
                           const void* row_scale, const void* diag_vec,
                           int same, int q, int n1, int n2, int d, void* out,
                           void* c0_out, void* stream) {
  return gram_launch<lcgp::Matern52, double>(x1, x2, inv_l, amp, nug,
                                             row_scale, diag_vec, same, q, n1,
                                             n2, d, out, c0_out, stream);
}

int lcgp_matern52_gram_f32(const void* x1, const void* x2, const void* inv_l,
                           const void* amp, const void* nug,
                           const void* row_scale, const void* diag_vec,
                           int same, int q, int n1, int n2, int d, void* out,
                           void* c0_out, void* stream) {
  return gram_launch<lcgp::Matern52, float>(x1, x2, inv_l, amp, nug,
                                            row_scale, diag_vec, same, q, n1,
                                            n2, d, out, c0_out, stream);
}

}  // extern "C"

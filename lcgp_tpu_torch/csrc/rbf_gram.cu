// K4: the batched squared-exponential Gram stack / factorization target for
// Hopper (sm_90a), gram_kernel.cuh instantiated on lcgp::SE.
//
// No TPU kernel: replaces the jnp lcgp_tpu/ops/rbf.py::rbf_gram (:22-54) and
// its factor-target epilogue in lcgp_tpu/ops/gram.py:74-96.
//
//   C0[k,i,j] = exp(-1/2 sum_t S_t^2),  S_t = |x1[i,t] - x2[j,t]| * inv_l[k,t]
//
// from the subtracted distances, not the JAX package's GEMM form (see
// gram_kernel.cuh): the Gram stays exactly symmetric and C0 is exactly 1 on
// the diagonal.  What bounds it on the card: the writes, as for K1 (2d + 19
// f64 instructions per entry against 8 bytes written).

#include "gram_kernel.cuh"

extern "C" {

int lcgp_rbf_gram_f64(const void* x1, const void* x2, const void* inv_l,
                      const void* amp, const void* nug, const void* row_scale,
                      const void* diag_vec, int same, int q, int n1, int n2,
                      int d, void* out, void* c0_out, void* stream) {
  return gram_launch<lcgp::SE, double>(x1, x2, inv_l, amp, nug, row_scale,
                                       diag_vec, same, q, n1, n2, d, out,
                                       c0_out, stream);
}

int lcgp_rbf_gram_f32(const void* x1, const void* x2, const void* inv_l,
                      const void* amp, const void* nug, const void* row_scale,
                      const void* diag_vec, int same, int q, int n1, int n2,
                      int d, void* out, void* c0_out, void* stream) {
  return gram_launch<lcgp::SE, float>(x1, x2, inv_l, amp, nug, row_scale,
                                      diag_vec, same, q, n1, n2, d, out,
                                      c0_out, stream);
}

}  // extern "C"

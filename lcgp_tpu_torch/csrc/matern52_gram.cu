// K3: the batched Matern 5/2 Gram stack / factorization target for Hopper
// (sm_90a), matern52_gram_kernel.cuh instantiated on lcgp::Matern52.
//
// No TPU kernel: replaces the jnp lcgp_tpu/ops/matern52.py::matern52_gram
// (:27-60) and its factor-target epilogue in lcgp_tpu/ops/gram.py:74-96.
//
//   C0[k,i,j] = prod_t (1 + sqrt5 S_t + 5/3 S_t^2) * exp(-sqrt5 sum_t S_t),
//   S_t = |x1[i,t] - x2[j,t]| * inv_l[k,t]
//
// What bounds it on the card: the writes (2.7 GB, 0.80 ms at 3.35 TB/s, at
// q = 20, n = 4096), with one triangle of the f64 arithmetic (5d + 20
// instructions an entry, 0.59 ms at d = 8) just under them.  Its own
// template, not gram_kernel.cuh's: streamed factors for three blocks an SM
// and the stores staged in shared memory and written by bulk copies, so
// that the writes overlap the arithmetic (see matern52_gram_kernel.cuh).

#include "matern52_gram_kernel.cuh"

extern "C" {

int lcgp_matern52_gram_f64(const void* x1, const void* x2, const void* inv_l,
                           const void* amp, const void* nug,
                           const void* row_scale, const void* diag_vec,
                           int same, int q, int n1, int n2, int d, void* out,
                           void* c0_out, void* stream) {
  return k3::gram_launch<lcgp::Matern52, double>(x1, x2, inv_l, amp, nug,
                                                 row_scale, diag_vec, same, q,
                                                 n1, n2, d, out, c0_out,
                                                 stream);
}

int lcgp_matern52_gram_f32(const void* x1, const void* x2, const void* inv_l,
                           const void* amp, const void* nug,
                           const void* row_scale, const void* diag_vec,
                           int same, int q, int n1, int n2, int d, void* out,
                           void* c0_out, void* stream) {
  return k3::gram_launch<lcgp::Matern52, float>(x1, x2, inv_l, amp, nug,
                                                row_scale, diag_vec, same, q,
                                                n1, n2, d, out, c0_out,
                                                stream);
}

}  // extern "C"

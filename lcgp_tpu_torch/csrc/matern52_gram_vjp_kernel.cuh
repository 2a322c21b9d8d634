// The Gram-stack VJP of K3 (Matern 5/2) and K4 (squared exponential),
// designed for Hopper (sm_90a): one template on two policies of
// gram_common.cuh, instantiated by matern52_gram_vjp.cu (lcgp::Matern52)
// and rbf_gram_vjp.cu (lcgp::SE).  (K2, Matern 3/2, keeps the older
// template of gram_vjp_kernel.cuh.)  It reduces what that template
// reduces, for the same cotangent
//
//   cbar[k,i,j] = alpha_k * M[k,i,j] + beta * w[k,i] * w[k,j]
//
// into the same (d + 2) sums per component and tile, written to the same
// partials and finished by the same gram_vjp_finish_kernel: G0 = sum cbar
// C0, G1 = sum_i cbar[k,i,i] and G2+t = sum cbar C0 dlnC0/dlnS_t.  Matern
// 5/2 forms C0 with the forward's operations in the forward's order
// (gram_common.cuh), so it is the forward's bit for bit; SE forms it with
// fewer operations (below), within a few ulp of the forward's.
//
// What bounds it on the card, over one triangle of (20, 4096, 4096) at
// d = 8.  Matern 5/2 needs 12d + 20 f64 instructions an entry, 1.15 ms at
// 17e12/s, against 0.80 ms to read M once: the f64 pipe.  SE needs 4d + 15
// in the lean loop below, 0.46 ms: the read of M, which the loads must
// overlap without taking the threads' issue slots.  The older template
// reached 33-36% of these bounds; its SASS and ptxas show why:
//
// - a block barrier for every four entries a thread sums (a 16-row stage),
//   and twelve element-wise cp.async copies a thread and stage, each with
//   its address arithmetic and bounds test, in the issue slots of the f64
//   work;
// - a branch on t < d around every factor of every entry, and the suffix
//   recomputing each factor (14d + 20 f64 instructions, not 12d + 20);
// - 124 registers for two interleaved entries, two blocks an SM;
// - in f32, every term converted to f64 and added there (d + 2 F2F and f64
//   adds an entry, on the slow f64 pipe);
// - the underflow guard's `continue`, on which a warp diverges.
//
// The design:
//
// - Tensor-copy loads behind mbarriers.  Lane 0 of warp 0 loads each stage
//   (the 32 x 64 strip of M and the 64 x 32 strip of the transposed tile)
//   into a ring of shared-memory slots with Hopper's tensor copies
//   (cp.async.bulk.tensor: one for the strip, one per 128 bytes of the
//   transposed strip's rows), two stages ahead, and lanes 1-31 the small
//   operands (the strips of w, the component's 1/l row, alpha) with
//   cp.async.  Each slot has a `full` mbarrier (the copies' bytes and those
//   lanes' arrivals) and an `empty` one (one arrival per warp).  No block
//   barrier is taken after the start, and no thread issues a load of M.
//   (A separate producer warp would make blocks of 288 threads, for which
//   ptxas allows 96 registers at two blocks an SM, and the factors spill;
//   256 threads get 128.)  SE hands the loads of stage s to warp s mod 8,
//   and the finish of component c (below) to warp c mod 8: one warp that
//   did all of them lagged the others by its extra work, and the ring's
//   empty barriers held the whole block to its pace.
// - The transposed strip is loaded with the 128-byte swizzle, so that the
//   lanes of a warp, which read one row's column each, spread over eight
//   16-byte chunks of the banks: a 4-way conflict, not the 32-way one of a
//   dense layout.
// - Longer stages: 32 rows, eight entries a thread between two arrivals.
// - The factors once: the forward sweep keeps, per dimension, the policy's
//   lens_step: Matern 5/2's factor g_t = f_t - 1 and Q_t = (prod_{u<t}
//   f_u) S_t^2 (1 + sqrt5 S_t), so that the suffix sweep is two fmas a
//   dimension (the term into its sum, the factor into the suffix): 12d + 26
//   f64 instructions an entry (122 at d = 8 in the SASS), the function's
//   12d + 20 and the exp's range handling.  No branch on t < d: past d, x
//   and 1/l are 0 in shared memory, so those dimensions change nothing
//   (S_t = 0: a factor of exactly 1, terms of exactly 0); a MAXD 2
//   instantiation keeps FITC's d = 2 from paying for four.
// - SE in four operations a dimension.  SE has no factor, and its decay's
//   argument is sum_t nh_t D_t^2 with D_t = x1_t - x2_t the raw difference
//   and nh_t = -1/2 (1/l_t)^2, formed once a stage: a subtraction, the
//   square, an fma into the argument and, after the decay, an fma of
//   (cbar e) D_t^2 into the dimension's sum, scaled by 1/l_t^2 once a
//   component (reduce).  The forward's route, S_t = |D_t| / l_t, then
//   S_t^2 into the sum and again into the term, takes five.  x1's rows are
//   packed (stride MAXD) and read with 16-byte loads; x2's column of the
//   thread is held in registers for the whole block.
// - SE's exp on the lean loop: exp_lean, a table of 2^(i/64) in shared
//   memory and a degree-5 polynomial, ten f64 operations and four
//   non-immediate constants where exp(double) takes fifteen and eleven
//   (each re-materialised with two moves an entry), within 3 ulp; the
//   general loop keeps exp(double).
// - f32 sums per stage: in the f32 instantiations the eight terms of a
//   stage are summed in f32 (8 eps_32 of their magnitude at most, far under
//   the 1e-5 bound) and added to the f64 accumulators once a stage.  Two
//   entries interleave in f32, and in SE's f64 up to MAXD 4; f64 keeps one
//   otherwise (two entries' factors, or two rows of SE's S_t^2 at MAXD 8,
//   spill at 128 registers).
// - The underflow guard (C0 == 0: a prefix product may have overflowed in
//   f32) selects the old sum instead of skipping the entry: no divergence.
//   SE has no product to overflow; at tiny lengthscales its decay
//   underflows to 0 and every term is 0 times a finite D_t^2.
// - SE's lean loop.  SE's VJP is bound by issue slots as much as by its
//   f64 pipe, and a third of its instructions an entry were the general
//   loop's per-entry bounds, pairing and diagonal tests and the swizzled
//   offset's signed arithmetic.  On a whole off-diagonal tile of a
//   same-point Gram (all but the n/64 diagonal and the edge tiles) every
//   entry is an active pair, so SE sums it in a loop without those tests,
//   with its shared-memory addresses stepped from row to row (the swizzled
//   one by a per-thread base and a two-operation step) and with exp_lean.
//   Matern 5/2 keeps the one loop.
// - The reduction per component: each warp shuffles its sums and writes
//   them to one of four shared buffers; one warp (warp 0; SE's rotates),
//   two components later, sums the eight warps' values in a fixed order
//   into the partials.  SE's warps sum their values with
//   warp_sum_scatter, a third of the shuffles.  The same inputs give the
//   same bits, with no atomics.
// - Shapes the tensor copy cannot take (n2 * sizeof(T) not a multiple of
//   16, M not 16-byte aligned) go to a second kernel on the same body,
//   gram_vjp_copy_kernel, whose threads all load with element-wise
//   cp.async into the same swizzled layout, completing on the same
//   mbarriers; it runs one block an SM, so that its address arithmetic
//   has registers without spilling.  A tensor map that does not encode
//   fails the launch.
//
// The launcher encodes the tensor maps on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint: no link against the driver
// library), launches on the caller's stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() after the launches.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "gram_common.cuh"
#include "gram_vjp_kernel.cuh"
#include "tensor_map.cuh"


namespace {
namespace k3v {

constexpr int TT = 64;                 // tile side
constexpr int SR = 32;                 // rows of a stage's strip
constexpr int NSTRIP = TT / SR;        // stages per component and tile
constexpr int BX = 64;                 // threads along j
constexpr int BY = 4;                  // threads along i
constexpr int NTH = BX * BY;
constexpr int NW = NTH / 32;           // warps
constexpr int NRED = 4;                // buffers of per-warp sums

// ring slots: three at MAXD <= 8, two above (shared memory)
template <int MAXD>
__host__ __device__ constexpr int nslot() {
  return MAXD <= 8 ? 3 : 2;
}

// One slot: the strips in bytes from its 1024-aligned start, and the small
// operands in bytes from the slot's part of a separate array.
template <typename T, int MAXD>
struct Slot {
  static constexpr int SZ = (int)sizeof(T);
  static constexpr int BW = 128 / SZ;         // columns a swizzled box spans
  static constexpr int NB = SR / BW;          // boxes of the transposed strip
  static constexpr int B = 0;                 // [NB][TT rows][128 B] swizzled
  static constexpr int A = B + TT * SR * SZ;  // [SR][TT]  M[k, r0+r, j0+c]
  static constexpr int SIZE = A + SR * TT * SZ;  // a multiple of 1024
  static constexpr int WI = 0;                 // [SR]  w[k, r0+r]
  static constexpr int WJ = WI + SR * SZ;      // [TT]  w[k, j0+c]
  static constexpr int INV = WJ + TT * SZ;     // [MAXD]  1/l row of k
  static constexpr int ALPHA = INV + MAXD * SZ;  // alpha_k
  static constexpr int SMALL = (ALPHA + SZ + 15) / 16 * 16;
};

// The block's shared memory, in bytes from the 1024-aligned ring: every
// part at a constant offset, so that one base register addresses them all.
template <typename T, int MAXD>
struct Layout {
  using S = Slot<T, MAXD>;
  static constexpr int NS = nslot<MAXD>();
  static constexpr int NV = MAXD + 2;
  static constexpr int SMALL = NS * S::SIZE;          // [NS][S::SMALL]
  static constexpr int RED = SMALL + NS * S::SMALL;   // [NRED][NW][NV] f64
  static constexpr int XI = RED + NRED * NW * NV * 8;  // [TT][MAXD+1]  x1
  static constexpr int XJ = XI + TT * (MAXD + 1) * S::SZ;  // [MAXD][TT]  x2
  static constexpr int BARS = (XJ + MAXD * TT * S::SZ + 7) / 8 * 8;
  // mbarriers: full[NS], empty[NS], red[NRED]
  static constexpr int BYTES = BARS + (2 * NS + NRED) * 8;
};

template <typename T, int MAXD>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (size_t)Layout<T, MAXD>::BYTES;   // with alignment slack
}

// Byte offset of element (row c, column r) of the transposed strip, in
// the tensor copy's 128-byte swizzle.
template <typename T, int MAXD>
__device__ __forceinline__ int b_offset(int c, int r) {
  return Slot<T, MAXD>::B + tmap::swizzled(c, r, TT, (int)sizeof(T));
}

// 2^(i/64), i = 0..63, each correctly rounded.
__constant__ double kExp2Tab[64] = {
    0x1.0000000000000p+0, 0x1.02c9a3e778061p+0, 0x1.059b0d3158574p+0,
    0x1.0874518759bc8p+0, 0x1.0b5586cf9890fp+0, 0x1.0e3ec32d3d1a2p+0,
    0x1.11301d0125b51p+0, 0x1.1429aaea92de0p+0, 0x1.172b83c7d517bp+0,
    0x1.1a35beb6fcb75p+0, 0x1.1d4873168b9aap+0, 0x1.2063b88628cd6p+0,
    0x1.2387a6e756238p+0, 0x1.26b4565e27cddp+0, 0x1.29e9df51fdee1p+0,
    0x1.2d285a6e4030bp+0, 0x1.306fe0a31b715p+0, 0x1.33c08b26416ffp+0,
    0x1.371a7373aa9cbp+0, 0x1.3a7db34e59ff7p+0, 0x1.3dea64c123422p+0,
    0x1.4160a21f72e2ap+0, 0x1.44e086061892dp+0, 0x1.486a2b5c13cd0p+0,
    0x1.4bfdad5362a27p+0, 0x1.4f9b2769d2ca7p+0, 0x1.5342b569d4f82p+0,
    0x1.56f4736b527dap+0, 0x1.5ab07dd485429p+0, 0x1.5e76f15ad2148p+0,
    0x1.6247eb03a5585p+0, 0x1.6623882552225p+0, 0x1.6a09e667f3bcdp+0,
    0x1.6dfb23c651a2fp+0, 0x1.71f75e8ec5f74p+0, 0x1.75feb564267c9p+0,
    0x1.7a11473eb0187p+0, 0x1.7e2f336cf4e62p+0, 0x1.82589994cce13p+0,
    0x1.868d99b4492edp+0, 0x1.8ace5422aa0dbp+0, 0x1.8f1ae99157736p+0,
    0x1.93737b0cdc5e5p+0, 0x1.97d829fde4e50p+0, 0x1.9c49182a3f090p+0,
    0x1.a0c667b5de565p+0, 0x1.a5503b23e255dp+0, 0x1.a9e6b5579fdbfp+0,
    0x1.ae89f995ad3adp+0, 0x1.b33a2b84f15fbp+0, 0x1.b7f76f2fb5e47p+0,
    0x1.bcc1e904bc1d2p+0, 0x1.c199bdd85529cp+0, 0x1.c67f12e57d14bp+0,
    0x1.cb720dcef9069p+0, 0x1.d072d4a07897cp+0, 0x1.d5818dcfba487p+0,
    0x1.da9e603db3285p+0, 0x1.dfc97337b9b5fp+0, 0x1.e502ee78b3ff6p+0,
    0x1.ea4afa2a490dap+0, 0x1.efa1bee615a27p+0, 0x1.f50765b6e4540p+0,
    0x1.fa7c1819e90d8p+0};

// exp(a) for a <= 0 (or a NaN), within 3 ulp: k = round(64 a / ln 2),
// r = a - k ln2/64 (|r| <= 0.0057) in two steps, exp(r) by its Taylor
// polynomial of degree 5 (remainder r^6/720 < 6e-17), times 2^((k mod
// 64)/64) from the table `tab` in shared memory and 2^floor(k/64) in the
// exponent.  Ten f64 operations, half of exp(double)'s, and four constants
// that are not immediates; below -708.4 the scaling takes two steps, so
// that a subnormal result is rounded once, and below -745.2 it is 0.
__device__ __forceinline__ double exp_lean(double a, const double* tab) {
  constexpr double kMagic = 6.75539944105574400e+15;
  constexpr double kInvLn2x64 = 0x1.71547p+6;          // 64/ln2, 21 bits
  constexpr double kLn2d64Hi = 0x1.62e42p-7;           // ln2/64, 21 bits
  constexpr double kLn2d64Lo = 0x1.fdf473de6af28p-28;  // ln2/64 - Hi
  const double t = __fma_rn(a, kInvLn2x64, kMagic);
  const int k = __double2loint(t);
  const double jt = __dadd_rn(t, -kMagic);
  double r = __fma_rn(jt, -kLn2d64Hi, a);
  r = __fma_rn(jt, -kLn2d64Lo, r);
  double p = __fma_rn(r, 1.0 / 120.0, 1.0 / 24.0);
  p = __fma_rn(r, p, 1.0 / 6.0);
  p = __fma_rn(r, p, 0.5);
  p = __fma_rn(r, p, 1.0);
  p = __fma_rn(r, p, 1.0);
  const double e = __dmul_rn(p, tab[k & 63]);
  const int n = k >> 6;
  // a >= -708: the hi word of a <= 0 grows with |a| (NaN above all)
  if ((unsigned)__double2hiint(a) <= 0xc0862000u) {
    return __hiloint2double(__double2hiint(e) + n * 0x100000,
                            __double2loint(e));
  }
  if (!(a >= -745.2)) return a != a ? a : 0.0;
  const int n1 = n / 2;
  return __dmul_rn(
      __dmul_rn(e, __hiloint2double((n1 + 1023) * 0x100000, 0)),
      __hiloint2double((n - n1 + 1023) * 0x100000, 0));
}

// One step of warp_sum_scatter: a lane holding v[0, 2 HALF) keeps the half
// its lane bit O selects and swaps the other with lane ^ O.
template <int HALF, int O, int NP>
__device__ __forceinline__ void scatter_step(double (&v)[NP], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const double send = up ? v[i] : v[i + HALF];
    const double keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (HALF > 1) scatter_step<HALF / 2, O / 2>(v, lane);
}

// Each of NV <= 32 values summed over the warp's 32 lanes, scattered: in
// each of the first log2 NP steps (NP: NV rounded up to a power of two) a
// lane keeps half of the values it holds and swaps the other half with its
// partner, one shuffle a pair, and the last steps sum the one value left.
// NP - 1 + 5 - log2 NP shuffles instead of 5 NV, in warp_sum's pairs and
// order (the same bits: each sum only swaps its operands).  Lane L
// ends with the total of value (L >> (5 - log2 NP)) & (NP - 1); `idx` is
// that index in the first lane of each group holding it, -1 elsewhere.
template <int NV>
__device__ __forceinline__ double warp_sum_scatter(const double (&acc)[NV],
                                                   int lane, int& idx) {
  constexpr int NP = NV <= 2 ? 2 : NV <= 4 ? 4 : NV <= 8 ? 8 : NV <= 16 ? 16
                                                                    : 32;
  constexpr int LOG = NP == 2 ? 1 : NP == 4 ? 2 : NP == 8 ? 3 : NP == 16 ? 4
                                                                   : 5;
  static_assert(NV <= 32, "one value a lane at most");
  double v[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) v[i] = i < NV ? acc[i] : 0.0;
  scatter_step<NP / 2, 16>(v, lane);
#pragma unroll
  for (int o = 16 >> LOG; o >= 1; o >>= 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  }
  idx = (lane & ((32 >> LOG) - 1)) ? -1 : (lane >> (5 - LOG)) & (NP - 1);
  return v[0];
}

// The stage's sums: the f64 accumulators themselves in f64, the f32 ones
// of the stage in f32.
template <typename T, int NV>
__device__ __forceinline__ T (&pick_sums(double (&acc)[NV], T (&sacc)[NV]))[NV] {
  if constexpr (std::is_same<T, double>::value) {
    return acc;
  } else {
    return sacc;
  }
}

// A row of N values of T from shared memory, in 16-byte loads where the row
// is a multiple of 16 bytes (its start is 16-byte aligned).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, T (&out)[N]) {
  if constexpr (N * sizeof(T) % 16 == 0) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int v = 0; v < N / PER; ++v) {
      if constexpr (std::is_same<T, double>::value) {
        const double2 u = reinterpret_cast<const double2*>(p)[v];
        out[2 * v] = u.x;
        out[2 * v + 1] = u.y;
      } else {
        const float4 u = reinterpret_cast<const float4*>(p)[v];
        out[4 * v] = u.x;
        out[4 * v + 1] = u.y;
        out[4 * v + 2] = u.z;
        out[4 * v + 3] = u.w;
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) out[t] = p[t];
  }
}

// The lean loop's offset of row ty + BY m, column tx of the transposed
// strip, b_offset's value in two parts: lean_b_base (per thread) plus
// lean_b_step (per row).  With BY = 4 rows apart, the 128-byte swizzle's
// chunk of row ty + 4m is (ty / 2 + 2m) mod 8 in f64 and m in f32.
static_assert(BY == 4 && SR == 32 && TT == 64, "lean_b_* assume this shape");
template <typename T, int MAXD>
__device__ __forceinline__ unsigned lean_b_base(unsigned tx, unsigned ty) {
  if constexpr (sizeof(T) == 8) {
    return Slot<T, MAXD>::B + tx * 128 + ((((ty >> 1) ^ tx) & 1) << 4) +
           (ty & 1) * 8;
  } else {
    return Slot<T, MAXD>::B + tx * 128 + ty * 4;
  }
}
template <typename T>
__device__ __forceinline__ unsigned lean_b_step(unsigned tx, unsigned m) {
  if constexpr (sizeof(T) == 8) {
    return ((m >> 2) << 13) + ((((m & 3) ^ (tx >> 1)) & 3) << 5);
  } else {
    return ((m ^ tx) & 7) << 4;
  }
}

// The kernel's body.  TMA: M by tensor copies (lane 0 of warp 0), else by
// every thread's element-wise cp.async; two kernels, so that the copies'
// address arithmetic does not take registers from the tensor-copy path.
template <bool TMA, typename T, int MAXD, typename P>
__device__ __forceinline__ void vjp_body(
    const CUtensorMap& map_a, const CUtensorMap& map_b,
    const T* __restrict__ x1, const T* __restrict__ x2,
    const T* __restrict__ inv_l, const T* __restrict__ M,
    const T* __restrict__ w, const T* __restrict__ alpha, T beta, int same,
    int q, int n1, int n2, int d, double* __restrict__ partials) {
  using S = Slot<T, MAXD>;
  constexpr int NS = nslot<MAXD>();
  constexpr int NV = MAXD + 2;
  extern __shared__ unsigned char smem_raw[];
  using L = Layout<T, MAXD>;
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* small = ring + L::SMALL;
  double* s_red = reinterpret_cast<double*>(ring + L::RED);
  T* s_xi = reinterpret_cast<T*>(ring + L::XI);
  T* s_xj = reinterpret_cast<T*>(ring + L::XJ);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::BARS);
  uint64_t* empty = full + NS;
  uint64_t* red = full + 2 * NS;

  // x1's row stride in shared memory: SE reads a row with 16-byte loads
  constexpr int XS = P::kFactor ? MAXD + 1 : MAXD;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int ti, tj;
  lcgp::tile_of(blockIdx.x, same, (n2 + TT - 1) / TT, ti, tj);
  const int i0 = ti * TT, j0 = tj * TT;
  const long long plane = (long long)n1 * n2;
  const int nv = d + 2;
  const int nst = q * NSTRIP;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      // tensor copies: warp 0's lanes arrive; element copies: every thread
      mbar_init(&full[s], TMA ? 32 : NTH);
      mbar_init(&empty[s], NW);
    }
    for (int s = 0; s < NRED; ++s) mbar_init(&red[s], NW);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < TT * MAXD; e += NTH) {
    const int r = e / MAXD, t = e % MAXD;
    s_xi[r * XS + t] =
        (t < d && i0 + r < n1) ? x1[(long long)(i0 + r) * d + t] : T(0);
  }
  for (int e = tid; e < MAXD * TT; e += NTH) {
    const int t = e / TT, c = e % TT;
    s_xj[t * TT + c] =
        (t < d && j0 + c < n2) ? x2[(long long)(j0 + c) * d + t] : T(0);
  }
  // SE in f64: the lean loop's exp table, past x1's packed rows
  double* s_tab = reinterpret_cast<double*>(s_xi + TT * MAXD);
  if constexpr (!P::kFactor && std::is_same<T, double>::value) {
    for (int e = tid; e < 64; e += NTH) s_tab[e] = kExp2Tab[e];
  }
  __syncthreads();

  // ---- the loads: one warp with tensor copies, every thread without ----
  // The warp that loads a stage (its lane 0 the tensor copies, lanes 1-31
  // the small operands) and the one that finishes a component's sums: SE
  // rotates both over the warps (stage s: warp s mod NW; component c: c
  // mod NW), since a warp that did them all would lag the others, and
  // through the ring's empty barriers hold every warp to its pace.
  // Matern 5/2 keeps warp 0.
  constexpr bool kRotate = !P::kFactor;
  // the loaders without rotation
  [[maybe_unused]] const bool producer = !TMA || warp == 0;
  const unsigned tx_bytes =
      (unsigned)((SR * TT + (same ? TT * SR : 0)) * S::SZ);
  auto fill = [&](int st) {
    const int k = st / NSTRIP, h = st % NSTRIP;
    const int slot = st % NS;
    if (st >= NS) mbar_wait(&empty[slot], ((st / NS) - 1) & 1);
    unsigned char* buf = ring + slot * S::SIZE;
    unsigned char* sm = small + slot * S::SMALL;
    const int r0 = i0 + h * SR;
    const T* Mk = M + k * plane;
    if constexpr (TMA) {
      if (lane == 0) {
        mbar_arrive_tx(&full[slot], tx_bytes);
        tma_load(buf + S::A, &map_a, j0, r0, k, &full[slot]);
        if (same) {
#pragma unroll
          for (int b = 0; b < S::NB; ++b) {
            tma_load(buf + S::B + b * TT * 128, &map_b, r0 + b * S::BW, j0,
                     k, &full[slot]);
          }
        }
      }
    } else {
      for (int e = tid; e < SR * TT; e += NTH) {
        const int r = e / TT, c = e % TT;
        const bool ok = r0 + r < n1 && j0 + c < n2;
        cp_async(reinterpret_cast<T*>(buf + S::A) + e,
                 ok ? Mk + (long long)(r0 + r) * n2 + (j0 + c) : M, ok);
      }
      if (same) {
        for (int e = tid; e < TT * SR; e += NTH) {
          const int c = e / SR, r = e % SR;
          const bool ok = j0 + c < n1 && r0 + r < n1;
          cp_async(reinterpret_cast<T*>(buf + b_offset<T, MAXD>(c, r)),
                   ok ? Mk + (long long)(j0 + c) * n2 + (r0 + r) : M, ok);
        }
      }
    }
    if (warp == (kRotate ? st % NW : 0) && lane > 0) {
      // w's strips, the 1/l row (zero past d) and alpha, on lanes 1..31
      const int items = (w ? SR + TT : 0) + MAXD + (alpha ? 1 : 0);
      for (int e = lane - 1; e < items; e += 31) {
        T* dst;
        const T* src;
        bool ok = true;
        int e2 = e;
        if (w && e2 < SR + TT) {
          const int g = e2 < SR ? r0 + e2 : j0 + (e2 - SR);
          ok = g < n1;
          dst = reinterpret_cast<T*>(sm + (e2 < SR ? S::WI : S::WJ)) +
                (e2 < SR ? e2 : e2 - SR);
          src = ok ? w + (long long)k * n1 + g : w;
        } else {
          e2 -= w ? SR + TT : 0;
          if (e2 < MAXD) {
            ok = e2 < d;
            dst = reinterpret_cast<T*>(sm + S::INV) + e2;
            src = ok ? inv_l + (long long)k * d + e2 : inv_l;
          } else {
            dst = reinterpret_cast<T*>(sm + S::ALPHA);
            src = alpha + k;
          }
        }
        cp_async(dst, src, ok);
      }
    }
    if (!TMA || lane > 0) mbar_arrive_cp_async(&full[slot]);
  };
  // component c's sums, by warp 0: the warps' values in a fixed order
  auto reduce = [&](int c) {
    mbar_wait(&red[c % NRED], (c / NRED) & 1);
    const double* src = s_red + (c % NRED) * NW * NV;
    for (int v = lane; v < nv; v += 32) {
      double tot = 0.0;
#pragma unroll
      for (int wp = 0; wp < NW; ++wp) tot += src[wp * NV + v];
      if constexpr (!P::kFactor) {
        // SE sums cbar C0 D_t^2: S_t^2 = D_t^2 / l_t^2
        if (v >= 2) {
          const double il = (double)inv_l[(long long)c * d + (v - 2)];
          tot *= il * il;
        }
      }
      partials[((long long)c * nv + v) * gridDim.x + blockIdx.x] = tot;
    }
  };
  if constexpr (kRotate) {
    for (int p = 0; p < NS - 1 && p < nst; ++p) {
      if (!TMA || warp == p % NW) fill(p);
    }
  } else if (producer) {
    for (int p = 0; p < NS - 1 && p < nst; ++p) fill(p);
  }

  // ---- the sums, every warp ----
  const int tx = tid % BX, ty = tid / BX;
  const int j = j0 + tx;
  // SE: this thread's column of x2, the same in every stage
  T xj[MAXD];
  if constexpr (!P::kFactor) {
#pragma unroll
    for (int t = 0; t < MAXD; ++t) xj[t] = s_xj[t * TT + tx];
  }
  // SE on a whole off-diagonal tile of a same-point Gram takes the lean
  // loop: every entry there is an active pair
  const bool lean = !P::kFactor && same && ti > tj && i0 + TT <= n1;
  double acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.0;

  for (int st = 0; st < nst; ++st) {
    const int k = st / NSTRIP, h = st % NSTRIP;
    const int slot = st % NS;
    // a warp finishes component k - 2 (its buffer is reused at k + 2),
    // then the loads run NS - 1 stages ahead
    if constexpr (kRotate) {
      if (warp == k % NW && h == 0 && k >= 2) reduce(k - 2);
      if ((!TMA || warp == (st + NS - 1) % NW) && st + NS - 1 < nst) {
        fill(st + NS - 1);
      }
    } else {
      if (warp == 0 && h == 0 && k >= 2) reduce(k - 2);
      if (producer && st + NS - 1 < nst) fill(st + NS - 1);
    }
    mbar_wait(&full[slot], (st / NS) & 1);
    const unsigned char* buf = ring + slot * S::SIZE;
    const unsigned char* sm = small + slot * S::SMALL;
    const T* sA = reinterpret_cast<const T*>(buf + S::A);
    const T* sWI = reinterpret_cast<const T*>(sm + S::WI);
    const T* sWJ = reinterpret_cast<const T*>(sm + S::WJ);
    const T* sInv = reinterpret_cast<const T*>(sm + S::INV);
    const T a_k = alpha ? *reinterpret_cast<const T*>(sm + S::ALPHA) : T(1);
    const T wj = w ? sWJ[tx] : T(0);
    // f32: the stage's terms are summed in f32, then added in f64
    T sacc[NV] = {};

    if constexpr (!P::kFactor) {
      // SE: nh_t = -1/2 (1/l_t)^2, so that the decay's argument is
      // sum_t nh_t D_t^2 with D_t the raw difference, and each dimension's
      // term (cbar e) D_t^2 (scaled by 1/l_t^2 once, in reduce): four
      // operations a dimension, not five
      T nh[MAXD];
#pragma unroll
      for (int t = 0; t < MAXD; ++t) {
        nh[t] = lcgp::mul_rn(T(-0.5), lcgp::mul_rn(sInv[t], sInv[t]));
      }
      T(&sum)[NV] = pick_sums<T, NV>(acc, sacc);
      // one entry's decay and terms, at cotangent cb, on x1's row xrow;
      // the lean loop's exp is exp_lean (`fast`), the general loop's
      // exp(double)
      auto se_entry = [&](T cb, const T* xrow, auto fast) {
        T xr[MAXD];
        load_row<T, MAXD>(xrow, xr);
        T D2[MAXD];
        T arg = T(0);
#pragma unroll
        for (int t = 0; t < MAXD; ++t) {
          const T dd = lcgp::add_rn(xr[t], -xj[t]);
          D2[t] = lcgp::mul_rn(dd, dd);
          arg = lcgp::fma_rn(D2[t], nh[t], arg);
        }
        T e;
        if constexpr (decltype(fast)::value &&
                      std::is_same<T, double>::value) {
          e = exp_lean(arg, s_tab);
        } else {
          e = lcgp::exp_t(arg);
        }
        const T suf = lcgp::mul_rn(cb, e);
        sum[0] = lcgp::fma_rn(cb, e, sum[0]);
#pragma unroll
        for (int t = 0; t < MAXD; ++t) {
          sum[2 + t] = lcgp::fma_rn(suf, D2[t], sum[2 + t]);
        }
      };
      if (lean) {
        // a whole off-diagonal tile: every entry is an active pair, so no
        // per-entry tests
        const T wjb = w ? lcgp::mul_rn(lcgp::mul_rn(T(2), beta), wj) : T(0);
        const T* pA = sA + ty * TT + tx;
        const T* pWI = sWI + ty;
        const T* pX = s_xi + (h * SR + ty) * XS;
        const unsigned char* pB = buf + lean_b_base<T, MAXD>(tx, ty);
#pragma unroll (sizeof(T) == 4 || MAXD <= 4 ? 2 : 1)
        for (int m = 0; m < SR / BY; ++m) {
          T cb = lcgp::mul_rn(
              a_k, lcgp::add_rn(*pA, *reinterpret_cast<const T*>(
                                         pB + lean_b_step<T>(tx, m))));
          if (w) cb = lcgp::fma_rn(*pWI, wjb, cb);
          se_entry(cb, pX, std::true_type{});
          pA += BY * TT;
          pWI += BY;
          pX += BY * XS;
        }
      } else {
#pragma unroll (sizeof(T) == 4 || MAXD <= 4 ? 2 : 1)
        for (int r = ty; r < SR; r += BY) {
          const int rt = h * SR + r;
          const int i = i0 + rt;
          const bool active = i < n1 && j < n2 && (!same || i >= j);
          const bool on_diag = same && i == j;
          const bool pair = same && i > j;
          T mv = sA[r * TT + tx];
          if (pair) {
            mv = lcgp::add_rn(
                mv, *reinterpret_cast<const T*>(buf + b_offset<T, MAXD>(tx, r)));
          }
          T cb = lcgp::mul_rn(a_k, mv);
          if (w) {
            const T bw = pair ? lcgp::mul_rn(T(2), beta) : beta;
            cb = lcgp::fma_rn(lcgp::mul_rn(bw, sWI[r]), wj, cb);
          }
          cb = active ? cb : T(0);
          se_entry(cb, s_xi + rt * XS, std::false_type{});
          sum[1] += on_diag ? cb : T(0);
        }
      }
    } else {
      // Matern 5/2: rows ty, ty + BY, ... of the strip.  f64: one entry at
      // a time (two entries' factors would not fit the 128 registers of two
      // blocks an SM); f32 two, interleaved
#pragma unroll (sizeof(T) == 4 ? 2 : 1)
      for (int r = ty; r < SR; r += BY) {
        const int rt = h * SR + r;          // row in the tile
        const int i = i0 + rt;
        // same: i > j in pairs, i == j once, i < j left to the pair
        const bool active = i < n1 && j < n2 && (!same || i >= j);
        const bool on_diag = same && i == j;
        const bool pair = same && i > j;
        T mv = sA[r * TT + tx];
        if (pair) {
          mv = mv + *reinterpret_cast<const T*>(buf +
                                                b_offset<T, MAXD>(tx, r));
        }
        T cb = a_k * mv;
        if (w) {
          const T bw = pair ? T(2) * beta : beta;
          cb = cb + (bw * sWI[r]) * wj;
        }
        cb = active ? cb : T(0);

        T Q[MAXD], G[MAXD];
        T prod = T(1), ssum = T(0);
        const T* xi = s_xi + rt * XS;
        // every dimension up to MAXD: past d, x and 1/l are 0, so S_t = 0
        // leaves the product and the sum exact and adds 0 to the sums
#pragma unroll
        for (int t = 0; t < MAXD; ++t) {
          const T s = lcgp::mul_rn(
              lcgp::absdiff(xi[t], s_xj[t * TT + tx]), sInv[t]);
          // P::grow(prod, s) with its factor kept
          P::lens_step(s, prod, Q[t], G[t]);
          ssum = P::accum(ssum, s);
        }
        const T e = P::decay(ssum);
        const T c0 = P::c0(prod, e);
        // C0 == 0: every lengthscale term is 0, and a prefix product may
        // have overflowed (f32): the sums keep their values, by select
        const bool live = !P::kGuardUnderflow || e != T(0);
        T suf = cb * e;   // cbar decay prod_{u > t} f_u
        if constexpr (std::is_same<T, double>::value) {
          acc[0] = lcgp::fma_rn(cb, c0, acc[0]);
          acc[1] += on_diag ? cb : 0.0;
#pragma unroll
          for (int t = MAXD - 1; t >= 0; --t) {
            const double nxt = lcgp::fma_rn(suf, Q[t], acc[2 + t]);
            acc[2 + t] = live ? nxt : acc[2 + t];
            suf = lcgp::fma_rn(suf, G[t], suf);
          }
        } else {
          sacc[0] = lcgp::fma_rn(cb, c0, sacc[0]);
          sacc[1] += on_diag ? cb : T(0);
#pragma unroll
          for (int t = MAXD - 1; t >= 0; --t) {
            const T nxt = lcgp::fma_rn(suf, Q[t], sacc[2 + t]);
            sacc[2 + t] = live ? nxt : sacc[2 + t];
            suf = lcgp::fma_rn(suf, G[t], suf);
          }
        }
      }
    }
    if constexpr (!std::is_same<T, double>::value) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v < nv) acc[v] += (double)sacc[v];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);

    if (h == NSTRIP - 1) {
      // the component is summed over this warp's part of the tile
      double* dst = s_red + (k % NRED) * NW * NV + warp * NV;
      if constexpr (!P::kFactor && NV <= 32) {
        int idx;
        const double tot = warp_sum_scatter<NV>(acc, lane, idx);
        if (idx >= 0 && idx < nv) dst[idx] = tot;
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[v] = 0.0;
        __syncwarp();   // the lanes' stores before lane 0's arrival
      } else {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          if (v < nv) {
            const double tot = warp_sum(acc[v]);
            if (lane == 0) dst[v] = tot;
          }
          acc[v] = 0.0;
        }
      }
      if (lane == 0) mbar_arrive(&red[k % NRED]);
    }
  }
  if constexpr (kRotate) {
    for (int c = max(0, q - 2); c < q; ++c) {
      if (warp == c % NW) reduce(c);
    }
  } else if (warp == 0) {
    for (int c = max(0, q - 2); c < q; ++c) reduce(c);
  }
}

template <typename T, int MAXD, typename P>
__global__ void __launch_bounds__(NTH, MAXD <= 8 ? 2 : 1)
gram_vjp_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const T* __restrict__ x1, const T* __restrict__ x2,
                    const T* __restrict__ inv_l, const T* __restrict__ M,
                    const T* __restrict__ w, const T* __restrict__ alpha,
                    T beta, int same, int q, int n1, int n2, int d,
                    double* __restrict__ partials) {
  vjp_body<true, T, MAXD, P>(map_a, map_b, x1, x2, inv_l, M, w, alpha, beta,
                             same, q, n1, n2, d, partials);
}

// Shapes the tensor copy cannot address (rare: odd n2, a misaligned M).
template <typename T, int MAXD, typename P>
__global__ void __launch_bounds__(NTH, 1)
gram_vjp_copy_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ inv_l, const T* __restrict__ M,
                     const T* __restrict__ w, const T* __restrict__ alpha,
                     T beta, int same, int q, int n1, int n2, int d,
                     double* __restrict__ partials) {
  vjp_body<false, T, MAXD, P>(map_a, map_b, x1, x2, inv_l, M, w, alpha,
                              beta, same, q, n1, n2, d, partials);
}

template <typename P, typename T, int MAXD>
int vjp_launch_maxd(const T* x1, const T* x2, const T* inv_l, const T* amp,
                    const T* nug, const T* M, const T* w, const T* alpha,
                    T beta, int same, int q, int n1, int n2, int d,
                    double* partials, T* glens, T* gamp, T* gnug,
                    cudaStream_t stream) {
  // the strip (TT columns, SR rows) and the transposed strip (128 bytes of
  // columns, TT rows, swizzled)
  CUtensorMap map_a{}, map_b{};
  const bool tma = tmap::addressable<T>(M, n2);
  auto kernel = tma ? gram_vjp_tma_kernel<T, MAXD, P>
                    : gram_vjp_copy_kernel<T, MAXD, P>;
  constexpr size_t bytes = smem_bytes<T, MAXD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (tma &&
      !(tmap::encode_stack<T>(&map_a, M, q, n1, n2, TT, SR,
                              CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tmap::encode_stack<T>(&map_b, M, q, n1, n2, 128 / sizeof(T), TT,
                              CU_TENSOR_MAP_SWIZZLE_128B))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nblk = vjp_block_count(same, n1, n2);
  kernel<<<(unsigned)nblk, NTH, bytes, stream>>>(
      map_a, map_b, x1, x2, inv_l, M, w, alpha, beta, same, q, n1, n2, d,
      partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_vjp_finish_kernel<T, P><<<q, VNT, 0, stream>>>(
      partials, nblk, inv_l, amp, nug, same, d, glens, gamp, gnug);
  return (int)cudaGetLastError();
}

// The body of the lcgp_matern52_gram_vjp_{f64,f32} and
// lcgp_rbf_gram_vjp_{f64,f32} C entry points.
template <typename P, typename T>
int vjp_launch(const void* x1, const void* x2, const void* inv_l,
               const void* amp, const void* nug, const void* M,
               const void* w, const void* alpha, double beta, int same, int q,
               int n1, int n2, int d, void* partials, void* glens, void* gamp,
               void* gnug, void* stream) {
  if (q <= 0 || n1 <= 0 || n2 <= 0 || d <= 0 || d > 32 ||
      (w && n1 != n2) || (same && n1 != n2) ||
      vjp_block_count(same, n1, n2) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto maxd_tag) {
    constexpr int MD = decltype(maxd_tag)::value;
    return vjp_launch_maxd<P, T, MD>(
        static_cast<const T*>(x1), static_cast<const T*>(x2),
        static_cast<const T*>(inv_l), static_cast<const T*>(amp),
        static_cast<const T*>(nug), static_cast<const T*>(M),
        static_cast<const T*>(w), static_cast<const T*>(alpha), T(beta), same,
        q, n1, n2, d, static_cast<double*>(partials), static_cast<T*>(glens),
        static_cast<T*>(gamp), static_cast<T*>(gnug), s);
  };
  if (d <= 2) return run(std::integral_constant<int, 2>{});
  if (d <= 4) return run(std::integral_constant<int, 4>{});
  if (d <= 8) return run(std::integral_constant<int, 8>{});
  if (d <= 16) return run(std::integral_constant<int, 16>{});
  return run(std::integral_constant<int, 32>{});
}

}  // namespace k3v
}  // namespace

// Batch secp256k1 signature verification (ECDSA, BCH Schnorr, BIP340) on
// Hopper: one hand-written CUDA kernel.
//
// Replaces pallas_kernel._kernel (tpunode/verify/pallas_kernel.py:130-370,
// reached through pl.pallas_call at :526) in its projective / 4-bit /
// lazy-reduction / tree-select / scan-ladder form, in both of its variants:
// SCHNORR_FREE (the ECDSA-only program, acceptance pows pruned) and the full
// program with the Euler and p-2 pow ladders for Schnorr and BIP340 lanes.
// Per lane it computes what the reference computes: the Q table
// [O, Q .. 15Q] by 14 sequential complete adds, the λQ table by scaling X by
// β, 33 windows of 4 doublings and 4 complete adds against G, λG, Q and λQ
// selected by the lane's digits and signs, then x(R) ∈ {r, r+n} projectively,
// qy² = qx³ + 7, Z ≢ 0, and (full variant) jacobi(Y·Z) and the parity of
// Y·Z^(p-2).  The plain version is kernel.verify_core; the verdicts are
// identical.
//
// What bounds it: int32 ALU issue.  One verify is millions of int32
// multiply-adds, shifts and masks over 24-limb field elements and moves a
// few hundred bytes of input, so the card's integer issue rate is the
// floor, and memory bandwidth is not.
//
// Design, simple and right first:
// * One signature per thread, lane = blockIdx.x * blockDim.x + threadIdx.x,
//   128 threads a block, the ragged edge masked.  Inputs keep the reference
//   layout (rows, B), lane-minor, so a warp's loads of one limb row coalesce.
// * Field elements are int32_t[24], products int32_t[47], with the plain
//   version's exact carry/fold schedule (field.cuh), so verify/bounds.py's
//   replay proves that no int32 overflows.
// * The convolution, the reduction tails, pt_add, pt_double, mul, sqr and
//   canonical are __noinline__ functions: one copy of each keeps the build
//   to seconds and the instruction cache warm, at the price of passing
//   operands through the thread's stack.
// * The per-signature Q and λQ tables (9,216 B) and the pow table (1,536 B)
//   live in per-thread local memory; the hardware interleaves local memory
//   across a warp, so equal offsets coalesce.
// * G and λG (2 x 4,608 B) are loaded once per block into shared memory.
//   Each thread indexes them by its own digit, which constant memory would
//   serialise.
// * The exponent digits of the pows are __constant__: every thread reads
//   the same digit, a broadcast.
// * A table entry is selected by indexing with the digit.  The reference's
//   branch-free select tree exists because Mosaic has no gather; the inputs
//   are public, so constant time is not required.
// * What it leaves for later: register pressure and the stack traffic of the
//   noinline calls.  The times and the -Xptxas -v counts are in PERF.md.
#include "curve.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

namespace tpn {

constexpr int WINDOWS = 33;  // 4-bit windows of the ~2^129 GLV half-scalars
constexpr int TABLE = 16;  // entries of a 4-bit window table

// 64 MSB-first 4-bit digits of (p-1)/2 (Euler) and p-2 (Fermat inverse).
TPN_CONSTANT int8_t EULER_DIGITS[64] = {
    7,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 7,  15, 15, 15, 15, 14, 1,  7};
TPN_CONSTANT int8_t PM2_DIGITS[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 14, 15, 15, 15, 15, 15, 12, 2,  13};
// β, the cube root of unity mod p: φ(x, y) = (βx, y) = λ·(x, y).
TPN_CONSTANT int32_t BETA_LIMBS[NL] = {
    494, 672, 454, 1556, 918, 898, 613, 1964, 1298, 302, 961, 1230,
    846, 104, 1963, 572, 1636, 525, 28,  702, 694, 724, 1722, 3};

// The kernel's arguments: PreparedBatch.device_args order, rows lane-minor.
struct VerifyArgs {
  const int32_t *d1a, *d1b, *d2a, *d2b;  // (33, B) digits of |u1a| .. |u2b|
  const uint8_t *n1a, *n1b, *n2a, *n2b;  // (B,) signs of the half-scalars
  const int32_t *qx, *qy, *r1, *r2;  // (24, B) limbs
  const uint8_t *r2_valid, *host_valid, *schnorr, *bip340;  // (B,) flags
  uint8_t* out;  // (B,) verdicts
  int B;
};

TPN_INLINE void load_col(int32_t* out, const int32_t* rows, int B, int lane) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = rows[i * B + lane];
}

// acc += (neg ? -entry : entry); -P = (X, -Y, Z).
TPN_INLINE void add_signed(Pt* acc, const Pt* entry, bool neg) {
  Pt e;
  copy_pt(&e, entry);
  if (neg) {
#pragma unroll
    for (int i = 0; i < NL; ++i) e.y[i] = -e.y[i];
  }
  pt_add(acc, acc, &e);
}

// t^((p-1)/2) (euler) or t^(p-2): a 16-entry power table built by
// sequential multiplies, then 64 windows of 4 squarings and one multiply
// (kernel._pow_const, scan form).  The digit is read straight from constant
// memory: the same address in every thread, a broadcast.
TPN_NOINLINE void pow_const(int32_t* out, const int32_t* t, bool euler) {
  int32_t tab[TABLE][NL];
  set_small(tab[0], 1);
  copy(tab[1], t);
#pragma unroll 1
  for (int k = 2; k < TABLE; ++k) mul(tab[k], tab[k - 1], t);
  int32_t acc[NL];
  set_small(acc, 1);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    sqr(acc, acc);
    sqr(acc, acc);
    sqr(acc, acc);
    sqr(acc, acc);
    mul(acc, acc, tab[euler ? EULER_DIGITS[w] : PM2_DIGITS[w]]);
  }
  copy(out, acc);
}

template <bool SCHNORR_FREE>
TPN_INLINE bool verify_lane(const VerifyArgs& a, const Pt* g_tab, const Pt* lg_tab,
                            int lane) {
  const int B = a.B;
  Pt q1;
  load_col(q1.x, a.qx, B, lane);
  load_col(q1.y, a.qy, B, lane);
  set_small(q1.z, 1);

  // per-signature tables [O, Q, 2Q, .., 15Q] and λ[O, Q, .., 15Q]
  Pt qtab[TABLE], lqtab[TABLE];
  set_infinity(&qtab[0]);
  copy_pt(&qtab[1], &q1);
#pragma unroll 1
  for (int k = 2; k < TABLE; ++k) pt_add(&qtab[k], &qtab[k - 1], &q1);
  int32_t beta[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) beta[i] = BETA_LIMBS[i];
#pragma unroll 1
  for (int k = 0; k < TABLE; ++k) {
    mul(lqtab[k].x, qtab[k].x, beta);
    copy(lqtab[k].y, qtab[k].y);
    copy(lqtab[k].z, qtab[k].z);
  }

  // Shamir/GLV window loop, digits most significant first
  const bool n1a = a.n1a[lane], n1b = a.n1b[lane];
  const bool n2a = a.n2a[lane], n2b = a.n2b[lane];
  Pt acc;
  set_infinity(&acc);
#pragma unroll 1
  for (int w = 0; w < WINDOWS; ++w) {
#pragma unroll 1
    for (int d = 0; d < 4; ++d) pt_double(&acc, &acc);
    const int row = w * B + lane;
    add_signed(&acc, &g_tab[a.d1a[row] & (TABLE - 1)], n1a);
    add_signed(&acc, &lg_tab[a.d1b[row] & (TABLE - 1)], n1b);
    add_signed(&acc, &qtab[a.d2a[row] & (TABLE - 1)], n2a);
    add_signed(&acc, &lqtab[a.d2b[row] & (TABLE - 1)], n2b);
  }

  // x(R) ∈ {r, r+n} projectively, R finite, Q on the curve
  int32_t t[NL], u[NL];
  const bool not_inf = !is_zero(acc.z);
  load_col(t, a.r1, B, lane);
  mul(t, t, acc.z);
  const bool m1 = eq(acc.x, t);
  load_col(t, a.r2, B, lane);
  mul(t, t, acc.z);
  const bool m2 = eq(acc.x, t) && a.r2_valid[lane];
  sqr(t, q1.y);
  sqr(u, q1.x);
  mul(u, u, q1.x);
  u[0] += 7;
  const bool on_curve = eq(t, u);

  bool jac_ok = true, even_ok = true;
  if (!SCHNORR_FREE) {
    // jacobi(y(R)) = jacobi(Y·Z): Euler's criterion
    mul(t, acc.y, acc.z);
    pow_const(u, t, true);
    set_small(t, 1);
    jac_ok = eq(u, t);
    // y(R) = Y·Z^(p-2); its canonical low bit
    pow_const(u, acc.z, false);
    mul(t, acc.y, u);
    canonical(t, t);
    even_ok = (t[0] & 1) == 0;
  }
  const bool algo_ok = a.bip340[lane] ? (m1 && even_ok)
                       : a.schnorr[lane] ? (m1 && jac_ok)
                                         : (m1 || m2);
  return a.host_valid[lane] && on_curve && not_inf && algo_ok;
}

#if defined(__CUDACC__)

// g_tabs: (2, 16, 3, 24) int32 — G's window table, then λG's.
template <bool SCHNORR_FREE>
__global__ void __launch_bounds__(128) verify_kernel(VerifyArgs a, const int32_t* g_tabs) {
  __shared__ Pt s_tabs[2 * TABLE];
  int32_t* s = reinterpret_cast<int32_t*>(s_tabs);
  for (int i = threadIdx.x; i < 2 * TABLE * 3 * NL; i += blockDim.x) s[i] = g_tabs[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  a.out[lane] = verify_lane<SCHNORR_FREE>(a, s_tabs, s_tabs + TABLE, lane) ? 1 : 0;
}

#endif

}  // namespace tpn

#if defined(__CUDACC__)

constexpr int kThreads = 128;

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int tpn_verify_blocked(
    const int32_t* g_tabs, const int32_t* d1a, const int32_t* d1b, const int32_t* d2a,
    const int32_t* d2b, const uint8_t* n1a, const uint8_t* n1b, const uint8_t* n2a,
    const uint8_t* n2b, const int32_t* qx, const int32_t* qy, const int32_t* r1,
    const int32_t* r2, const uint8_t* r2_valid, const uint8_t* host_valid,
    const uint8_t* schnorr, const uint8_t* bip340, uint8_t* out, int B, int schnorr_free,
    void* stream) {
  tpn::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,
                    r2_valid, host_valid, schnorr, bip340, out, B};
  const dim3 grid((B + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (schnorr_free) {
    tpn::verify_kernel<true><<<grid, kThreads, 0, s>>>(a, g_tabs);
  } else {
    tpn::verify_kernel<false><<<grid, kThreads, 0, s>>>(a, g_tabs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif

// Batch secp256k1 signature verification (ECDSA, BCH Schnorr, BIP340) on
// Hopper: one hand-written CUDA kernel.
//
// Replaces pallas_kernel._kernel (tpunode/verify/pallas_kernel.py:130-370,
// reached through pl.pallas_call at :526) in its scan-ladder form, at both
// window widths (WB = 4 and 5, TPUNODE_WINDOW_BITS), in both point forms
// (AFFINE, TPUNODE_POINT_FORM), with both reductions of the point formulas
// (EAGER, TPUNODE_FIELD_REDUCE: every product reduced at once, or lazy
// accumulation; curve.cuh), with both table selects (ONEHOT,
// TPUNODE_SELECT16: the tree form's indexed read, or the one-hot compare and
// accumulate of pallas_kernel._select16, :108-114), with both squares
// (SQR_MUL, TPUNODE_FIELD_SQR: the half product, or the full product
// conv(a, a) of pallas_field._square_conv under "mul", :171-174; field.cuh)
// and in both variants: SCHNORR_FREE (the ECDSA-only program, acceptance
// pows pruned) and the full program with the Euler and p-2 pow ladders for
// Schnorr and BIP340 lanes: 64 instantiations, with both multiplies
// (TPN_MUL_DOT, TPUNODE_FIELD_MUL: the shift-add convolution, or under
// dot_general every convolution contracted on the integer tensor cores,
// pallas_field._conv_dot and _sqr_dot, :116-174; field_dot.cuh): 128.
// Per lane it computes what the reference computes: the Q table
// [O, Q .. (2^WB - 1)Q] by 2^WB - 2 sequential complete adds (in the affine
// form then normalised to 2 coordinates by one batch inversion: prefix
// products, one Fermat ladder, a suffix pass), the λQ table by scaling X by
// β, WINDOWS<WB> windows (33 at 4-bit, 27 at 5-bit) of WB doublings and 4
// adds against G, λG, Q and λQ selected by the lane's digits and signs
// (complete adds, or mixed adds that skip digit 0 in the affine form), then
// x(R) ∈ {r, r+n} projectively,
// qy² = qx³ + 7, Z ≢ 0, and (full variant) jacobi(Y·Z) and the parity of
// Y·Z^(p-2).  The pow ladders are 4-bit at both widths: their exponents are
// constants unrelated to the GLV windows.  The plain version is
// kernel.verify_core; the verdicts are identical.
//
// What bounds it: int32 ALU issue.  One verify is millions of int32
// multiply-adds, shifts and masks over 24-limb field elements and moves a
// few hundred bytes of input, so the card's integer issue rate is the
// floor, and memory bandwidth is not.
//
// Under dot_general the tensor-core contraction is warp-collective: every
// mma needs all 32 threads of the warp, converged.  A lane-per-thread kernel
// parts its lanes in two places before a multiply, and a dot build keeps
// the warp together at both: the ragged last warp runs its lanes past B on
// clamped loads (lane B - 1's) to the end and skips only their stores, and
// the affine window add runs for the whole warp whenever any of its lanes
// has a nonzero digit, each lane keeping its accumulator where its own digit
// is 0 (the reference's jnp.where, pallas_kernel.py:310).  Shift-add builds
// compile as before: the two changes sit behind if constexpr on MUL_DOT.
// What bounds a dot build is in field_dot.cuh: the staging and
// recombination around the mma, not the tensor cores; it is slower than
// shift-add.
//
// Build: the same source is four libraries (cuda_kernel.py), one a
// (multiply, square): -DTPN_MUL_DOT=0/1 with -DTPN_SQR_MUL=0 instantiates 32
// half-product kernels, =1 32 full-product ones, each library behind its own
// tpn_verify_blocked; the nvcc processes run side by side.
//
// Design, simple and right first:
// * One signature per thread, lane = blockIdx.x * blockDim.x + threadIdx.x,
//   128 threads a block, the ragged edge masked.  Inputs keep the reference
//   layout (rows, B), lane-minor, so a warp's loads of one limb row coalesce.
// * Field elements are int32_t[24], products int32_t[47], with the plain
//   version's exact carry/fold schedule (field.cuh), so verify/bounds.py's
//   replay proves that no int32 overflows.
// * The convolution, the reduction tails, mul, mul_t, sqr, sqr_t, the lazy
//   and the eager pt_add, pt_add_mixed and pt_double, pow_const and
//   canonical are __noinline__ functions: one copy of each keeps the build
//   to seconds and the instruction cache warm, at the price of passing
//   operands through the thread's stack.  The eager bodies make more such
//   calls (each product is a mul, mul_t or sqr_t of three calls; PERF.md
//   counts them).  The λ scaling, the batch inversion, the pows and the
//   final checks multiply by mul and sqr in both reductions, as the
//   reference does.
// * The per-signature Q and λQ tables (9,216 B at 4-bit, 18,432 B at
//   5-bit; in the affine form 6,144 B / 12,288 B plus the Z and prefix
//   columns, 3,072 B / 6,144 B) and the pow table (1,536 B) live in
//   per-thread local memory; the hardware interleaves local memory across a
//   warp, so equal offsets coalesce.  An affine select loads 192 B, a
//   projective one 288 B; a one-hot select 2^WB times that.
// * G and λG (2 x 4,608 B at 4-bit, 2 x 9,216 B at 5-bit; two thirds of
//   that affine) are loaded once per block into shared memory, under the
//   48 KB static limit with a dot build's 12,288 B of staging beside them.
//   Each thread indexes them by its own digit, which constant memory would
//   serialise.
// * The exponent digits of the pows are __constant__: every thread reads
//   the same digit, a broadcast.
// * A table entry is selected (select_entry) in one of two ways.  The tree
//   instantiations index with the digit: the reference's branch-free select
//   tree exists because Mosaic has no gather, and the inputs are public, so
//   constant time is not required.  Lanes of a warp then read different
//   offsets: local-memory reads do not coalesce, shared-memory reads
//   conflict on banks.  The one-hot instantiations read every entry in
//   order and OR in entry & -(digit == t), word by word, as the reference
//   sums where(digit == t, entry, 0): every lane reads the same offset (local
//   memory coalesces, shared memory broadcasts), at 2^WB times the bytes.
// * What it leaves for later: register pressure and the stack traffic of the
//   noinline calls.  The times and the -Xptxas -v counts are in PERF.md.
#include <type_traits>

#include "curve.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

namespace tpn {

// Windows of WB bits that cover the ~2^129 GLV half-scalars.
template <int WB>
constexpr int WINDOWS = WB == 4 ? 33 : 27;
// β, the cube root of unity mod p: φ(x, y) = (βx, y) = λ·(x, y).
TPN_CONSTANT int32_t BETA_LIMBS[NL] = {
    494, 672, 454, 1556, 918, 898, 613, 1964, 1298, 302, 961, 1230,
    846, 104, 1963, 572, 1636, 525, 28,  702, 694, 724, 1722, 3};

// The kernel's arguments: PreparedBatch.device_args order, rows lane-minor.
struct VerifyArgs {
  const int32_t *d1a, *d1b, *d2a, *d2b;  // (windows, B) digits of |u1a| .. |u2b|
  const uint8_t *n1a, *n1b, *n2a, *n2b;  // (B,) signs of the half-scalars
  const int32_t *qx, *qy, *r1, *r2;  // (24, B) limbs
  const uint8_t *r2_valid, *host_valid, *schnorr, *bip340;  // (B,) flags
  uint8_t* out;  // (B,) verdicts
  int B;
};

// acc += (neg ? -entry : entry); -P = (X, -Y, Z).
template <bool EAGER>
TPN_INLINE void add_signed(Pt* acc, const Pt* entry, bool neg) {
  Pt e;
  copy_pt(&e, entry);
  if (neg) {
#pragma unroll
    for (int i = 0; i < NL; ++i) e.y[i] = -e.y[i];
  }
  pt_add<EAGER>(acc, acc, &e);
}

// The table entry `digit` (in [0, TABLE)) of `table`: per-lane Q / λQ
// tables in local memory or the block's G / λG in shared memory.  The tree
// form returns the indexed entry itself (`out` unused, so its code is a
// plain indexed read); the one-hot form reads all TABLE entries and keeps
// the one whose mask is all ones, in `out` (the reference's
// compare-accumulate: exactly one term is nonzero, so OR and + agree).
TPN_INLINE void or_masked(int32_t* out, const int32_t* e, int32_t m) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] |= e[i] & m;
}
TPN_INLINE void or_masked(Pt* out, const Pt* e, int32_t m) {
  or_masked(out->x, e->x, m);
  or_masked(out->y, e->y, m);
  or_masked(out->z, e->z, m);
}
TPN_INLINE void or_masked(AffPt* out, const AffPt* e, int32_t m) {
  or_masked(out->x, e->x, m);
  or_masked(out->y, e->y, m);
}

template <bool ONEHOT, typename Entry, int TABLE>
TPN_INLINE const Entry* select_entry(const Entry* table, int digit, Entry* out) {
  if constexpr (!ONEHOT) {
    return &table[digit];
  } else {
    *out = Entry{};
#pragma unroll 1
    for (int t = 0; t < TABLE; ++t) or_masked(out, &table[t], -static_cast<int32_t>(digit == t));
    return out;
  }
}

// The affine form's window add: acc += ±entry by a mixed add where the
// digit is nonzero, and acc kept where it is 0 (the affine table cannot hold
// infinity; the reference keeps acc through a select).  A branch, not a
// select: the inputs are public, so constant time is not required, the
// verdicts are the same, and a warp whose lanes all read digit 0 skips the
// add.  A warp issues the add whenever any of its 32 lanes needs it.  Under
// MUL_DOT the add's convolutions are warp-collective, so every lane of such
// a warp computes it and keeps acc where its own digit is 0.
template <bool EAGER>
TPN_INLINE void add_signed_mixed(Pt* acc, const AffPt* entry, int digit, bool neg) {
  if constexpr (MUL_DOT) {
    if (!warp_any(digit != 0)) return;
  } else {
    if (digit == 0) return;
  }
  AffPt e;
  copy(e.x, entry->x);
  copy(e.y, entry->y);
  if (neg) {
#pragma unroll
    for (int i = 0; i < NL; ++i) e.y[i] = -e.y[i];
  }
  if constexpr (MUL_DOT) {
    Pt nxt;
    pt_add_mixed<EAGER>(&nxt, acc, &e);
    if (digit != 0) copy_pt(acc, &nxt);
  } else {
    pt_add_mixed<EAGER>(acc, acc, &e);
  }
}

// The projective form's per-signature tables [O, Q, .., (TABLE-1)Q] and
// λ[O, Q, ..] (kernel._build_q_table, kernel._lambda_table).
template <int TABLE, bool EAGER, bool SQR_MUL>
TPN_INLINE void build_tables(Pt* qtab, Pt* lqtab, const Pt& q1, const int32_t* beta) {
  set_infinity(&qtab[0]);
  copy_pt(&qtab[1], &q1);
#pragma unroll 1
  for (int k = 2; k < TABLE; ++k) pt_add<EAGER>(&qtab[k], &qtab[k - 1], &q1);
#pragma unroll 1
  for (int k = 0; k < TABLE; ++k) {
    mul(lqtab[k].x, qtab[k].x, beta);
    copy(lqtab[k].y, qtab[k].y);
    copy(lqtab[k].z, qtab[k].z);
  }
}

// The affine form's tables (kernel._affine_q_table, in the order of
// pallas_kernel.py:220-260): the projective chain with each Z set aside in a
// column; prefix products ptab[k] = z_2 .. z_k with ptab[1] = 1; one Fermat
// ladder (ptab[TABLE-1])^(p-2); then from the last entry down to entry 2,
// z_k^-1 = run * ptab[k-1] (at k = 2 a multiply by 1, as the reference
// does), X and Y times it, and run *= z_k.  Entry 0 is the (0, 1)
// placeholder.  A lane whose chain reaches Z = 0 (Q off the curve) gets
// garbage entries; the on-curve check masks its verdict.
template <int TABLE, bool EAGER, bool SQR_MUL>
TPN_INLINE void build_tables(AffPt* qtab, AffPt* lqtab, const Pt& q1, const int32_t* beta) {
  int32_t ztab[TABLE][NL], ptab[TABLE][NL];
  set_small(qtab[0].x, 0);
  set_small(qtab[0].y, 1);
  copy(qtab[1].x, q1.x);
  copy(qtab[1].y, q1.y);
  Pt acc;
  copy_pt(&acc, &q1);
#pragma unroll 1
  for (int k = 2; k < TABLE; ++k) {
    pt_add<EAGER>(&acc, &acc, &q1);
    copy(qtab[k].x, acc.x);
    copy(qtab[k].y, acc.y);
    copy(ztab[k], acc.z);
  }
  set_small(ptab[1], 1);
  copy(ptab[2], ztab[2]);
#pragma unroll 1
  for (int k = 3; k < TABLE; ++k) mul(ptab[k], ptab[k - 1], ztab[k]);
  int32_t run[NL], zinv[NL];
  pow_const<SQR_MUL>(run, ptab[TABLE - 1], false);
#pragma unroll 1
  for (int k = TABLE - 1; k >= 2; --k) {
    mul(zinv, run, ptab[k - 1]);
    mul(qtab[k].x, qtab[k].x, zinv);
    mul(qtab[k].y, qtab[k].y, zinv);
    if (k > 2) mul(run, run, ztab[k]);
  }
#pragma unroll 1
  for (int k = 0; k < TABLE; ++k) {
    mul(lqtab[k].x, qtab[k].x, beta);
    copy(lqtab[k].y, qtab[k].y);
  }
}

template <bool SCHNORR_FREE, int WB, bool AFFINE, bool EAGER, bool ONEHOT, bool SQR_MUL>
TPN_INLINE bool verify_lane(const VerifyArgs& a,
                            const typename std::conditional<AFFINE, AffPt, Pt>::type* g_tab,
                            const typename std::conditional<AFFINE, AffPt, Pt>::type* lg_tab,
                            int lane) {
  static_assert(WB == 4 || WB == 5, "window width is 4 or 5 bits");
  using Entry = typename std::conditional<AFFINE, AffPt, Pt>::type;
  constexpr int TABLE = 1 << WB;  // entries of a window table
  const int B = a.B;
  Pt q1;
  load_col(q1.x, a.qx, B, lane);
  load_col(q1.y, a.qy, B, lane);
  set_small(q1.z, 1);

  int32_t beta[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) beta[i] = BETA_LIMBS[i];
  Entry qtab[TABLE], lqtab[TABLE];
  build_tables<TABLE, EAGER, SQR_MUL>(qtab, lqtab, q1, beta);

  // Shamir/GLV window loop, digits most significant first
  const bool n1a = a.n1a[lane], n1b = a.n1b[lane];
  const bool n2a = a.n2a[lane], n2b = a.n2b[lane];
  Pt acc;
  set_infinity(&acc);
  Entry sel;  // the one-hot select's entry; the tree form reads the table
#pragma unroll 1
  for (int w = 0; w < WINDOWS<WB>; ++w) {
#pragma unroll 1
    for (int d = 0; d < WB; ++d) pt_double<EAGER, SQR_MUL>(&acc, &acc);
    const int row = w * B + lane;
    const int da = a.d1a[row] & (TABLE - 1), db = a.d1b[row] & (TABLE - 1);
    const int dc = a.d2a[row] & (TABLE - 1), dd = a.d2b[row] & (TABLE - 1);
    if constexpr (AFFINE) {
      // digit 0 skips the add after the select, as the reference discards it
      add_signed_mixed<EAGER>(&acc, select_entry<ONEHOT, Entry, TABLE>(g_tab, da, &sel), da, n1a);
      add_signed_mixed<EAGER>(&acc, select_entry<ONEHOT, Entry, TABLE>(lg_tab, db, &sel), db,
                              n1b);
      add_signed_mixed<EAGER>(&acc, select_entry<ONEHOT, Entry, TABLE>(qtab, dc, &sel), dc, n2a);
      add_signed_mixed<EAGER>(&acc, select_entry<ONEHOT, Entry, TABLE>(lqtab, dd, &sel), dd,
                              n2b);
    } else {
      add_signed<EAGER>(&acc, select_entry<ONEHOT, Entry, TABLE>(g_tab, da, &sel), n1a);
      add_signed<EAGER>(&acc, select_entry<ONEHOT, Entry, TABLE>(lg_tab, db, &sel), n1b);
      add_signed<EAGER>(&acc, select_entry<ONEHOT, Entry, TABLE>(qtab, dc, &sel), n2a);
      add_signed<EAGER>(&acc, select_entry<ONEHOT, Entry, TABLE>(lqtab, dd, &sel), n2b);
    }
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
  sqr<SQR_MUL>(t, q1.y);
  sqr<SQR_MUL>(u, q1.x);
  mul(u, u, q1.x);
  u[0] += 7;
  const bool on_curve = eq(t, u);

  bool jac_ok = true, even_ok = true;
  if (!SCHNORR_FREE) {
    // jacobi(y(R)) = jacobi(Y·Z): Euler's criterion
    mul(t, acc.y, acc.z);
    pow_const<SQR_MUL>(u, t, true);
    set_small(t, 1);
    jac_ok = eq(u, t);
    // y(R) = Y·Z^(p-2); its canonical low bit
    pow_const<SQR_MUL>(u, acc.z, false);
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

// g_tabs: (2, 2^WB, 3, 24) int32 — G's window table, then λG's — or
// (2, 2^WB, 2, 24) in the affine form.
template <bool SCHNORR_FREE, int WB, bool AFFINE, bool EAGER, bool ONEHOT, bool SQR_MUL>
__global__ void __launch_bounds__(128) verify_kernel(VerifyArgs a, const int32_t* g_tabs) {
  using Entry = typename std::conditional<AFFINE, AffPt, Pt>::type;
  constexpr int TABLE = 1 << WB;
  __shared__ Entry s_tabs[2 * TABLE];
  int32_t* s = reinterpret_cast<int32_t*>(s_tabs);
  for (int i = threadIdx.x; i < 2 * TABLE * (AFFINE ? 2 : 3) * NL; i += blockDim.x) {
    s[i] = g_tabs[i];
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (MUL_DOT) {
    // the whole warp runs to the end: a warp with no lane of the batch
    // leaves at once, and a lane past B verifies lane B - 1 unstored
    if ((lane & ~31) >= a.B) return;
    const bool ok = verify_lane<SCHNORR_FREE, WB, AFFINE, EAGER, ONEHOT, SQR_MUL>(
        a, s_tabs, s_tabs + TABLE, lane < a.B ? lane : a.B - 1);
    if (lane < a.B) a.out[lane] = ok ? 1 : 0;
  } else {
    if (lane >= a.B) return;
    a.out[lane] = verify_lane<SCHNORR_FREE, WB, AFFINE, EAGER, ONEHOT, SQR_MUL>(
                      a, s_tabs, s_tabs + TABLE, lane)
                      ? 1
                      : 0;
  }
}

#endif

}  // namespace tpn

#if defined(__CUDACC__)

#if !defined(TPN_SQR_MUL) || (TPN_SQR_MUL != 0 && TPN_SQR_MUL != 1)
#error "compile with -DTPN_SQR_MUL=0 (the half-product square) or -DTPN_SQR_MUL=1 (full)"
#endif
#if TPN_MUL_DOT != 0 && TPN_MUL_DOT != 1
#error "compile with -DTPN_MUL_DOT=0 (shift_add) or -DTPN_MUL_DOT=1 (dot_general)"
#endif

constexpr int kThreads = 128;
constexpr bool kSqrMul = TPN_SQR_MUL == 1;  // this library's square
#if TPN_MUL_DOT
static_assert(kThreads == 32 * tpn::DOT_BLOCK_WARPS, "a staging buffer for each warp");
#endif

template <bool SCHNORR_FREE, int WB, bool AFFINE, bool EAGER, bool ONEHOT>
static int launch(const tpn::VerifyArgs& a, const int32_t* g_tabs, cudaStream_t s) {
  const dim3 grid((a.B + kThreads - 1) / kThreads);
  tpn::verify_kernel<SCHNORR_FREE, WB, AFFINE, EAGER, ONEHOT, kSqrMul>
      <<<grid, kThreads, 0, s>>>(a, g_tabs);
  return static_cast<int>(cudaGetLastError());
}

template <bool SCHNORR_FREE, int WB, bool AFFINE, bool EAGER>
static int launch_select(const tpn::VerifyArgs& a, const int32_t* g_tabs, int select,
                         cudaStream_t s) {
  if (select == 0) return launch<SCHNORR_FREE, WB, AFFINE, EAGER, false>(a, g_tabs, s);
  if (select == 1) return launch<SCHNORR_FREE, WB, AFFINE, EAGER, true>(a, g_tabs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool SCHNORR_FREE, int WB, bool AFFINE>
static int launch_reduce(const tpn::VerifyArgs& a, const int32_t* g_tabs, int reduce,
                         int select, cudaStream_t s) {
  if (reduce == 0) return launch_select<SCHNORR_FREE, WB, AFFINE, false>(a, g_tabs, select, s);
  if (reduce == 1) return launch_select<SCHNORR_FREE, WB, AFFINE, true>(a, g_tabs, select, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool SCHNORR_FREE, int WB>
static int launch_form(const tpn::VerifyArgs& a, const int32_t* g_tabs, int point_form,
                       int reduce, int select, cudaStream_t s) {
  if (point_form == 0) {
    return launch_reduce<SCHNORR_FREE, WB, false>(a, g_tabs, reduce, select, s);
  }
  if (point_form == 1) {
    return launch_reduce<SCHNORR_FREE, WB, true>(a, g_tabs, reduce, select, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the kernel on `stream` (of the current device: the caller makes
// the tensors' card current) and returns cudaGetLastError() (0 = launched),
// or cudaErrorInvalidValue for a window width other than 4 or 5, a point
// form other than 0 (projective) or 1 (affine), a reduce other than 0
// (lazy) or 1 (eager), a select other than 0 (tree) or 1 (onehot), a sqr
// other than this library's TPN_SQR_MUL (0 the half product, 1 the full
// product), or a mul other than its TPN_MUL_DOT (0 shift_add, 1
// dot_general).  32 instantiations: variant x width x form x reduce x
// select, at the library's multiply and square.
extern "C" int tpn_verify_blocked(
    const int32_t* g_tabs, const int32_t* d1a, const int32_t* d1b, const int32_t* d2a,
    const int32_t* d2b, const uint8_t* n1a, const uint8_t* n1b, const uint8_t* n2a,
    const uint8_t* n2b, const int32_t* qx, const int32_t* qy, const int32_t* r1,
    const int32_t* r2, const uint8_t* r2_valid, const uint8_t* host_valid,
    const uint8_t* schnorr, const uint8_t* bip340, uint8_t* out, int B, int schnorr_free,
    int window_bits, int point_form, int reduce, int select, int sqr, int mul, void* stream) {
  if (sqr != TPN_SQR_MUL || mul != TPN_MUL_DOT) return static_cast<int>(cudaErrorInvalidValue);
  tpn::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,
                    r2_valid, host_valid, schnorr, bip340, out, B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window_bits == 4 && schnorr_free) {
    return launch_form<true, 4>(a, g_tabs, point_form, reduce, select, s);
  }
  if (window_bits == 4) return launch_form<false, 4>(a, g_tabs, point_form, reduce, select, s);
  if (window_bits == 5 && schnorr_free) {
    return launch_form<true, 5>(a, g_tabs, point_form, reduce, select, s);
  }
  if (window_bits == 5) return launch_form<false, 5>(a, g_tabs, point_form, reduce, select, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tpn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif

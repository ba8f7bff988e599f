// Batch secp256k1 signature verification (ECDSA, BCH Schnorr, BIP340) on
// Hopper at the one-hot eager affine tuples, on verify_u32.cu's 8-word
// arithmetic.
//
// Replaces pallas_kernel._kernel (tpunode/verify/pallas_kernel.py:130-370,
// reached through pl.pallas_call at :526) at two mode tuples: 4-bit windows,
// affine points, eager reduction, one-hot select, shift-add multiply, with
// the half-product square or (SQR_MUL, TPUNODE_FIELD_SQR=mul) the full
// product, under either pow ladder (the ladder changes only the plain
// program), in both variants: SCHNORR_FREE (the ECDSA-only program) and the
// full program with the Euler and p-2 pow ladders.  Per lane it computes
// what the reference computes at these modes, and its verdicts are the plain
// version's (kernel.verify_core):
// * the Q table [O, Q .. 15Q] by 14 sequential complete adds in the eager
//   order, made affine by one Montgomery batch inversion (prefix products, one
//   Fermat ladder Z^(p-2), a suffix pass; pallas_kernel.py:220-260,
//   kernel._affine_q_table);
// * 33 windows of 4 doublings and 4 mixed adds against affine G, λG, Q and λQ
//   selected by the lane's digits and signs; a digit of 0 keeps the
//   accumulator (pallas_kernel.py:294-311), as the affine table cannot hold
//   infinity;
// * every entry picked by the one-hot select, the masked sum over all 16
//   entries (pallas_kernel._select16, :108-114; kernel.select_onehot);
// * the point formulas in the eager bodies' order (curve_u32.cuh's *_eager),
//   every square a square<SQR_MUL>;
// * then verify_u32.cu's final checks: x(R) ∈ {r, r+n} projectively,
//   qy² = qx³ + 7, Z ≢ 0, and (full variant) jacobi(Y·Z) and the parity of
//   Y·Z^(p-2).
//
// What bounds it: integer issue, the FMA pipe first, as in verify_u32.cu:
// about 3,800 field products a lane in the full variant and 3,100 in
// SCHNORR_FREE (11 a mixed add against 12 a complete one; the inversion's
// 68 and its pow ladder's 334 more), each 64 widening multiplies and a
// reduction; the one-hot select adds 16 masked reads a table and about
// 16 x 18 ALU operations a select.
// chip_smoke.u32_ops_per_lane counts the operations from this source.
//
// What its design does about the radix-11 template's costs (verify_kernel.cu
// at these modes; PERF.md §6):
// * 8-word elements (field_u32.cuh): 64 widening multiplies a product, not
//   576 limb products (300 for radix-11's half square; the half square here
//   takes its 28 cross products once).  Eager costs nothing extra: every
//   product here is reduced at once in either order (curve_u32.cuh).
// * Everything is inlined (radix-11: about 7,400 noinline calls a lane
//   through a 12,384 B frame).  The window loop runs its four mixed adds
//   through one copy of pt_add_mixed_eager (a loop over the four tables).
// * The affine Q table is 16 x 64 B in local memory, 1,024 B a lane
//   (radix-11: Q and λQ 6,144 B and 3,072 B of Z and prefix columns); the Z
//   column and the prefix products live only while the table is built; λQ
//   is not stored: its entry is (β·x, y), one multiply at the select.
// * Affine G and λG (2 x 16 x 64 B) sit in shared memory, converted once a
//   block from the prep's (2, 16, 2, 24) radix-11 rows, at an odd stride of
//   17 words an entry.
// * The one-hot select reads all 16 entries at the same offset in every lane
//   (local memory coalesces, shared memory broadcasts) and ORs in
//   entry & -(digit == t), word by word: exactly one term is nonzero, so OR
//   and + agree.  The read of every entry is the mode's point, and is kept.
// * __launch_bounds__(128, 2), as verify_u32.cu.  ptxas (nvcc 12.9,
//   sm_90a) gives 212 registers (214 SCHNORR_FREE), a 2,560 B stack frame,
//   0 spills and 2,176 B of shared memory in each of the four
//   instantiations, either square (chip_smoke phase 2 prints them).
//
// No signed value can overflow; tests/test_torch_u32_modes.py holds the
// formulas, the affine table, the select and the per-lane program against
// Python integers and the plain version under UBSan as host C++
// (host_u32_modes.cpp).
//
// Build: the source is two libraries (cuda_kernel.py), one a square:
// -DTPN_SQR_MUL=0 (verify_u32_modes_half) or 1 (verify_u32_modes_mul), two
// instantiations each (the variants), built side by side with the others
// (one nvcc of all four took 127-132 s, the longest of the build).  Each
// exports tpn_verify_u32_modes: tpn_verify_u32's arguments and the square's
// code.
#include "curve_u32.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

namespace tpn {
namespace u32 {
namespace modes {

constexpr int WINDOWS = 33;  // 4-bit windows over the ~2^129 GLV half-scalars
constexpr int TABLE = 16;  // entries of a window table
constexpr int SMEM_STRIDE = 17;  // words an affine G / λG entry in shared memory: 16, padded odd
constexpr int G_ELEMENTS = 2 * TABLE * 2;  // G's and λG's entries' coordinates

// β, the cube root of unity mod p: φ(x, y) = (βx, y) = λ·(x, y).
TPN_CONSTANT uint32_t BETA_WORDS[NWORDS] = {0x719501EEu, 0xC1396C28u, 0x12F58995u, 0x9CF04975u,
                                            0xAC3434E9u, 0x6E64479Eu, 0x657C0710u, 0x7AE96A2Bu};

// The kernel's arguments: PreparedBatch.device_args order, rows lane-minor.
struct VerifyArgs {
  const int32_t *d1a, *d1b, *d2a, *d2b;  // (33, B) digits of |u1a| .. |u2b|
  const uint8_t *n1a, *n1b, *n2a, *n2b;  // (B,) signs of the half-scalars
  const int32_t *qx, *qy, *r1, *r2;  // (24, B) radix-11 limbs
  const uint8_t *r2_valid, *host_valid, *schnorr, *bip340;  // (B,) flags
  uint8_t* out;  // (B,) verdicts
  int B;
};

// G's and λG's affine window tables, (2, 16, 2, 24) radix-11 int32, as
// 8-word elements at SMEM_STRIDE words an entry (x, y, one pad word):
// element e of `g_rows` by the threads `first`, `first + step`, ...
TPN_INLINE void convert_g_tables(uint32_t* g_tabs, const int32_t* g_rows, int first, int step) {
  for (int e = first; e < G_ELEMENTS; e += step) {
    const Fe v = from_radix11(g_rows + e * 24, 1, 0);
    uint32_t* dst = g_tabs + (e / 2) * SMEM_STRIDE + (e % 2) * NWORDS;
#pragma unroll
    for (int i = 0; i < NWORDS; ++i) dst[i] = v.w[i];
  }
}

// out |= e & m, word by word, for each coordinate.
TPN_INLINE void or_masked(AffPt& out, const uint32_t* ex, const uint32_t* ey, uint32_t m) {
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) {
    out.x.w[i] |= ex[i] & m;
    out.y.w[i] |= ey[i] & m;
  }
}

TPN_INLINE AffPt aff_zero() {
  AffPt s;
  s.x = fe_small(0);
  s.y = fe_small(0);
  return s;
}

// The one-hot select of G's (t 0) or λG's (t 1) entry `digit`: every entry
// read, the same address in every lane (a shared-memory broadcast).
TPN_INLINE AffPt select_g(const uint32_t* g_tabs, int t, int digit) {
  AffPt s = aff_zero();
#pragma unroll 1
  for (int k = 0; k < TABLE; ++k) {
    const uint32_t* e = g_tabs + (t * TABLE + k) * SMEM_STRIDE;
    or_masked(s, e, e + NWORDS, 0u - static_cast<uint32_t>(digit == k));
  }
  return s;
}

// The one-hot select of the per-lane table's entry `digit`: every entry
// read, the same offset in every lane (local memory coalesces).
TPN_INLINE AffPt select_q(const AffPt* qtab, int digit) {
  AffPt s = aff_zero();
#pragma unroll 1
  for (int k = 0; k < TABLE; ++k) {
    or_masked(s, qtab[k].x.w, qtab[k].y.w, 0u - static_cast<uint32_t>(digit == k));
  }
  return s;
}

// The affine Q table (kernel._affine_q_table, in the order of
// pallas_kernel.py:220-260): the projective chain of complete eager adds
// with each Z set aside; prefix products ptab[k] = z_2 .. z_k with
// ptab[1] = 1; one Fermat ladder (ptab[15])^(p-2); then from entry 15 down to
// entry 2, z_k^-1 = run · ptab[k-1] (at k = 2 a multiply by 1, as the
// reference does), x and y times it, and run · z_k.  Entry 0 is the (0, 1)
// placeholder.  A lane whose chain reaches Z = 0 (Q off the curve) inverts 0
// to 0 and gets garbage entries; the on-curve check masks its verdict.
template <bool SQR_MUL>
TPN_INLINE void build_affine_table(AffPt* qtab, const Pt& q1) {
  Fe ztab[TABLE], ptab[TABLE];
  qtab[0].x = fe_small(0);
  qtab[0].y = fe_small(1);
  qtab[1].x = q1.x;
  qtab[1].y = q1.y;
  Pt acc = q1;
#pragma unroll 1
  for (int k = 2; k < TABLE; ++k) {
    acc = pt_add_eager(acc, q1);
    qtab[k].x = acc.x;
    qtab[k].y = acc.y;
    ztab[k] = acc.z;
  }
  ptab[1] = fe_small(1);
  ptab[2] = ztab[2];
#pragma unroll 1
  for (int k = 3; k < TABLE; ++k) ptab[k] = mul(ptab[k - 1], ztab[k]);
  Fe run = pow_const<SQR_MUL>(ptab[TABLE - 1], false);
#pragma unroll 1
  for (int k = TABLE - 1; k >= 2; --k) {
    const Fe zinv = mul(run, ptab[k - 1]);
    qtab[k].x = mul(qtab[k].x, zinv);
    qtab[k].y = mul(qtab[k].y, zinv);
    if (k > 2) run = mul(run, ztab[k]);
  }
}

template <bool SCHNORR_FREE, bool SQR_MUL>
TPN_INLINE bool verify_lane(const VerifyArgs& a, const uint32_t* g_tabs, int lane) {
  const int B = a.B;
  Pt q1;
  q1.x = from_radix11(a.qx, B, lane);
  q1.y = from_radix11(a.qy, B, lane);
  q1.z = fe_small(1);

  AffPt qtab[TABLE];
  build_affine_table<SQR_MUL>(qtab, q1);

  Fe beta;
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) beta.w[i] = BETA_WORDS[i];

  // Shamir/GLV window loop, digits most significant first; the four mixed
  // adds a window are one loop over G, λG, Q and λQ (λQ's entry: Q's with
  // x·β), each skipped where its digit is 0
  const bool n1a = a.n1a[lane], n1b = a.n1b[lane];
  const bool n2a = a.n2a[lane], n2b = a.n2b[lane];
  Pt acc = infinity();
#pragma unroll 1
  for (int w = 0; w < WINDOWS; ++w) {
#pragma unroll 1
    for (int d = 0; d < 4; ++d) acc = pt_double_eager<SQR_MUL>(acc);
    const int row = w * B + lane;
    const int da = a.d1a[row] & (TABLE - 1), db = a.d1b[row] & (TABLE - 1);
    const int dc = a.d2a[row] & (TABLE - 1), dd = a.d2b[row] & (TABLE - 1);
#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
      const int digit = t == 0 ? da : t == 1 ? db : t == 2 ? dc : dd;
      const bool negate = t == 0 ? n1a : t == 1 ? n1b : t == 2 ? n2a : n2b;
      AffPt e;
      if (t < 2) {
        e = select_g(g_tabs, t, digit);
      } else {
        e = select_q(qtab, digit);
        if (t == 3) e.x = mul(e.x, beta);
      }
      if (digit != 0) {
        e.y = select(e.y, neg(e.y), negate);  // -P = (x, -y)
        acc = pt_add_mixed_eager(acc, e);
      }
    }
  }

  // x(R) ∈ {r, r+n} projectively, R finite, Q on the curve
  const bool not_inf = !is_zero(acc.z);
  const bool m1 = eq(acc.x, mul(from_radix11(a.r1, B, lane), acc.z));
  const bool m2 = eq(acc.x, mul(from_radix11(a.r2, B, lane), acc.z)) && a.r2_valid[lane];
  const bool on_curve =
      eq(square<SQR_MUL>(q1.y), add(mul(square<SQR_MUL>(q1.x), q1.x), fe_small(7)));

  bool jac_ok = true, even_ok = true;
  if (!SCHNORR_FREE) {
    // jacobi(y(R)) = jacobi(Y·Z): Euler's criterion
    jac_ok = eq(pow_const<SQR_MUL>(mul(acc.y, acc.z), true), fe_small(1));
    // y(R) = Y·Z^(p-2); its canonical low bit
    even_ok = (canonical(mul(acc.y, pow_const<SQR_MUL>(acc.z, false))).w[0] & 1) == 0;
  }
  const bool algo_ok = a.bip340[lane] ? (m1 && even_ok)
                       : a.schnorr[lane] ? (m1 && jac_ok)
                                         : (m1 || m2);
  return a.host_valid[lane] && on_curve && not_inf && algo_ok;
}

#if defined(__CUDACC__)

// g_rows: (2, 16, 2, 24) int32, G's affine window table then λG's.
template <bool SCHNORR_FREE, bool SQR_MUL>
__global__ void __launch_bounds__(128, 2)
    verify_u32_modes_kernel(VerifyArgs a, const int32_t* g_rows) {
  __shared__ uint32_t g_tabs[2 * TABLE * SMEM_STRIDE];
  convert_g_tables(g_tabs, g_rows, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  a.out[lane] = verify_lane<SCHNORR_FREE, SQR_MUL>(a, g_tabs, lane) ? 1 : 0;
}

#endif

}  // namespace modes
}  // namespace u32
}  // namespace tpn

#if defined(__CUDACC__)

#if !defined(TPN_SQR_MUL) || (TPN_SQR_MUL != 0 && TPN_SQR_MUL != 1)
#error "compile with -DTPN_SQR_MUL=0 (the half-product square) or -DTPN_SQR_MUL=1 (full)"
#endif

constexpr int kU32ModesThreads = 128;
constexpr bool kU32ModesSqrMul = TPN_SQR_MUL == 1;  // this library's square

template <bool SCHNORR_FREE>
static int launch_u32_modes(const tpn::u32::modes::VerifyArgs& a, const int32_t* g_rows,
                            cudaStream_t s) {
  const dim3 grid((a.B + kU32ModesThreads - 1) / kU32ModesThreads);
  tpn::u32::modes::verify_u32_modes_kernel<SCHNORR_FREE, kU32ModesSqrMul>
      <<<grid, kU32ModesThreads, 0, s>>>(a, g_rows);
  return static_cast<int>(cudaGetLastError());
}

// Launches the kernel on `stream` (of the current device: the caller makes
// the tensors' card current) and returns cudaGetLastError() (0 = launched),
// or cudaErrorInvalidValue for a sqr other than this library's TPN_SQR_MUL
// (0 the half product, 1 the full product).  The arguments are
// tpn_verify_u32's and the square's code: this library runs (4, affine,
// eager, onehot, its square, shift_add) only.
extern "C" int tpn_verify_u32_modes(const int32_t* g_rows, const int32_t* d1a,
                                    const int32_t* d1b, const int32_t* d2a, const int32_t* d2b,
                                    const uint8_t* n1a, const uint8_t* n1b, const uint8_t* n2a,
                                    const uint8_t* n2b, const int32_t* qx, const int32_t* qy,
                                    const int32_t* r1, const int32_t* r2,
                                    const uint8_t* r2_valid, const uint8_t* host_valid,
                                    const uint8_t* schnorr, const uint8_t* bip340, uint8_t* out,
                                    int B, int schnorr_free, int sqr, void* stream) {
  const tpn::u32::modes::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,
                                      r2_valid, host_valid, schnorr, bip340, out, B};
  if (sqr != TPN_SQR_MUL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return schnorr_free ? launch_u32_modes<true>(a, g_rows, s)
                      : launch_u32_modes<false>(a, g_rows, s);
}

extern "C" const char* tpn_u32_modes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif

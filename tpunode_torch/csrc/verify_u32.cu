// Batch secp256k1 signature verification (ECDSA, BCH Schnorr, BIP340) on
// Hopper, redesigned for the card: the main path's verify kernel.
//
// Replaces pallas_kernel._kernel (tpunode/verify/pallas_kernel.py:130-370,
// reached through pl.pallas_call at :526) at the default mode tuple: 4-bit
// windows, projective points, lazy reduction, tree select, half-product
// square, shift-add multiply, under either pow ladder (the ladder changes
// only the plain program), in both variants: SCHNORR_FREE (the ECDSA-only
// program) and the full program with the Euler and p-2 pow ladders.  Every
// other mode tuple runs verify_kernel.cu's radix-11 template, which computes
// the reference's own formulation.  Per lane it computes what the reference
// computes, and its verdicts are the plain version's (kernel.verify_core):
// the Q table [O, Q .. 15Q] by 14 sequential complete adds, 33 windows of
// 4 doublings and 4 complete adds against G, λG, Q and λQ selected by the
// lane's digits and signs, then x(R) ∈ {r, r+n} projectively,
// qy² = qx³ + 7, Z ≢ 0, and (full variant) jacobi(Y·Z) and the parity of
// Y·Z^(p-2).
//
// What bounds it: integer issue, the FMA pipe first.  One verify is about
// 3,500 field products a lane; each is 64 widening 32 x 32 -> 64 multiplies
// (IMAD.WIDE.U32, two FMA-pipe issues each) with their carry adds on either
// pipe, and a reduction; a lane moves a few hundred bytes, so memory
// bandwidth is not the floor.  chip_smoke.u32_ops_per_lane counts the
// operations from this source, by pipe.
//
// What its design does about it (radix-11's costs in PERF.md §6-§7):
// * Field elements are 8 x uint32_t (field_u32.cuh), not 24 radix-11
//   limbs: a product is 64 widening multiplies instead of 576 (300 for the
//   half-product square: the square here takes its 28 cross products once),
//   and the reduction is secp256k1's fold 2^256 ≡ 2^32 + 977, 8 more.
// * Everything is inlined: the field functions and the point formulas
//   (curve_u32.cuh) run in registers, and no operand crosses the stack
//   (radix-11: about 7,400 noinline calls a lane through local memory, a
//   12,384 B frame).  The window loop runs its four adds through one copy of
//   pt_add (a loop over the four tables, the table picked per trip), so the
//   kernel holds two copies of pt_add (table build, window loop), one of
//   pt_double and two of the pow ladder.
// * __launch_bounds__(128, 2): occupancy is set, not left to 255
//   registers.  ptxas gives 200 registers and no spills (chip_smoke phase 2
//   prints them); 32,768 lanes are 256 blocks on 132 SMs, so the lanes set
//   two blocks an SM and a higher minimum would only cap the registers.
//   A one-off sweep on the card found this build ahead of a minimum of 1,
//   3 or 4 blocks and of pt_add / pt_double as calls (PERF.md §6).
// * Tables a third of the size: the per-lane Q table is 16 x 96 B in local
//   memory; λQ is not stored but computed at the select, β·X, one multiply a
//   window (33 a lane against 16 to build it, about 0.5% of the lane's
//   products), which halves the lane's local footprint to 1,536 B.  G and λG
//   (2 x 16 x 96 B, converted from the radix-11 rows once a block) sit in
//   shared memory at an odd stride of 25 words an entry, so the tree
//   select's divergent reads of one word fall on distinct banks for
//   distinct digits.
// * Inputs are converted on load: qx, qy, r1, r2 and the G tables arrive as
//   the prep's radix-11 rows (24, B) and become 8 words (from_radix11, any
//   value below 2^264 reduced, nothing cut).
// * One signature per thread, lane = blockIdx.x * blockDim.x + threadIdx.x,
//   128 threads a block, the ragged edge masked; rows lane-minor, so a
//   warp's loads of one limb row coalesce.
//
// verify/bounds.py's int32 headroom replay proves the radix-11 template and
// says nothing about this arithmetic, which has no signed value to
// overflow: tests/test_torch_u32.py stands in for it (the field layer
// against Python integers at the carries' edges, the point formulas and the
// per-lane program against the plain version, under UBSan as host C++).
//
// Build: one library, verify_u32 (cuda_kernel.py), beside the radix-11
// ones; it exports tpn_verify_u32, tpn_verify_blocked's arguments without
// the mode codes.
#include "curve_u32.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

namespace tpn {
namespace u32 {

constexpr int WINDOWS = 33;  // 4-bit windows over the ~2^129 GLV half-scalars
constexpr int TABLE = 16;  // entries of a window table
constexpr int SMEM_STRIDE = 25;  // words a G / λG entry in shared memory: 24, padded odd
constexpr int G_ELEMENTS = 2 * TABLE * 3;  // G's and λG's entries' coordinates

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

// G's (t 0) or λG's (t 1) entry `digit` from the converted tables, 25 words
// an entry (x, y, z, one pad word).
TPN_INLINE Pt g_entry(const uint32_t* g_tabs, int t, int digit) {
  const uint32_t* e = g_tabs + (t * TABLE + digit) * SMEM_STRIDE;
  Pt p;
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) {
    p.x.w[i] = e[i];
    p.y.w[i] = e[NWORDS + i];
    p.z.w[i] = e[2 * NWORDS + i];
  }
  return p;
}

// G's and λG's window tables, (2, 16, 3, 24) radix-11 int32, as 8-word
// elements at SMEM_STRIDE words an entry: element e of `g_rows` by the
// threads `first`, `first + step`, ...
TPN_INLINE void convert_g_tables(uint32_t* g_tabs, const int32_t* g_rows, int first, int step) {
  for (int e = first; e < G_ELEMENTS; e += step) {
    const Fe v = from_radix11(g_rows + e * 24, 1, 0);
    uint32_t* dst = g_tabs + (e / 3) * SMEM_STRIDE + (e % 3) * NWORDS;
#pragma unroll
    for (int i = 0; i < NWORDS; ++i) dst[i] = v.w[i];
  }
}

template <bool SCHNORR_FREE>
TPN_INLINE bool verify_lane(const VerifyArgs& a, const uint32_t* g_tabs, int lane) {
  const int B = a.B;
  Pt q1;
  q1.x = from_radix11(a.qx, B, lane);
  q1.y = from_radix11(a.qy, B, lane);
  q1.z = fe_small(1);

  // the per-signature table [O, Q, .., 15Q] (kernel._build_q_table)
  Pt qtab[TABLE];
  qtab[0] = infinity();
  qtab[1] = q1;
#pragma unroll 1
  for (int k = 2; k < TABLE; ++k) qtab[k] = pt_add(qtab[k - 1], q1);

  Fe beta;
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) beta.w[i] = BETA_WORDS[i];

  // Shamir/GLV window loop, digits most significant first; the four adds a
  // window are one loop over G, λG, Q and λQ (λQ's entry: Q's with X·β)
  const bool n1a = a.n1a[lane], n1b = a.n1b[lane];
  const bool n2a = a.n2a[lane], n2b = a.n2b[lane];
  Pt acc = infinity();
#pragma unroll 1
  for (int w = 0; w < WINDOWS; ++w) {
#pragma unroll 1
    for (int d = 0; d < 4; ++d) acc = pt_double(acc);
    const int row = w * B + lane;
    const int da = a.d1a[row] & (TABLE - 1), db = a.d1b[row] & (TABLE - 1);
    const int dc = a.d2a[row] & (TABLE - 1), dd = a.d2b[row] & (TABLE - 1);
#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
      const int digit = t == 0 ? da : t == 1 ? db : t == 2 ? dc : dd;
      const bool negate = t == 0 ? n1a : t == 1 ? n1b : t == 2 ? n2a : n2b;
      Pt e;
      if (t < 2) {
        e = g_entry(g_tabs, t, digit);
      } else {
        e = qtab[digit];
        if (t == 3) e.x = mul(e.x, beta);
      }
      e.y = select(e.y, neg(e.y), negate);  // -P = (X, -Y, Z)
      acc = pt_add(acc, e);
    }
  }

  // x(R) ∈ {r, r+n} projectively, R finite, Q on the curve
  const bool not_inf = !is_zero(acc.z);
  const bool m1 = eq(acc.x, mul(from_radix11(a.r1, B, lane), acc.z));
  const bool m2 = eq(acc.x, mul(from_radix11(a.r2, B, lane), acc.z)) && a.r2_valid[lane];
  const bool on_curve = eq(sqr(q1.y), add(mul(sqr(q1.x), q1.x), fe_small(7)));

  bool jac_ok = true, even_ok = true;
  if (!SCHNORR_FREE) {
    // jacobi(y(R)) = jacobi(Y·Z): Euler's criterion
    jac_ok = eq(pow_const(mul(acc.y, acc.z), true), fe_small(1));
    // y(R) = Y·Z^(p-2); its canonical low bit
    even_ok = (canonical(mul(acc.y, pow_const(acc.z, false))).w[0] & 1) == 0;
  }
  const bool algo_ok = a.bip340[lane] ? (m1 && even_ok)
                       : a.schnorr[lane] ? (m1 && jac_ok)
                                         : (m1 || m2);
  return a.host_valid[lane] && on_curve && not_inf && algo_ok;
}

#if defined(__CUDACC__)

// g_rows: (2, 16, 3, 24) int32, G's window table then λG's.
template <bool SCHNORR_FREE>
__global__ void __launch_bounds__(128, 2)
    verify_u32_kernel(VerifyArgs a, const int32_t* g_rows) {
  __shared__ uint32_t g_tabs[2 * TABLE * SMEM_STRIDE];
  convert_g_tables(g_tabs, g_rows, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  a.out[lane] = verify_lane<SCHNORR_FREE>(a, g_tabs, lane) ? 1 : 0;
}

#endif

}  // namespace u32
}  // namespace tpn

#if defined(__CUDACC__)

constexpr int kU32Threads = 128;

// Launches the kernel on `stream` (of the current device: the caller makes
// the tensors' card current) and returns cudaGetLastError() (0 = launched).
// The arguments are tpn_verify_blocked's without its mode codes: this
// library runs the default tuple only.
extern "C" int tpn_verify_u32(const int32_t* g_tabs, const int32_t* d1a, const int32_t* d1b,
                              const int32_t* d2a, const int32_t* d2b, const uint8_t* n1a,
                              const uint8_t* n1b, const uint8_t* n2a, const uint8_t* n2b,
                              const int32_t* qx, const int32_t* qy, const int32_t* r1,
                              const int32_t* r2, const uint8_t* r2_valid,
                              const uint8_t* host_valid, const uint8_t* schnorr,
                              const uint8_t* bip340, uint8_t* out, int B, int schnorr_free,
                              void* stream) {
  const tpn::u32::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,
                               r2_valid, host_valid, schnorr, bip340, out, B};
  const dim3 grid((B + kU32Threads - 1) / kU32Threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (schnorr_free) {
    tpn::u32::verify_u32_kernel<true><<<grid, kU32Threads, 0, s>>>(a, g_tabs);
  } else {
    tpn::u32::verify_u32_kernel<false><<<grid, kU32Threads, 0, s>>>(a, g_tabs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpn_u32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif

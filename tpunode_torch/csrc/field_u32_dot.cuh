// The dot_general multiply on the 8-word arithmetic: each lane's partial
// products formed on the CUDA cores, their anti-diagonal sums contracted on
// Hopper's integer tensor cores against a constant 0/1/2 scatter.
//
// Replaces, inside pallas_kernel._kernel under TPUNODE_FIELD_MUL=dot_general
// (tpunode/verify/pallas_kernel.py:526), the contractions
// pallas_field._conv_dot and _sqr_dot (pallas_field.py:116-164): the
// (pairs, B) partial products summed into their anti-diagonals by one int32
// dot_general against _mul_scatter().  The TPU forms the products on its VPU
// and sums them on its MXU; here the CUDA cores form them (both operands
// differ per lane, and an mma operand is shared across its tile) and
// mma.sync.aligned.m16n8k32 (8-bit operands, int32 sums) takes the sums.
// Used by verify_u32_modes.cu's lazy dot_general libraries (DotMul, the
// multiply of their point formulas and pows) and by diag.cu's
// field_mul_u32_dot probe.
//
// The products.  An element is field_u32.cuh's 8 words, so a product is the
// 64 products a_i·b_j (i, j < 8) of 64 bits, not 576 radix-11 limb products:
// the half square takes the 8 squares a_i·a_i and the 28 cross products
// a_i·a_j (i < j) once.  Word position s of the 512-bit result gets the lo
// word of every product with i + j = s and the hi word of every product
// with i + j = s - 1; byte e of a word at s lands at byte position 4s + e.
// So the contraction sums bytes: K is the bytes of the products' words,
// which enter the mma as they stand (a .b32 register of an 8-bit A fragment
// holds four consecutive k-columns of one row: one word), with no byte
// transpose, no sign plane (the products are unsigned) and no recombination
// of planes.  The scatter B maps each byte to its byte position; a half
// square's cross product has the entry 2 there and its diagonal 1 (2·a_i·a_j
// may need 65 bits; the entry costs nothing).  A position's sum is below 15
// words x 255 (8 x 2 x 255 for the half square) < 2^12, so the int32 sums
// are exact; they are carried into 16 words once, after the last k-step,
// and reduced by field_u32.cuh's reduce_wide.
//
// The layout of one mma (M 16 x N 8 x K 32): M is lanes, N is byte
// positions, K is four product words of each of two word groups.
// * M: a warp's 32 lanes in two m-tiles.  Row g of m-tile mt is lane 4g +
//   2mt, row g + 8 lane 4g + 2mt + 1: thread (g, q) (g = lane >> 2, q = lane
//   & 3) holds the A rows and the C rows of the four lanes of its own quad.
// * K, a word group: four products of one anti-diagonal d = i + j, rows m ..
//   m + 3, thread q holding slot q, a_{m+q}·b_{d-m-q}; its lo words (at word
//   position d) or its hi words (at d + 1).  A k-step is two word groups
//   (its halves: k-columns 4q .. 4q + 3 and 16 + 4q ..), both inside one
//   n-tile.  Thread q reads a_{m+q} and b_{u-q} at a constant m and u, so
//   every index is known when the kernel is compiled: each lane's operands
//   sit in shared memory in rows of words (zero rows around them), and
//   thread q loads them from its own row offset, q.
// * N: an n-tile is the 8 byte positions of word positions 2nt and 2nt + 1.
//   Column c of n-tile nt is position 8nt + c, and thread (g, q)'s B register
//   of a half holds the bytes of its slot's word that land in column g: one
//   byte (the factor: 1, or 2 / 1 / 0 in the half square) or none.
// The multiply's 64 products are 22 word groups of four (anti-diagonals of 1
// to 8 products, in groups of four rows; a slot past the anti-diagonal reads
// a zero row), 44 halves in 24 k-steps; the half square's 36 are 15 groups
// (the slots with i > j have the factor 0), 30 halves in 16 k-steps.  So a
// warp's multiply is 48 mma (two m-tiles x 24), its half square 32, against
// the radix-11 contraction's 880 (field_dot.cuh): one n-tile a k-step, since
// a k-step's words sit in one n-tile's two word positions.
//
// A thread's work for one product: its operands' 16 words (8 for a square)
// stored to the warp's rows in shared memory; for each m-tile the 32
// operand words of its two lanes loaded (a_{m+q}, b_{u-q}), the products
// of its slots (22 or 15 a lane, IMAD.WIDE), the 24 or 16 mma with a new
// accumulator at each n-tile, and at an n-tile's end each row's two sums
// packed into one word (c0 + c1·256, below 2^21); the packed words written
// to their lane's row of the warp's shared memory (two 16-byte stores a
// lane); then each lane reads its 32 packed words (eight 16-byte loads),
// carries them into 16 words and reduces.  Shared memory, a warp: the
// operand rows, 2 x 14 x 33 words, and the packed sums, 32 x 32 words (7,792
// B).  Bank conflicts: the operand rows hold a lane a column at a stride of
// 33 words, so each load and store of a word touches 32 banks; the packed
// words of a lane are a 128-byte row whose eight 16-byte units are permuted
// by swz(lane), so the writes of a quarter-warp and the reads of eight lanes
// touch distinct units.
//
// Every thread of a warp must reach every product: the caller keeps its
// warps converged (lanes past the batch run on stand-in operands and only
// skip their store) and each product starts with __syncwarp().
//
// Without __CUDACC__ the same code is host C++: dot_warp_host runs a warp's
// 32 threads stage by stage through the same shared-memory rows and
// emulates each mma by the fragment maps (field_dot.cuh's), and
// dot_lane_wide is one lane's arithmetic (its products' bytes summed into
// the positions that the scatter selects, the packing and the carry);
// dot_lane, that reduced, is the product of the per-lane program on the
// host.  Both give the 16 words before the reduction, held word for word
// to mul_wide / sqr_wide under UBSan (tests/test_torch_u32_dot5.py); a
// misread map only the card's comparison with field_mul_u32 catches.
#pragma once

#include "field_u32.cuh"

namespace tpn {
namespace u32 {
namespace dot {

constexpr int ROWS = 14;  // operand rows: words -3 .. 10 (zeros outside 0 .. 7)
constexpr int ROW0 = 3;  // the row of word 0
constexpr int ROW_STRIDE = 33;  // words a row: 32 lanes and a pad word
constexpr int OPERAND_WORDS = ROWS * ROW_STRIDE;  // one operand's rows
constexpr int OUT_STRIDE = 32;  // words of a lane's packed sums: 8 units of 16 bytes
constexpr int OUTS = 2 * OPERAND_WORDS;  // the packed sums' offset, 16-byte aligned
constexpr int WARP_WORDS = OUTS + 32 * OUT_STRIDE;  // a warp's shared memory
static_assert(OUTS % 4 == 0, "the packed sums start 16-byte aligned");
constexpr int MAX_STEPS = 24;

// Half a k-step: the lo (hi 0) or hi (hi 1) words of the products of
// anti-diagonal d, rows m .. m + 3; d < 0: none.
struct Half {
  int d, m, hi;
};

// The k-steps of a contraction, each with its n-tile and two halves.
struct Schedule {
  int steps;
  int nt[MAX_STEPS];
  Half h[MAX_STEPS][2];
};

constexpr int diag_first(int d) { return d > 7 ? d - 7 : 0; }  // the least i with i + j = d
constexpr int diag_len(int d) { return (d < 14 - d ? d : 14 - d) + 1; }

// The word groups of anti-diagonal d: one a four rows; the half square's
// (i <= j) fit one.
constexpr int groups(bool half, int d) { return half ? 1 : (diag_len(d) + 3) / 4; }

// n-tile by n-tile, the word groups at its word positions w = 2nt, 2nt + 1
// (the lo words of d = w, then the hi words of d = w - 1), two a k-step; an
// n-tile's odd group gets an empty half.
constexpr Schedule make_schedule(bool half) {
  Schedule s{};
  for (int nt = 0; nt < 8; ++nt) {
    bool pending = false;
    Half first{-1, 0, 0};
    for (int w = 2 * nt; w < 2 * nt + 2; ++w) {
      for (int hi = 0; hi < 2; ++hi) {
        const int d = w - hi;
        if (d < 0 || d > 14) continue;
        for (int k = 0; k < groups(half, d); ++k) {
          const Half h{d, diag_first(d) + 4 * k, hi};
          if (pending) {
            s.nt[s.steps] = nt;
            s.h[s.steps][0] = first;
            s.h[s.steps][1] = h;
            ++s.steps;
          } else {
            first = h;
          }
          pending = !pending;
        }
      }
    }
    if (pending) {
      s.nt[s.steps] = nt;
      s.h[s.steps][0] = first;
      s.h[s.steps][1] = Half{-1, 0, 0};
      ++s.steps;
    }
  }
  return s;
}

// The scatter's entries of a half's four slots, one byte a slot q: 1 for
// each product of the multiply (a slot past its anti-diagonal reads a zero
// row); in the half square 2 for a cross product a_i·a_j (i < j), 1 for a
// square, 0 for i > j (those products are counted as their mirrors).
constexpr uint32_t factors(bool half, const Half& h) {
  uint32_t f = 0;
  for (int q = 0; q < 4; ++q) {
    const int i = h.m + q, j = h.d - i;
    const uint32_t v = h.d < 0 ? 0u : !half ? 1u : i < j ? 2u : i == j ? 1u : 0u;
    f |= v << (8 * q);
  }
  return f;
}

template <bool HALF>
struct Plan {
  static constexpr Schedule value = make_schedule(HALF);
  static constexpr int STEPS = value.steps;
};
static_assert(Plan<false>::STEPS == 24 && Plan<true>::STEPS == 16, "the k-step counts");

// K-step k of a contraction, as compile-time scalars: its n-tile, whether
// it starts or ends its n-tile, and for each half its anti-diagonal, first
// row, lo / hi word, scatter entries and byte-pattern index (its word
// position less 2nt).
template <bool HALF, int K>
struct Step {
  static constexpr int NT = Plan<HALF>::value.nt[K];
  static constexpr bool FIRST = K == 0 || Plan<HALF>::value.nt[K - 1] != NT;
  static constexpr bool LAST = K + 1 == Plan<HALF>::STEPS || Plan<HALF>::value.nt[K + 1] != NT;
  static constexpr int D0 = Plan<HALF>::value.h[K][0].d, M0 = Plan<HALF>::value.h[K][0].m,
                       HI0 = Plan<HALF>::value.h[K][0].hi;
  static constexpr int D1 = Plan<HALF>::value.h[K][1].d, M1 = Plan<HALF>::value.h[K][1].m,
                       HI1 = Plan<HALF>::value.h[K][1].hi;
  static constexpr uint32_t F0 = factors(HALF, Plan<HALF>::value.h[K][0]);
  static constexpr uint32_t F1 = factors(HALF, Plan<HALF>::value.h[K][1]);
  static constexpr int P0 = D0 + HI0 - 2 * NT, P1 = D1 + HI1 - 2 * NT;
};

// A thread of the warp: its lane n, group g and thread q in the group, and
// the B byte patterns of column g: p[δ] holds a 1 in the byte of column g
// within word position 2nt + δ of an n-tile (4δ <= g < 4δ + 4), else 0.
struct Thread {
  int n, g, q;
  uint32_t p[2];
};

TPN_INLINE Thread thread_of(int n) {
  Thread t;
  t.n = n;
  t.g = n >> 2;
  t.q = n & 3;
  t.p[0] = t.g < 4 ? 1u << (8 * t.g) : 0u;
  t.p[1] = t.g < 4 ? 0u : 1u << (8 * (t.g - 4));
  return t;
}

// The packed sums' 16-byte unit of a lane's unit u: u ^ swz(lane), a
// permutation of the lane's eight units, so that the units that a
// quarter-warp writes (lanes 4g + c of two groups, units 2q + h) and the
// units that eight consecutive lanes read are distinct.
TPN_INLINE int swz(int lane) { return ((lane & 7) >> 2) | ((lane & 3) << 1); }

// Thread n's operands into column n of the warp's operand rows: x's words
// at rows ROW0 .. ROW0 + 7, y's in the second operand's rows (the half
// square reads x alone).
template <bool HALF>
TPN_INLINE void stage(uint32_t* buf, const Fe& x, const Fe& y, int n) {
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) {
    buf[(ROW0 + i) * ROW_STRIDE + n] = x.w[i];
    if (!HALF) buf[OPERAND_WORDS + (ROW0 + i) * ROW_STRIDE + n] = y.w[i];
  }
}

// The operands of thread q's slots for lanes l and l + 1 (its rows g and g
// + 8 of an m-tile): x[r][m] = a_{m+q} and y[r][u] = b_{u-q} of lane l + r,
// zero outside words 0 .. 7.
struct Rows {
  uint32_t x[2][NWORDS], y[2][NWORDS];
};

template <bool HALF>
TPN_INLINE void load_rows(Rows& rows, const uint32_t* buf, int l, int q) {
  const uint32_t* xs = buf + (ROW0 + q) * ROW_STRIDE + l;
  const uint32_t* ys = buf + (HALF ? 0 : OPERAND_WORDS) + (ROW0 - q) * ROW_STRIDE + l;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int m = 0; m < NWORDS; ++m) {
      rows.x[r][m] = xs[m * ROW_STRIDE + r];
      rows.y[r][m] = ys[m * ROW_STRIDE + r];
    }
  }
}

// A half's word of thread q's slot for one lane: the lo or hi word of
// a_{M+q}·b_{D-M-q}; 0 for an empty half.
template <int D, int M, int HI>
TPN_INLINE uint32_t a_word(const uint32_t* x, const uint32_t* y) {
  if constexpr (D < 0) {
    return 0u;
  } else {
    const uint64_t p = static_cast<uint64_t>(x[M]) * y[D - M];
    return HI ? static_cast<uint32_t>(p >> 32) : static_cast<uint32_t>(p);
  }
}

// A half's B register of thread (g, q): its slot's entry (F's byte q) in
// the byte of column g, if column g is one of the word's positions.
template <uint32_t F, int P>
TPN_INLINE uint32_t b_word(const Thread& t) {
  if constexpr (F == 0u) {
    return 0u;
  } else if constexpr (F == 0x01010101u) {
    return t.p[P];
  } else {
    return ((F >> (8 * t.q)) & 0xFFu) * t.p[P];
  }
}

// One lane's 32 packed sums, [nt][q]: positions 8nt + 2q and 8nt + 2q + 1 as
// c0 + c1·256, at bit 64nt + 16q; carried into the product's 16 words r.
TPN_INLINE void carry_wide(uint32_t* r, const uint32_t (*ch)[4]) {
  uint64_t t = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    t += ch[nt][0] + (static_cast<uint64_t>(ch[nt][1]) << 16);
    r[2 * nt] = static_cast<uint32_t>(t);
    t = (t >> 32) + ch[nt][2] + (static_cast<uint64_t>(ch[nt][3]) << 16);
    r[2 * nt + 1] = static_cast<uint32_t>(t);
    t >>= 32;
  }  // t is 0: the product is below 2^512
}

// Row lane `lane`'s packed sums of thread q (n-tiles 0 .. 7) into its units
// 2q and 2q + 1.
TPN_INLINE void store_packed(uint32_t* outs, const uint32_t* packed, int lane, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t* dst = outs + lane * OUT_STRIDE + 4 * ((2 * q + h) ^ swz(lane));
#if defined(__CUDACC__)
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(packed[4 * h], packed[4 * h + 1], packed[4 * h + 2], packed[4 * h + 3]);
#else
    for (int e = 0; e < 4; ++e) dst[e] = packed[4 * h + e];
#endif
  }
}

// Lane n's product r (16 words): its eight units (unit 2q + h: n-tiles 4h ..
// 4h + 3 of thread q's positions), carried.
TPN_INLINE void finish_wide(uint32_t* r, const uint32_t* outs, int n) {
  uint32_t ch[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const uint32_t* src = outs + n * OUT_STRIDE + 4 * (u ^ swz(n));
#if defined(__CUDACC__)
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    ch[4 * (u & 1)][u >> 1] = v.x;
    ch[4 * (u & 1) + 1][u >> 1] = v.y;
    ch[4 * (u & 1) + 2][u >> 1] = v.z;
    ch[4 * (u & 1) + 3][u >> 1] = v.w;
#else
    for (int e = 0; e < 4; ++e) ch[4 * (u & 1) + e][u >> 1] = src[e];
#endif
  }
  carry_wide(r, ch);
}

// Lane n's product, reduced.
TPN_INLINE Fe finish(const uint32_t* outs, int n) {
  uint32_t r[NWIDE];
  finish_wide(r, outs, n);
  return reduce_wide(r);
}

// The A registers of k-step K for thread (g, q) (rows g and g + 8, halves 0
// and 1) and its B registers.
template <bool HALF, int K>
TPN_INLINE void fragments(uint32_t* a, uint32_t* b, const Rows& rows, const Thread& t) {
  using S = Step<HALF, K>;
  a[0] = a_word<S::D0, S::M0, S::HI0>(rows.x[0], rows.y[0]);
  a[1] = a_word<S::D0, S::M0, S::HI0>(rows.x[1], rows.y[1]);
  a[2] = a_word<S::D1, S::M1, S::HI1>(rows.x[0], rows.y[0]);
  a[3] = a_word<S::D1, S::M1, S::HI1>(rows.x[1], rows.y[1]);
  b[0] = b_word<S::F0, S::P0>(t);
  b[1] = b_word<S::F1, S::P1>(t);
}

#if defined(__CUDACC__)

constexpr int BLOCK_WARPS = 4;  // the kernels' 128 threads

// Each warp's operand rows and packed sums.
__shared__ __align__(16) uint32_t dot_buf[BLOCK_WARPS][WARP_WORDS];

// Zero every warp's operand rows (threads first, first + step, ...): the
// rows outside words 0 .. 7 stay zero.  The caller syncs the block after.
TPN_INLINE void dot_init(int first, int step) {
  for (int i = first; i < BLOCK_WARPS * OUTS; i += step) dot_buf[i / OUTS][i % OUTS] = 0u;
}

// acc (c0 .. c3 of thread (g, q)) += A·B over the warp, .u8 operands.
TPN_INLINE void mma_u8(uint32_t* acc, const uint32_t* a, const uint32_t* b) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// K-steps K .. of one m-tile: each n-tile's accumulators from zero, packed
// into p0 (row g) and p1 (row g + 8) at the n-tile's last step.
template <bool HALF, int K = 0>
TPN_INLINE void steps(const Rows& rows, const Thread& t, uint32_t* acc, uint32_t* p0,
                      uint32_t* p1) {
  if constexpr (K < Plan<HALF>::STEPS) {
    using S = Step<HALF, K>;
    if constexpr (S::FIRST) acc[0] = acc[1] = acc[2] = acc[3] = 0u;
    uint32_t a[4], b[2];
    fragments<HALF, K>(a, b, rows, t);
    mma_u8(acc, a, b);
    if constexpr (S::LAST) {
      p0[S::NT] = acc[0] + (acc[1] << 8);
      p1[S::NT] = acc[2] + (acc[3] << 8);
    }
    steps<HALF, K + 1>(rows, t, acc, p0, p1);
  }
}

// The product x·y (HALF: the half square of x) of the calling lane, reduced:
// a warp-wide contraction through the warp's dot_buf; every thread of the
// warp calls it.
template <bool HALF>
TPN_INLINE Fe dot_mul(const Fe& x, const Fe& y) {
  const int n = threadIdx.x & 31;
  uint32_t* buf = dot_buf[threadIdx.x >> 5];
  __syncwarp();  // converged: a lane's branch may end just before a product
  stage<HALF>(buf, x, y, n);
  __syncwarp();
  const Thread t = thread_of(n);
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    const int l = 4 * t.g + 2 * mt;
    Rows rows;
    load_rows<HALF>(rows, buf, l, t.q);
    uint32_t acc[4], p0[8], p1[8];
    steps<HALF>(rows, t, acc, p0, p1);
    store_packed(buf + OUTS, p0, l, t.q);
    store_packed(buf + OUTS, p1, l + 1, t.q);
  }
  __syncwarp();
  return finish(buf + OUTS, n);
}

#else

// Calls of dot_lane on the host, [HALF]: which contraction each product ran.
inline uint64_t host_dot_calls[2] = {0, 0};

// One m16n8k32 over a warp's fragments (.u8 A and B): d[n] += A·B, by the
// fragment maps (A: row g + 8(r & 1), column 4q + e + 16(r >> 1) of register
// r; B: row 4q + e + 16r, column g; C: row g + 8(r >> 1), column 2q + (r &
// 1)).
inline void mma_host(uint32_t (*d)[4], const uint32_t (*a)[4], const uint32_t (*b)[2]) {
  uint32_t am[16][32], bm[32][8];
  for (int n = 0; n < 32; ++n) {
    const int g = n >> 2, q = n & 3;
    for (int r = 0; r < 4; ++r) {
      for (int e = 0; e < 4; ++e) {
        am[g + 8 * (r & 1)][4 * q + e + 16 * (r >> 1)] = (a[n][r] >> (8 * e)) & 0xFFu;
      }
    }
    for (int r = 0; r < 2; ++r) {
      for (int e = 0; e < 4; ++e) bm[4 * q + e + 16 * r][g] = (b[n][r] >> (8 * e)) & 0xFFu;
    }
  }
  for (int n = 0; n < 32; ++n) {
    const int g = n >> 2, q = n & 3;
    for (int r = 0; r < 4; ++r) {
      uint32_t acc = 0;
      for (int k = 0; k < 32; ++k) acc += am[g + 8 * (r >> 1)][k] * bm[k][2 * q + (r & 1)];
      d[n][r] += acc;
    }
  }
}

// steps() for the warp's 32 threads at once: each thread's fragments, one
// emulated mma, the packing.
template <bool HALF, int K = 0>
inline void host_steps(const Rows* rows, const Thread* t, uint32_t (*acc)[4],
                       uint32_t (*p0)[8], uint32_t (*p1)[8]) {
  if constexpr (K < Plan<HALF>::STEPS) {
    using S = Step<HALF, K>;
    uint32_t a[32][4], b[32][2];
    for (int n = 0; n < 32; ++n) {
      if (S::FIRST) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0u;
      fragments<HALF, K>(a[n], b[n], rows[n], t[n]);
    }
    mma_host(acc, a, b);
    if (S::LAST) {
      for (int n = 0; n < 32; ++n) {
        p0[n][S::NT] = acc[n][0] + (acc[n][1] << 8);
        p1[n][S::NT] = acc[n][2] + (acc[n][3] << 8);
      }
    }
    host_steps<HALF, K + 1>(rows, t, acc, p0, p1);
  }
}

// dot_mul for a warp's 32 threads stage by stage: wide[n] = x[n]·y[n] (HALF:
// the half square of x[n]), its 16 words before the reduction.
template <bool HALF>
inline void dot_warp_host(uint32_t (*wide)[NWIDE], const Fe* x, const Fe* y) {
  uint32_t buf[WARP_WORDS] = {};
  for (int n = 0; n < 32; ++n) stage<HALF>(buf, x[n], y[n], n);
  Thread t[32];
  for (int n = 0; n < 32; ++n) t[n] = thread_of(n);
  for (int mt = 0; mt < 2; ++mt) {
    Rows rows[32];
    uint32_t acc[32][4], p0[32][8], p1[32][8];
    for (int n = 0; n < 32; ++n) load_rows<HALF>(rows[n], buf, 4 * t[n].g + 2 * mt, t[n].q);
    host_steps<HALF>(rows, t, acc, p0, p1);
    for (int n = 0; n < 32; ++n) {
      store_packed(buf + OUTS, p0[n], 4 * t[n].g + 2 * mt, t[n].q);
      store_packed(buf + OUTS, p1[n], 4 * t[n].g + 2 * mt + 1, t[n].q);
    }
  }
  for (int n = 0; n < 32; ++n) finish_wide(wide[n], buf + OUTS, n);
}

// One lane's contraction, as the mma computes it: each slot's word's bytes
// times its scatter entry, summed into the byte positions of its word
// position, then packed and carried as the kernel does: r, the 16 words.
template <bool HALF>
inline void dot_lane_wide(uint32_t* r, const Fe& x, const Fe& y) {
  constexpr Schedule plan = Plan<HALF>::value;
  uint32_t sums[64] = {};
  for (int k = 0; k < plan.steps; ++k) {
    for (const Half& h : plan.h[k]) {
      if (h.d < 0) continue;
      const uint32_t f = factors(HALF, h);
      for (int q = 0; q < 4; ++q) {
        const int i = h.m + q, j = h.d - i;
        const uint64_t p = i < NWORDS && j >= 0 ? static_cast<uint64_t>(x.w[i]) * y.w[j] : 0u;
        const uint32_t word = static_cast<uint32_t>(h.hi ? p >> 32 : p);
        for (int e = 0; e < 4; ++e) {
          sums[4 * (h.d + h.hi) + e] += ((f >> (8 * q)) & 0xFFu) * ((word >> (8 * e)) & 0xFFu);
        }
      }
    }
  }
  uint32_t ch[8][4];
  for (int nt = 0; nt < 8; ++nt) {
    for (int q = 0; q < 4; ++q) ch[nt][q] = sums[8 * nt + 2 * q] + (sums[8 * nt + 2 * q + 1] << 8);
  }
  carry_wide(r, ch);
}

// dot_lane_wide, reduced: the per-lane program's product on the host,
// counted in host_dot_calls.
template <bool HALF>
inline Fe dot_lane(const Fe& x, const Fe& y) {
  ++host_dot_calls[HALF];
  uint32_t r[NWIDE];
  dot_lane_wide<HALF>(r, x, y);
  return reduce_wide(r);
}

template <bool HALF>
inline Fe dot_mul(const Fe& x, const Fe& y) {
  return dot_lane<HALF>(x, y);
}

#endif

// The multiply of the lazy dot_general tuples (field_u32.cuh's ShiftAdd's
// counterpart): every product contracted on the tensor cores, the square
// the half product or (SQR_MUL) the full one, x·x.  Warp-wide on the card.
template <bool SQR_MUL>
struct DotMul {
  static constexpr bool WARP = true;
  TPN_MEMBER static Fe mul(const Fe& a, const Fe& b) { return dot_mul<false>(a, b); }
  TPN_MEMBER static Fe sqr(const Fe& a) { return dot_mul<!SQR_MUL>(a, a); }
};

}  // namespace dot
}  // namespace u32
}  // namespace tpn

// The dot_general formulation's convolution on Hopper's integer tensor
// cores: dot_warp, the contraction of diag.cu's field_mul_dot probe and of
// every convolution of the verify kernel built under TPN_MUL_DOT=1
// (conv_dot and sqr_dot, at the end).
//
// Replaces the contraction inside benchmarks/mosaic_diag.py:123
// (_field_mul_dot: _field_mul's pallas_call at :114 under
// mul="dot_general") and inside pallas_kernel._kernel under
// TPUNODE_FIELD_MUL=dot_general (tpunode/verify/pallas_kernel.py:526):
// pallas_field._conv_dot and _sqr_dot (pallas_field.py:116-174), the (576,
// B) partial products a_i·b_j, pair c = 24·i + j, contracted with the (47,
// 576) anti-diagonal scatter by one int32 dot_general.  Here a warp
// contracts its 32 lanes, one lane a thread, as D (48 x 32) = S (48 x 576) ·
// P (576 x 32) by mma.sync.aligned.m16n8k32 (8-bit operands, int32 sums):
// M = the 47 output limbs padded to 48 (three m-tiles of 16), N = the warp's
// lanes (four n-tiles of 8), and K = the 576 pairs in the same order, a
// k-step one row i of the outer product: its 24 pairs (i, j) at k-rows
// 0..23, k-rows 24..31 zero.  The half-product square follows
// pallas_field._sqr_dot: the same pairs and scatter, pair (i, j) holding
// a_i·a_i on the diagonal, a_i·(2a_j) for j > i (the d = a + a of
// field.cuh's sqr_conv) and 0 for j < i.
//
// The byte split, and why the int32 result is exact.  The tensor cores
// take no int32 operand, and after mul's carry round (field.cuh's carry, as
// mul_wide does) a product reaches ±2^30 (top·top).  Each product p is cut
// into the four bytes of its two's complement: p = b0 + b1·2^8 + b2·2^16 +
// s3·2^24, with b0 .. b2 unsigned (.u8) and s3 = p >> 24 signed (.s8): every
// int32 has such a split, with no carry between the planes, and the split
// is a byte transpose of four products into four plane words.  The scatter
// is 0/1 (.s8).  One mma sums at most 32 bytes, so it cannot overflow.  The
// planes recombine as Σ s_b·2^(8b) in wrapping 32-bit arithmetic, which is
// the true anti-diagonal sum modulo 2^32; mul's contract keeps every true
// sum inside int32 (tpunode/verify/field.py:403-420), so the result is the
// shift-add conv's, limb for limb.  The recombination runs in uint32_t and
// converts once (to_int32), so the host build has no signed overflow and no
// left shift of a negative value.
//
// Loop order.  The 24 steps run as a loop, not unrolled, so the code is
// small and compiles in seconds: a step's scatter is a shifted identity
// (pair (i, j) to output limb i + j) whose A fragments take a few integer
// ops from i, and its products read a_i and the lane's b_j, held in
// registers.  (A k-step of 32 consecutive pairs, unrolled 18 times, was
// unrolled only twice by nvcc inside the verify kernel's __noinline__
// convolution, leaving pair indices, divisions and A fragments to run
// time.)  In each step every thread writes its lane's 24 products as plane
// words to the warp's shared memory, the four planes of a word side by side
// (one 16-byte store), __syncwarp, reads its B fragments (4 planes x 4
// n-tiles x 2 registers, in 16-byte loads), __syncwarp, and then for each
// m-tile that holds one of the step's limbs i .. i + 23 (two or three of
// the three: a branch on i, the same in every thread) builds its A fragment
// and runs the 16 mma of the 4 planes x 4 n-tiles, each from zero, adding
// its 4 sums into the lane's running totals at its plane's shift.  So a
// thread keeps 48 total words (3 m-tiles x 4 n-tiles x 4), not the 192 of
// four planes' separate accumulators.  880 mma a warp: 55 (step, m-tile)
// pairs x 16.  The totals then go through the same shared memory, a m-tile
// (16 rows of 33 words) at a time, back to one lane a thread.  Shared
// memory: DOT_WARP_WORDS words (3,072 B) a warp, 16-byte aligned.  Every
// thread of the warp must reach every mma and __syncwarp: the caller runs
// lanes it does not own on stand-in operands and only skips their stores,
// never returns early (verify_kernel.cu keeps its warps converged).
//
// What bounds it.  The 576 products stay on the FMA pipe and the reduction
// and canonical form on the ALU pipe, as in the shift-add conv; only the
// anti-diagonal adds move to the tensor cores, which do 47 times the
// multiply-adds of the dense scatter and more for the padding (112,640 int8
// a lane), a few µs at 32,768 lanes at the data sheet's rate.  The byte
// transposes, the A fragments, the per-step recombination (64 shift-adds a
// touched m-tile) and the shared-memory staging add int32 issue work, some
// 6,000 operations a lane a convolution against shift-add's 576
// multiply-adds, so int32 issue, not the tensor cores, bounds it, and it is
// slower than shift-add: in the verify kernel ~3,500 convolutions a lane
// (full variant, 4-bit projective lazy), ~1.3·10^13 int8 multiply-adds a
// launch at 32,768 lanes, ~13 ms at the data sheet's rate.  The design is
// the simple, right one: wgmma, TMA and a scatter kept in shared memory are
// later work.
//
// Fragment index maps (PTX ISA, mma.m16n8k32 with 8-bit A and B; the
// elements of a .b32 register are its bytes, lowest first).  A thread's
// group g = laneid >> 2 and t = laneid & 3:
//   A (16 x 32, row): register q (0..3), byte e: row g + 8·(q & 1), column
//     4t + e + 16·(q >> 1);
//   B (32 x 8, col): register q (0..1), byte e: row 4t + e + 16·q, column g;
//   C, D (16 x 8, s32): register q (0..3): row g + 8·(q >> 1), column
//     2t + (q & 1).
//
// Without __CUDACC__ the same code is host C++ (host_check.cpp): the warp is
// a loop over its 32 threads, stage by stage, and mma_host gathers the
// fragments by the same maps, multiplies and scatters.  That check catches
// an index, shift or padding fault; a misread map it reads the same way, so
// only the card's comparison with shift-add catches that.  A host build
// under TPN_MUL_DOT runs conv_dot and sqr_dot one lane at a time
// (dot_lane): the byte-plane split of each product, the plane sums into the
// rows that the scatter selects and the uint32_t recombination, the
// arithmetic that the host check holds to UBSan at every convolution of a
// lane.
#pragma once

#include "field.cuh"

namespace tpn {

constexpr int DOT_MT = 3;  // m-tiles: the 47 output limbs padded to 48
constexpr int DOT_NT = 4;  // n-tiles: a warp's 32 lanes, 8 a tile
constexpr int DOT_PLANES = 4;  // bytes of an int32 product
constexpr int DOT_OUT_ROW = 33;  // words a row of the totals: 32 lanes, padded
constexpr int DOT_PART1 = 32 * 4 * DOT_PLANES;  // staged words of k-rows 0..15, 32 lanes
constexpr int DOT_WARP_WORDS = DOT_PART1 + 32 * 2 * DOT_PLANES;  // and of k-rows 16..23
static_assert(16 * DOT_OUT_ROW <= DOT_WARP_WORDS, "a m-tile of totals fits the buffer");
static_assert(16 * DOT_MT >= NW, "the m-tiles cover the output limbs");

// The fragment maps above.
TPN_INLINE int a_row(int g, int q) { return g + 8 * (q & 1); }
TPN_INLINE int a_col(int t, int q, int e) { return 4 * t + e + 16 * (q >> 1); }
TPN_INLINE int b_row(int t, int q, int e) { return 4 * t + e + 16 * q; }
TPN_INLINE int d_row(int g, int q) { return g + 8 * (q >> 1); }
TPN_INLINE int d_col(int t, int q) { return 2 * t + (q & 1); }

// The int32 whose two's complement is u, without an implementation-defined
// conversion.
TPN_INLINE int32_t to_int32(uint32_t u) {
  return u < 0x80000000u ? static_cast<int32_t>(u)
                         : -static_cast<int32_t>(~u) - 1;
}

// A lane's 16 bytes at a word offset that is a multiple of 4: one 16-byte
// store or load on the card.
TPN_INLINE void store4(uint32_t* dst, const uint32_t* v) {
#if defined(__CUDACC__)
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
#else
  for (int b = 0; b < 4; ++b) dst[b] = v[b];
#endif
}

TPN_INLINE void load4(uint32_t* v, const uint32_t* src) {
#if defined(__CUDACC__)
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
#else
  for (int b = 0; b < 4; ++b) v[b] = src[b];
#endif
}

// The two's complement of pair (i, j)'s product, a_i·y_j; under HALF (y =
// a) a_i·a_i on the diagonal, a_i·(2a_j) for j > i and 0 for j < i.
template <bool HALF>
TPN_INLINE uint32_t dot_product(int32_t ai, const int32_t* y, int i, int j) {
  if constexpr (HALF) {
    const int32_t v = j < i ? 0 : (j == i ? y[j] : y[j] + y[j]);
    return static_cast<uint32_t>(ai * v);
  } else {
    return static_cast<uint32_t>(ai * y[j]);
  }
}

// Thread n stages step i: its lane's 24 products, word w (pairs 4w .. 4w +
// 3) of plane b holding byte b of each; the four planes of a word side by
// side, words 0..3 (k-rows 0..15) at (4n + w)·4, words 4, 5 (k-rows
// 16..23) at DOT_PART1 + (2n + w - 4)·4.
template <bool HALF>
TPN_INLINE void dot_stage(uint32_t* buf, int32_t ai, const int32_t* y, int i, int n) {
#pragma unroll
  for (int w = 0; w < NL / 4; ++w) {
    uint32_t p[4], word[DOT_PLANES] = {};
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = dot_product<HALF>(ai, y, i, 4 * w + e);
#pragma unroll
    for (int b = 0; b < DOT_PLANES; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) word[b] |= ((p[e] >> (8 * b)) & 0xFFu) << (8 * e);
    }
    store4(buf + (w < 4 ? (4 * n + w) * 4 : DOT_PART1 + (2 * n + w - 4) * 4), word);
  }
}

// Thread (g, t)'s B fragments of the staged step, (plane, n-tile,
// register): register 0 holds k-rows 4t .. 4t + 3, register 1 k-rows 16 +
// 4t .. 19 + 4t, zero past k-row 23 (t >= 2); every thread loads, so the
// warp stays converged.
TPN_INLINE void dot_load_b(uint32_t (*frag)[DOT_NT][2], const uint32_t* buf, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < DOT_NT; ++nt) {
    const int lane = 8 * nt + g;
    uint32_t lo[DOT_PLANES], hi[DOT_PLANES];
    load4(lo, buf + (4 * lane + t) * 4);
    load4(hi, buf + DOT_PART1 + (2 * lane + (t & 1)) * 4);
#pragma unroll
    for (int b = 0; b < DOT_PLANES; ++b) {
      frag[b][nt][0] = lo[b];
      frag[b][nt][1] = t < 2 ? hi[b] : 0u;
    }
  }
}

// Thread (g, t)'s A fragment register q of m-tile mt at step i: the
// scatter's shifted identity, byte e set where pair (i, 4t + 16(q >> 1) +
// e) sums into the register's row 16·mt + g + 8(q & 1).
TPN_INLINE uint32_t dot_a_word(int mt, int i, int g, int t, int q) {
  const int col = a_col(t, q, 0);
  const int e = 16 * mt + a_row(g, q) - i - col;
  return e >= 0 && e < 4 && col + e < NL ? 1u << (8 * e) : 0u;
}

// Whether step i's limbs i .. i + 23 reach m-tile mt.
TPN_INLINE bool dot_touch(int mt, int i) { return 16 * mt <= i + NL - 1 && 16 * mt + 15 >= i; }

// The four sums of one plane's mma into the running totals, at the plane's
// shift, wrapping.
TPN_INLINE void dot_accumulate(uint32_t* total, const int32_t* d, int plane) {
#pragma unroll
  for (int q = 0; q < 4; ++q) total[q] += static_cast<uint32_t>(d[q]) << (8 * plane);
}

// Thread (g, t)'s totals of m-tile mt into 16 rows of 33 words, and lane
// n's limbs 16·mt .. 16·mt + 15 out of them.
TPN_INLINE void dot_store_tile(uint32_t* buf, const uint32_t (*total)[4], int g, int t) {
#pragma unroll
  for (int nt = 0; nt < DOT_NT; ++nt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      buf[d_row(g, q) * DOT_OUT_ROW + 8 * nt + d_col(t, q)] = total[nt][q];
    }
  }
}

TPN_INLINE void dot_load_tile(int32_t* w, const uint32_t* buf, int mt, int n) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if (16 * mt + r < NW) w[16 * mt + r] = to_int32(buf[r * DOT_OUT_ROW + n]);
  }
}

#if defined(__CUDACC__)

// d = A·B of one m16n8k32 over the warp: A the scatter (.s8), B plane
// `plane` of the products (.u8 for planes 0-2, .s8 for the top byte).
template <int PLANE>
TPN_INLINE void mma_plane(int32_t* d, const uint32_t* a, const uint32_t* b) {
#if defined(__CUDA_ARCH__)
  if constexpr (PLANE == DOT_PLANES - 1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0));
  }
#endif
}

// w (47 limbs) = the contraction of the calling thread's lane n of its warp
// (n = laneid): the convolution of the limbs a and y, or under HALF (y = a)
// the half-product square of a; buf is the warp's DOT_WARP_WORDS words of
// shared memory (16-byte aligned).  Every thread of the warp calls it.
template <bool HALF>
TPN_INLINE void dot_warp(int32_t* w, const int32_t* a, const int32_t* y, uint32_t* buf, int n) {
  const int g = n >> 2, t = n & 3;
  int32_t ry[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) ry[j] = y[j];
  uint32_t total[DOT_MT][DOT_NT][4] = {};
#pragma unroll 1
  for (int i = 0; i < NL; ++i) {
    dot_stage<HALF>(buf, a[i], ry, i, n);
    __syncwarp();
    uint32_t b[DOT_PLANES][DOT_NT][2];
    dot_load_b(b, buf, g, t);
    __syncwarp();  // every fragment read before the next step's stores
#pragma unroll
    for (int mt = 0; mt < DOT_MT; ++mt) {
      if (!dot_touch(mt, i)) continue;
      uint32_t af[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) af[q] = dot_a_word(mt, i, g, t, q);
#pragma unroll
      for (int nt = 0; nt < DOT_NT; ++nt) {
        int32_t d[4];
        mma_plane<0>(d, af, b[0][nt]);
        dot_accumulate(total[mt][nt], d, 0);
        mma_plane<1>(d, af, b[1][nt]);
        dot_accumulate(total[mt][nt], d, 1);
        mma_plane<2>(d, af, b[2][nt]);
        dot_accumulate(total[mt][nt], d, 2);
        mma_plane<3>(d, af, b[3][nt]);
        dot_accumulate(total[mt][nt], d, 3);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < DOT_MT; ++mt) {
    dot_store_tile(buf, total[mt], g, t);
    __syncwarp();
    dot_load_tile(w, buf, mt, n);
    __syncwarp();  // every total read before the buffer is written again
  }
}

#if TPN_MUL_DOT

constexpr int DOT_BLOCK_WARPS = 4;  // the verify kernel's 128 threads

// The warps' staging buffers, one for each warp of a block, shared by
// conv_dot and sqr_dot.
__shared__ __align__(16) uint32_t dot_buf[DOT_BLOCK_WARPS][DOT_WARP_WORDS];

// field.cuh's conv under TPN_MUL_DOT: the calling lane's convolution, its
// warp converged first (a lane's sign branch can end just before a point
// formula).
TPN_NOINLINE void conv_dot(int32_t* w, const int32_t* a, const int32_t* b) {
  __syncwarp();
  dot_warp<false>(w, a, b, dot_buf[threadIdx.x >> 5], threadIdx.x & 31);
}

// field.cuh's sqr_conv under TPN_MUL_DOT: the half-product square.
TPN_NOINLINE void sqr_dot(int32_t* w, const int32_t* a) {
  __syncwarp();
  dot_warp<true>(w, a, a, dot_buf[threadIdx.x >> 5], threadIdx.x & 31);
}

#endif  // TPN_MUL_DOT

#else

// The byte of word u at position e, as the mma reads it: .s8 or .u8.
TPN_INLINE int32_t byte_of(uint32_t u, int e, bool is_signed) {
  const int32_t v = static_cast<int32_t>((u >> (8 * e)) & 0xFFu);
  return is_signed && v >= 128 ? v - 256 : v;
}

// One m16n8k32 over a warp's fragments: a (32 threads x 4) the .s8 A, b
// (32 x 2) the B (.s8 where b_signed, else .u8), d (32 x 4) = A·B.
TPN_INLINE void mma_host(int32_t (*d)[4], const uint32_t (*a)[4], const uint32_t (*b)[2],
                         bool b_signed) {
  int32_t am[16][32], bm[32][8];
  for (int n = 0; n < 32; ++n) {
    const int g = n >> 2, t = n & 3;
    for (int q = 0; q < 4; ++q) {
      for (int e = 0; e < 4; ++e) am[a_row(g, q)][a_col(t, q, e)] = byte_of(a[n][q], e, true);
    }
    for (int q = 0; q < 2; ++q) {
      for (int e = 0; e < 4; ++e) bm[b_row(t, q, e)][g] = byte_of(b[n][q], e, b_signed);
    }
  }
  for (int n = 0; n < 32; ++n) {
    const int g = n >> 2, t = n & 3;
    for (int q = 0; q < 4; ++q) {
      int32_t acc = 0;
      for (int k = 0; k < 32; ++k) acc += am[d_row(g, q)][k] * bm[k][d_col(t, q)];
      d[n][q] = acc;
    }
  }
}

// dot_warp for the warp's 32 threads in turn, stage by stage: w[n] (47
// limbs) for thread n's a[n] and y[n] (under HALF y = a).
template <bool HALF>
TPN_INLINE void dot_warp(int32_t (*w)[NW], const int32_t (*a)[NL], const int32_t (*y)[NL],
                         uint32_t* buf) {
  uint32_t total[32][DOT_MT][DOT_NT][4] = {};
  for (int i = 0; i < NL; ++i) {
    for (int n = 0; n < 32; ++n) dot_stage<HALF>(buf, a[n][i], y[n], i, n);
    uint32_t b[32][DOT_PLANES][DOT_NT][2];
    for (int n = 0; n < 32; ++n) dot_load_b(b[n], buf, n >> 2, n & 3);
    for (int mt = 0; mt < DOT_MT; ++mt) {
      if (!dot_touch(mt, i)) continue;
      uint32_t af[32][4];
      for (int n = 0; n < 32; ++n) {
        for (int q = 0; q < 4; ++q) af[n][q] = dot_a_word(mt, i, n >> 2, n & 3, q);
      }
      for (int nt = 0; nt < DOT_NT; ++nt) {
        for (int plane = 0; plane < DOT_PLANES; ++plane) {
          uint32_t bf[32][2];
          int32_t d[32][4];
          for (int n = 0; n < 32; ++n) {
            bf[n][0] = b[n][plane][nt][0];
            bf[n][1] = b[n][plane][nt][1];
          }
          mma_host(d, af, bf, plane == DOT_PLANES - 1);
          for (int n = 0; n < 32; ++n) dot_accumulate(total[n][mt][nt], d[n], plane);
        }
      }
    }
  }
  for (int mt = 0; mt < DOT_MT; ++mt) {
    for (int n = 0; n < 32; ++n) dot_store_tile(buf, total[n][mt], n >> 2, n & 3);
    for (int n = 0; n < 32; ++n) dot_load_tile(w[n], buf, mt, n);
  }
}

#if TPN_MUL_DOT

// One lane's contraction, as the mma planes compute it: each product's four
// bytes (three .u8, the top .s8) summed into the row that the scatter
// selects for its pair (i + j), then the planes recombined in wrapping
// uint32_t.
template <bool HALF>
TPN_INLINE void dot_lane(int32_t* w, const int32_t* a, const int32_t* y) {
  int32_t plane[DOT_PLANES][NW] = {};
  for (int i = 0; i < NL; ++i) {
    for (int j = 0; j < NL; ++j) {
      const uint32_t p = dot_product<HALF>(a[i], y, i, j);
      for (int b = 0; b < DOT_PLANES; ++b) {
        plane[b][i + j] += byte_of(p, b, b == DOT_PLANES - 1);
      }
    }
  }
  for (int k = 0; k < NW; ++k) {
    uint32_t u = 0;
    for (int b = 0; b < DOT_PLANES; ++b) u += static_cast<uint32_t>(plane[b][k]) << (8 * b);
    w[k] = to_int32(u);
  }
}

TPN_NOINLINE void conv_dot(int32_t* w, const int32_t* a, const int32_t* b) {
  TPN_COUNT(conv_dot);
  dot_lane<false>(w, a, b);
}

TPN_NOINLINE void sqr_dot(int32_t* w, const int32_t* a) {
  TPN_COUNT(sqr_dot);
  dot_lane<true>(w, a, a);
}

#endif  // TPN_MUL_DOT

#endif

}  // namespace tpn

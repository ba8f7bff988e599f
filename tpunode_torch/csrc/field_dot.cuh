// The dot_general formulation's convolution on Hopper's integer tensor
// cores: conv_dot_warp, the contraction of diag.cu's field_mul_dot probe.
//
// Replaces the contraction inside benchmarks/mosaic_diag.py:123
// (_field_mul_dot: _field_mul's pallas_call at :114 under
// mul="dot_general"), pallas_field._conv_dot: the (576, B) partial
// products a_i·b_j, pair c = 24·i + j, contracted with the (47, 576)
// anti-diagonal scatter by one int32 dot_general.  Here a warp contracts
// its 32 lanes, one lane a thread, as D (48 x 32) = S (48 x 576) · P (576 x
// 32) by mma.sync.aligned.m16n8k32 (8-bit operands, int32 sums): M = the
// 47 output limbs padded to 48 (three m-tiles of 16), K = the 576 pairs
// (18 k-steps of 32), N = the warp's lanes (four n-tiles of 8).
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
// Loop order.  The k-steps run outermost, unrolled, so the products index
// the lane's limbs by constants and stay in registers.  In each k-step every
// thread writes its lane's 32 products as four plane rows of 8 words to the
// warp's shared memory (B-fragment order: a lane's row holds its 32 pairs'
// bytes, padded to 12 words so that an n-tile's 8 lanes read 8 distinct
// banks), __syncwarp, reads its B fragments (4 planes x 4 n-tiles x 2
// words), __syncwarp, and then for each m-tile builds its A fragment from
// indices (entry (row r, pair c) is 1 iff c / 24 + c % 24 == r: no table,
// as pallas_field._mul_scatter builds it from iota) and runs the 16 mma of
// the 4 planes x 4 n-tiles, each from zero, adding its 4 sums into the
// lane's running totals at its plane's shift.  So a thread keeps 48 total
// words (3 m-tiles x 4 n-tiles x 4), not the 192 of four planes' separate
// accumulators.  864 mma a warp: 3 x 18 x 4 x 4.  The totals then go through
// the same shared memory (48 rows of 33 words) back to one lane a thread.
// Shared memory: DOT_WARP_WORDS words (6,336 B) a warp.  Every thread of the
// warp must reach every mma and __syncwarp: the caller stages lanes it does
// not own as zeros and only skips their stores, never returns early.
//
// What bounds it.  The 576 products stay on the FMA pipe and the reduction
// and canonical form on the ALU pipe, as in the shift-add conv; only the
// anti-diagonal adds move to the tensor cores, which do 47 times the
// multiply-adds of the dense scatter (110,592 int8 a lane), a few µs at
// 32,768 lanes at the data sheet's rate.  The byte transposes, the A
// fragments built from indices, the per-k-step recombination and the
// shared-memory staging add int32 issue work, so int32 issue, not the
// tensor cores, bounds it, and it is no faster than shift-add.  The design
// is the simple, right one, to measure that: wgmma, TMA and a scatter table
// in shared memory are later work.
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
// only the card's comparison with the shift-add probe catches that.
#pragma once

#include "field.cuh"

namespace tpn {

constexpr int DOT_MT = 3;  // m-tiles: the 47 output limbs padded to 48
constexpr int DOT_KS = 18;  // k-steps: 576 pairs, 32 a step
constexpr int DOT_NT = 4;  // n-tiles: a warp's 32 lanes, 8 a tile
constexpr int DOT_PLANES = 4;  // bytes of an int32 product
constexpr int DOT_STAGE_ROW = 12;  // words a lane's row of a plane: 8, padded
constexpr int DOT_STAGE_PLANE = 32 * DOT_STAGE_ROW;
constexpr int DOT_OUT_ROW = 33;  // words a row of the totals: 32 lanes, padded
constexpr int DOT_WARP_WORDS = 16 * DOT_MT * DOT_OUT_ROW;  // a warp's shared memory
static_assert(DOT_PLANES * DOT_STAGE_PLANE <= DOT_WARP_WORDS, "the staging fits the buffer");
static_assert(16 * DOT_MT >= NW && 32 * DOT_KS == NL * NL, "the tiles cover the contraction");

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

// Thread n stages its lane's products of k-step ks, pairs c = 32·ks + 4·w +
// e, as plane b's word w: byte e of it is byte b of that pair's product.
TPN_INLINE void dot_stage(uint32_t* buf, const int32_t* x, const int32_t* y, int ks, int n) {
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    uint32_t p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 32 * ks + 4 * w + e;
      p[e] = static_cast<uint32_t>(x[c / NL] * y[c % NL]);
    }
#pragma unroll
    for (int b = 0; b < DOT_PLANES; ++b) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) word |= ((p[e] >> (8 * b)) & 0xFFu) << (8 * e);
      buf[b * DOT_STAGE_PLANE + n * DOT_STAGE_ROW + w] = word;
    }
  }
}

// Thread (g, t)'s B fragments of the staged k-step: (plane, n-tile, register).
TPN_INLINE void dot_load_b(uint32_t (*frag)[DOT_NT][2], const uint32_t* buf, int g, int t) {
#pragma unroll
  for (int b = 0; b < DOT_PLANES; ++b) {
#pragma unroll
    for (int nt = 0; nt < DOT_NT; ++nt) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        frag[b][nt][q] = buf[b * DOT_STAGE_PLANE + (8 * nt + g) * DOT_STAGE_ROW + b_row(t, q, 0) / 4];
      }
    }
  }
}

// Thread (g, t)'s A fragment of m-tile mt at k-step ks: the scatter's
// entries, 1 where the pair's limbs sum to the row.
TPN_INLINE void dot_a_frag(uint32_t* frag, int mt, int ks, int g, int t) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = 16 * mt + a_row(g, q);
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 32 * ks + a_col(t, q, e);
      word |= static_cast<uint32_t>(c / NL + c % NL == row) << (8 * e);
    }
    frag[q] = word;
  }
}

// The four sums of one plane's mma into the running totals, at the plane's
// shift, wrapping.
TPN_INLINE void dot_accumulate(uint32_t* total, const int32_t* d, int plane) {
#pragma unroll
  for (int q = 0; q < 4; ++q) total[q] += static_cast<uint32_t>(d[q]) << (8 * plane);
}

// Thread (g, t)'s totals into the (48, 33) rows of the buffer.
TPN_INLINE void dot_store_totals(uint32_t* buf, const uint32_t (*total)[DOT_NT][4], int g, int t) {
#pragma unroll
  for (int mt = 0; mt < DOT_MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < DOT_NT; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        buf[(16 * mt + d_row(g, q)) * DOT_OUT_ROW + 8 * nt + d_col(t, q)] = total[mt][nt][q];
      }
    }
  }
}

// Lane n's 47 output limbs from the buffer.
TPN_INLINE void dot_load_wide(int32_t* w, const uint32_t* buf, int n) {
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] = to_int32(buf[k * DOT_OUT_ROW + n]);
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

// w (47 limbs) = the convolution of the carried limbs x and y, for the
// calling thread's lane n of its warp (n = laneid); buf is the warp's
// DOT_WARP_WORDS words of shared memory.  Every thread of the warp calls
// it.
TPN_INLINE void conv_dot_warp(int32_t* w, const int32_t* x, const int32_t* y, uint32_t* buf,
                              int n) {
  const int g = n >> 2, t = n & 3;
  uint32_t total[DOT_MT][DOT_NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < DOT_KS; ++ks) {
    dot_stage(buf, x, y, ks, n);
    __syncwarp();
    uint32_t b[DOT_PLANES][DOT_NT][2];
    dot_load_b(b, buf, g, t);
    __syncwarp();  // every fragment read before the next k-step's stores
#pragma unroll
    for (int mt = 0; mt < DOT_MT; ++mt) {
      uint32_t a[4];
      dot_a_frag(a, mt, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < DOT_NT; ++nt) {
        int32_t d[4];
        mma_plane<0>(d, a, b[0][nt]);
        dot_accumulate(total[mt][nt], d, 0);
        mma_plane<1>(d, a, b[1][nt]);
        dot_accumulate(total[mt][nt], d, 1);
        mma_plane<2>(d, a, b[2][nt]);
        dot_accumulate(total[mt][nt], d, 2);
        mma_plane<3>(d, a, b[3][nt]);
        dot_accumulate(total[mt][nt], d, 3);
      }
    }
  }
  dot_store_totals(buf, total, g, t);
  __syncwarp();
  dot_load_wide(w, buf, n);
  __syncwarp();  // every total read before the buffer is staged again
}

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

// conv_dot_warp for the warp's 32 threads in turn, stage by stage: w[n]
// (47 limbs) for thread n's carried x[n] and y[n].
TPN_INLINE void conv_dot_warp(int32_t (*w)[NW], const int32_t (*x)[NL], const int32_t (*y)[NL],
                              uint32_t* buf) {
  uint32_t total[32][DOT_MT][DOT_NT][4] = {};
  for (int ks = 0; ks < DOT_KS; ++ks) {
    for (int n = 0; n < 32; ++n) dot_stage(buf, x[n], y[n], ks, n);
    uint32_t b[32][DOT_PLANES][DOT_NT][2];
    for (int n = 0; n < 32; ++n) dot_load_b(b[n], buf, n >> 2, n & 3);
    for (int mt = 0; mt < DOT_MT; ++mt) {
      uint32_t a[32][4];
      for (int n = 0; n < 32; ++n) dot_a_frag(a[n], mt, ks, n >> 2, n & 3);
      for (int nt = 0; nt < DOT_NT; ++nt) {
        for (int plane = 0; plane < DOT_PLANES; ++plane) {
          uint32_t bf[32][2];
          int32_t d[32][4];
          for (int n = 0; n < 32; ++n) {
            bf[n][0] = b[n][plane][nt][0];
            bf[n][1] = b[n][plane][nt][1];
          }
          mma_host(d, a, bf, plane == DOT_PLANES - 1);
          for (int n = 0; n < 32; ++n) dot_accumulate(total[n][mt][nt], d[n], plane);
        }
      }
    }
  }
  for (int n = 0; n < 32; ++n) dot_store_totals(buf, total[n], n >> 2, n & 3);
  for (int n = 0; n < 32; ++n) dot_load_wide(w[n], buf, n);
}

#endif

}  // namespace tpn

// secp256k1 field arithmetic on Hopper's widening multiply: 8 words of 32 bits.
//
// The field layer of verify_u32.cu, the main path's verify kernel (4-bit
// windows, projective, lazy, tree select, half-product square, shift-add:
// the default mode tuple), and of verify_u32_modes.cu (the same arithmetic
// at other mode tuples).  The reference's radix-11 x 24 int32 limbs
// (field.cuh) exist because a TPU has no wide integers; Hopper has a
// 32 x 32 -> 64 multiply (IMAD.WIDE.U32) and carry-chained adds (IADD3.X),
// so an element is 8 little-endian uint32_t words and a product is 64
// partial products, reduced by secp256k1's own fold 2^256 ≡ 2^32 + 977
// (mod p) instead of the reference's 2^264 fold over 11-bit limbs.
//
// Every element is weakly reduced: a value in [0, 2^256), congruent mod p to
// the number it stands for, not necessarily below p.  mul, sqr, add, sub and
// mul_small all return weakly reduced values for weakly reduced inputs;
// canonical() is one conditional subtraction of p (2^256 < 2p).  Every
// function is written over uint64_t partial products and sums, so the same
// source compiles as host C++ (tests/test_torch_u32.py builds it under
// UBSan and holds it against Python integers) and nvcc turns each
// (uint64_t)a * b + c into IMAD.WIDE.U32 and each 64-bit add into an
// IADD3 and an IADD3.X or IMAD.X (PERF.md §6 counts the SASS).  Unsigned
// overflow is defined, so a dropped carry is a wrong value, not undefined
// behaviour: the tests compare values at the carries' edges.  Every function is inlined (TPN_INLINE): an element lives
// in registers, and no operand crosses the thread's stack.
//
// The names live in tpn::u32, beside the radix-11 layer's tpn names, so a
// translation unit may include both (diag.cu's field_mul_u32 probe does).
#pragma once

#include <stdint.h>

#if !defined(TPN_INLINE)
#if defined(__CUDACC__)
#define TPN_INLINE __device__ __forceinline__
#define TPN_NOINLINE __device__ __noinline__
#define TPN_CONSTANT __constant__
#else
#define TPN_INLINE static inline
#define TPN_NOINLINE static
#define TPN_CONSTANT static const
#endif
#endif
#if !defined(TPN_MEMBER)
#if defined(__CUDACC__)
#define TPN_MEMBER __device__ __forceinline__  // a static member function, inlined
#else
#define TPN_MEMBER inline
#endif
#endif

namespace tpn {
namespace u32 {

constexpr int NWORDS = 8;  // words of an element
constexpr int NWIDE = 16;  // words of an unreduced product
constexpr uint32_t FOLD_LO = 977;  // 2^256 mod p = 2^32 + 977

struct Fe {
  uint32_t w[NWORDS];
};

TPN_INLINE Fe fe_small(uint32_t v) {
  Fe x;
  x.w[0] = v;
#pragma unroll
  for (int i = 1; i < NWORDS; ++i) x.w[i] = 0;
  return x;
}

// x += c·(2^32 + 977) for c < 2^34; returns the carry out of 2^256 (0 or 1).
TPN_INLINE uint32_t add_fold_once(Fe& x, uint64_t c) {
  uint64_t t = static_cast<uint64_t>(x.w[0]) + c * FOLD_LO;  // c·977 < 2^44
  x.w[0] = static_cast<uint32_t>(t);
  t = (t >> 32) + x.w[1] + c;
  x.w[1] = static_cast<uint32_t>(t);
  t >>= 32;
#pragma unroll
  for (int i = 2; i < NWORDS; ++i) {
    t += x.w[i];
    x.w[i] = static_cast<uint32_t>(t);
    t >>= 32;
  }
  return static_cast<uint32_t>(t);
}

// x + c·2^256 ≡ x + c·(2^32 + 977) for c < 2^34, weakly reduced.  The first
// fold may carry out once; then the low 256 bits are below c·(2^32 + 977) <
// 2^67, so folding that carry cannot carry again.
TPN_INLINE void fold(Fe& x, uint64_t c) {
  const uint32_t carry = add_fold_once(x, c);
  add_fold_once(x, carry);
}

// x -= c·(2^32 + 977) for c in {0, 1}; returns the borrow (0 or 1).
TPN_INLINE uint32_t sub_fold_once(Fe& x, uint32_t c) {
  uint64_t t = static_cast<uint64_t>(x.w[0]) - c * FOLD_LO;
  x.w[0] = static_cast<uint32_t>(t);
  uint32_t borrow = static_cast<uint32_t>(t >> 63);
  t = static_cast<uint64_t>(x.w[1]) - c - borrow;
  x.w[1] = static_cast<uint32_t>(t);
  borrow = static_cast<uint32_t>(t >> 63);
#pragma unroll
  for (int i = 2; i < NWORDS; ++i) {
    t = static_cast<uint64_t>(x.w[i]) - borrow;
    x.w[i] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  return borrow;
}

// a + b, weakly reduced: the carry out of 2^256 folded back.
TPN_INLINE Fe add(const Fe& a, const Fe& b) {
  Fe x;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) {
    c += static_cast<uint64_t>(a.w[i]) + b.w[i];
    x.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  fold(x, c);
  return x;
}

// a - b, weakly reduced.  A borrow leaves a - b + 2^256 ≡ a - b + 2^32 + 977,
// so 2^32 + 977 is taken off; if that borrows again (the wrapped value was
// below it), once more, and then the value is at least 2^256 - 2(2^32 + 977):
// no third borrow.
TPN_INLINE Fe sub(const Fe& a, const Fe& b) {
  Fe x;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) {
    const uint64_t t = static_cast<uint64_t>(a.w[i]) - b.w[i] - borrow;
    x.w[i] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  borrow = sub_fold_once(x, borrow);
  sub_fold_once(x, borrow);
  return x;
}

TPN_INLINE Fe neg(const Fe& a) { return sub(fe_small(0), a); }

// a·k for a small constant k (k < 2^32), weakly reduced: the ninth word
// (below k) folded back.
TPN_INLINE Fe mul_small(const Fe& a, uint32_t k) {
  Fe x;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) {
    c += static_cast<uint64_t>(a.w[i]) * k;
    x.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  fold(x, c);
  return x;
}

// The 512-bit product, operand scanning: row i adds a_i·b into r[i..i+8].
// Each step is (2^32-1)^2 + 2(2^32-1) = 2^64 - 1 at most: no overflow.
TPN_INLINE void mul_wide(uint32_t* r, const Fe& a, const Fe& b) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NWORDS; ++j) {
    c = static_cast<uint64_t>(a.w[0]) * b.w[j] + (c >> 32);
    r[j] = static_cast<uint32_t>(c);
  }
  r[NWORDS] = static_cast<uint32_t>(c >> 32);
#pragma unroll
  for (int i = 1; i < NWORDS; ++i) {
    c = 0;
#pragma unroll
    for (int j = 0; j < NWORDS; ++j) {
      c = static_cast<uint64_t>(a.w[i]) * b.w[j] + r[i + j] + (c >> 32);
      r[i + j] = static_cast<uint32_t>(c);
    }
    r[i + NWORDS] = static_cast<uint32_t>(c >> 32);
  }
}

// The 512-bit square: the 28 cross products a_i·a_j (i < j) once, doubled
// by a one-bit shift, then the 8 squares a_i^2 added on the diagonal.
TPN_INLINE void sqr_wide(uint32_t* r, const Fe& a) {
  uint64_t c = 0;
  r[0] = 0;
#pragma unroll
  for (int j = 1; j < NWORDS; ++j) {
    c = static_cast<uint64_t>(a.w[0]) * a.w[j] + (c >> 32);
    r[j] = static_cast<uint32_t>(c);
  }
  r[NWORDS] = static_cast<uint32_t>(c >> 32);
#pragma unroll
  for (int i = 1; i < NWORDS - 1; ++i) {
    c = 0;
#pragma unroll
    for (int j = i + 1; j < NWORDS; ++j) {
      c = static_cast<uint64_t>(a.w[i]) * a.w[j] + r[i + j] + (c >> 32);
      r[i + j] = static_cast<uint32_t>(c);
    }
    r[i + NWORDS] = static_cast<uint32_t>(c >> 32);
  }
  r[NWIDE - 1] = 0;
  // the cross sum is below 2^511: doubling it fits 16 words
#pragma unroll
  for (int k = NWIDE - 1; k > 0; --k) r[k] = (r[k] << 1) | (r[k - 1] >> 31);
  r[0] <<= 1;
  c = 0;
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) {
    const uint64_t d = static_cast<uint64_t>(a.w[i]) * a.w[i];
    c += static_cast<uint64_t>(r[2 * i]) + static_cast<uint32_t>(d);
    r[2 * i] = static_cast<uint32_t>(c);
    c = (c >> 32) + r[2 * i + 1] + (d >> 32);
    r[2 * i + 1] = static_cast<uint32_t>(c);
    c >>= 32;
  }
}

// r mod p, weakly reduced: lo + hi·977 + hi·2^32 in one pass (each column
// below 2^43), its top (below 2^33) folded by fold().
TPN_INLINE Fe reduce_wide(const uint32_t* r) {
  Fe x;
  uint64_t c = static_cast<uint64_t>(r[0]) + static_cast<uint64_t>(r[NWORDS]) * FOLD_LO;
  x.w[0] = static_cast<uint32_t>(c);
  c >>= 32;
#pragma unroll
  for (int i = 1; i < NWORDS; ++i) {
    c += static_cast<uint64_t>(r[i]) + static_cast<uint64_t>(r[NWORDS + i]) * FOLD_LO +
         r[NWORDS + i - 1];
    x.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  fold(x, c + r[NWIDE - 1]);
  return x;
}

TPN_INLINE Fe mul(const Fe& a, const Fe& b) {
  uint32_t r[NWIDE];
  mul_wide(r, a, b);
  return reduce_wide(r);
}

TPN_INLINE Fe sqr(const Fe& a) {
  uint32_t r[NWIDE];
  sqr_wide(r, a);
  return reduce_wide(r);
}

// The square of the field_sqr mode: the half product sqr (28 cross products
// once) or, under SQR_MUL (TPUNODE_FIELD_SQR=mul), the full product mul(a, a).
template <bool SQR_MUL>
TPN_INLINE Fe square(const Fe& a) {
  if constexpr (SQR_MUL) {
    return mul(a, a);
  } else {
    return sqr(a);
  }
}

// The multiply of a mode tuple as the point formulas, the pows and the
// verify program take it: F::mul(a, b) and F::sqr(a), the square of the
// field_sqr mode.  ShiftAdd is this file's: each lane multiplies alone on the
// widening multiply (WARP false).  field_u32_dot.cuh's DotMul contracts a
// warp's products on the tensor cores (WARP true: every lane of the warp must
// reach every product).
template <bool SQR_MUL>
struct ShiftAdd {
  static constexpr bool WARP = false;
  TPN_MEMBER static Fe mul(const Fe& a, const Fe& b) { return tpn::u32::mul(a, b); }
  TPN_MEMBER static Fe sqr(const Fe& a) { return square<SQR_MUL>(a); }
};

// The representative in [0, p): x - p where x + 2^32 + 977 carries out of
// 2^256 (x >= p), else x.  One subtraction suffices: x < 2^256 < 2p.
TPN_INLINE Fe canonical(const Fe& a) {
  Fe y = a;
  const uint32_t ge = add_fold_once(y, 1);
  const uint32_t keep = ge - 1u;  // all ones where x < p
  Fe x;
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) x.w[i] = (a.w[i] & keep) | (y.w[i] & ~keep);
  return x;
}

TPN_INLINE bool is_zero(const Fe& a) {
  const Fe c = canonical(a);
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) any |= c.w[i];
  return any == 0;
}

TPN_INLINE bool eq(const Fe& a, const Fe& b) { return is_zero(sub(a, b)); }

// where ? b : a, word by word.
TPN_INLINE Fe select(const Fe& a, const Fe& b, bool where) {
  const uint32_t m = 0u - static_cast<uint32_t>(where);
  Fe x;
#pragma unroll
  for (int i = 0; i < NWORDS; ++i) x.w[i] = (a.w[i] & ~m) | (b.w[i] & m);
  return x;
}

// One lane's element from limb rows (24, B), lane-minor, radix 2^11: the
// value Σ limb_i·2^(11i) mod p for any int32 limbs (the prep writes
// canonical ones below 2^264; mul's loose contract, ±2^19, is exact too).
// The limbs are summed into a signed 64-bit window that gives up one word
// each time 32 bits are complete; what is left above 2^256 (|top| < 2^40)
// is folded by 2^256 ≡ 2^32 + 977: added, or taken off with its borrow
// folded as sub() folds one.
TPN_INLINE Fe from_radix11(const int32_t* rows, int B, int lane) {
  Fe x;
  int64_t acc = 0;
  int bits = 0, k = 0;
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    acc += static_cast<int64_t>(rows[i * B + lane]) * (static_cast<int64_t>(1) << bits);
    bits += 11;
    if (bits >= 32 && k < NWORDS) {
      x.w[k++] = static_cast<uint32_t>(static_cast<uint64_t>(acc));
      acc = (acc - static_cast<int64_t>(static_cast<uint32_t>(static_cast<uint64_t>(acc)))) /
            (static_cast<int64_t>(1) << 32);
      bits -= 32;
    }
  }
  // 24 limbs: 264 bits; words 0..7 are out, acc holds the value's top above 2^256
  if (acc >= 0) {
    fold(x, static_cast<uint64_t>(acc));
  } else {
    const uint64_t m = static_cast<uint64_t>(-acc);  // take off m·(2^32 + 977)
    uint64_t t = static_cast<uint64_t>(x.w[0]) - m * FOLD_LO;
    x.w[0] = static_cast<uint32_t>(t);
    // the borrow out of each word: the high half of t, as a signed count
    int64_t carry = static_cast<int64_t>(t) >> 32;
    t = static_cast<uint64_t>(static_cast<int64_t>(x.w[1]) - static_cast<int64_t>(m) + carry);
    x.w[1] = static_cast<uint32_t>(t);
    carry = static_cast<int64_t>(t) >> 32;
#pragma unroll
    for (int i = 2; i < NWORDS; ++i) {
      t = static_cast<uint64_t>(static_cast<int64_t>(x.w[i]) + carry);
      x.w[i] = static_cast<uint32_t>(t);
      carry = static_cast<int64_t>(t) >> 32;
    }
    // carry is 0 or -1: a borrow out of 2^256 leaves the value + 2^256
    const uint32_t borrow = sub_fold_once(x, static_cast<uint32_t>(-carry));
    sub_fold_once(x, borrow);
  }
  return x;
}

// A canonical element as 24 radix-2^11 limbs, into limb rows (24, B).
TPN_INLINE void to_radix11(int32_t* rows, const Fe& a, int B, int lane) {
#pragma unroll
  for (int i = 0; i < 24; ++i) {
    const int bit = 11 * i, word = bit / 32, shift = bit % 32;
    uint64_t v = a.w[word] >> shift;
    if (shift > 21 && word + 1 < NWORDS) v |= static_cast<uint64_t>(a.w[word + 1]) << (32 - shift);
    rows[i * B + lane] = static_cast<int32_t>(v & 0x7FF);
  }
}

// ---- constant-exponent pows: a 4-bit table and 64 windows ----

constexpr int POW_TABLE = 16;

// (p-1)/2 (Euler) and p-2 (Fermat inverse), little-endian words; window w
// (most significant first) reads its digit from these __constant__ words:
// every thread reads the same address, a broadcast.
TPN_CONSTANT uint32_t EULER_EXP[NWORDS] = {0x7FFFFE17u, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                           0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu};
TPN_CONSTANT uint32_t PM2_EXP[NWORDS] = {0xFFFFFC2Du, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                         0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};

// t^((p-1)/2) (euler) or t^(p-2) under the multiply F: the table [1, t, ..,
// t^15] by sequential multiplies in local memory, then 64 windows of four
// squarings (F::sqr) and one multiply by the entry of the window's digit
// (field.cuh's pow_const, the reference's scan ladder).  The digits are the
// same in every lane, so a warp stays converged.
template <class F>
TPN_INLINE Fe pow_by(const Fe& t, bool euler) {
  Fe tab[POW_TABLE];
  tab[0] = fe_small(1);
  tab[1] = t;
#pragma unroll 1
  for (int k = 2; k < POW_TABLE; ++k) tab[k] = F::mul(tab[k - 1], t);
  const uint32_t* e = euler ? EULER_EXP : PM2_EXP;
  Fe acc = fe_small(1);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    acc = F::sqr(acc);
    acc = F::sqr(acc);
    acc = F::sqr(acc);
    acc = F::sqr(acc);
    const int digit = (e[NWORDS - 1 - w / 8] >> (28 - 4 * (w % 8))) & 0xF;
    acc = F::mul(acc, tab[digit]);
  }
  return acc;
}

// pow_by under shift-add, every square a square<SQR_MUL>.
template <bool SQR_MUL = false>
TPN_INLINE Fe pow_const(const Fe& t, bool euler) {
  return pow_by<ShiftAdd<SQR_MUL>>(t, euler);
}

}  // namespace u32
}  // namespace tpn

// secp256k1 field arithmetic for the verify kernel: radix-11 x 24 int32 limbs.
//
// Device transcription of the plain version (tpunode_torch/verify/field.py)
// with the SAME carry/fold schedule, op for op: the carry rounds of _carry,
// _fold_once over 48 then 28 limbs, _fold_top, reduce_wide and
// reduce_wide_loose.  Keeping the schedule is what makes the int32 headroom
// replay in verify/bounds.py a proof for this code too: signed overflow is
// undefined behaviour in C++, and that replay is the only guard against it.
// Summation order inside a convolution may differ from the plain version's;
// the replay bounds sums of magnitudes, so no order can overflow, and the
// integer results are identical.
//
// A field element is int32_t[NL]; an unreduced product is int32_t[NW].
// Limbs may be loose and negative: & MASK and arithmetic >> RADIX keep every
// carry round exact, and the top limb keeps its overflow in place.  Left
// shifts of possibly negative values are written as multiplications, which
// are defined.
//
// A square runs one of the reference's two formulations, picked at compile
// time by the SQR_MUL template parameter of sqr, sqr_t, pow_const (and the
// doublings and the kernel above them): the half product sqr_conv
// (TPUNODE_FIELD_SQR=half) or the general convolution conv(a, a) (=mul).
// Every output limb is the same; the parameter has no default, so no call
// site can fall back to the half product without naming it.
//
// A multiply runs one of the reference's two formulations, picked at
// compile time by the TPN_MUL_DOT macro (TPUNODE_FIELD_MUL; 0 when not
// defined): the shift-add sums below (shift_add), or under TPN_MUL_DOT=1
// the dot_general contraction on the tensor cores, conv_dot and sqr_dot of
// field_dot.cuh (dot_general), which conv and sqr_conv then call.  Those are
// warp-collective: every thread of a warp must reach each convolution
// together (verify_kernel.cu keeps its warps converged where they would part).
// Every output limb is the same.
//
// The same header compiles as host C++ (no __CUDACC__), so the per-lane
// program can be checked against the plain version without a card.  A host
// build may define TPN_COUNT(counter) before including it to count the
// calls of the convolutions; a device build compiles it to nothing.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define TPN_INLINE __device__ __forceinline__
#define TPN_NOINLINE __device__ __noinline__
#define TPN_CONSTANT __constant__
#else
#define TPN_INLINE static inline
#define TPN_NOINLINE static
#define TPN_CONSTANT static const
#endif

#if defined(__CUDACC__) || !defined(TPN_COUNT)
#undef TPN_COUNT
#define TPN_COUNT(counter) ((void)0)
#endif

#if !defined(TPN_MUL_DOT)
#define TPN_MUL_DOT 0
#endif

namespace tpn {

constexpr int RADIX = 11;
constexpr int NL = 24;  // limbs of a field element
constexpr int NW = 2 * NL - 1;  // limbs of an unreduced product
constexpr int32_t MASK = (1 << RADIX) - 1;
constexpr bool MUL_DOT = TPN_MUL_DOT != 0;  // this build's multiply: dot_general

// p, and the multiple of p that canonical() adds so loose values turn
// positive (25 limbs; field._BIG_LIMBS).
TPN_CONSTANT int32_t P_LIMBS[NL] = {
    1071, 2047, 1023, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047,
    2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 7};
TPN_CONSTANT int32_t BIG_LIMBS[NL + 1] = {
    1071, 1070, 1023, 1023, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047,
    2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 2047, 7,    8};

// 2^264 mod p = 256*(2^32+977) and 2^256 mod p = 2^32+977, 4 limbs each.
TPN_INLINE int32_t fold_c(int i) {
  return i == 0 ? 256 : (i == 1 ? 122 : (i == 2 ? 0 : 128));
}
TPN_INLINE int32_t c256_c(int i) {
  return i == 0 ? 977 : (i == 2 ? 1024 : 0);
}

// One carry round over N limbs (field._carry): lo = x & MASK, hi = x >> R,
// limb i gains hi[i-1]; the top limb is x[N-1] + hi[N-2] (its own overflow
// stays in place: (x & MASK) + (x >> R) * 2^R == x).
template <int N>
TPN_INLINE void carry(int32_t* x) {
  int32_t hi[N];
#pragma unroll
  for (int i = 0; i < N; ++i) hi[i] = x[i] >> RADIX;
  const int32_t top = x[N - 1] + hi[N - 2];
#pragma unroll
  for (int i = N - 2; i > 0; --i) x[i] = (x[i] & MASK) + hi[i - 1];
  x[0] = x[0] & MASK;
  x[N - 1] = top;
}

template <int N>
TPN_INLINE void carry_rounds(int32_t* x, int rounds) {
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) carry<N>(x);
}

TPN_INLINE void copy(int32_t* out, const int32_t* a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = a[i];
}

TPN_INLINE void set_small(int32_t* out, int32_t v) {
  out[0] = v;
#pragma unroll
  for (int i = 1; i < NL; ++i) out[i] = 0;
}

// One lane's field element from limb rows (24, B), lane-minor, and back.
TPN_INLINE void load_col(int32_t* out, const int32_t* rows, int B, int lane) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = rows[i * B + lane];
}

TPN_INLINE void store_col(int32_t* rows, const int32_t* x, int B, int lane) {
#pragma unroll
  for (int i = 0; i < NL; ++i) rows[i * B + lane] = x[i];
}

TPN_INLINE void add(int32_t* out, const int32_t* a, const int32_t* b) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = a[i] + b[i];
}

// field._fold_top: carry into a 25th limb, fold it back via 2^264 ≡ FOLD.
TPN_INLINE void fold_top(int32_t* x) {
  int32_t t[NL + 1];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = x[i];
  t[NL] = 0;
  carry<NL + 1>(t);
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = t[i];
#pragma unroll
  for (int f = 0; f < 4; ++f) x[f] += fold_c(f) * t[NL];
}

// Whether any lane of the calling warp has p set: __any_sync over the full
// warp on the card; without __CUDACC__ a lane is a warp of its own.
TPN_INLINE bool warp_any(bool p) {
#if defined(__CUDACC__)
  return __any_sync(0xFFFFFFFFu, p);
#else
  return p;
#endif
}

#if TPN_MUL_DOT

// The dot_general formulation (field_dot.cuh): conv and sqr_conv contract
// on the tensor cores, every output limb theirs.
TPN_NOINLINE void conv_dot(int32_t* w, const int32_t* a, const int32_t* b);
TPN_NOINLINE void sqr_dot(int32_t* w, const int32_t* a);
TPN_INLINE void conv(int32_t* w, const int32_t* a, const int32_t* b) { conv_dot(w, a, b); }
TPN_INLINE void sqr_conv(int32_t* w, const int32_t* a) { sqr_dot(w, a); }

#else

// field.mul_t_wide / field._conv: the 24x24 limb convolution.
TPN_NOINLINE void conv(int32_t* w, const int32_t* a, const int32_t* b) {
  TPN_COUNT(conv);
  int32_t ra[NL], rb[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    ra[i] = a[i];
    rb[i] = b[i];
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    int32_t acc = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int j = k - i;
      if (j >= 0 && j < NL) acc += ra[i] * rb[j];
    }
    w[k] = acc;
  }
}

// field.sqr_t_wide / field._sqr_conv: out[i+j] += (2 - δij)·a_i·a_j over
// i <= j, the cross terms against d = a + a.
TPN_NOINLINE void sqr_conv(int32_t* w, const int32_t* a) {
  TPN_COUNT(sqr_conv);
  int32_t ra[NL], rd[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    ra[i] = a[i];
    rd[i] = ra[i] + ra[i];
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    int32_t acc = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int j = k - i;
      if (j == i) acc += ra[i] * ra[i];
      else if (j > i && j < NL) acc += ra[i] * rd[j];
    }
    w[k] = acc;
  }
}

#endif  // TPN_MUL_DOT

// The square's convolution: field._sqr_conv's half product, or under
// SQR_MUL the full product conv(a, a) (field.field_ns(mul, "mul"), the
// reference's _square_conv under TPUNODE_FIELD_SQR=mul).
template <bool SQR_MUL>
TPN_INLINE void square_conv(int32_t* w, const int32_t* a) {
  if constexpr (SQR_MUL) {
    conv(w, a, a);
  } else {
    sqr_conv(w, a);
  }
}

// field.reduce_wide_loose: pad to 48, two carry rounds, _fold_once (48
// limbs -> 27, pad 28, two carry rounds, -> 24), one carry round, _fold_top.
TPN_NOINLINE void reduce_wide_loose(int32_t* out, const int32_t* w_in) {
  int32_t w[NW + 1];
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = w_in[i];
  w[NW] = 0;
  carry<NW + 1>(w);
  carry<NW + 1>(w);
  int32_t o[NL + 4];
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = w[i];
#pragma unroll
  for (int i = NL; i < NL + 4; ++i) o[i] = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
#pragma unroll
    for (int j = 0; j < NL; ++j) o[f + j] += fold_c(f) * w[NL + j];
  }
  carry<NL + 4>(o);
  carry<NL + 4>(o);
  int32_t x[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = o[i];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[f + j] += fold_c(f) * o[NL + j];
  }
  carry<NL>(x);
  fold_top(x);
  copy(out, x);
}

// field.reduce_wide: the loose tail plus its final carry round.
TPN_INLINE void reduce_wide(int32_t* out, const int32_t* w) {
  reduce_wide_loose(out, w);
  carry<NL>(out);
}

TPN_INLINE void tighten(int32_t* x) { carry<NL>(x); }

// field.mul_wide: one carry round per input, then the convolution.
TPN_INLINE void mul_wide(int32_t* w, const int32_t* a, const int32_t* b) {
  int32_t ta[NL], tb[NL];
  copy(ta, a);
  copy(tb, b);
  carry<NL>(ta);
  carry<NL>(tb);
  conv(w, ta, tb);
}

// field.mul (loose inputs); out may alias a or b.
TPN_NOINLINE void mul(int32_t* out, const int32_t* a, const int32_t* b) {
  int32_t w[NW];
  mul_wide(w, a, b);
  reduce_wide(out, w);
}

// field.sqr (loose input); out may alias a.
template <bool SQR_MUL>
TPN_NOINLINE void sqr(int32_t* out, const int32_t* a) {
  int32_t ta[NL], w[NW];
  copy(ta, a);
  carry<NL>(ta);
  square_conv<SQR_MUL>(w, ta);
  reduce_wide(out, w);
}

// field.mul_t: mul for pre-tight operands (every |limb| <= 2^13), with no
// input carry round; out may alias a or b.
TPN_NOINLINE void mul_t(int32_t* out, const int32_t* a, const int32_t* b) {
  int32_t w[NW];
  conv(w, a, b);
  reduce_wide(out, w);
}

// field.sqr_t: sqr for a pre-tight operand (mul_t's contract), with no
// input carry round; out may alias a.
template <bool SQR_MUL>
TPN_NOINLINE void sqr_t(int32_t* out, const int32_t* a) {
  int32_t w[NW];
  square_conv<SQR_MUL>(w, a);
  reduce_wide(out, w);
}

// field.mul_small_red: scale by a small constant, fold the top limb back.
TPN_INLINE void mul_small_red(int32_t* out, const int32_t* a, int32_t k) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = a[i] * k;
  fold_top(out);
}

// field._ge_p: lexicographic a >= p over canonical nonnegative limbs.
TPN_INLINE bool ge_p(const int32_t* a) {
  bool gt = false, eq = true;
#pragma unroll
  for (int i = NL - 1; i >= 0; --i) {
    gt = gt || (eq && a[i] > P_LIMBS[i]);
    eq = eq && a[i] == P_LIMBS[i];
  }
  return gt || eq;
}

// field.canonical: the exact representative in [0, p), nonnegative limbs.
TPN_NOINLINE void canonical(int32_t* out, const int32_t* in) {
  int32_t x[NL];
  copy(x, in);
  fold_top(x);  // _tight24
  carry<NL>(x);
  int32_t w[NL + 1];
#pragma unroll
  for (int i = 0; i < NL; ++i) w[i] = x[i] + BIG_LIMBS[i];
  w[NL] = BIG_LIMBS[NL];
  carry_rounds<NL + 1>(w, NL + 4);
  // value bits 256+ are limb23 >> 3 and limb24: fold via 2^256 mod p
  const int32_t hi = (w[NL - 1] >> 3) + w[NL] * 256;
  int32_t lo[NL];
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) lo[i] = w[i];
  lo[NL - 1] = w[NL - 1] & 7;
#pragma unroll
  for (int f = 0; f < 4; ++f) lo[f] += c256_c(f) * hi;
  carry_rounds<NL>(lo, NL + 2);
#pragma unroll 1
  for (int rep = 0; rep < 2; ++rep) {
    const bool ge = ge_p(lo);
#pragma unroll
    for (int i = 0; i < NL; ++i) lo[i] -= ge ? P_LIMBS[i] : 0;
    carry_rounds<NL>(lo, NL + 1);
  }
  copy(out, lo);
}

TPN_INLINE bool is_zero(const int32_t* x) {
  int32_t c[NL];
  canonical(c, x);
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) any |= c[i];
  return any == 0;
}

TPN_INLINE bool eq(const int32_t* a, const int32_t* b) {
  int32_t d[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) d[i] = a[i] - b[i];
  return is_zero(d);
}

// ---- constant-exponent pows: 4-bit windows at every MSM window width ----

constexpr int POW_TABLE = 16;  // entries of the pow ladders' 4-bit table

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

// t^((p-1)/2) (euler) or t^(p-2): a 16-entry power table built by
// sequential multiplies, then 64 windows of 4 squarings and one multiply
// (kernel._pow_const, scan form), its squarings SQR_MUL's.  The digit is
// read straight from constant memory: the same address in every thread, a
// broadcast.
template <bool SQR_MUL>
TPN_NOINLINE void pow_const(int32_t* out, const int32_t* t, bool euler) {
  int32_t tab[POW_TABLE][NL];
  set_small(tab[0], 1);
  copy(tab[1], t);
#pragma unroll 1
  for (int k = 2; k < POW_TABLE; ++k) mul(tab[k], tab[k - 1], t);
  int32_t acc[NL];
  set_small(acc, 1);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    sqr<SQR_MUL>(acc, acc);
    sqr<SQR_MUL>(acc, acc);
    sqr<SQR_MUL>(acc, acc);
    sqr<SQR_MUL>(acc, acc);
    mul(acc, acc, tab[euler ? EULER_DIGITS[w] : PM2_DIGITS[w]]);
  }
  copy(out, acc);
}

}  // namespace tpn

#if TPN_MUL_DOT
#include "field_dot.cuh"
#endif

// secp256k1 complete projective point formulas over field_u32.cuh's elements.
//
// RCB'16 Algorithms 7 (add), 8 (the mixed add, an affine second operand) and
// 9 (double) for a = 0, b3 = 3·7 = 21, in the operation order of curve.cuh's
// lazy bodies (_pt_add_lazy, _pt_double_lazy: pt_add, pt_double, whose
// products are F::mul and F::sqr, the multiply of a mode tuple), on 8-word
// weakly reduced elements; and in the order of the eager bodies (curve.py
// pt_add, pt_add_mixed, pt_double: the *_eager functions, for
// verify_u32_modes.cu).  Complete formulas need no branch for infinity or
// P = ±Q.
//
// Eager and lazy differ here only in the order of their operations.  The
// reference's lazy bodies sum unreduced products before one loose
// reduction, its eager ones reduce each product at once; in this arithmetic
// every product is reduced at once in both (below), so an eager body is the
// eager order over the same mul / sqr / add / sub, with no reduction of its
// own.  The mixed add has one body, pt_add_mixed_eager: the reference's
// _pt_add_mixed_lazy takes the same 11 products and the same sums, which
// reduced at once give the same words in either order.
//
// Reduction discipline: every product is reduced at once (mul / sqr), and a
// coordinate's two products are then summed by add() or subtracted by sub().
// The lazy bodies' alternative, summing two 512-bit products before one
// reduction, would need a 513th bit for a sum and an added multiple of
// p·2^256 for a difference; it saves one reduction (8 IMAD.WIDE and about 20
// adds) a coordinate but costs a 16-word add or subtract (about 32 adds):
// three coordinates of an add and one of a double save under 3% of their
// operations, so each product is reduced, and every intermediate is a
// weakly reduced element.  The differences t3 - (t0 + t1), t1 - b3·t2,
// x·y - z·w and t0 - 3·t2 are negative as often as not: sub() folds each
// borrow.
#pragma once

#include "field_u32.cuh"

namespace tpn {
namespace u32 {

constexpr uint32_t B3 = 21;

struct Pt {
  Fe x, y, z;
};

TPN_INLINE Pt infinity() {
  Pt p;
  p.x = fe_small(0);
  p.y = fe_small(1);
  p.z = fe_small(0);
  return p;
}

// curve._pt_add_lazy's order: 12 products, each reduced; every product an
// F::mul (the default: verify_u32.cu's shift-add).
template <class F = ShiftAdd<false>>
TPN_INLINE Pt pt_add(const Pt& p, const Pt& q) {
  const Fe t0 = F::mul(p.x, q.x);
  const Fe t1 = F::mul(p.y, q.y);
  const Fe t2 = F::mul(p.z, q.z);
  const Fe t3 = sub(F::mul(add(p.x, p.y), add(q.x, q.y)), add(t0, t1));  // X1·Y2 + X2·Y1
  const Fe t4 = sub(F::mul(add(p.y, p.z), add(q.y, q.z)), add(t1, t2));  // Y1·Z2 + Y2·Z1
  const Fe t5 = sub(F::mul(add(p.x, p.z), add(q.x, q.z)), add(t0, t2));  // X1·Z2 + X2·Z1
  const Fe t2b3 = mul_small(t2, B3);
  const Fe t03 = mul_small(t0, 3);  // 3·X1·X2
  const Fe z3s = add(t1, t2b3);
  const Fe t1m = sub(t1, t2b3);
  const Fe y3r = mul_small(t5, B3);  // b3·(X1·Z2 + X2·Z1)
  Pt r;
  r.x = sub(F::mul(t3, t1m), F::mul(t4, y3r));
  r.y = add(F::mul(t1m, z3s), F::mul(y3r, t03));
  r.z = add(F::mul(z3s, t4), F::mul(t03, t3));
  return r;
}

// curve._pt_double_lazy's order: 2 squares (F::sqr, the default the half
// product) and 6 products, each reduced.
template <class F = ShiftAdd<false>>
TPN_INLINE Pt pt_double(const Pt& p) {
  const Fe t0 = F::sqr(p.y);
  const Fe z8 = mul_small(t0, 8);  // 8·Y^2
  const Fe t1 = F::mul(p.y, p.z);
  const Fe t2 = mul_small(F::sqr(p.z), B3);  // b3·Z^2
  const Fe y3s = add(t0, t2);
  const Fe t0m = sub(t0, mul_small(t2, 3));
  Pt r;
  r.z = F::mul(t1, z8);
  r.y = add(F::mul(t2, z8), F::mul(t0m, y3s));
  const Fe x3 = F::mul(t0m, F::mul(p.x, p.y));
  r.x = add(x3, x3);
  return r;
}

// ---- the eager bodies' order (curve.py:137-166, 239-266, 298-328) ----

// An affine point (x, y): a window-table entry of the affine form, never
// infinity.
struct AffPt {
  Fe x, y;
};

// curve.pt_add's eager order: 12 products.
TPN_INLINE Pt pt_add_eager(const Pt& p, const Pt& q) {
  const Fe t0 = mul(p.x, q.x);
  const Fe t1 = mul(p.y, q.y);
  const Fe t2 = mul(p.z, q.z);
  const Fe t3 = sub(mul(add(p.x, p.y), add(q.x, q.y)), add(t0, t1));  // X1·Y2 + X2·Y1
  const Fe t4 = sub(mul(add(p.y, p.z), add(q.y, q.z)), add(t1, t2));  // Y1·Z2 + Y2·Z1
  const Fe t5 = sub(mul(add(p.x, p.z), add(q.x, q.z)), add(t0, t2));  // X1·Z2 + X2·Z1
  const Fe t03 = add(add(t0, t0), t0);  // 3·X1·X2
  const Fe t2b3 = mul_small(t2, B3);
  const Fe z3s = add(t1, t2b3);
  const Fe t1m = sub(t1, t2b3);
  const Fe y3r = mul_small(t5, B3);  // b3·(X1·Z2 + X2·Z1)
  Pt r;
  const Fe x3 = mul(t4, y3r);
  r.x = sub(mul(t3, t1m), x3);
  const Fe y3 = mul(y3r, t03);
  r.y = add(mul(t1m, z3s), y3);
  const Fe t0b = mul(t03, t3);
  r.z = add(mul(z3s, t4), t0b);
  return r;
}

// curve.pt_add_mixed's eager order (RCB'16 Algorithm 8, Z2 = 1): 11
// products, each an F::mul (the default: verify_u32_modes.cu's shift-add),
// and 2 scalings by b3.  Complete in p; q cannot be infinity.
template <class F = ShiftAdd<false>>
TPN_INLINE Pt pt_add_mixed_eager(const Pt& p, const AffPt& q) {
  const Fe t0 = F::mul(p.x, q.x);
  const Fe t1 = F::mul(p.y, q.y);
  const Fe t3 = sub(F::mul(add(p.x, p.y), add(q.x, q.y)), add(t0, t1));  // X1·y2 + x2·Y1
  const Fe t4 = add(F::mul(q.y, p.z), p.y);  // Y1·Z2 + Y2·Z1 with Z2 = 1
  const Fe t5 = add(F::mul(q.x, p.z), p.x);  // X1·Z2 + X2·Z1 with Z2 = 1
  const Fe t03 = add(add(t0, t0), t0);  // 3·X1·x2
  const Fe t2b3 = mul_small(p.z, B3);  // b3·Z1·Z2 with Z2 = 1
  const Fe z3s = add(t1, t2b3);
  const Fe t1m = sub(t1, t2b3);
  const Fe y3r = mul_small(t5, B3);
  Pt r;
  const Fe x3 = F::mul(t4, y3r);
  r.x = sub(F::mul(t3, t1m), x3);
  const Fe y3 = F::mul(y3r, t03);
  r.y = add(F::mul(t1m, z3s), y3);
  const Fe t0b = F::mul(t03, t3);
  r.z = add(F::mul(z3s, t4), t0b);
  return r;
}

// curve.pt_double's eager order: 2 squares (square<SQR_MUL>) and 6 products.
template <bool SQR_MUL>
TPN_INLINE Pt pt_double_eager(const Pt& p) {
  const Fe t0 = square<SQR_MUL>(p.y);
  const Fe z8 = mul_small(t0, 8);  // 8·Y^2
  const Fe t1 = mul(p.y, p.z);
  const Fe t2 = mul_small(square<SQR_MUL>(p.z), B3);  // b3·Z^2
  const Fe x3a = mul(t2, z8);
  const Fe y3s = add(t0, t2);
  Pt r;
  r.z = mul(t1, z8);
  const Fe t0m = sub(t0, add(add(t2, t2), t2));  // Y^2 - 3·b3·Z^2
  r.y = add(x3a, mul(t0m, y3s));
  const Fe x3 = mul(t0m, mul(p.x, p.y));
  r.x = add(x3, x3);
  return r;
}

}  // namespace u32
}  // namespace tpn

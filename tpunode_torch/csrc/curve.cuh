// secp256k1 complete projective point formulas for the verify kernel.
//
// Device transcription of both reduction disciplines of
// tpunode_torch/verify/curve.py (RCB'16 Algorithms 7, 8 and 9, a = 0,
// b3 = 21), op for op, so verify/bounds.py's replay of those bodies in each
// mode is the int32 headroom proof of this code:
// * lazy (_pt_add_lazy, _pt_add_mixed_lazy, _pt_double_lazy): the products
//   of one output coordinate accumulate unreduced and share one loose
//   reduction;
// * eager (the bodies of pt_add, pt_add_mixed and pt_double under
//   reduce="eager"): every product is reduced at once, by mul (one carry
//   round on each input first) or by mul_t / sqr_t (pre-tight inputs, no
//   carry).  Which of the two a line calls decides its limbs, not its value
//   mod p, so each line names its plain counterpart.
// pt_add<EAGER>, pt_add_mixed<EAGER> and pt_double<EAGER, SQR_MUL> pick a
// body at compile time; the doublings' two squares are SQR_MUL's
// (field.cuh).  Complete formulas need no branch for infinity or P = ±Q;
// the mixed add's affine operand cannot be infinity.  Every function reads
// all of its inputs before it writes its output, so out may alias an input.
#pragma once

#include "field.cuh"

namespace tpn {

constexpr int32_t B3 = 21;

struct Pt {
  int32_t x[NL], y[NL], z[NL];
};

// An affine point (x, y), Z = 1 implied: an entry of the affine window tables.
struct AffPt {
  int32_t x[NL], y[NL];
};

TPN_INLINE void set_infinity(Pt* p) {
  set_small(p->x, 0);
  set_small(p->y, 1);
  set_small(p->z, 0);
}

TPN_INLINE void copy_pt(Pt* out, const Pt* p) {
  copy(out->x, p->x);
  copy(out->y, p->y);
  copy(out->z, p->z);
}

// curve._pt_add_lazy.
TPN_NOINLINE void pt_add_lazy(Pt* out, const Pt* p, const Pt* q) {
  int32_t w[NW], w2[NW], a[NL], b[NL];
  int32_t t0[NL], t1[NL], t2[NL], t3[NL], t4[NL], t5[NL];
  conv(w, p->x, q->x);
  reduce_wide_loose(t0, w);
  conv(w, p->y, q->y);
  reduce_wide_loose(t1, w);
  conv(w, p->z, q->z);
  reduce_wide_loose(t2, w);
  add(a, p->x, p->y);
  add(b, q->x, q->y);
  mul_wide(w, a, b);
  reduce_wide_loose(t3, w);
#pragma unroll
  for (int i = 0; i < NL; ++i) t3[i] = t3[i] - (t0[i] + t1[i]);  // X1*Y2 + X2*Y1
  add(a, p->y, p->z);
  add(b, q->y, q->z);
  mul_wide(w, a, b);
  reduce_wide_loose(t4, w);
#pragma unroll
  for (int i = 0; i < NL; ++i) t4[i] = t4[i] - (t1[i] + t2[i]);
  add(a, p->x, p->z);
  add(b, q->x, q->z);
  mul_wide(w, a, b);
  reduce_wide_loose(t5, w);
#pragma unroll
  for (int i = 0; i < NL; ++i) t5[i] = t5[i] - (t0[i] + t2[i]);  // X1*Z2 + X2*Z1
  int32_t t2b3[NL], t03[NL], z3s[NL], t1m[NL], y3r[NL];
  mul_small_red(t2b3, t2, B3);
  tighten(t3);
  tighten(t4);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    t03[i] = t0[i] + t0[i] + t0[i];  // 3*X1*X2
    z3s[i] = t1[i] + t2b3[i];
    t1m[i] = t1[i] - t2b3[i];
  }
  tighten(t03);
  tighten(z3s);
  tighten(t1m);
  mul_small_red(y3r, t5, B3);  // b3*(X1*Z2 + X2*Z1)
  tighten(y3r);
  conv(w, t3, t1m);
  conv(w2, t4, y3r);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = w[i] - w2[i];
  reduce_wide_loose(out->x, w);
  conv(w, t1m, z3s);
  conv(w2, y3r, t03);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = w[i] + w2[i];
  reduce_wide_loose(out->y, w);
  conv(w, z3s, t4);
  conv(w2, t03, t3);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = w[i] + w2[i];
  reduce_wide_loose(out->z, w);
}

// curve._pt_add_mixed_lazy: q affine (Z2 = 1), 11 convolutions.
TPN_NOINLINE void pt_add_mixed_lazy(Pt* out, const Pt* p, const AffPt* q) {
  int32_t w[NW], w2[NW], a[NL], b[NL];
  int32_t t0[NL], t1[NL], t3[NL], t4[NL], t5[NL];
  conv(w, p->x, q->x);
  reduce_wide_loose(t0, w);
  conv(w, p->y, q->y);
  reduce_wide_loose(t1, w);
  add(a, p->x, p->y);
  add(b, q->x, q->y);
  mul_wide(w, a, b);
  reduce_wide_loose(t3, w);
#pragma unroll
  for (int i = 0; i < NL; ++i) t3[i] = t3[i] - (t0[i] + t1[i]);  // X1*y2 + x2*Y1
  conv(w, q->y, p->z);
  reduce_wide_loose(t4, w);
#pragma unroll
  for (int i = 0; i < NL; ++i) t4[i] = t4[i] + p->y[i];  // Y1*Z2 + y2*Z1
  conv(w, q->x, p->z);
  reduce_wide_loose(t5, w);
#pragma unroll
  for (int i = 0; i < NL; ++i) t5[i] = t5[i] + p->x[i];  // X1*Z2 + x2*Z1
  int32_t t2b3[NL], t03[NL], z3s[NL], t1m[NL], y3r[NL];
  mul_small_red(t2b3, p->z, B3);  // b3*Z1*Z2
  tighten(t3);
  tighten(t4);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    t03[i] = t0[i] + t0[i] + t0[i];  // 3*X1*x2
    z3s[i] = t1[i] + t2b3[i];
    t1m[i] = t1[i] - t2b3[i];
  }
  tighten(t03);
  tighten(z3s);
  tighten(t1m);
  mul_small_red(y3r, t5, B3);
  tighten(y3r);
  conv(w, t3, t1m);
  conv(w2, t4, y3r);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = w[i] - w2[i];
  reduce_wide_loose(out->x, w);
  conv(w, t1m, z3s);
  conv(w2, y3r, t03);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = w[i] + w2[i];
  reduce_wide_loose(out->y, w);
  conv(w, z3s, t4);
  conv(w2, t03, t3);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = w[i] + w2[i];
  reduce_wide_loose(out->z, w);
}

// curve._pt_double_lazy.
template <bool SQR_MUL>
TPN_NOINLINE void pt_double_lazy(Pt* out, const Pt* p) {
  int32_t w[NW], w2[NW];
  int32_t t0[NL], z8[NL], t1[NL], t2[NL], y3s[NL], t0m[NL], t1b[NL];
  int32_t x3[NL], y3[NL], z3[NL];
  square_conv<SQR_MUL>(w, p->y);
  reduce_wide_loose(t0, w);
#pragma unroll
  for (int i = 0; i < NL; ++i) z8[i] = t0[i] * 8;  // 8Y^2
  tighten(z8);
  conv(w, p->y, p->z);
  reduce_wide_loose(t1, w);
  square_conv<SQR_MUL>(w, p->z);
  reduce_wide_loose(t2, w);
  mul_small_red(t2, t2, B3);  // b3*Z^2
  tighten(t2);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    y3s[i] = t0[i] + t2[i];
    t0m[i] = t0[i] - (t2[i] + t2[i] + t2[i]);
  }
  tighten(t0m);
  conv(w, t1, z8);
  reduce_wide_loose(z3, w);
  conv(w, t2, z8);
  conv(w2, t0m, y3s);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = w[i] + w2[i];
  reduce_wide_loose(y3, w);
  conv(w, p->x, p->y);
  reduce_wide_loose(t1b, w);
  conv(w, t0m, t1b);
  reduce_wide_loose(x3, w);
#pragma unroll
  for (int i = 0; i < NL; ++i) out->x[i] = x3[i] + x3[i];
  copy(out->y, y3);
  copy(out->z, z3);
}

// curve.pt_add with reduce="eager": 12 products, each reduced at once.
TPN_NOINLINE void pt_add_eager(Pt* out, const Pt* p, const Pt* q) {
  int32_t a[NL], b[NL], u[NL];
  int32_t t0[NL], t1[NL], t2[NL], t3[NL], t4[NL], t5[NL];
  int32_t t03[NL], t2b3[NL], z3[NL], t1m[NL], x3[NL], y3[NL];
  mul_t(t0, p->x, q->x);  // t0 = F.mul_t(X1, X2)
  mul_t(t1, p->y, q->y);  // t1 = F.mul_t(Y1, Y2)
  mul_t(t2, p->z, q->z);  // t2 = F.mul_t(Z1, Z2)
  add(a, p->x, p->y);
  add(b, q->x, q->y);
  mul(t3, a, b);  // t3 = mul(X1 + Y1, X2 + Y2)
#pragma unroll
  for (int i = 0; i < NL; ++i) t3[i] = t3[i] - (t0[i] + t1[i]);  // t3 - (t0 + t1)
  add(a, p->y, p->z);
  add(b, q->y, q->z);
  mul(t4, a, b);  // t4 = mul(Y1 + Z1, Y2 + Z2)
#pragma unroll
  for (int i = 0; i < NL; ++i) t4[i] = t4[i] - (t1[i] + t2[i]);  // t4 - (t1 + t2)
  add(a, p->x, p->z);
  add(b, q->x, q->z);
  mul(t5, a, b);  // t5 = mul(X1 + Z1, X2 + Z2)
#pragma unroll
  for (int i = 0; i < NL; ++i) t5[i] = t5[i] - (t0[i] + t2[i]);  // X1*Z2 + X2*Z1
#pragma unroll
  for (int i = 0; i < NL; ++i) t03[i] = t0[i] + t0[i] + t0[i];  // t0_3 = 3*X1*X2
  mul_small_red(t2b3, t2, B3);  // t2_b3 = F.mul_small_red(t2, B3)
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    z3[i] = t1[i] + t2b3[i];  // z3 = t1 + t2_b3
    t1m[i] = t1[i] - t2b3[i];  // t1m = t1 - t2_b3
  }
  mul_small_red(y3, t5, B3);  // y3 = F.mul_small_red(t5, B3)
  mul(x3, t4, y3);  // x3 = mul(t4, y3)
  mul(u, t3, t1m);  // t2b = mul(t3, t1m)
#pragma unroll
  for (int i = 0; i < NL; ++i) x3[i] = u[i] - x3[i];  // x3 = t2b - x3
  mul(y3, y3, t03);  // y3 = mul(y3, t0_3)
  mul(u, t1m, z3);  // t1b = mul(t1m, z3)
#pragma unroll
  for (int i = 0; i < NL; ++i) y3[i] = u[i] + y3[i];  // y3 = t1b + y3
  mul(u, t03, t3);  // t0b = mul(t0_3, t3)
  mul(z3, z3, t4);  // z3 = mul(z3, t4)
#pragma unroll
  for (int i = 0; i < NL; ++i) z3[i] = z3[i] + u[i];  // z3 = z3 + t0b
  copy(out->x, x3);
  copy(out->y, y3);
  copy(out->z, z3);
}

// curve.pt_add_mixed with reduce="eager": q affine (Z2 = 1), 11 products,
// each reduced at once.
TPN_NOINLINE void pt_add_mixed_eager(Pt* out, const Pt* p, const AffPt* q) {
  int32_t a[NL], b[NL], u[NL];
  int32_t t0[NL], t1[NL], t3[NL], t4[NL], t5[NL];
  int32_t t03[NL], t2b3[NL], z3[NL], t1m[NL], x3[NL], y3[NL];
  mul_t(t0, p->x, q->x);  // t0 = F.mul_t(X1, x2)
  mul_t(t1, p->y, q->y);  // t1 = F.mul_t(Y1, y2)
  add(a, p->x, p->y);
  add(b, q->x, q->y);
  mul(t3, a, b);  // t3 = mul(X1 + Y1, x2 + y2)
#pragma unroll
  for (int i = 0; i < NL; ++i) t3[i] = t3[i] - (t0[i] + t1[i]);  // X1*y2 + x2*Y1
  mul_t(t4, q->y, p->z);  // t4 = F.mul_t(y2, Z1)
#pragma unroll
  for (int i = 0; i < NL; ++i) t4[i] = t4[i] + p->y[i];  // t4 = t4 + Y1
  mul_t(t5, q->x, p->z);  // t5 = F.mul_t(x2, Z1)
#pragma unroll
  for (int i = 0; i < NL; ++i) t5[i] = t5[i] + p->x[i];  // t5 = t5 + X1
#pragma unroll
  for (int i = 0; i < NL; ++i) t03[i] = t0[i] + t0[i] + t0[i];  // t0_3 = 3*X1*x2
  mul_small_red(t2b3, p->z, B3);  // t2_b3 = F.mul_small_red(Z1, B3)
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    z3[i] = t1[i] + t2b3[i];  // z3 = t1 + t2_b3
    t1m[i] = t1[i] - t2b3[i];  // t1m = t1 - t2_b3
  }
  mul_small_red(y3, t5, B3);  // y3 = F.mul_small_red(t5, B3)
  mul(x3, t4, y3);  // x3 = mul(t4, y3)
  mul(u, t3, t1m);  // t2b = mul(t3, t1m)
#pragma unroll
  for (int i = 0; i < NL; ++i) x3[i] = u[i] - x3[i];  // x3 = t2b - x3
  mul(y3, y3, t03);  // y3 = mul(y3, t0_3)
  mul(u, t1m, z3);  // t1b = mul(t1m, z3)
#pragma unroll
  for (int i = 0; i < NL; ++i) y3[i] = u[i] + y3[i];  // y3 = t1b + y3
  mul(u, t03, t3);  // t0b = mul(t0_3, t3)
  mul(z3, z3, t4);  // z3 = mul(z3, t4)
#pragma unroll
  for (int i = 0; i < NL; ++i) z3[i] = z3[i] + u[i];  // z3 = z3 + t0b
  copy(out->x, x3);
  copy(out->y, y3);
  copy(out->z, z3);
}

// curve.pt_double with reduce="eager": 6 products and 2 squares, each
// reduced at once.
template <bool SQR_MUL>
TPN_NOINLINE void pt_double_eager(Pt* out, const Pt* p) {
  int32_t t0[NL], t1[NL], t2[NL], x3[NL], y3[NL], z3[NL];
  sqr_t<SQR_MUL>(t0, p->y);  // t0 = F.sqr_t(Y)
#pragma unroll
  for (int i = 0; i < NL; ++i) z3[i] = t0[i] * 8;  // z3 = t0 * 8
  mul_t(t1, p->y, p->z);  // t1 = F.mul_t(Y, Z)
  sqr_t<SQR_MUL>(t2, p->z);  // t2 = F.sqr_t(Z)
  mul_small_red(t2, t2, B3);  // t2 = F.mul_small_red(t2, B3)
  mul(x3, t2, z3);  // x3 = mul(t2, z3)
#pragma unroll
  for (int i = 0; i < NL; ++i) y3[i] = t0[i] + t2[i];  // y3 = t0 + t2
  mul(z3, t1, z3);  // z3 = mul(t1, z3)
#pragma unroll
  for (int i = 0; i < NL; ++i) t0[i] = t0[i] - (t2[i] + t2[i] + t2[i]);  // t0 - t2_3
  mul(y3, t0, y3);  // y3 = mul(t0, y3)
#pragma unroll
  for (int i = 0; i < NL; ++i) y3[i] = x3[i] + y3[i];  // y3 = x3 + y3
  mul_t(t1, p->x, p->y);  // t1 = F.mul_t(X, Y)
  mul(x3, t0, t1);  // x3 = mul(t0, t1)
#pragma unroll
  for (int i = 0; i < NL; ++i) out->x[i] = x3[i] + x3[i];  // x3 = x3 + x3
  copy(out->y, y3);
  copy(out->z, z3);
}

// The body a template instantiation runs: TPUNODE_FIELD_REDUCE's eager or
// lazy discipline, chosen at compile time (and for the doubling
// TPUNODE_FIELD_SQR's square).
template <bool EAGER>
TPN_INLINE void pt_add(Pt* out, const Pt* p, const Pt* q) {
  if constexpr (EAGER) {
    pt_add_eager(out, p, q);
  } else {
    pt_add_lazy(out, p, q);
  }
}

template <bool EAGER>
TPN_INLINE void pt_add_mixed(Pt* out, const Pt* p, const AffPt* q) {
  if constexpr (EAGER) {
    pt_add_mixed_eager(out, p, q);
  } else {
    pt_add_mixed_lazy(out, p, q);
  }
}

template <bool EAGER, bool SQR_MUL>
TPN_INLINE void pt_double(Pt* out, const Pt* p) {
  if constexpr (EAGER) {
    pt_double_eager<SQR_MUL>(out, p);
  } else {
    pt_double_lazy<SQR_MUL>(out, p);
  }
}

}  // namespace tpn

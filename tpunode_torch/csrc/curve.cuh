// secp256k1 complete projective point formulas for the verify kernel.
//
// Device transcription of the lazy bodies of tpunode_torch/verify/curve.py
// (_pt_add_lazy, _pt_add_mixed_lazy, _pt_double_lazy: RCB'16 Algorithms 7,
// 8 and 9, a = 0, b3 = 21), op for op, so verify/bounds.py's replay of
// those bodies is the int32 headroom proof of this code.  Complete formulas
// need no branch for infinity or P = ±Q; the mixed add's affine operand
// cannot be infinity.  Every function reads all of its inputs before it
// writes its output, so out may alias an input.
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
TPN_NOINLINE void pt_add(Pt* out, const Pt* p, const Pt* q) {
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
TPN_NOINLINE void pt_add_mixed(Pt* out, const Pt* p, const AffPt* q) {
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
TPN_NOINLINE void pt_double(Pt* out, const Pt* p) {
  int32_t w[NW], w2[NW];
  int32_t t0[NL], z8[NL], t1[NL], t2[NL], y3s[NL], t0m[NL], t1b[NL];
  int32_t x3[NL], y3[NL], z3[NL];
  sqr_conv(w, p->y);
  reduce_wide_loose(t0, w);
#pragma unroll
  for (int i = 0; i < NL; ++i) z8[i] = t0[i] * 8;  // 8Y^2
  tighten(z8);
  conv(w, p->y, p->z);
  reduce_wide_loose(t1, w);
  sqr_conv(w, p->z);
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

}  // namespace tpn

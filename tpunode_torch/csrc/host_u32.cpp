// The main path's verify kernel (verify_u32.cu, field_u32.cuh,
// curve_u32.cuh) compiled as host C++, for the CPU tests
// (tests/test_torch_u32.py): a plain C interface over the 8-word field
// layer, the point formulas, the per-lane program and the field_mul_u32
// probe lane (diag.cu), each looping over its elements or lanes.
//
// Not part of the nvcc build.  The test builds this file once with
//   g++ -std=c++17 -O1 -Wall -Wno-unknown-pragmas -fsanitize=undefined
//       -fno-sanitize-recover=all -shared -fPIC
// Unsigned arithmetic cannot overflow, so UBSan guards only the conversions'
// signed sums and the indexing; the values are held against Python integers
// and the plain version.
//
// Layouts: an element is 8 little-endian uint32 words, n elements (n, 8); a
// point (n, 3, 8); limb rows are the kernel's (24, B) int32, lane-minor.
#include <stdint.h>

#include "diag.cu"
#include "verify_u32.cu"

namespace {

namespace U = tpn::u32;

U::Fe load(const uint32_t* v) {
  U::Fe x;
  for (int i = 0; i < U::NWORDS; ++i) x.w[i] = v[i];
  return x;
}

void store(uint32_t* v, const U::Fe& x) {
  for (int i = 0; i < U::NWORDS; ++i) v[i] = x.w[i];
}

U::Pt load_pt(const uint32_t* v) {
  U::Pt p;
  p.x = load(v);
  p.y = load(v + U::NWORDS);
  p.z = load(v + 2 * U::NWORDS);
  return p;
}

void store_pt(uint32_t* v, const U::Pt& p) {
  store(v, p.x);
  store(v + U::NWORDS, p.y);
  store(v + 2 * U::NWORDS, p.z);
}

}  // namespace

extern "C" {

// op: 0 mul, 1 sqr (b unread), 2 add, 3 sub, 4 neg (b unread), 5 canonical
// (b unread), 6 mul_small by k, 7 the Euler pow, 8 the p-2 pow (b unread).
// Returns 1 for another op.
int tpn_u32_field(const uint32_t* a, const uint32_t* b, uint32_t* out, int n, int op,
                  uint32_t k) {
  if (op < 0 || op > 8) return 1;
  for (int i = 0; i < n; ++i) {
    const U::Fe x = load(a + 8 * i), y = load(b + 8 * i);
    U::Fe r;
    switch (op) {
      case 0: r = U::mul(x, y); break;
      case 1: r = U::sqr(x); break;
      case 2: r = U::add(x, y); break;
      case 3: r = U::sub(x, y); break;
      case 4: r = U::neg(x); break;
      case 5: r = U::canonical(x); break;
      case 6: r = U::mul_small(x, k); break;
      case 7: r = U::pow_const(x, true); break;
      default: r = U::pow_const(x, false); break;
    }
    store(out + 8 * i, r);
  }
  return 0;
}

// is_zero and eq of each pair: out (n,) 0 or 1.
void tpn_u32_tests(const uint32_t* a, const uint32_t* b, uint8_t* is_zero, uint8_t* eq, int n) {
  for (int i = 0; i < n; ++i) {
    is_zero[i] = U::is_zero(load(a + 8 * i)) ? 1 : 0;
    eq[i] = U::eq(load(a + 8 * i), load(b + 8 * i)) ? 1 : 0;
  }
}

// from_radix11 of each lane of the limb rows (24, B) into out (B, 8).
void tpn_u32_from_radix11(const int32_t* rows, uint32_t* out, int B) {
  for (int lane = 0; lane < B; ++lane) store(out + 8 * lane, U::from_radix11(rows, B, lane));
}

// to_radix11 of each canonical element of a (B, 8) into the limb rows (24, B).
void tpn_u32_to_radix11(const uint32_t* a, int32_t* rows, int B) {
  for (int lane = 0; lane < B; ++lane) U::to_radix11(rows, load(a + 8 * lane), B, lane);
}

// pt_add (op 0, q read) or pt_double (op 1) of (n, 3, 8) points.
void tpn_u32_point(const uint32_t* p, const uint32_t* q, uint32_t* out, int n, int op) {
  for (int i = 0; i < n; ++i) {
    const U::Pt a = load_pt(p + 24 * i);
    store_pt(out + 24 * i, op == 0 ? U::pt_add(a, load_pt(q + 24 * i)) : U::pt_double(a));
  }
}

// The field_mul_u32 probe over B lanes of limb rows (24, B).
void tpn_host_field_mul_u32(const int32_t* a, const int32_t* b, int32_t* out, int B) {
  for (int lane = 0; lane < B; ++lane) tpn::diag_field_mul_u32_lane(a, b, out, B, lane);
}

// verify_lane over B lanes with the arguments of tpn_verify_u32 (no
// stream); the G tables converted as a block converts them.
int tpn_u32_verify(const int32_t* g_rows, const int32_t* d1a, const int32_t* d1b,
                   const int32_t* d2a, const int32_t* d2b, const uint8_t* n1a,
                   const uint8_t* n1b, const uint8_t* n2a, const uint8_t* n2b,
                   const int32_t* qx, const int32_t* qy, const int32_t* r1, const int32_t* r2,
                   const uint8_t* r2_valid, const uint8_t* host_valid, const uint8_t* schnorr,
                   const uint8_t* bip340, uint8_t* out, int B, int schnorr_free) {
  const U::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,
                        r2_valid, host_valid, schnorr, bip340, out, B};
  uint32_t g_tabs[2 * U::TABLE * U::SMEM_STRIDE] = {};
  U::convert_g_tables(g_tabs, g_rows, 0, 1);
  for (int lane = 0; lane < B; ++lane) {
    const bool ok = schnorr_free ? U::verify_lane<true>(a, g_tabs, lane)
                                 : U::verify_lane<false>(a, g_tabs, lane);
    out[lane] = ok ? 1 : 0;
  }
  return 0;
}

}  // extern "C"

// verify_u32_modes.cu (the one-hot eager affine tuples on the 8-word
// arithmetic) compiled as host C++, for the CPU tests
// (tests/test_torch_u32_modes.py): a plain C interface over the eager point
// formulas, the affine Q table, the one-hot select and the per-lane
// program, each looping over its elements or lanes.
//
// Not part of the nvcc build.  The test builds this file once with
//   g++ -std=c++17 -O1 -Wall -Wno-unknown-pragmas -fsanitize=undefined
//       -fno-sanitize-recover=all -shared -fPIC
// Unsigned arithmetic cannot overflow, so UBSan guards only the conversions'
// signed sums and the indexing; the values are held against Python integers
// and the plain version.
//
// Layouts: an element is 8 little-endian uint32 words, n elements (n, 8); a
// point (n, 3, 8), an affine one (n, 2, 8); a table (n, 16, 2, 8); limb rows
// are the kernel's (24, B) int32, lane-minor.
#include <stdint.h>

#include "verify_u32_modes.cu"

namespace {

namespace U = tpn::u32;
namespace M = tpn::u32::modes;

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

U::AffPt load_aff(const uint32_t* v) {
  U::AffPt p;
  p.x = load(v);
  p.y = load(v + U::NWORDS);
  return p;
}

void store_aff(uint32_t* v, const U::AffPt& p) {
  store(v, p.x);
  store(v + U::NWORDS, p.y);
}

}  // namespace

extern "C" {

// op: 0 pt_add_eager (q (n, 3, 8)), 1 pt_double_eager with the half square,
// 2 with the full one (q unread), 3 pt_add_mixed_eager (q (n, 2, 8));
// out (n, 3, 8).  Returns 1 for another op.
int tpn_u32m_point(const uint32_t* p, const uint32_t* q, uint32_t* out, int n, int op) {
  if (op < 0 || op > 3) return 1;
  for (int i = 0; i < n; ++i) {
    const U::Pt a = load_pt(p + 24 * i);
    U::Pt r;
    switch (op) {
      case 0: r = U::pt_add_eager(a, load_pt(q + 24 * i)); break;
      case 1: r = U::pt_double_eager<false>(a); break;
      case 2: r = U::pt_double_eager<true>(a); break;
      default: r = U::pt_add_mixed_eager(a, load_aff(q + 16 * i)); break;
    }
    store_pt(out + 24 * i, r);
  }
  return 0;
}

// square<sqr> (sqr 0 the half product, 1 the full one) and the p-2 and Euler
// pows under it: out (n, 3, 8) = (a^2, a^(p-2), a^((p-1)/2)).
void tpn_u32m_square(const uint32_t* a, uint32_t* out, int n, int sqr) {
  for (int i = 0; i < n; ++i) {
    const U::Fe x = load(a + 8 * i);
    uint32_t* o = out + 24 * i;
    if (sqr) {
      store(o, U::square<true>(x));
      store(o + 8, U::pow_const<true>(x, false));
      store(o + 16, U::pow_const<true>(x, true));
    } else {
      store(o, U::square<false>(x));
      store(o + 8, U::pow_const<false>(x, false));
      store(o + 16, U::pow_const<false>(x, true));
    }
  }
}

// The affine Q table of each (qx, qy) (n, 2, 8) into out (n, 16, 2, 8).
void tpn_u32m_affine_table(const uint32_t* q, uint32_t* out, int n, int sqr) {
  for (int i = 0; i < n; ++i) {
    U::Pt q1;
    q1.x = load(q + 16 * i);
    q1.y = load(q + 16 * i + 8);
    q1.z = U::fe_small(1);
    U::AffPt tab[M::TABLE];
    if (sqr) {
      M::build_affine_table<true>(tab, q1);
    } else {
      M::build_affine_table<false>(tab, q1);
    }
    for (int k = 0; k < M::TABLE; ++k) store_aff(out + (16 * i + k) * 16, tab[k]);
  }
}

// The one-hot select of digits[i] (masked to 4 bits) from table i
// (n, 16, 2, 8), out (n, 2, 8); from_shared 1 reads the table as the G / λG
// select does (entries at SMEM_STRIDE words, table t 0), 0 as the Q select.
void tpn_u32m_select(const uint32_t* tables, const int32_t* digits, uint32_t* out, int n,
                     int from_shared) {
  for (int i = 0; i < n; ++i) {
    const int digit = digits[i] & (M::TABLE - 1);
    U::AffPt tab[M::TABLE];
    for (int k = 0; k < M::TABLE; ++k) tab[k] = load_aff(tables + (16 * i + k) * 16);
    if (from_shared) {
      uint32_t smem[M::TABLE * M::SMEM_STRIDE] = {};
      for (int k = 0; k < M::TABLE; ++k) {
        for (int w = 0; w < U::NWORDS; ++w) {
          smem[k * M::SMEM_STRIDE + w] = tab[k].x.w[w];
          smem[k * M::SMEM_STRIDE + U::NWORDS + w] = tab[k].y.w[w];
        }
      }
      store_aff(out + 16 * i, M::select_g(smem, 0, digit));
    } else {
      store_aff(out + 16 * i, M::select_q(tab, digit));
    }
  }
}

// G's and λG's affine rows (2, 16, 2, 24) converted as a block converts them,
// into out (2, 16, 2, 8).
void tpn_u32m_g_tables(const int32_t* g_rows, uint32_t* out) {
  uint32_t g_tabs[2 * M::TABLE * M::SMEM_STRIDE] = {};
  M::convert_g_tables(g_tabs, g_rows, 0, 1);
  for (int e = 0; e < 2 * M::TABLE; ++e) {
    for (int w = 0; w < 2 * U::NWORDS; ++w) out[e * 16 + w] = g_tabs[e * M::SMEM_STRIDE + w];
  }
}

// verify_lane over B lanes with the arguments of tpn_verify_u32_modes (no
// stream); the G tables converted as a block converts them.  Returns 1 for a
// sqr other than 0 or 1.
int tpn_u32m_verify(const int32_t* g_rows, const int32_t* d1a, const int32_t* d1b,
                    const int32_t* d2a, const int32_t* d2b, const uint8_t* n1a,
                    const uint8_t* n1b, const uint8_t* n2a, const uint8_t* n2b,
                    const int32_t* qx, const int32_t* qy, const int32_t* r1, const int32_t* r2,
                    const uint8_t* r2_valid, const uint8_t* host_valid, const uint8_t* schnorr,
                    const uint8_t* bip340, uint8_t* out, int B, int schnorr_free, int sqr) {
  if (sqr != 0 && sqr != 1) return 1;
  const M::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,
                        r2_valid, host_valid, schnorr, bip340, out, B};
  uint32_t g_tabs[2 * M::TABLE * M::SMEM_STRIDE] = {};
  M::convert_g_tables(g_tabs, g_rows, 0, 1);
  for (int lane = 0; lane < B; ++lane) {
    bool ok;
    if (sqr) {
      ok = schnorr_free ? M::verify_lane<true, true>(a, g_tabs, lane)
                        : M::verify_lane<false, true>(a, g_tabs, lane);
    } else {
      ok = schnorr_free ? M::verify_lane<true, false>(a, g_tabs, lane)
                        : M::verify_lane<false, false>(a, g_tabs, lane);
    }
    out[lane] = ok ? 1 : 0;
  }
  return 0;
}

}  // extern "C"

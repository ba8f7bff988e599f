// verify_u32_modes.cu (the eager affine tuples on the 8-word arithmetic)
// compiled as host C++, for the CPU tests (tests/test_torch_u32_modes.py at
// 4-bit windows, tests/test_torch_u32_modes5.py at 5-bit, both one-hot;
// tests/test_torch_u32_modes_tree.py, the tree select at 4-bit): a plain C
// interface over the eager point formulas, the affine Q table, the one-hot
// and the tree selects and the per-lane program, each looping over its
// elements or lanes.  The table, select, G-table and per-lane functions are
// templates on the window width WB, exported once a width: tpn_u32m_* at 4
// bits, tpn_u32m5_* at 5; the tree select's reads and per-lane program at 4
// bits as tpn_u32mt_*.
//
// Not part of the nvcc build.  The test builds this file once with
//   g++ -std=c++17 -O1 -Wall -Wno-unknown-pragmas -fsanitize=undefined
//       -fno-sanitize-recover=all -shared -fPIC
// Unsigned arithmetic cannot overflow, so UBSan guards only the conversions'
// signed sums and the indexing; the values are held against Python integers
// and the plain version.
//
// Layouts: an element is 8 little-endian uint32 words, n elements (n, 8); a
// point (n, 3, 8), an affine one (n, 2, 8); a table (n, 2^WB, 2, 8); limb
// rows are the kernel's (24, B) int32, lane-minor.
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

// The affine Q table of each (qx, qy) (n, 2, 8) into out (n, 2^WB, 2, 8).
template <int WB>
void affine_table(const uint32_t* q, uint32_t* out, int n, int sqr) {
  constexpr int T = M::TABLE<WB>;
  for (int i = 0; i < n; ++i) {
    U::Pt q1;
    q1.x = load(q + 16 * i);
    q1.y = load(q + 16 * i + 8);
    q1.z = U::fe_small(1);
    alignas(16) U::AffPt tab[T];
    if (sqr) {
      M::build_affine_table<WB, true>(tab, q1);
    } else {
      M::build_affine_table<WB, false>(tab, q1);
    }
    for (int k = 0; k < T; ++k) store_aff(out + (T * i + k) * 16, tab[k]);
  }
}

// The one-hot select of digits[i] (masked to WB bits) from table i
// (n, 2^WB, 2, 8), out (n, 2, 8).  source 1 reads the table as the G / λG
// select does (entries at SMEM_STRIDE words, table t 0), 0 as the Q select,
// 2 as the λQ select (from the last entry down).  Returns 1 for another
// source.
template <int WB>
int select_entry(const uint32_t* tables, const int32_t* digits, uint32_t* out, int n,
                 int source) {
  constexpr int T = M::TABLE<WB>;
  if (source < 0 || source > 2) return 1;
  for (int i = 0; i < n; ++i) {
    const int digit = digits[i] & (T - 1);
    alignas(16) U::AffPt tab[T];
    for (int k = 0; k < T; ++k) tab[k] = load_aff(tables + (T * i + k) * 16);
    U::AffPt got;
    if (source == 1) {
      uint32_t smem[T * M::SMEM_STRIDE] = {};
      for (int k = 0; k < T; ++k) {
        for (int w = 0; w < U::NWORDS; ++w) {
          smem[k * M::SMEM_STRIDE + w] = tab[k].x.w[w];
          smem[k * M::SMEM_STRIDE + U::NWORDS + w] = tab[k].y.w[w];
        }
      }
      got = M::select_g<WB>(smem, 0, digit);
    } else {
      got = source == 2 ? M::select_q<WB, true>(tab, digit) : M::select_q<WB, false>(tab, digit);
    }
    store_aff(out + 16 * i, got);
  }
  return 0;
}

// The tree select's read of digits[i] (masked to WB bits) from table i
// (n, 2^WB, 2, 8), out (n, 2, 8): source 0 reads it as Q's entry is read
// (entry_q), 1 as G's (entry_g, table t 0, SMEM_STRIDE words an entry), 2 as
// λG's (table t 1), 3 as λQ's (Q's entry, then x·β).  Returns 1 for another
// source.
template <int WB>
int tree_entry(const uint32_t* tables, const int32_t* digits, uint32_t* out, int n,
               int source) {
  constexpr int T = M::TABLE<WB>;
  if (source < 0 || source > 3) return 1;
  U::Fe beta;
  for (int i = 0; i < U::NWORDS; ++i) beta.w[i] = M::BETA_WORDS[i];
  for (int i = 0; i < n; ++i) {
    const int digit = digits[i] & (T - 1);
    alignas(16) U::AffPt tab[T];
    for (int k = 0; k < T; ++k) tab[k] = load_aff(tables + (T * i + k) * 16);
    U::AffPt got;
    if (source == 1 || source == 2) {
      const int t = source - 1;
      uint32_t smem[2 * T * M::SMEM_STRIDE] = {};
      for (int k = 0; k < T; ++k) {
        for (int w = 0; w < U::NWORDS; ++w) {
          smem[(t * T + k) * M::SMEM_STRIDE + w] = tab[k].x.w[w];
          smem[(t * T + k) * M::SMEM_STRIDE + U::NWORDS + w] = tab[k].y.w[w];
        }
      }
      got = M::entry_g<WB>(smem, t, digit);
    } else {
      got = M::entry_q(tab, digit);
      if (source == 3) got.x = U::mul(got.x, beta);
    }
    store_aff(out + 16 * i, got);
  }
  return 0;
}

// G's and λG's affine rows (2, 2^WB, 2, 24) converted as a block converts
// them, into out (2, 2^WB, 2, 8).
template <int WB>
void g_tables(const int32_t* g_rows, uint32_t* out) {
  uint32_t g_tabs[2 * M::TABLE<WB> * M::SMEM_STRIDE] = {};
  M::convert_g_tables<WB>(g_tabs, g_rows, 0, 1);
  for (int e = 0; e < 2 * M::TABLE<WB>; ++e) {
    for (int w = 0; w < 2 * U::NWORDS; ++w) out[e * 16 + w] = g_tabs[e * M::SMEM_STRIDE + w];
  }
}

// verify_lane over B lanes with the arguments of tpn_verify_u32_modes (no
// stream), with the tree select (TREE) or the one-hot one; the G tables
// converted as a block converts them.  Returns 1 for a sqr other than 0 or
// 1.
template <int WB, bool TREE>
int verify(const int32_t* g_rows, const M::VerifyArgs& a, int schnorr_free, int sqr) {
  if (sqr != 0 && sqr != 1) return 1;
  uint32_t g_tabs[2 * M::TABLE<WB> * M::SMEM_STRIDE] = {};
  M::convert_g_tables<WB>(g_tabs, g_rows, 0, 1);
  for (int lane = 0; lane < a.B; ++lane) {
    bool ok;
    if (sqr) {
      ok = schnorr_free ? M::verify_lane<WB, true, true, TREE>(a, g_tabs, lane)
                        : M::verify_lane<WB, false, true, TREE>(a, g_tabs, lane);
    } else {
      ok = schnorr_free ? M::verify_lane<WB, true, false, TREE>(a, g_tabs, lane)
                        : M::verify_lane<WB, false, false, TREE>(a, g_tabs, lane);
    }
    a.out[lane] = ok ? 1 : 0;
  }
  return 0;
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

#define TPN_U32M_WIDTH(P, WB)                                                                  \
  void P##_affine_table(const uint32_t* q, uint32_t* out, int n, int sqr) {                    \
    affine_table<WB>(q, out, n, sqr);                                                          \
  }                                                                                            \
  void P##_g_tables(const int32_t* g_rows, uint32_t* out) { g_tables<WB>(g_rows, out); }       \
  int P##_select(const uint32_t* tables, const int32_t* digits, uint32_t* out, int n,          \
                 int source) {                                                                 \
    return select_entry<WB>(tables, digits, out, n, source);                                   \
  }                                                                                            \
  int P##_verify(const int32_t* g_rows, const int32_t* d1a, const int32_t* d1b,                \
                 const int32_t* d2a, const int32_t* d2b, const uint8_t* n1a,                   \
                 const uint8_t* n1b, const uint8_t* n2a, const uint8_t* n2b,                   \
                 const int32_t* qx, const int32_t* qy, const int32_t* r1, const int32_t* r2,   \
                 const uint8_t* r2_valid, const uint8_t* host_valid, const uint8_t* schnorr,   \
                 const uint8_t* bip340, uint8_t* out, int B, int schnorr_free, int sqr) {      \
    const M::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,             \
                          r2_valid, host_valid, schnorr, bip340, out, B};                      \
    return verify<WB, false>(g_rows, a, schnorr_free, sqr);                                    \
  }

// At 4 bits: tpn_u32m_affine_table (out (n, 16, 2, 8)), tpn_u32m_g_tables
// (out (2, 16, 2, 8)), tpn_u32m_verify and tpn_u32m_select (source 0 Q,
// 1 G / λG, 2 λQ); at 5 bits the same as tpn_u32m5_*, with 32-entry tables.
TPN_U32M_WIDTH(tpn_u32m, 4)
TPN_U32M_WIDTH(tpn_u32m5, 5)

// The tree select at 4 bits: tpn_u32mt_select (source 0 Q, 1 G, 2 λG, 3 λQ)
// and tpn_u32mt_verify, tpn_u32m_verify's arguments.
int tpn_u32mt_select(const uint32_t* tables, const int32_t* digits, uint32_t* out, int n,
                     int source) {
  return tree_entry<4>(tables, digits, out, n, source);
}

int tpn_u32mt_verify(const int32_t* g_rows, const int32_t* d1a, const int32_t* d1b,
                     const int32_t* d2a, const int32_t* d2b, const uint8_t* n1a,
                     const uint8_t* n1b, const uint8_t* n2a, const uint8_t* n2b,
                     const int32_t* qx, const int32_t* qy, const int32_t* r1, const int32_t* r2,
                     const uint8_t* r2_valid, const uint8_t* host_valid, const uint8_t* schnorr,
                     const uint8_t* bip340, uint8_t* out, int B, int schnorr_free, int sqr) {
  const M::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,
                        r2_valid, host_valid, schnorr, bip340, out, B};
  return verify<4, true>(g_rows, a, schnorr_free, sqr);
}

}  // extern "C"

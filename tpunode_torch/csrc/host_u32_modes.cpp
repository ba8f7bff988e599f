// verify_u32_modes.cu (the eager tuples on the 8-word arithmetic) compiled
// as host C++, for the CPU tests (tests/test_torch_u32_modes.py at 4-bit
// windows, tests/test_torch_u32_modes5.py at 5-bit, both one-hot affine;
// tests/test_torch_u32_modes_tree.py, the tree select at 4-bit;
// tests/test_torch_u32_modes5_proj.py, one-hot projective at 5-bit): a
// plain C interface over the eager point formulas, the affine and the
// projective Q tables, the one-hot and the tree selects and the per-lane
// program, each looping over its elements or lanes.  The table, select,
// G-table and per-lane functions are templates on the window width WB (the
// G tables and the per-lane program on the point form too), exported once a
// width and form: tpn_u32m_* at 4 bits,
// tpn_u32m5_* at 5, affine; the tree select's reads and per-lane program at
// 4 bits as tpn_u32mt_*; the projective 5-bit ones as tpn_u32mp5_*.
//
// Not part of the nvcc build.  The test builds this file once with
//   g++ -std=c++17 -O1 -Wall -Wno-unknown-pragmas -fsanitize=undefined
//       -fno-sanitize-recover=all -shared -fPIC
// Unsigned arithmetic cannot overflow, so UBSan guards only the conversions'
// signed sums and the indexing; the values are held against Python integers
// and the plain version.
//
// Layouts: an element is 8 little-endian uint32 words, n elements (n, 8); a
// point (n, 3, 8), an affine one (n, 2, 8); a table (n, 2^WB, 2, 8) affine,
// (n, 2^WB, 3, 8) projective; limb rows are the kernel's (24, B) int32,
// lane-minor.
#include <stdint.h>

#include "verify_u32_modes.cu"

namespace {

namespace U = tpn::u32;
namespace M = tpn::u32::modes;
namespace D = tpn::u32::dot;

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

// The projective Q table of each (qx, qy) (n, 2, 8) into out
// (n, 2^WB, 3, 8).
template <int WB>
void projective_table(const uint32_t* q, uint32_t* out, int n) {
  constexpr int T = M::TABLE<WB>;
  for (int i = 0; i < n; ++i) {
    U::Pt q1;
    q1.x = load(q + 16 * i);
    q1.y = load(q + 16 * i + 8);
    q1.z = U::fe_small(1);
    alignas(16) U::Pt tab[T];
    M::build_projective_table<WB>(tab, q1);
    for (int k = 0; k < T; ++k) store_pt(out + (T * i + k) * 24, tab[k]);
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
  constexpr int T = M::TABLE<WB>, S = M::SMEM_STRIDE<false>;
  if (source < 0 || source > 2) return 1;
  for (int i = 0; i < n; ++i) {
    const int digit = digits[i] & (T - 1);
    alignas(16) U::AffPt tab[T];
    for (int k = 0; k < T; ++k) tab[k] = load_aff(tables + (T * i + k) * 16);
    U::AffPt got;
    if (source == 1) {
      uint32_t smem[T * S] = {};
      for (int k = 0; k < T; ++k) {
        for (int w = 0; w < U::NWORDS; ++w) {
          smem[k * S + w] = tab[k].x.w[w];
          smem[k * S + U::NWORDS + w] = tab[k].y.w[w];
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

// The projective one-hot select of digits[i] (masked to WB bits) from table
// i (n, 2^WB, 3, 8), out (n, 3, 8).  source 1 reads the table as the G / λG
// select does (entries at SMEM_STRIDE words, table t 0); 0 and 2 walk it
// once for Q's and λQ's entries (select_q_pair): 0 gives Q's entry of the
// digit (λQ's digit its complement), 2 λQ's (Q's digit the complement).
// Returns 1 for another source.
template <int WB>
int select_entry_proj(const uint32_t* tables, const int32_t* digits, uint32_t* out, int n,
                      int source) {
  constexpr int T = M::TABLE<WB>, S = M::SMEM_STRIDE<true>;
  if (source < 0 || source > 2) return 1;
  for (int i = 0; i < n; ++i) {
    const int digit = digits[i] & (T - 1), other = (T - 1) - digit;
    alignas(16) U::Pt tab[T];
    for (int k = 0; k < T; ++k) tab[k] = load_pt(tables + (T * i + k) * 24);
    U::Pt got, rest;
    if (source == 1) {
      uint32_t smem[T * S] = {};
      for (int k = 0; k < T; ++k) {
        for (int w = 0; w < 3 * U::NWORDS; ++w) smem[k * S + w] = tables[(T * i + k) * 24 + w];
      }
      got = M::select_g_proj<WB>(smem, 0, digit);
    } else if (source == 0) {
      M::select_q_pair<WB>(tab, digit, other, got, rest);
    } else {
      M::select_q_pair<WB>(tab, other, digit, rest, got);
    }
    store_pt(out + 24 * i, got);
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
  constexpr int T = M::TABLE<WB>, S = M::SMEM_STRIDE<false>;
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
      uint32_t smem[2 * T * S] = {};
      for (int k = 0; k < T; ++k) {
        for (int w = 0; w < U::NWORDS; ++w) {
          smem[(t * T + k) * S + w] = tab[k].x.w[w];
          smem[(t * T + k) * S + U::NWORDS + w] = tab[k].y.w[w];
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

// G's and λG's rows (2, 2^WB, COORDS, 24) converted as a block converts
// them, into out (2, 2^WB, COORDS, 8).
template <int WB, bool PROJ>
void g_tables(const int32_t* g_rows, uint32_t* out) {
  constexpr int W = (PROJ ? 3 : 2) * U::NWORDS, S = M::SMEM_STRIDE<PROJ>;
  uint32_t g_tabs[2 * M::TABLE<WB> * S] = {};
  M::convert_g_tables<WB, PROJ>(g_tabs, g_rows, 0, 1);
  for (int e = 0; e < 2 * M::TABLE<WB>; ++e) {
    for (int w = 0; w < W; ++w) out[e * W + w] = g_tabs[e * S + w];
  }
}

// verify_lane over B lanes with the arguments of tpn_verify_u32_modes (no
// stream), with the tree select (TREE) or the one-hot one, in the point
// form PROJ, eager and shift-add or (DOT) lazy and dot_general, each
// product then dot_lane's; the G tables converted as a block converts them.
// Returns 1 for a sqr other than 0 or 1.
template <int WB, bool TREE, bool PROJ, bool DOT = false>
int verify(const int32_t* g_rows, const M::VerifyArgs& a, int schnorr_free, int sqr) {
  if (sqr != 0 && sqr != 1) return 1;
  uint32_t g_tabs[2 * M::TABLE<WB> * M::SMEM_STRIDE<PROJ>] = {};
  M::convert_g_tables<WB, PROJ>(g_tabs, g_rows, 0, 1);
  for (int lane = 0; lane < a.B; ++lane) {
    bool ok;
    if constexpr (DOT) {
      using Half = D::DotMul<false>;
      using Full = D::DotMul<true>;
      if (sqr) {
        ok = schnorr_free ? M::verify_lane<WB, true, true, TREE, PROJ, true, Full>(a, g_tabs, lane)
                          : M::verify_lane<WB, false, true, TREE, PROJ, true, Full>(a, g_tabs, lane);
      } else {
        ok = schnorr_free ? M::verify_lane<WB, true, false, TREE, PROJ, true, Half>(a, g_tabs, lane)
                          : M::verify_lane<WB, false, false, TREE, PROJ, true, Half>(a, g_tabs, lane);
      }
    } else if (sqr) {
      ok = schnorr_free ? M::verify_lane<WB, true, true, TREE, PROJ>(a, g_tabs, lane)
                        : M::verify_lane<WB, false, true, TREE, PROJ>(a, g_tabs, lane);
    } else {
      ok = schnorr_free ? M::verify_lane<WB, true, false, TREE, PROJ>(a, g_tabs, lane)
                        : M::verify_lane<WB, false, false, TREE, PROJ>(a, g_tabs, lane);
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
  void P##_g_tables(const int32_t* g_rows, uint32_t* out) {                                    \
    g_tables<WB, false>(g_rows, out);                                                          \
  }                                                                                            \
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
    return verify<WB, false, false>(g_rows, a, schnorr_free, sqr);                             \
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
  return verify<4, true, false>(g_rows, a, schnorr_free, sqr);
}

// The one-hot projective select at 5 bits: tpn_u32mp5_table (out
// (n, 32, 3, 8)), tpn_u32mp5_g_tables (out (2, 32, 3, 8)), tpn_u32mp5_select
// (source 0 Q, 1 G / λG, 2 λQ, Q's and λQ's from one walk; tables
// (n, 32, 3, 8)) and tpn_u32mp5_verify,
// tpn_u32m_verify's arguments.
void tpn_u32mp5_table(const uint32_t* q, uint32_t* out, int n) { projective_table<5>(q, out, n); }

void tpn_u32mp5_g_tables(const int32_t* g_rows, uint32_t* out) { g_tables<5, true>(g_rows, out); }

int tpn_u32mp5_select(const uint32_t* tables, const int32_t* digits, uint32_t* out, int n,
                      int source) {
  return select_entry_proj<5>(tables, digits, out, n, source);
}

int tpn_u32mp5_verify(const int32_t* g_rows, const int32_t* d1a, const int32_t* d1b,
                      const int32_t* d2a, const int32_t* d2b, const uint8_t* n1a,
                      const uint8_t* n1b, const uint8_t* n2a, const uint8_t* n2b,
                      const int32_t* qx, const int32_t* qy, const int32_t* r1, const int32_t* r2,
                      const uint8_t* r2_valid, const uint8_t* host_valid, const uint8_t* schnorr,
                      const uint8_t* bip340, uint8_t* out, int B, int schnorr_free, int sqr) {
  const M::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,
                        r2_valid, host_valid, schnorr, bip340, out, B};
  return verify<5, false, true>(g_rows, a, schnorr_free, sqr);
}

// The lazy dot_general tuple at 5 bits (tests/test_torch_u32_dot5.py):
// the contraction's host forms and the per-lane program.
//
// tpn_u32d_contract: out (n, 16) = x·y (half 0) or the half square of x
// (half 1; y unread) of (n, 8) elements, its 16 words before the reduction,
// by dot_warp_host (form 0: n a multiple of 32, warp by warp), dot_lane_wide
// (form 1) or field_u32.cuh's mul_wide / sqr_wide (form 2, shift-add); with
// reduced 1, out (n, 8) is that reduced by reduce_wide (form 1: dot_lane, the
// per-lane program's product).  Returns 1 for another form, half or n.
int tpn_u32d_contract(const uint32_t* x, const uint32_t* y, uint32_t* out, int n, int half,
                      int form, int reduced) {
  if (form < 0 || form > 2 || (half != 0 && half != 1) || (form == 0 && n % 32)) return 1;
  const int lanes = form == 0 ? 32 : 1;
  for (int base = 0; base < n; base += lanes) {
    U::Fe a[32], b[32];
    uint32_t wide[32][U::NWIDE];
    for (int k = 0; k < lanes; ++k) {
      a[k] = load(x + 8 * (base + k));
      b[k] = half ? a[k] : load(y + 8 * (base + k));
    }
    if (form == 0) {
      if (half) {
        D::dot_warp_host<true>(wide, a, b);
      } else {
        D::dot_warp_host<false>(wide, a, b);
      }
    } else if (form == 1) {
      if (half) {
        D::dot_lane_wide<true>(wide[0], a[0], b[0]);
      } else {
        D::dot_lane_wide<false>(wide[0], a[0], b[0]);
      }
    } else if (half) {
      U::sqr_wide(wide[0], a[0]);
    } else {
      U::mul_wide(wide[0], a[0], b[0]);
    }
    for (int k = 0; k < lanes; ++k) {
      if (!reduced) {
        for (int i = 0; i < U::NWIDE; ++i) out[U::NWIDE * (base + k) + i] = wide[k][i];
      } else if (form == 1) {
        store(out + 8 * (base + k), half ? D::dot_lane<true>(a[k], b[k])
                                          : D::dot_lane<false>(a[k], b[k]));
      } else {
        store(out + 8 * (base + k), U::reduce_wide(wide[k]));
      }
    }
  }
  return 0;
}

// The lazy tuple's bodies under the dot_general multiply (dot_lane; sqr 0
// the half square, 1 the full one): op 0 pt_add_mixed_eager, its one mixed
// add (q (n, 2, 8)), 1 pt_add
// (q (n, 3, 8)), 2 pt_double (q unread); out (n, 3, 8).  Returns 1 for
// another op or sqr.
int tpn_u32d_point(const uint32_t* p, const uint32_t* q, uint32_t* out, int n, int op, int sqr) {
  if (op < 0 || op > 2 || (sqr != 0 && sqr != 1)) return 1;
  for (int i = 0; i < n; ++i) {
    const U::Pt a = load_pt(p + 24 * i);
    U::Pt r;
    if (op == 0) {
      r = U::pt_add_mixed_eager<D::DotMul<false>>(a, load_aff(q + 16 * i));
    } else if (op == 1) {
      r = U::pt_add<D::DotMul<false>>(a, load_pt(q + 24 * i));
    } else {
      r = sqr ? U::pt_double<D::DotMul<true>>(a) : U::pt_double<D::DotMul<false>>(a);
    }
    store_pt(out + 24 * i, r);
  }
  return 0;
}

// dot_lane's calls since the last read, (2,): the full products, then the
// half squares; read and reset.
void tpn_u32d_calls(uint64_t* out) {
  for (int h = 0; h < 2; ++h) {
    out[h] = D::host_dot_calls[h];
    D::host_dot_calls[h] = 0;
  }
}

// tpn_u32m_verify's arguments at 5 bits, affine, lazy, one-hot, dot_general.
int tpn_u32d5_verify(const int32_t* g_rows, const int32_t* d1a, const int32_t* d1b,
                     const int32_t* d2a, const int32_t* d2b, const uint8_t* n1a,
                     const uint8_t* n1b, const uint8_t* n2a, const uint8_t* n2b,
                     const int32_t* qx, const int32_t* qy, const int32_t* r1, const int32_t* r2,
                     const uint8_t* r2_valid, const uint8_t* host_valid, const uint8_t* schnorr,
                     const uint8_t* bip340, uint8_t* out, int B, int schnorr_free, int sqr) {
  const M::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,
                        r2_valid, host_valid, schnorr, bip340, out, B};
  return verify<5, false, false, true>(g_rows, a, schnorr_free, sqr);
}

}  // extern "C"

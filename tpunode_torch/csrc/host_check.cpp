// The verify kernel's device code compiled as host C++, for the CPU tests
// (tests/test_torch_hostcc.py): a plain C interface over the field and
// curve functions, the window-table select, the probe lanes, the
// field_mul_dot probe's warps and their tensor-core contraction (emulated
// a warp at a time, field_dot.cuh; the verify kernel's under dot_general)
// and the per-lane program verify_lane, each looping over lanes.
//
// Not part of the nvcc build: cuda_kernel.build compiles verify_kernel.cu
// and diag.cu only.  The test builds this file with
//   g++ -std=c++17 -O1 -Wno-unknown-pragmas -fsanitize=undefined
//       -fno-sanitize-recover=all -shared -fPIC
// so a signed overflow or a shift out of range aborts the process.  Without
// __CUDACC__ the TPN_* macros of field.cuh make the headers plain C++, limb
// for limb the card's code; the plain version (tpunode_torch/verify) is the
// yardstick.
//
// Layouts are the kernel's: a field element is a (24, B) block of limb rows,
// a point (3, 24, B) or, affine, (2, 24, B), lane-minor.  Both squares are
// instantiated (sqr 0: the half product, 1: the full product), and the
// calls of the convolutions are counted through field.cuh's TPN_COUNT hook,
// which the nvcc build compiles to nothing.  Built with -DTPN_MUL_DOT=1 the
// same file checks the dot_general build: every convolution is
// field_dot.cuh's conv_dot or sqr_dot in its per-lane host form (dot_lane),
// and verify_lane keeps the warp-converged paths of the kernel, a lane a
// warp of its own.
#include <stdint.h>

namespace {
struct Counts {
  int64_t conv, sqr_conv, conv_dot, sqr_dot;
};
Counts counts;
}  // namespace

#define TPN_COUNT(counter) (++counts.counter)
#include "diag.cu"
#include "verify_kernel.cu"

namespace {

using tpn::AffPt;
using tpn::NL;
using tpn::Pt;

void load_pt(Pt* p, const int32_t* rows, int B, int lane) {
  tpn::load_col(p->x, rows, B, lane);
  tpn::load_col(p->y, rows + NL * B, B, lane);
  tpn::load_col(p->z, rows + 2 * NL * B, B, lane);
}

void load_pt(AffPt* p, const int32_t* rows, int B, int lane) {
  tpn::load_col(p->x, rows, B, lane);
  tpn::load_col(p->y, rows + NL * B, B, lane);
}

void store_pt(int32_t* rows, const Pt& p, int B, int lane) {
  tpn::store_col(rows, p.x, B, lane);
  tpn::store_col(rows + NL * B, p.y, B, lane);
  tpn::store_col(rows + 2 * NL * B, p.z, B, lane);
}

// Each lane's verdict, and into lane_counts (B, 4), when not null, the
// lane's calls of conv, sqr_conv, conv_dot and sqr_dot.
template <bool SCHNORR_FREE, int WB, bool AFFINE, bool EAGER, bool ONEHOT, bool SQR_MUL>
int verify_lanes(const tpn::VerifyArgs& a, const int32_t* g_tabs, int64_t* lane_counts) {
  using Entry = typename std::conditional<AFFINE, AffPt, Pt>::type;
  const Entry* g = reinterpret_cast<const Entry*>(g_tabs);
  for (int lane = 0; lane < a.B; ++lane) {
    counts = Counts{};
    a.out[lane] = tpn::verify_lane<SCHNORR_FREE, WB, AFFINE, EAGER, ONEHOT, SQR_MUL>(
                      a, g, g + (1 << WB), lane)
                      ? 1
                      : 0;
    if (lane_counts != nullptr) {
      lane_counts[4 * lane] = counts.conv;
      lane_counts[4 * lane + 1] = counts.sqr_conv;
      lane_counts[4 * lane + 2] = counts.conv_dot;
      lane_counts[4 * lane + 3] = counts.sqr_dot;
    }
  }
  return 0;
}

template <bool SCHNORR_FREE, int WB, bool AFFINE, bool EAGER, bool ONEHOT>
int verify_sqr(const tpn::VerifyArgs& a, const int32_t* g_tabs, int sqr, int64_t* lane_counts) {
  if (sqr == 0) return verify_lanes<SCHNORR_FREE, WB, AFFINE, EAGER, ONEHOT, false>(a, g_tabs,
                                                                                 lane_counts);
  if (sqr == 1) return verify_lanes<SCHNORR_FREE, WB, AFFINE, EAGER, ONEHOT, true>(a, g_tabs,
                                                                                lane_counts);
  return 1;
}

template <bool SCHNORR_FREE, int WB, bool AFFINE, bool EAGER>
int verify_select(const tpn::VerifyArgs& a, const int32_t* g_tabs, int select, int sqr,
                  int64_t* lane_counts) {
  if (select == 0) {
    return verify_sqr<SCHNORR_FREE, WB, AFFINE, EAGER, false>(a, g_tabs, sqr, lane_counts);
  }
  if (select == 1) {
    return verify_sqr<SCHNORR_FREE, WB, AFFINE, EAGER, true>(a, g_tabs, sqr, lane_counts);
  }
  return 1;
}

template <bool SCHNORR_FREE, int WB, bool AFFINE>
int verify_reduce(const tpn::VerifyArgs& a, const int32_t* g_tabs, int reduce, int select,
                  int sqr, int64_t* lane_counts) {
  if (reduce == 0) {
    return verify_select<SCHNORR_FREE, WB, AFFINE, false>(a, g_tabs, select, sqr, lane_counts);
  }
  if (reduce == 1) {
    return verify_select<SCHNORR_FREE, WB, AFFINE, true>(a, g_tabs, select, sqr, lane_counts);
  }
  return 1;
}

template <bool SCHNORR_FREE, int WB>
int verify_form(const tpn::VerifyArgs& a, const int32_t* g_tabs, int point_form, int reduce,
                int select, int sqr, int64_t* lane_counts) {
  if (point_form == 0) {
    return verify_reduce<SCHNORR_FREE, WB, false>(a, g_tabs, reduce, select, sqr, lane_counts);
  }
  if (point_form == 1) {
    return verify_reduce<SCHNORR_FREE, WB, true>(a, g_tabs, reduce, select, sqr, lane_counts);
  }
  return 1;
}

// One table of TABLE entries (TABLE, C, 24), each digit's entry by
// select_entry into out (n, C, 24).
template <typename Entry, int TABLE>
void select_lanes(const int32_t* table, const int32_t* digits, int32_t* out, int n, int onehot) {
  const Entry* t = reinterpret_cast<const Entry*>(table);
  Entry* o = reinterpret_cast<Entry*>(out);
  for (int i = 0; i < n; ++i) {
    Entry sel;
    o[i] = onehot ? *tpn::select_entry<true, Entry, TABLE>(t, digits[i], &sel)
                  : *tpn::select_entry<false, Entry, TABLE>(t, digits[i], &sel);
  }
}

}  // namespace

extern "C" {

// The multiply this library was built with: 0 shift_add, 1 dot_general.
int tpn_host_mul_dot() { return TPN_MUL_DOT; }

void tpn_host_mul_t(const int32_t* a, const int32_t* b, int32_t* out, int B) {
  for (int lane = 0; lane < B; ++lane) {
    int32_t x[NL], y[NL];
    tpn::load_col(x, a, B, lane);
    tpn::load_col(y, b, B, lane);
    tpn::mul_t(x, x, y);
    tpn::store_col(out, x, B, lane);
  }
}

// sqr 1 squares by the full product, 0 by the half product.
void tpn_host_sqr_t(const int32_t* a, int32_t* out, int B, int sqr) {
  for (int lane = 0; lane < B; ++lane) {
    int32_t x[NL];
    tpn::load_col(x, a, B, lane);
    if (sqr) {
      tpn::sqr_t<true>(x, x);
    } else {
      tpn::sqr_t<false>(x, x);
    }
    tpn::store_col(out, x, B, lane);
  }
}

// The three point formulas; eager 1 runs the eager bodies, 0 the lazy ones;
// the doubling squares as tpn_host_sqr_t's sqr says.
void tpn_host_pt_add(const int32_t* p, const int32_t* q, int32_t* out, int B, int eager) {
  for (int lane = 0; lane < B; ++lane) {
    Pt a, b;
    load_pt(&a, p, B, lane);
    load_pt(&b, q, B, lane);
    if (eager) {
      tpn::pt_add<true>(&a, &a, &b);
    } else {
      tpn::pt_add<false>(&a, &a, &b);
    }
    store_pt(out, a, B, lane);
  }
}

void tpn_host_pt_add_mixed(const int32_t* p, const int32_t* q, int32_t* out, int B,
                           int eager) {
  for (int lane = 0; lane < B; ++lane) {
    Pt a;
    AffPt b;
    load_pt(&a, p, B, lane);
    load_pt(&b, q, B, lane);
    if (eager) {
      tpn::pt_add_mixed<true>(&a, &a, &b);
    } else {
      tpn::pt_add_mixed<false>(&a, &a, &b);
    }
    store_pt(out, a, B, lane);
  }
}

void tpn_host_pt_double(const int32_t* p, int32_t* out, int B, int eager, int sqr) {
  for (int lane = 0; lane < B; ++lane) {
    Pt a;
    load_pt(&a, p, B, lane);
    if (eager && sqr) {
      tpn::pt_double<true, true>(&a, &a);
    } else if (eager) {
      tpn::pt_double<true, false>(&a, &a);
    } else if (sqr) {
      tpn::pt_double<false, true>(&a, &a);
    } else {
      tpn::pt_double<false, false>(&a, &a);
    }
    store_pt(out, a, B, lane);
  }
}

// The window-table select over a (entries, 3 or 2, 24) table: 0 when
// entries is 16 or 32, else 1.
int tpn_host_select(const int32_t* table, const int32_t* digits, int32_t* out, int n,
                    int entries, int affine, int onehot) {
  if (entries == 16 && affine) select_lanes<AffPt, 16>(table, digits, out, n, onehot);
  else if (entries == 16) select_lanes<Pt, 16>(table, digits, out, n, onehot);
  else if (entries == 32 && affine) select_lanes<AffPt, 32>(table, digits, out, n, onehot);
  else if (entries == 32) select_lanes<Pt, 32>(table, digits, out, n, onehot);
  else return 1;
  return 0;
}

void tpn_host_field_mul(const int32_t* a, const int32_t* b, int32_t* out, int B) {
  for (int lane = 0; lane < B; ++lane) tpn::diag_field_mul_lane(a, b, out, B, lane);
}

// The field_mul_dot kernel over B lanes, in warps of 32, the last one
// padded with zeros.
void tpn_host_field_mul_dot(const int32_t* a, const int32_t* b, int32_t* out, int B) {
  for (int warp = 0; 32 * warp < B; ++warp) tpn::diag_field_mul_dot_warp(a, b, out, B, warp);
}

// dot_warp alone: w (47, B) for the carried limbs a, b (24, B) (half 0:
// their convolution; 1: the half-product square of a, b unread), in warps
// of 32, the last one padded with zeros.
void tpn_host_conv_dot(const int32_t* a, const int32_t* b, int32_t* w, int B, int half) {
  for (int warp = 0; 32 * warp < B; ++warp) {
    int32_t x[32][NL], y[32][NL], wide[32][tpn::NW];
    uint32_t buf[tpn::DOT_WARP_WORDS];
    tpn::load_warp(x, a, B, warp);
    tpn::load_warp(y, half ? a : b, B, warp);
    if (half) {
      tpn::dot_warp<true>(wide, x, y, buf);
    } else {
      tpn::dot_warp<false>(wide, x, y, buf);
    }
    for (int n = 0; n < 32 && 32 * warp + n < B; ++n) {
      for (int k = 0; k < tpn::NW; ++k) w[k * B + 32 * warp + n] = wide[n][k];
    }
  }
}

void tpn_host_lazy_reduce(const int32_t* a, const int32_t* b, const int32_t* c,
                          const int32_t* d, int32_t* out, int B) {
  for (int lane = 0; lane < B; ++lane) tpn::diag_lazy_reduce_lane(a, b, c, d, out, B, lane);
}

void tpn_host_table_build(const int32_t* a, int32_t* out, int B) {
  for (int lane = 0; lane < B; ++lane) tpn::diag_table_build_lane(a, out, B, lane);
}

void tpn_host_pow_descan(const int32_t* t, int32_t* out, int B) {
  for (int lane = 0; lane < B; ++lane) tpn::diag_pow_descan_lane(t, out, B, lane);
}

void tpn_host_select_tree(const int32_t* t, const int32_t* d, int32_t* out, int B) {
  for (int lane = 0; lane < B; ++lane) tpn::diag_select_tree_lane(t, d, out, B, lane);
}

void tpn_host_pow_window(const int32_t* t, const int32_t* digits, int32_t* out, int B) {
  for (int lane = 0; lane < B; ++lane) tpn::diag_pow_window_lane(t, digits, out, B, lane);
}

void tpn_host_window5(const int32_t* a, const int32_t* g_tab, const int32_t* d, int32_t* out,
                      int B) {
  for (int lane = 0; lane < B; ++lane) tpn::diag_window5_lane(a, g_tab, d, out, B, lane);
}

// verify_lane over B lanes with the arguments of tpn_verify_blocked (no
// stream and no mul: the build's), and each lane's calls of conv, sqr_conv,
// conv_dot and sqr_dot into lane_counts (B, 4) unless it is null; returns 1
// for a width, a form, a reduce, a select or a sqr that the kernel has no
// instantiation of, as the launcher returns cudaErrorInvalidValue.
int tpn_host_verify(const int32_t* g_tabs, const int32_t* d1a, const int32_t* d1b,
                    const int32_t* d2a, const int32_t* d2b, const uint8_t* n1a,
                    const uint8_t* n1b, const uint8_t* n2a, const uint8_t* n2b,
                    const int32_t* qx, const int32_t* qy, const int32_t* r1, const int32_t* r2,
                    const uint8_t* r2_valid, const uint8_t* host_valid, const uint8_t* schnorr,
                    const uint8_t* bip340, uint8_t* out, int B, int schnorr_free,
                    int window_bits, int point_form, int reduce, int select, int sqr,
                    int64_t* lane_counts) {
  const tpn::VerifyArgs a{d1a, d1b, d2a, d2b, n1a, n1b, n2a, n2b, qx, qy, r1, r2,
                          r2_valid, host_valid, schnorr, bip340, out, B};
  if (window_bits == 4 && schnorr_free) {
    return verify_form<true, 4>(a, g_tabs, point_form, reduce, select, sqr, lane_counts);
  }
  if (window_bits == 4) {
    return verify_form<false, 4>(a, g_tabs, point_form, reduce, select, sqr, lane_counts);
  }
  if (window_bits == 5 && schnorr_free) {
    return verify_form<true, 5>(a, g_tabs, point_form, reduce, select, sqr, lane_counts);
  }
  if (window_bits == 5) {
    return verify_form<false, 5>(a, g_tabs, point_form, reduce, select, sqr, lane_counts);
  }
  return 1;
}

}  // extern "C"

// Probes of the verify kernel's constructs on Hopper, one hand-written CUDA
// kernel each, for tpunode_torch/cuda_diag.py.
//
// Counterparts of benchmarks/mosaic_diag.py's Mosaic probes:
// * trivial_kernel replaces _trivial (pallas_call at :89): x + 1 over an
//   (8, 128) int32 block, one element a thread: the toolchain's floor;
// * field_mul_kernel replaces _field_mul (pallas_call at :114):
//   canonical(mul(a, b)) per lane, the eager point formulas' construct (one
//   product reduced at once, mul's input carry folding loose limbs);
// * field_mul_dot_kernel replaces _field_mul_dot (:123, which runs
//   _field_mul's pallas_call at :114 under mul="dot_general"): the same
//   canonical(mul(a, b)) with the convolution as the 576 partial products
//   contracted against the (47, 576) anti-diagonal scatter on the integer
//   tensor cores, mma.sync.aligned.m16n8k32 (field_dot.cuh's dot_warp, the
//   verify kernel's own contraction under dot_general, whose note says how
//   the int32 sums stay exact and what bounds it): a warp-collective
//   kernel, 32 lanes a warp, whose threads never return early (lanes past B
//   contract zeros and skip their stores);
// * field_mul_u32_kernel computes _field_mul's function (pallas_call at
//   :114), canonical(a·b), on field_u32.cuh's 8-word elements, the field
//   layer of verify_u32.cu (the main path's kernel): the radix-11 rows
//   converted on load, 64 widening multiplies and the 2^256 ≡ 2^32 + 977
//   fold, one conditional subtraction of p, and the result written back as
//   canonical radix-11 limbs.  It pins a fault to that arithmetic and gives
//   the cost of one of its multiplies beside field_mul's;
// * lazy_reduce_kernel replaces _lazy_reduce (pallas_call at :538):
//   canonical(reduce_wide_loose(conv(a, b) + conv(c, d))) per lane, the lazy
//   point formulas' construct (two bare products accumulated wide, one
//   loose reduction);
// * mixed_add_kernel replaces _mixed_add (pallas_call at :300): one complete
//   mixed addition (px, py, 1) + (qx, qy) per lane through curve.cuh's lazy
//   pt_add_mixed, the window add of the affine form;
// * table_build_kernel replaces _table_build (pallas_call at :175): the
//   16-entry power table [1, a, .., a^15] of one lane's a written by dynamic
//   index in local memory, k = 2 .. 15 in a #pragma unroll 1 loop (the
//   construct of verify_kernel.cu's build_tables), and canonical(a^15);
// * pow_descan_kernel replaces _pow_descan (pallas_call at :440): Euler's
//   pow t^((p-1)/2) with every digit a compile-time constant (kernel.py's
//   _pow_const in its unroll form): the power table by the static log-depth
//   chain, the first window's entry seeding the accumulator, then 63
//   windows of four squarings and a multiply by the entry of a digit nvcc
//   sees as a literal (a zero digit would drop its multiply at compile
//   time).  The digits come from the exponent's 64-bit words as template
//   arguments, never from memory: no __constant__ or global array, so no
//   digit load and no select; on quadratic residues every lane's canonical
//   result is 1;
// * batch_inv_kernel replaces _batch_inv (pallas_call at :379): the affine
//   Q table's batch inversion over 16 entries, composed as the verify kernel
//   composes it — the column z^1 .. z^14 of one lane's z in entries 2 .. 15,
//   prefix products, one Fermat ladder (pow_const, digits in __constant__),
//   then the suffix step of entry 15 — and canonical(z_15 · z_15^-1), which
//   must be 1;
// * select_tree_kernel replaces _select_tree (pallas_call at :496): the
//   16-entry power table [1, t, .., t^15] of one lane's t by 14 sequential
//   multiplies in local memory, then entry d by the literal 4-level tree (15
//   branch-free selects, level i resolving digit bit i); out canonical(t^d);
// * pow_window_kernel and pow_window_smem_kernel replace the two cases of
//   _pow_window_impl (pallas_call at :245; _pow_window :257 and
//   _pow_window_smem :261): Euler's pow t^((p-1)/2) as 64 windows of four
//   squarings and one multiply by the 16-entry power table's entry picked by
//   a one-hot compare-accumulate on the window's digit, read by dynamic index
//   from a (2, 64) int32 array: in global memory (the reference's VMEM
//   case) or staged in shared memory (its SMEM case); on quadratic residues
//   every lane's canonical result is 1;
// * window5_kernel replaces _window5 (pallas_call at :608): a 32-entry
//   per-lane power table of a in local memory and a shared constant table of
//   g^k, k < 32, loaded once per block into shared memory as the verify
//   kernel loads G / λG, both read by the 5-level tree on the lane's digit;
//   out canonical(a^d · g^d).
// Each is one lane (one element for trivial) per thread, 128 threads a
// block (field_mul_dot's four warps each contracting its 32 lanes
// together), tables in local memory, with the verify kernel's own
// functions: a fault here is pinned to the construct.  Their squares are
// the half product (SQR_MUL false, named at every call): the reference's
// probes run its default formulation.  What bounds them: int32 issue,
// like the verify kernel (trivial: its bytes); at the probes' few hundred
// lanes, a few blocks, the launch itself dominates.  The plain versions are
// cuda_diag's *_plain functions.
#include "curve.cuh"
#include "field_dot.cuh"
#include "field_u32.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

namespace tpn {

// out (24, B): canonical(mul(a, b)).
TPN_INLINE void diag_field_mul_lane(const int32_t* a, const int32_t* b, int32_t* out, int B,
                                    int lane) {
  int32_t x[NL], y[NL];
  load_col(x, a, B, lane);
  load_col(y, b, B, lane);
  mul(x, x, y);
  canonical(x, x);
  store_col(out, x, B, lane);
}

// out (24, B): canonical(a·b) by field_u32.cuh's 8-word arithmetic.
TPN_INLINE void diag_field_mul_u32_lane(const int32_t* a, const int32_t* b, int32_t* out,
                                        int B, int lane) {
  const u32::Fe x = u32::from_radix11(a, B, lane), y = u32::from_radix11(b, B, lane);
  u32::to_radix11(out, u32::canonical(u32::mul(x, y)), B, lane);
}

#if !defined(__CUDACC__)

// Lanes 32·warp .. 32·warp + 31 of the limb rows (24, B) as 32 field
// elements, zeros at and past B: a warp's operands, its last one padded.
static void load_warp(int32_t (*x)[NL], const int32_t* rows, int B, int warp) {
  for (int n = 0; n < 32; ++n) {
    if (32 * warp + n < B) {
      load_col(x[n], rows, B, 32 * warp + n);
    } else {
      set_small(x[n], 0);
    }
  }
}

// The field_mul_dot kernel's warp `warp` as host C++: lanes at or past B
// contract zeros and store nothing (host_check.cpp's; host_u32.cpp, which
// includes this file for field_mul_u32, leaves it unused).
[[maybe_unused]] static void diag_field_mul_dot_warp(const int32_t* a, const int32_t* b, int32_t* out, int B,
                                    int warp) {
  int32_t x[32][NL], y[32][NL], w[32][NW];
  uint32_t buf[DOT_WARP_WORDS];
  load_warp(x, a, B, warp);
  load_warp(y, b, B, warp);
  for (int n = 0; n < 32; ++n) {
    carry<NL>(x[n]);
    carry<NL>(y[n]);
  }
  dot_warp<false>(w, x, y, buf);
  for (int n = 0; n < 32 && 32 * warp + n < B; ++n) {
    reduce_wide(x[n], w[n]);
    canonical(x[n], x[n]);
    store_col(out, x[n], B, 32 * warp + n);
  }
}

#endif

// out (24, B): canonical(reduce_wide_loose(conv(a, b) + conv(c, d))), the
// sum of two bare products (field.acc_add of two mul_t_wide).
TPN_INLINE void diag_lazy_reduce_lane(const int32_t* a, const int32_t* b, const int32_t* c,
                                      const int32_t* d, int32_t* out, int B, int lane) {
  int32_t x[NL], y[NL], w[NW], w2[NW];
  load_col(x, a, B, lane);
  load_col(y, b, B, lane);
  conv(w, x, y);
  load_col(x, c, B, lane);
  load_col(y, d, B, lane);
  conv(w2, x, y);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = w[i] + w2[i];
  reduce_wide_loose(x, w);
  canonical(x, x);
  store_col(out, x, B, lane);
}

// out (3, 24, B): the projective sum of (px, py, 1) and the affine (qx, qy).
TPN_INLINE void diag_mixed_add_lane(const int32_t* px, const int32_t* py, const int32_t* qx,
                                    const int32_t* qy, int32_t* out, int B, int lane) {
  Pt p, r;
  AffPt q;
  load_col(p.x, px, B, lane);
  load_col(p.y, py, B, lane);
  set_small(p.z, 1);
  load_col(q.x, qx, B, lane);
  load_col(q.y, qy, B, lane);
  pt_add_mixed<false>(&r, &p, &q);
  store_col(out, r.x, B, lane);
  store_col(out + NL * B, r.y, B, lane);
  store_col(out + 2 * NL * B, r.z, B, lane);
}

// out (24, B): canonical(z_15 · z_15^-1) for the column z_k = z^(k-1).
TPN_INLINE void diag_batch_inv_lane(const int32_t* z, int32_t* out, int B, int lane) {
  constexpr int TABLE = 16;
  int32_t ztab[TABLE][NL], ptab[TABLE][NL], inv[NL];
  load_col(ztab[2], z, B, lane);
#pragma unroll 1
  for (int k = 3; k < TABLE; ++k) mul(ztab[k], ztab[k - 1], ztab[2]);
  set_small(ptab[1], 1);
  copy(ptab[2], ztab[2]);
#pragma unroll 1
  for (int k = 3; k < TABLE; ++k) mul(ptab[k], ptab[k - 1], ztab[k]);
  pow_const<false>(inv, ptab[TABLE - 1], false);
  mul(inv, inv, ptab[TABLE - 2]);  // z_15^-1 = (z_2 .. z_15)^-1 · (z_2 .. z_14)
  mul(inv, ztab[TABLE - 1], inv);
  canonical(inv, inv);
  store_col(out, inv, B, lane);
}

// [1, t, .., t^(T-1)] by T - 2 sequential multiplies.
template <int T>
TPN_INLINE void power_table(int32_t (*tab)[NL], const int32_t* t) {
  set_small(tab[0], 1);
  copy(tab[1], t);
#pragma unroll 1
  for (int k = 2; k < T; ++k) mul(tab[k], tab[k - 1], t);
}

// Entry d of a T-entry table (T x 24 words) by the balanced tree
// (kernel.select_tree16): level i keeps, of each pair, the odd entry where
// bit i of d is set; the first level reads the table, the others fold
// `level` in place.  Each select is branch-free: (odd & m) | (even & ~m).
template <int T>
TPN_INLINE void tree_select(int32_t* out, const int32_t* tab, int d) {
  int32_t level[T / 2][NL];
  int32_t m = -(d & 1);
#pragma unroll 1
  for (int j = 0; j < T / 2; ++j) {
    const int32_t* odd = tab + (2 * j + 1) * NL;
    const int32_t* even = tab + 2 * j * NL;
#pragma unroll
    for (int i = 0; i < NL; ++i) level[j][i] = (odd[i] & m) | (even[i] & ~m);
  }
#pragma unroll 1
  for (int n = T / 4, bit = 1; n >= 1; n /= 2, ++bit) {
    m = -((d >> bit) & 1);
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        level[j][i] = (level[2 * j + 1][i] & m) | (level[2 * j][i] & ~m);
      }
    }
  }
  copy(out, level[0]);
}

// out (24, B): canonical(a^15), the last entry of a's power table.
TPN_INLINE void diag_table_build_lane(const int32_t* a, int32_t* out, int B, int lane) {
  int32_t x[NL], tab[16][NL];
  load_col(x, a, B, lane);
  power_table<16>(tab, x);
  canonical(x, tab[15]);
  store_col(out, x, B, lane);
}

// The 4-bit digit W (most significant first, W = 0 .. 63) of the exponent
// whose 64-bit words, most significant first, are E3 .. E0.
template <uint64_t E3, uint64_t E2, uint64_t E1, uint64_t E0, int W>
struct ExpDigit {
  static_assert(W >= 0 && W < 64, "64 windows of 4 bits");
  static constexpr uint64_t word = W < 16 ? E3 : (W < 32 ? E2 : (W < 48 ? E1 : E0));
  static constexpr int value = static_cast<int>((word >> (4 * (15 - W % 16))) & 15);
};

// Windows W .. 63 of the static ladder: four squarings, then, where the
// digit is not 0, a multiply by its table entry, at an index fixed at
// compile time.
template <uint64_t E3, uint64_t E2, uint64_t E1, uint64_t E0, int W>
TPN_INLINE void descan_windows(int32_t* acc, int32_t (*tab)[NL]) {
  constexpr int d = ExpDigit<E3, E2, E1, E0, W>::value;
  sqr<false>(acc, acc);
  sqr<false>(acc, acc);
  sqr<false>(acc, acc);
  sqr<false>(acc, acc);
  if constexpr (d != 0) mul(acc, acc, tab[d]);
  if constexpr (W + 1 < 64) descan_windows<E3, E2, E1, E0, W + 1>(acc, tab);
}

// out = t^e, e = E3 .. E0 (kernel._pow_const, unroll form): [1, t, .., t^15]
// by the static log-depth chain (t^k the square of t^(k/2) for even k,
// t^(k-1) · t for odd k), the first digit's entry as the accumulator, then
// windows 1 .. 63.  A function of its own, so that phase 2 of chip_smoke.py
// can read its PTX for digit loads.
template <uint64_t E3, uint64_t E2, uint64_t E1, uint64_t E0>
TPN_NOINLINE void pow_descan(int32_t* out, const int32_t* t) {
  int32_t tab[16][NL], acc[NL];
  set_small(tab[0], 1);
  copy(tab[1], t);
  sqr<false>(tab[2], tab[1]);
  mul(tab[3], tab[2], tab[1]);
  sqr<false>(tab[4], tab[2]);
  mul(tab[5], tab[4], tab[1]);
  sqr<false>(tab[6], tab[3]);
  mul(tab[7], tab[6], tab[1]);
  sqr<false>(tab[8], tab[4]);
  mul(tab[9], tab[8], tab[1]);
  sqr<false>(tab[10], tab[5]);
  mul(tab[11], tab[10], tab[1]);
  sqr<false>(tab[12], tab[6]);
  mul(tab[13], tab[12], tab[1]);
  sqr<false>(tab[14], tab[7]);
  mul(tab[15], tab[14], tab[1]);
  copy(acc, tab[ExpDigit<E3, E2, E1, E0, 0>::value]);
  descan_windows<E3, E2, E1, E0, 1>(acc, tab);
  copy(out, acc);
}

// (p-1)/2, Euler's exponent, as four 64-bit words, most significant first.
constexpr uint64_t EULER_E3 = 0x7FFFFFFFFFFFFFFFull;
constexpr uint64_t EULER_E2 = 0xFFFFFFFFFFFFFFFFull;
constexpr uint64_t EULER_E1 = 0xFFFFFFFFFFFFFFFFull;
constexpr uint64_t EULER_E0 = 0xFFFFFFFF7FFFFE17ull;

// out (24, B): canonical(t^((p-1)/2)) by the static ladder.
TPN_INLINE void diag_pow_descan_lane(const int32_t* t, int32_t* out, int B, int lane) {
  int32_t x[NL];
  load_col(x, t, B, lane);
  pow_descan<EULER_E3, EULER_E2, EULER_E1, EULER_E0>(x, x);
  canonical(x, x);
  store_col(out, x, B, lane);
}

// out (24, B): canonical(t^d), t (24, B), d (B,) in [0, 16).
TPN_INLINE void diag_select_tree_lane(const int32_t* t, const int32_t* d, int32_t* out, int B,
                                      int lane) {
  int32_t x[NL], tab[16][NL];
  load_col(x, t, B, lane);
  power_table<16>(tab, x);
  tree_select<16>(x, tab[0], d[lane] & 15);
  canonical(x, x);
  store_col(out, x, B, lane);
}

// out (24, B): canonical(t^e) for the exponent whose 64 MSB-first 4-bit
// digits are row 0 of `digits` (2, 64), each window's table entry picked by
// a one-hot compare-accumulate on its digit.
TPN_INLINE void diag_pow_window_lane(const int32_t* t, const int32_t* digits, int32_t* out,
                                     int B, int lane) {
  int32_t x[NL], acc[NL], sel[NL], tab[16][NL];
  load_col(x, t, B, lane);
  power_table<16>(tab, x);
  set_small(acc, 1);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
    sqr<false>(acc, acc);
    sqr<false>(acc, acc);
    sqr<false>(acc, acc);
    sqr<false>(acc, acc);
    const int d = digits[w];
    set_small(sel, 0);
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {
      const int32_t m = -static_cast<int32_t>(d == k);
#pragma unroll
      for (int i = 0; i < NL; ++i) sel[i] |= tab[k][i] & m;
    }
    mul(acc, acc, sel);
  }
  canonical(acc, acc);
  store_col(out, acc, B, lane);
}

// out (24, B): canonical(a^d · g^d), a (24, B), d (B,) in [0, 32), g_tab
// the shared (32, 24) table of g^k.
TPN_INLINE void diag_window5_lane(const int32_t* a, const int32_t* g_tab, const int32_t* d,
                                  int32_t* out, int B, int lane) {
  int32_t x[NL], y[NL], tab[32][NL];
  load_col(x, a, B, lane);
  power_table<32>(tab, x);
  const int digit = d[lane] & 31;
  tree_select<32>(x, tab[0], digit);
  tree_select<32>(y, g_tab, digit);
  mul(x, x, y);
  canonical(x, x);
  store_col(out, x, B, lane);
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(128) trivial_kernel(const int32_t* x, int32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1;
}

__global__ void __launch_bounds__(128)
    field_mul_kernel(const int32_t* a, const int32_t* b, int32_t* out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_field_mul_lane(a, b, out, B, lane);
}

__global__ void __launch_bounds__(128)
    field_mul_u32_kernel(const int32_t* a, const int32_t* b, int32_t* out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_field_mul_u32_lane(a, b, out, B, lane);
}

// Warp-collective: every thread reaches every mma and __syncwarp.
__global__ void __launch_bounds__(128)
    field_mul_dot_kernel(const int32_t* a, const int32_t* b, int32_t* out, int B) {
  __shared__ __align__(16) uint32_t s_dot[128 / 32][DOT_WARP_WORDS];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t x[NL], y[NL], w[NW];
  if (lane < B) {
    load_col(x, a, B, lane);
    load_col(y, b, B, lane);
  } else {
    set_small(x, 0);
    set_small(y, 0);
  }
  carry<NL>(x);
  carry<NL>(y);
  dot_warp<false>(w, x, y, s_dot[threadIdx.x / 32], threadIdx.x % 32);
  if (lane < B) {
    reduce_wide(x, w);
    canonical(x, x);
    store_col(out, x, B, lane);
  }
}

__global__ void __launch_bounds__(128)
    lazy_reduce_kernel(const int32_t* a, const int32_t* b, const int32_t* c, const int32_t* d,
                       int32_t* out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_lazy_reduce_lane(a, b, c, d, out, B, lane);
}

__global__ void __launch_bounds__(128)
    mixed_add_kernel(const int32_t* px, const int32_t* py, const int32_t* qx,
                     const int32_t* qy, int32_t* out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_mixed_add_lane(px, py, qx, qy, out, B, lane);
}

__global__ void __launch_bounds__(128) batch_inv_kernel(const int32_t* z, int32_t* out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_batch_inv_lane(z, out, B, lane);
}

__global__ void __launch_bounds__(128) table_build_kernel(const int32_t* a, int32_t* out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_table_build_lane(a, out, B, lane);
}

__global__ void __launch_bounds__(128) pow_descan_kernel(const int32_t* t, int32_t* out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_pow_descan_lane(t, out, B, lane);
}

__global__ void __launch_bounds__(128)
    select_tree_kernel(const int32_t* t, const int32_t* d, int32_t* out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_select_tree_lane(t, d, out, B, lane);
}

// The digits (2, 64) read in global memory.
__global__ void __launch_bounds__(128)
    pow_window_kernel(const int32_t* t, const int32_t* digits, int32_t* out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_pow_window_lane(t, digits, out, B, lane);
}

// The digits (2, 64) staged in shared memory first.
__global__ void __launch_bounds__(128)
    pow_window_smem_kernel(const int32_t* t, const int32_t* digits, int32_t* out, int B) {
  __shared__ int32_t s_digits[2 * 64];
  for (int i = threadIdx.x; i < 2 * 64; i += blockDim.x) s_digits[i] = digits[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_pow_window_lane(t, s_digits, out, B, lane);
}

__global__ void __launch_bounds__(128)
    window5_kernel(const int32_t* a, const int32_t* g_tab, const int32_t* d, int32_t* out,
                   int B) {
  __shared__ int32_t s_tab[32 * NL];
  for (int i = threadIdx.x; i < 32 * NL; i += blockDim.x) s_tab[i] = g_tab[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) diag_window5_lane(a, s_tab, d, out, B, lane);
}

#endif

}  // namespace tpn

#if defined(__CUDACC__)

constexpr int kThreads = 128;

// Each launcher launches on `stream` (of the current device: the caller
// makes the tensors' card current) and returns cudaGetLastError().  B counts
// lanes, or elements for trivial.
extern "C" int tpn_diag_trivial(const int32_t* x, int32_t* out, int B, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::trivial_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_field_mul(const int32_t* a, const int32_t* b, int32_t* out, int B,
                                  void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::field_mul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_field_mul_dot(const int32_t* a, const int32_t* b, int32_t* out, int B,
                                      void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::field_mul_dot_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out,
                                                                                      B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_field_mul_u32(const int32_t* a, const int32_t* b, int32_t* out, int B,
                                      void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::field_mul_u32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out,
                                                                                      B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_lazy_reduce(const int32_t* a, const int32_t* b, const int32_t* c,
                                    const int32_t* d, int32_t* out, int B, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::lazy_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, d, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_mixed_add(const int32_t* px, const int32_t* py, const int32_t* qx,
                                  const int32_t* qy, int32_t* out, int B, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::mixed_add_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      px, py, qx, qy, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_batch_inv(const int32_t* z, int32_t* out, int B, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::batch_inv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(z, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_table_build(const int32_t* a, int32_t* out, int B, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::table_build_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_pow_descan(const int32_t* t, int32_t* out, int B, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::pow_descan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_select_tree(const int32_t* t, const int32_t* d, int32_t* out, int B,
                                    void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::select_tree_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, d, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_pow_window(const int32_t* t, const int32_t* digits, int32_t* out, int B,
                                   void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::pow_window_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, digits,
                                                                                   out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_pow_window_smem(const int32_t* t, const int32_t* digits, int32_t* out,
                                        int B, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::pow_window_smem_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, digits, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpn_diag_window5(const int32_t* a, const int32_t* g_tab, const int32_t* d,
                                int32_t* out, int B, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  tpn::window5_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, g_tab, d, out,
                                                                                B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpn_diag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif

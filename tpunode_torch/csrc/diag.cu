// Probes of the verify kernel's affine-form constructs on Hopper, one
// hand-written CUDA kernel each, for tpunode_torch/cuda_diag.py.
//
// Counterparts of benchmarks/mosaic_diag.py's Mosaic probes:
// * mixed_add_kernel replaces _mixed_add (pallas_call at :300): one complete
//   mixed addition (px, py, 1) + (qx, qy) per lane through curve.cuh's
//   pt_add_mixed, the window add of the affine form;
// * batch_inv_kernel replaces _batch_inv (pallas_call at :379): the affine
//   Q table's batch inversion over 16 entries, composed as the verify kernel
//   composes it — the column z^1 .. z^14 of one lane's z in entries 2 .. 15,
//   prefix products, one Fermat ladder (pow_const, digits in __constant__),
//   then the suffix step of entry 15 — and canonical(z_15 · z_15^-1), which
//   must be 1.
// Each is one lane per thread, 128 threads a block, tables in local memory,
// with the verify kernel's own functions: a fault here is pinned to the
// construct.  What bounds them: int32 issue, like the verify kernel; at the
// probes' 256 lanes, two blocks, the launch itself dominates.  The plain
// versions are cuda_diag.mixed_add_plain and batch_inv_plain.
#include "curve.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

namespace tpn {

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
  pt_add_mixed(&r, &p, &q);
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
  pow_const(inv, ptab[TABLE - 1], false);
  mul(inv, inv, ptab[TABLE - 2]);  // z_15^-1 = (z_2 .. z_15)^-1 · (z_2 .. z_14)
  mul(inv, ztab[TABLE - 1], inv);
  canonical(inv, inv);
  store_col(out, inv, B, lane);
}

#if defined(__CUDACC__)

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

#endif

}  // namespace tpn

#if defined(__CUDACC__)

constexpr int kThreads = 128;

// Each launcher launches on `stream` and returns cudaGetLastError().
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

extern "C" const char* tpn_diag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif

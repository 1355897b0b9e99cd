// Fused Hermitian kernel for Hopper (sm_90a): cuMF's get_hermitian_x + B_u.
//
// Replaces the Pallas TPU kernel repro/kernels/hermitian.py
// fused_herm_pallas (_fused_herm_kernel), together with the theta gather
// that repro/kernels/ops.py fused_herm materialises before it.
//
// Per row u of a padded-ELL matrix (idx, val, cnt):
//   A_u = sum_{k < cnt_u} theta[idx[u,k]] theta[idx[u,k]]^T + diag_u * I
//   B_u = sum_{k < cnt_u} val[u,k] * theta[idx[u,k]]
//
// Bound on an H100: operations.  nnz * (f*(f+1) + 2f) fp32 flops against
// 67 TFLOP/s, versus the bytes of A (m f^2 * 4) against 3.35 TB/s.
//
// Design (herm_tile.cuh, where each point is argued): each thread keeps
// an 8x8 register tile of the lower block triangle of [g, val][g, val]^T,
// so B_u comes out of the same FMAs and a slot costs four float4
// shared-memory loads per 64 FMAs; the theta rows are gathered with
// cp.async into a second shared-memory buffer while the current chunk is
// computed; and a row with more than kSplit = 2048 slots is split over
// several CTAs whose partials a second kernel sums in a fixed order, so
// the heaviest item rows (K ~ 1e5) no longer run as a few long CTAs.
#include "herm_tile.cuh"

// Floats of scratch the wrapper allocates for a launch (0: none needed).
extern "C" long long fused_herm_scratch_floats(int m, int K, int f) {
  return herm::scratch_floats(m, K, f);
}

// Slots per part of a split row.
extern "C" int fused_herm_split_slots() { return herm::kSplit; }

// Dynamic shared memory one CTA of the launch asks for at f (the split
// path's reduction asks for less): kernels/budgets.py footprint_bytes.
extern "C" size_t fused_herm_smem_bytes(int f) { return herm::smem_bytes(f); }

// Plain C entry point for ctypes: one launch of the Hermitian kernel, and
// one of the reduction when K > kSplit.  Returns a cudaError_t (0 on
// success).
extern "C" int fused_herm_launch(const float* theta, const int* idx,
                                 const float* val, const int* cnt,
                                 const float* diag, float* A, float* B,
                                 float* scratch, int m, int K, int f, int n,
                                 int device, void* stream) {
  if (diag == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return herm::launch<false>(theta, idx, val, cnt, diag, A, B, scratch, m, K, f, n, 0, K,
                             device, stream);
}

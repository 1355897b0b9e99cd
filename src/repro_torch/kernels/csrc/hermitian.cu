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
// Design (first, simple version): the kernel template of herm_tile.cuh
// over all slots of each row in one launch: one CTA of 256 threads per row,
// the CTA gathers its own theta rows through __ldg into shared memory,
// each thread keeps ~f^2/512 lower-triangle entries of A_u in registers
// for the row's whole loop (cuMF's register-file accumulator) and writes
// them once.
//
// Bound on an H100: operations.  nnz * (f*(f+1) + 2f) fp32 flops against
// 67 TFLOP/s, versus the bytes of A (m f^2 * 4) against 3.35 TB/s.  This
// version issues two shared-memory loads per FMA, so shared-memory
// bandwidth, not the FMA pipes, limits it; register tiling of A is the
// next step.  Load imbalance: one CTA per row makes the heaviest item rows
// (K ~ 1e4-1e5) long-running tails.
#include "herm_tile.cuh"

// Plain C entry point for ctypes.  Returns a cudaError_t (0 on success).
extern "C" int fused_herm_launch(const float* theta, const int* idx,
                                 const float* val, const int* cnt,
                                 const float* diag, float* A, float* B,
                                 int m, int K, int f, int n, int device,
                                 void* stream) {
  if (diag == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return herm::launch<false>(theta, idx, val, cnt, diag, A, B, m, K, f, n, 0, K, device,
                             stream);
}

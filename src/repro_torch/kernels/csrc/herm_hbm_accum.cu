// Fig. 7 ablation for Hopper (sm_90a): the Hermitian without register
// accumulation across a row's ratings.
//
// Replaces the Pallas TPU kernel repro/kernels/hermitian.py herm_hbm_accum
// (_herm_onebin_kernel).
//
// It computes the same A_u, B_u as hermitian.cu (fused_herm), but only over
// one bin of slots [k0, k1) per launch, and writes that bin's partial
//   dA_u = sum_{k0 <= k < min(cnt_u, k1)} g g^T,  dB_u = sum val * g
// (g = theta[idx[u,k]]) to device memory.  The wrapper launches once per
// bin of tk slots and adds the partials into the running A, B between
// launches, as the reference's XLA add does; then it adds the diagonal.
// So the accumulator makes a round trip through device memory after every
// bin: cuMF's Alg. 2 without the register optimisation (paper Fig. 7).
//
// Design: fused_herm's kernel template (herm_tile.cuh: register tiles,
// cp.async gather), instantiated with kBin = true: one slot range, no
// diagonal, no split of heavy rows, launched per bin, so the ablation
// changes only where the accumulator lives between bins.  A ragged last
// bin (K % tk != 0) is fine.  Never on the ALS main path.
//
// Bound on an H100: the same function as fused_herm, so the same bound
// (operations: nnz * (f*(f+1) + 2f) fp32 flops against 67 TFLOP/s).  This
// ablation adds, per bin, a write of m*f^2 floats here and a read-add-write
// of the running sum in the wrapper, which is the cost it exists to show.
#include "herm_tile.cuh"

// Plain C entry point for ctypes: one bin [k0, k1) of every row into dA
// [m, f, f] and dB [m, f] (every entry written).  Returns a cudaError_t.
extern "C" int herm_bin_launch(const float* theta, const int* idx,
                               const float* val, const int* cnt, float* dA,
                               float* dB, int m, int K, int f, int n, int k0,
                               int k1, int device, void* stream) {
  return herm::launch<true>(theta, idx, val, cnt, nullptr, dA, dB, nullptr, m, K, f, n, k0, k1,
                            device, stream);
}

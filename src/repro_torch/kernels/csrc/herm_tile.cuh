// The Hermitian kernel shared by hermitian.cu (fused_herm) and
// herm_hbm_accum.cu (the Fig. 7 ablation), so the two differ only in
// where the accumulator lives between slot ranges.
//
// Per row u of a padded-ELL matrix (idx, val, cnt), g = theta[idx[u,k]]:
// - kBin = false (fused_herm): all slots, and the diagonal;
//     A_u = sum_{k < cnt_u} g g^T + diag_u * I,  B_u = sum_{k < cnt_u} val[u,k] g
// - kBin = true (one bin of the ablation): the slots [k0, k1), no diagonal;
//     A_u = sum_{k0 <= k < min(cnt_u, k1)} g g^T,  B_u likewise.
// kBin is a template parameter so that the fused instances compile without
// the range and diagonal tests (which cost registers, and spills, at some f).
//
// - one CTA of 256 threads per row u;
// - the CTA gathers the rated theta rows itself, kChunk rows at a time,
//   into shared memory through __ldg (the read-only path, cuMF's texture
//   read), so the [m, K, f] gather of the TPU version never exists;
// - each thread owns a fixed set of lower-triangle entries (i >= j) of A_u
//   and keeps them in registers across the whole range (cuMF's
//   register-file accumulator); f <= 128 gives at most 33 per thread;
// - the loop stops at cnt_u: padding slots would add exact zeros;
// - fp32 FMAs only (no TF32), one write of both triangles at the end;
// - an index outside [0, n) traps the launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace herm {

constexpr int kThreads = 256;
constexpr int kChunk = 32;   // theta rows staged in shared memory per step
constexpr int kMaxF = 128;

template <int J, bool kBin>
__global__ void __launch_bounds__(kThreads)
herm_kernel(const float* __restrict__ theta,
            const int* __restrict__ idx,
            const float* __restrict__ val,
            const int* __restrict__ cnt,
            const float* __restrict__ diag,   // unused when kBin
            float* __restrict__ A,
            float* __restrict__ B,
            int K, int f, int n, int k0, int k1) {
  __shared__ float s_g[kChunk][kMaxF];
  __shared__ float s_v[kChunk];
  __shared__ int s_idx[kChunk];

  const int64_t u = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_entries = f * (f + 1) / 2;

  // entry e -> (i, j), row-major over the lower triangle: e = i(i+1)/2 + j
  int ei[J], ej[J];
  float acc[J];
#pragma unroll
  for (int s = 0; s < J; ++s) {
    const int e = tid + s * kThreads;
    int i = 0;
    if (e < n_entries) {
      i = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
      while (i * (i + 1) / 2 > e) --i;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
    }
    ei[s] = i;
    ej[s] = e < n_entries ? e - i * (i + 1) / 2 : 0;
    acc[s] = 0.f;
  }
  float acc_b = 0.f;

  const int lo = kBin ? k0 : 0;
  const int hi = kBin ? min(min(cnt[u], K), k1) : min(cnt[u], K);
  const int* idx_u = idx + u * K;
  const float* val_u = val + u * K;
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int nk = min(kChunk, hi - c0);
    if (tid < nk) {
      const int v = idx_u[c0 + tid];
      if (v < 0 || v >= n) __trap();   // corrupt index: fail the launch
      s_idx[tid] = v;
      s_v[tid] = val_u[c0 + tid];
    }
    __syncthreads();
    for (int t = tid; t < nk * f; t += kThreads) {
      const int r = t / f;
      const int col = t - r * f;
      s_g[r][col] = __ldg(theta + static_cast<int64_t>(s_idx[r]) * f + col);
    }
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      const float* g = s_g[k];
#pragma unroll
      for (int s = 0; s < J; ++s) acc[s] = fmaf(g[ei[s]], g[ej[s]], acc[s]);
      if (tid < f) acc_b = fmaf(s_v[k], g[tid], acc_b);
    }
    __syncthreads();
  }

  const float d = kBin ? 0.f : diag[u];
  float* A_u = A + u * f * f;
#pragma unroll
  for (int s = 0; s < J; ++s) {
    const int e = tid + s * kThreads;
    if (e < n_entries) {
      const int i = ei[s], j = ej[s];
      const float a = (!kBin && i == j) ? acc[s] + d : acc[s];
      A_u[i * f + j] = a;
      A_u[j * f + i] = a;
    }
  }
  if (tid < f) B[u * f + tid] = acc_b;
}

template <int J, bool kBin>
cudaError_t launch_j(const float* theta, const int* idx, const float* val,
                     const int* cnt, const float* diag, float* A, float* B,
                     int m, int K, int f, int n, int k0, int k1,
                     cudaStream_t stream) {
  herm_kernel<J, kBin><<<m, kThreads, 0, stream>>>(theta, idx, val, cnt, diag, A, B,
                                                   K, f, n, k0, k1);
  return cudaGetLastError();
}

// Validates the shapes, picks the instance with enough accumulators per
// thread for f and launches it.  Returns a cudaError_t (0 on success).
template <bool kBin>
int launch(const float* theta, const int* idx, const float* val,
           const int* cnt, const float* diag, float* A, float* B,
           int m, int K, int f, int n, int k0, int k1, int device,
           void* stream) {
  if (m <= 0 || K <= 0 || f <= 0 || f > kMaxF || n <= 0 || k0 < 0 || k1 <= k0 || k1 > K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_thread = (f * (f + 1) / 2 + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HERM_CASE(J) \
  if (per_thread <= J) \
    return static_cast<int>(launch_j<J, kBin>(theta, idx, val, cnt, diag, A, B, m, K, f, n, k0, k1, s));
  HERM_CASE(1)
  HERM_CASE(2)
  HERM_CASE(4)
  HERM_CASE(8)
  HERM_CASE(12)
  HERM_CASE(16)
  HERM_CASE(20)
  HERM_CASE(24)
  HERM_CASE(28)
  HERM_CASE(33)
#undef HERM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace herm

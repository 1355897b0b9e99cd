// Batched SPD solve for Hopper (sm_90a): x_u = A_u^{-1} B_u by Cholesky.
//
// Replaces the Pallas TPU kernel repro/kernels/batch_solve.py
// batch_solve_pallas (_batch_solve_kernel, _cholesky_inplace,
// _trsv_lower, _trsv_upper_t).
//
// Per system u, one CTA of 256 threads:
// - A_u is copied into shared memory (f*f floats: 40 KB at f=100, 64 KB
//   at f=128, which needs the opt-in above 48 KB);
// - unblocked right-looking Cholesky, one column per step: the pivot is
//   clamped max(d, 1e-20) before rsqrt (as batch_solve.py:32), the column
//   is scaled in place, and the warps split the rows of the trailing
//   lower-triangle update, lanes along each row;
// - forward substitution L y = b and back substitution L^T x = y,
//   column-oriented so each step is one parallel update, dividing by
//   max(l_jj, 1e-20) (as batch_solve.py:55 and :73).
// The TPU version's one-hot contractions become direct indexing.
//
// Bound on an H100: bytes.  The work is ~f^3/3 flops per system, against
// m f^2 * 4 bytes of A read once; at f=100 that is ~8 flops per byte, far
// below the 67 TFLOP/s : 3.35 TB/s ridge.  This version is limited by the
// f sequential column steps (three barriers each) and shared-memory
// traffic, not by device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxF = 128;

__global__ void __launch_bounds__(kThreads)
batch_solve_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ X, int f) {
  extern __shared__ float smem[];
  float* M = smem;            // [f, f] A_u, overwritten by L (lower part)
  float* col = M + f * f;     // [f] current column of L
  float* y = col + f;         // [f] right-hand side, then the solution
  float* z = y + f;           // [f] forward-substitution result

  const int64_t u = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const float* A_u = A + u * f * f;
  for (int t = tid; t < f * f; t += kThreads) M[t] = A_u[t];
  for (int t = tid; t < f; t += kThreads) y[t] = B[u * f + t];
  __syncthreads();

  // Cholesky, right-looking: L[:, j] = M[:, j] * rsqrt(max(M[j, j], 1e-20))
  for (int j = 0; j < f; ++j) {
    const float r = rsqrtf(fmaxf(M[j * f + j], 1e-20f));
    __syncthreads();                       // all read the pivot first
    for (int i = j + tid; i < f; i += kThreads) {
      const float c = M[i * f + j] * r;
      M[i * f + j] = c;
      col[i] = c;
    }
    __syncthreads();
    for (int i = j + 1 + warp; i < f; i += kWarps) {
      const float ci = col[i];
      for (int k = j + 1 + lane; k <= i; k += 32) M[i * f + k] -= ci * col[k];
    }
    __syncthreads();
  }

  // forward substitution L z = y (column-oriented)
  for (int j = 0; j < f; ++j) {
    const float zj = y[j] / fmaxf(M[j * f + j], 1e-20f);
    if (tid == 0) z[j] = zj;
    for (int i = j + 1 + tid; i < f; i += kThreads) y[i] -= M[i * f + j] * zj;
    __syncthreads();
  }

  // back substitution L^T x = z (row j of L is column j of L^T)
  for (int j = f - 1; j >= 0; --j) {
    const float xj = z[j] / fmaxf(M[j * f + j], 1e-20f);
    if (tid == 0) y[j] = xj;
    for (int i = tid; i < j; i += kThreads) z[i] -= M[j * f + i] * xj;
    __syncthreads();
  }

  for (int t = tid; t < f; t += kThreads) X[u * f + t] = y[t];
}

}  // namespace

// Plain C entry point for ctypes.  Returns a cudaError_t (0 on success).
extern "C" int batch_solve_launch(const float* A, const float* B, float* X,
                                  int m, int f, int device, void* stream) {
  if (m <= 0 || f <= 0 || f > kMaxF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (static_cast<size_t>(f) * f + 3 * f) * sizeof(float);
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    err = cudaFuncSetAttribute(batch_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  batch_solve_kernel<<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, B, X, f);
  return static_cast<int>(cudaGetLastError());
}

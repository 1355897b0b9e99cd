// Batched SPD solve for Hopper (sm_90a): x_u = A_u^{-1} B_u by Cholesky.
//
// Replaces the Pallas TPU kernel repro/kernels/batch_solve.py
// batch_solve_pallas (_batch_solve_kernel, _cholesky_inplace,
// _trsv_lower, _trsv_upper_t).
//
// Bound on an H100: bytes.  The work is ~f^3/3 flops per system, against
// m f^2 * 4 bytes of A read once; at f=100 that is ~8 flops per byte, far
// below the 67 TFLOP/s : 3.35 TB/s ridge.  What held the earlier design
// back was latency, not bytes: f unblocked column steps of three CTA
// barriers each, then 2f barriered substitution steps, ~5f barriers per
// system, with one CTA of 40 KB per system (5 per SM) to hide them.  This
// design takes that to 3 barriers per block of kNB columns in the
// factorization and 2 in the back substitution (36 at f=100), and fits
// 7 systems per SM:
//
// - One CTA of 128 threads per system keeps W = [A_u ; b_u^T] in shared
//   memory, packed: rows 0..f-1 the lower triangle of A_u, row f b_u, so
//   the forward substitution L z = b runs inside the factorization as one
//   more row of every panel.  28.5 KB at f=100 with the panel buffer.
// - Blocked right-looking Cholesky over kNB = 16 columns (the last block
//   ragged, 4 columns at f=100), per block:
//   1. one warp factors the diagonal block in registers, lane i holding
//      row i, each column's values passed by shuffles: no CTA barrier; it
//      also leaves each column's 1 / max(L_jj, 1e-20), so that neither
//      substitution divides in its dependent chain;
//   2. all threads solve the panel below it, one row per thread, the
//      row's kNB values in registers, and store it also transposed;
//   3. all threads update the trailing lower triangle (and b) in 4x4
//      register tiles from the transposed panel, two float4 loads per 16
//      FMAs, kNB products per entry before one subtraction.  (Scalar
//      column reads of W made this step shared-memory bound.)
// - Blocked back substitution L^T x = z: one warp solves each diagonal
//   block by shuffles, then all threads subtract its x from the z of the
//   rows above.
// The reference's max(., 1e-20) clamps stay where it has them: on the
// pivot before rsqrt (batch_solve.py:32) and on the divisors of both
// substitutions (:55, :73), here as the reciprocal of the clamped
// divisor.  The TPU version's one-hot contractions become direct
// indexing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNB = 16;   // columns per block; a diagonal block fits one warp
constexpr int kMaxF = 128;
constexpr unsigned kFull = 0xffffffffu;

// row i of the packed lower triangle starts at tri0(i); row f holds b
__host__ __device__ inline int tri0(int i) { return i * (i + 1) / 2; }

// width of a row of the transposed panel: rows 0..f, in float4s
__host__ __device__ inline int pw_of(int f) { return (f + 1 + 3) / 4 * 4; }

__host__ __device__ inline size_t smem_floats(int f) {
  return static_cast<size_t>(pw_of(f)) * kNB                   // transposed panel
         + ((tri0(f) + f + 3) / 4 * 4)                          // W, packed
         + 3 * f;                                               // s_r, s_inv, s_x
}

// pair p -> (ti, tk), tk <= ti, row-major over a lower triangle
__device__ inline void tri(int p, int& ti, int& tk) {
  int i = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while (tri0(i) > p) --i;
  while (tri0(i + 1) <= p) ++i;
  ti = i;
  tk = p - tri0(i);
}

__global__ void __launch_bounds__(kThreads)
batch_solve_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ X, int f) {
  extern __shared__ __align__(16) float smem[];
  const int pw = pw_of(f);
  float* P = smem;                            // [kNB][pw]: the panel, transposed
  float* W = P + kNB * pw;                    // packed lower triangle of A_u, then b_u
  float* s_r = W + (tri0(f) + f + 3) / 4 * 4; // [f] rsqrt(max(pivot, 1e-20))
  float* s_inv = s_r + f;                     // [f] 1 / max(L_jj, 1e-20)
  float* s_x = s_inv + f;                     // [f] the solution
  float* z = W + tri0(f);                     // b_u, then z = L^{-1} b_u

  const int64_t u = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // A_u's lower triangle and b_u, every copy in flight at once
  const float* A_u = A + u * f * f;
  for (int i = warp; i < f; i += kThreads / 32)
    for (int j = lane; j <= i; j += 32) cp_async4(W + tri0(i) + j, A_u + i * f + j);
  for (int t = tid; t < f; t += kThreads) cp_async4(z + t, B + u * f + t);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int j0 = 0; j0 < f; j0 += kNB) {
    const int nbj = min(kNB, f - j0);
    const int j1 = j0 + nbj;

    // 1. the diagonal block, one warp, lane i holding row j0 + i
    if (warp == 0) {
      const bool live = lane < nbj;
      float* wr = W + tri0(j0 + (live ? lane : 0)) + j0;
      float row[kNB];
#pragma unroll
      for (int c = 0; c < kNB; ++c) row[c] = (live && c <= lane) ? wr[c] : 0.f;
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        if (c < nbj) {
          const float r = rsqrtf(fmaxf(__shfl_sync(kFull, row[c], c), 1e-20f));
          const float l = row[c] * r;
          if (lane >= c) row[c] = l;
#pragma unroll
          for (int k = c + 1; k < kNB; ++k) {
            const float lk = __shfl_sync(kFull, l, k);
            if (lane >= k) row[k] = fmaf(-l, lk, row[k]);
          }
          if (lane == c) {
            s_r[j0 + c] = r;
            s_inv[j0 + c] = 1.f / fmaxf(l, 1e-20f);
          }
        }
      }
      if (live) {
#pragma unroll
        for (int c = 0; c < kNB; ++c)
          if (c <= lane) wr[c] = row[c];
      }
    }
    __syncthreads();

    // 2. the panel below it: rows j1..f-1 of L, and row f (z = L^{-1} b),
    //    kept in W and, transposed, in P for the trailing update
    for (int i = j1 + tid; i <= f; i += kThreads) {
      float* wr = W + tri0(i) + j0;
      const float* scale = (i == f ? s_inv : s_r) + j0;
      float row[kNB];
#pragma unroll
      for (int c = 0; c < kNB; ++c) row[c] = c < nbj ? wr[c] : 0.f;
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        if (c < nbj) {
          const float l = row[c] * scale[c];
          row[c] = l;
#pragma unroll
          for (int k = c + 1; k < kNB; ++k)
            if (k < nbj) row[k] = fmaf(-l, W[tri0(j0 + k) + j0 + c], row[k]);
        }
      }
#pragma unroll
      for (int c = 0; c < kNB; ++c)
        if (c < nbj) {
          wr[c] = row[c];
          P[c * pw + i] = row[c];
        }
    }
    __syncthreads();

    // 3. the trailing lower triangle, rows j1..f, columns j1..min(i, f-1),
    //    in 4x4 tiles reading the transposed panel a float4 at a time (j1
    //    is a multiple of 4 here; entries past row f are read, not written)
    if (j1 < f) {
      const int nt = (f + 1 - j1 + 3) / 4;
      for (int p = tid; p < tri0(nt); p += kThreads) {
        int ti, tk;
        tri(p, ti, tk);
        const int i0 = j1 + 4 * ti, k0 = j1 + 4 * tk;
        float acc[4][4] = {};
#pragma unroll 4
        for (int c = 0; c < nbj; ++c) {
          const float4 a = *reinterpret_cast<const float4*>(P + c * pw + i0);
          const float4 b = *reinterpret_cast<const float4*>(P + c * pw + k0);
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[e][q] = fmaf(av[e], bv[q], acc[e][q]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + e, k = k0 + q;
            if (i <= f && k < f && k <= i) W[tri0(i) + k] -= acc[e][q];
          }
      }
      __syncthreads();
    }
  }

  // back substitution L^T x = z, last block first
  for (int J0 = (f - 1) / kNB * kNB; J0 >= 0; J0 -= kNB) {
    const int nbJ = min(kNB, f - J0);
    if (warp == 0) {
      float zl = lane < nbJ ? z[J0 + lane] : 0.f;
#pragma unroll
      for (int c = kNB - 1; c >= 0; --c) {
        if (c < nbJ) {
          const float* Lc = W + tri0(J0 + c) + J0;   // row c of the diagonal block
          const float xc = __shfl_sync(kFull, zl * s_inv[J0 + c], c);
          if (lane < c) zl = fmaf(-Lc[lane], xc, zl);
          if (lane == c) s_x[J0 + c] = xc;
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < J0; k += kThreads) {
      float s = z[k];
#pragma unroll 4
      for (int c = 0; c < nbJ; ++c) s = fmaf(-W[tri0(J0 + c) + k], s_x[J0 + c], s);
      z[k] = s;
    }
    __syncthreads();
  }

  for (int t = tid; t < f; t += kThreads) X[u * f + t] = s_x[t];
}

}  // namespace

// Dynamic shared memory one CTA of the launch asks for at f:
// kernels/budgets.py footprint_bytes.
extern "C" size_t batch_solve_smem_bytes(int f) { return smem_floats(f) * sizeof(float); }

// Plain C entry point for ctypes.  Returns a cudaError_t (0 on success).
extern "C" int batch_solve_launch(const float* A, const float* B, float* X,
                                  int m, int f, int device, void* stream) {
  if (m <= 0 || f <= 0 || f > kMaxF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_floats(f) * sizeof(float);
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

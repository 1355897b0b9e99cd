// Batched SPD solve for Hopper (sm_90a): x_u = A_u^{-1} B_u by Cholesky.
//
// Replaces the Pallas TPU kernel repro/kernels/batch_solve.py
// batch_solve_pallas (_batch_solve_kernel, _cholesky_inplace,
// _trsv_lower, _trsv_upper_t).
//
// Bound on an H100: bytes.  The work is ~f^3/3 flops per system, against
// m f^2 * 4 bytes of A read once; at f=100 that is ~8 flops per byte, far
// below the 67 TFLOP/s : 3.35 TB/s ridge: ~12 ns a system reading all of A
// (the benchmark's bound), ~6 ns reading the lower triangle this kernel
// reads, ~5 ns of FMAs.  What holds a solve back is latency: each column
// waits on the pivot before it.  The earlier design ran one 128-thread CTA
// a system, 7 an SM, with 3 CTA barriers a block of columns and one warp
// working while three waited: ~94 ns a system at f=100 on an H100.  This
// design runs each system on one warp, with no CTA barrier anywhere
// (__syncwarp and shuffles only), 10 systems an SM at f=100:
//
// - W = [A_u ; b_u^T], rows 0..f, lives in shared memory as its lower
//   triangle in 4x4 blocks: block-row a (rows 4a..4a+3) holds blocks
//   (a, 0..a), each four float4s (one a row), then one float4 of padding.
//   Every access of the factorization is an aligned float4 of one row and
//   four columns, and the padding puts block-row a at float4 a(2a+3), which
//   lands eight consecutive block-rows on eight different bank groups.
//   Rows past f and the diagonal blocks' upper corners are zero-filled by
//   cp.async, which reads only A's lower triangle.  With two 16-float
//   buffers for the panel, 23,008 B a system at f=100.
// - A CTA holds systems_per_cta(f) systems, one a warp: as many as fit in
//   half an SM's shared memory (kCtaSmem), at most kMaxSys, so that two CTAs
//   share an SM: 5 a CTA and 10 an SM at f=100, 3 and 6 at f=128, 5 and 10
//   at small f, where registers (at most 204 a thread) allow no more.
// - Blocked right-looking Cholesky over kNB = 16 columns, per block:
//   1. the panel, rows j0..f-1, in registers, four rows a lane (row
//      j0 + lane + 32 t), unrolled over its 16 columns with no branch: each
//      column's pivot goes to every lane by one shuffle, its L values
//      through a 16-float buffer read as float4 broadcasts, and every row is
//      scaled and updated at once, the diagonal block and the rows below it
//      in the same step.  Then row f, z = L^{-1} b (the forward
//      substitution as W's last row), against the stored diagonal block;
//   2. the trailing lower triangle, rows j0+16..f, in 4x4 tiles, one a lane
//      at a time, taken down each block-column so that a warp's lanes read
//      the same column tile (a broadcast) and different row tiles (different
//      bank groups): 16 float4 loads of the panel and 256 FMAs a tile, then
//      one read-modify-write of its four float4s.
// - Blocked back substitution L^T x = z: lane g keeps z[4g..4g+3] in
//   registers; every lane solves each diagonal block alike, then subtracts
//   that block's x from its four z.
// One copy of the panel serves every f (four slots cover f <= 128): on the
// H100 it ran faster than a copy for each count of slots, though at f=100
// 12 of its 28 slot-blocks work on zero rows.  Row f's solve and the back
// substitution's blocks have a copy without conditions for a block of 16
// columns below f and one for the last, ragged block.  On an H100 at 700 W
// (f=100, 262,144 systems, 168 registers a thread): ~49 ns a system
// against ~94 for the earlier design, X bit-equal to it.
// Each entry of W takes the earlier design's operations in its order (the
// products of a block summed in column order before one subtraction, the
// same FMAs in the diagonal block, the panel and both substitutions), so
// X is that design's bit for bit.  The reference's max(., 1e-20) clamps
// stay where it has them: on the pivot before rsqrt (batch_solve.py:32)
// and on the divisors of both substitutions (:55, :73), here as the
// reciprocal of the clamped divisor.  L_jj is used only through that
// reciprocal, which W keeps on its diagonal in L_jj's place.
// The TPU version's one-hot contractions become direct indexing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kNB = 16;   // columns per block; a diagonal block fits one warp
constexpr int kMaxF = 128;
constexpr int kMaxSys = 5;                      // systems (warps) a CTA at most
constexpr int kCtaSmem = 115712;                // half an SM's 228 KB, less a CTA's 1 KB
constexpr int kSlots = kMaxF / 32;              // rows of a panel a lane holds
constexpr unsigned kFull = 0xffffffffu;

// float4 offset of W's block-row a: each block-row a' before it holds
// 4 (a' + 1) float4s and one of padding
__host__ __device__ inline int brow(int a) { return a * (2 * a + 3); }

// float4s one system takes: W's block-rows 0..f/4, then two buffers of 16
// floats that pass a panel column's L values between lanes
__host__ __device__ inline int sys_float4s(int f) { return brow(f / 4 + 1) + 2 * kNB / 4; }

__host__ __device__ inline int systems_per_cta(int f) {
  const int s = kCtaSmem / (sys_float4s(f) * 16);
  return s < 1 ? 1 : (s > kMaxSys ? kMaxSys : s);
}

// the float4 of W's row i, columns c..c+3 (c a multiple of 4, at most i)
__device__ __forceinline__ int at(int i, int c) { return brow(i >> 2) + c + (i & 3); }

// W from A_u's lower triangle and b_u, block-row by block-row: lane l takes
// row 4a + l % 4, columns 4 (l / 4) + 32 k, the float4s l + 32 k of block-row
// a, so that addresses step by constants and every copy is in flight at
// once.  Aligned rows (vec) take one 16-byte copy a float4, the others four
// 4-byte copies; past the lower triangle and row f they copy zeros.
__device__ __forceinline__ void load_w(float4* W, const float* A_u, const float* b_u, int f,
                                       int lane, bool vec) {
  for (int a = 0; a <= f / 4; ++a) {
    const int i = 4 * a + (lane & 3);
    const float* row = i < f ? A_u + static_cast<int64_t>(i) * f : b_u;
    const int len = i < f ? i + 1 : (i == f ? f : 0);   // floats of the row to read
    float4* dst = W + brow(a) + lane;
    for (int c0 = 4 * (lane >> 2); c0 <= 4 * a; c0 += 32, dst += 32) {
      const int n = max(0, min(4, len - c0));
      const float* src = n > 0 ? row + c0 : b_u;
      if (vec) {
        cp_async16_zfill(dst, src, 4 * n);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          cp_async4_zfill(reinterpret_cast<float*>(dst) + k, k < n ? src + k : b_u, k < n ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// Step 1, the panel: columns j0..j0+15, rows j0..f-1, factored in
// registers, row j0 + lane + 32 t in slot t.  Column C is a template
// argument, so that every register index is a constant.  Lane C + 1 takes
// its own diagonal's update first (its L value times itself, the one every
// lane is about to take) and sends the next pivot by shuffle before the rest
// of the column; lanes 0..15 pass column C's L values to every lane through
// lk_buf (two buffers, one a column), read as float4 broadcasts.  No branch
// for a slot or a column: past f - j0 (the last block) and past row f-1 they
// work on zeros and padding, and nothing of them is kept.
template <int C>
__device__ __forceinline__ void panel_column(float (&row)[kSlots][kNB], float& p, float& d,
                                             float* lk_buf, int lane) {
  const float r = rsqrtf(fmaxf(p, 1e-20f));
  if (lane == C) d = p * r;
  row[0][C] *= r;
  if constexpr (C + 1 < kNB)   // lane C + 1's diagonal with column C applied
    p = __shfl_sync(kFull, fmaf(-row[0][C], row[0][C], row[0][C + 1]), C + 1);
  float* buf = lk_buf + kNB * (C & 1);
  if (lane < kNB) buf[lane] = row[0][C];
  __syncwarp();
  float lk[kNB];   // L[j0 + k][j0 + C], k > C
#pragma unroll
  for (int q = (C + 1) / 4; q < kNB / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(buf)[q];
    lk[4 * q] = v.x;
    lk[4 * q + 1] = v.y;
    lk[4 * q + 2] = v.z;
    lk[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int t = 1; t < kSlots; ++t) row[t][C] *= r;
#pragma unroll
  for (int t = 0; t < kSlots; ++t)
#pragma unroll
    for (int k = C + 1; k < kNB; ++k) row[t][k] = fmaf(-row[t][C], lk[k], row[t][k]);
  if constexpr (C + 1 < kNB) panel_column<C + 1>(row, p, d, lk_buf, lane);
}

// The panel's rows, then one division gives each lane c its
// 1 / max(L_cc, 1e-20), which the diagonal keeps (the only way L_cc is used).
__device__ __forceinline__ void panel_rows(float4* W, float* lk_buf, int f, int j0, int lane) {
  float row[kSlots][kNB];
#pragma unroll
  for (int cc = 0; cc < kNB / 4; ++cc) {
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int i = j0 + lane + 32 * t;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < f && j0 + 4 * cc <= (i & ~3)) v = W[at(i, j0 + 4 * cc)];
      row[t][4 * cc] = v.x;
      row[t][4 * cc + 1] = v.y;
      row[t][4 * cc + 2] = v.z;
      row[t][4 * cc + 3] = v.w;
    }
  }
  float p = __shfl_sync(kFull, row[0][0], 0);   // the next pivot
  float d = 0.f;                                // this lane's L_cc, c = lane
  panel_column<0>(row, p, d, lk_buf, lane);
  const float inv = 1.f / fmaxf(d, 1e-20f);   // 1 / max(L_cc, 1e-20), c = lane
#pragma unroll
  for (int cc = 0; cc < kNB / 4; ++cc) {
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int i = j0 + lane + 32 * t;
      float4 v = make_float4(row[t][4 * cc], row[t][4 * cc + 1], row[t][4 * cc + 2],
                             row[t][4 * cc + 3]);
      if (t == 0 && lane == 4 * cc) v.x = inv;
      if (t == 0 && lane == 4 * cc + 1) v.y = inv;
      if (t == 0 && lane == 4 * cc + 2) v.z = inv;
      if (t == 0 && lane == 4 * cc + 3) v.w = inv;
      if (i < f && j0 + 4 * cc <= (i & ~3)) W[at(i, j0 + 4 * cc)] = v;
    }
  }
}

// Row f, the forward substitution's z = L^{-1} b, against the stored
// diagonal block, by every lane alike: z[k] takes each earlier column's
// product in column order, then is scaled, as a row of the panel would be.
template <bool Full>   // all 16 columns real, no row past f - 1
__device__ __forceinline__ void panel_z(float4* W, int f, int j0, int lane) {
  const int nbj = min(kNB, f - j0);
  float z[kNB];
#pragma unroll
  for (int k = 0; k < kNB; ++k) {
    if (k % 4 == 0) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (Full || j0 + k <= (f & ~3)) v = W[at(f, j0 + k)];
      z[k] = v.x;
      z[k + 1] = v.y;
      z[k + 2] = v.z;
      z[k + 3] = v.w;
    }
    float l[kNB];   // row j0 + k of the diagonal block, columns 0..k
#pragma unroll
    for (int g = 0; g <= k / 4; ++g) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (Full || k < nbj) v = W[at(j0 + k, j0 + 4 * g)];
      l[4 * g] = v.x;
      l[4 * g + 1] = v.y;
      l[4 * g + 2] = v.z;
      l[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < k; ++c) z[k] = fmaf(-z[c], l[c], z[k]);
    z[k] *= l[k];
  }
#pragma unroll
  for (int cc = 0; cc < kNB / 4; ++cc)
    if (lane == 0 && (Full || j0 + 4 * cc <= (f & ~3)))
      W[at(f, j0 + 4 * cc)] = make_float4(z[4 * cc], z[4 * cc + 1], z[4 * cc + 2], z[4 * cc + 3]);
}

__device__ __forceinline__ void panel(float4* W, float* lk_buf, int f, int j0, int lane) {
  panel_rows(W, lk_buf, f, j0, lane);
  __syncwarp();
  if (j0 + kNB <= f)
    panel_z<true>(W, f, j0, lane);
  else
    panel_z<false>(W, f, j0, lane);
}

// Step 2, one 4x4 tile of the trailing update of the panel at j0:
// W[i][k] -= sum_c L[i][c] L[k][c] over the panel's 16 columns c, for rows
// 4ai..4ai+3 and columns 4ak..4ak+3 (ak <= ai), the products of each entry
// summed in column order before one subtraction.  Tiles past row f or
// column f-1 write only padding.
__device__ __forceinline__ void tile(float4* W, int j0, int ai, int ak) {
  float acc[4][4] = {};
#pragma unroll
  for (int cc = 0; cc < kNB / 4; ++cc) {
    float4 x[4], y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = W[brow(ai) + j0 + 4 * cc + e];
      y[e] = W[brow(ak) + j0 + 4 * cc + e];
    }
    const float xv[4][4] = {{x[0].x, x[0].y, x[0].z, x[0].w}, {x[1].x, x[1].y, x[1].z, x[1].w},
                            {x[2].x, x[2].y, x[2].z, x[2].w}, {x[3].x, x[3].y, x[3].z, x[3].w}};
    const float yv[4][4] = {{y[0].x, y[0].y, y[0].z, y[0].w}, {y[1].x, y[1].y, y[1].z, y[1].w},
                            {y[2].x, y[2].y, y[2].z, y[2].w}, {y[3].x, y[3].y, y[3].z, y[3].w}};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[e][q] = fmaf(xv[e][c], yv[q][c], acc[e][q]);
  }
  float4* w = W + brow(ai) + 4 * ak;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float4 v = w[e];
    v.x -= acc[e][0];
    v.y -= acc[e][1];
    v.z -= acc[e][2];
    v.w -= acc[e][3];
    w[e] = v;
  }
}

// Step 2, a lane's share of the trailing update of the panel at j0: the
// tiles below it, taken down each block-column in turn, lane by lane, so
// that a warp's lanes read one column tile (a broadcast) and different row
// tiles (different bank groups).
__device__ __forceinline__ void trailing(float4* W, int f, int j0, int lane) {
  const int a0 = j0 / 4 + kNB / 4;   // first block-row and block-column
  const int nt = f / 4 + 1 - a0;     // block-rows below the panel
  int tk = 0, o = lane;              // this lane's tile (a0 + tk + o, a0 + tk)
  while (tk < nt && o >= nt - tk) o -= nt - tk++;
  while (tk < nt) {
    tile(W, j0, a0 + tk + o, a0 + tk);
    o += 32;
    while (tk < nt && o >= nt - tk) o -= nt - tk++;
  }
}

// L^T x = z, last block first; z is W's row f, lane g keeping z[4g..4g+3].
// Every lane solves each diagonal block alike, with the block's z gathered
// by shuffles and L's rows read as float4 broadcasts (the diagonal holding
// 1 / max(L_cc, 1e-20)), so the chain from one x to the next is an FMA and
// a product; then lane g subtracts the block's x from its four z.
template <bool Full>   // all 16 columns of the block below f
__device__ __forceinline__ void back_block(const float4* W, float4& z, float* x_u, int f, int J0,
                                           int lane) {
  const int nbJ = min(kNB, f - J0);
  float zb[kNB];
#pragma unroll
  for (int g = 0; g < kNB / 4; ++g) {
    zb[4 * g] = __shfl_sync(kFull, z.x, J0 / 4 + g);
    zb[4 * g + 1] = __shfl_sync(kFull, z.y, J0 / 4 + g);
    zb[4 * g + 2] = __shfl_sync(kFull, z.z, J0 / 4 + g);
    zb[4 * g + 3] = __shfl_sync(kFull, z.w, J0 / 4 + g);
  }
  float xv[kNB], xo = 0.f;
#pragma unroll
  for (int c = kNB - 1; c >= 0; --c) {
    float l[kNB];   // row J0 + c of the diagonal block, columns 0..c
#pragma unroll
    for (int g = 0; g <= c / 4; ++g) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (Full || c < nbJ) v = W[at(J0 + c, J0 + 4 * g)];
      l[4 * g] = v.x;
      l[4 * g + 1] = v.y;
      l[4 * g + 2] = v.z;
      l[4 * g + 3] = v.w;
    }
    xv[c] = Full || c < nbJ ? zb[c] * l[c] : 0.f;
#pragma unroll
    for (int k = 0; k < c; ++k) zb[k] = fmaf(-l[k], xv[c], zb[k]);
    if (lane == c) xo = xv[c];
  }
  if (lane < nbJ) x_u[J0 + lane] = xo;
  if (4 * lane < J0) {
#pragma unroll
    for (int c = 0; c < kNB; ++c) {
      float4 l = make_float4(0.f, 0.f, 0.f, 0.f);   // and xv[c] = 0 past nbJ
      if (Full || c < nbJ) l = W[at(J0 + c, 4 * lane)];
      z.x = fmaf(-l.x, xv[c], z.x);
      z.y = fmaf(-l.y, xv[c], z.y);
      z.z = fmaf(-l.z, xv[c], z.z);
      z.w = fmaf(-l.w, xv[c], z.w);
    }
  }
}

__device__ __forceinline__ void back_substitute(const float4* W, float* x_u, int f, int lane) {
  float4 z = 4 * lane < f ? W[at(f, 4 * lane)] : make_float4(0.f, 0.f, 0.f, 0.f);
  int J0 = (f - 1) / kNB * kNB;
  if (f % kNB != 0) back_block<false>(W, z, x_u, f, J0, lane);
  else back_block<true>(W, z, x_u, f, J0, lane);
  for (J0 -= kNB; J0 >= 0; J0 -= kNB) back_block<true>(W, z, x_u, f, J0, lane);
}

__global__ void __launch_bounds__(kMaxSys * 32, 2)
batch_solve_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ X, int m, int f, bool vec) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (u >= m) return;
  float4* W = smem + warp * sys_float4s(f);
  float* lk_buf = reinterpret_cast<float*>(W + brow(f / 4 + 1));
  load_w(W, A + u * f * f, B + u * f, f, lane, vec);
  cp_async_wait_all();
  __syncwarp();
  for (int j0 = 0; j0 < f; j0 += kNB) {
    panel(W, lk_buf, f, j0, lane);
    __syncwarp();
    if (j0 + kNB < f) {
      trailing(W, f, j0, lane);
      __syncwarp();
    }
  }
  back_substitute(W, X + u * f, f, lane);
}

}  // namespace

// Dynamic shared memory one CTA of the launch asks for at f:
// kernels/budgets.py footprint_bytes.
extern "C" size_t batch_solve_smem_bytes(int f) {
  return static_cast<size_t>(systems_per_cta(f)) * sys_float4s(f) * 16;
}

// Systems (warps) one CTA of the launch solves at f:
// kernels/budgets.py solve_systems_per_cta.
extern "C" int batch_solve_systems_per_cta(int f) { return systems_per_cta(f); }

// Plain C entry point for ctypes.  Returns a cudaError_t (0 on success).
extern "C" int batch_solve_launch(const float* A, const float* B, float* X,
                                  int m, int f, int device, void* stream) {
  if (m <= 0 || f <= 0 || f > kMaxF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = batch_solve_smem_bytes(f);
  // a function's attributes are set per card: the largest opted in on each
  static size_t opted_in[64] = {};
  if (device >= 64 || smem > opted_in[device]) {
    err = cudaFuncSetAttribute(batch_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(batch_solve_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) opted_in[device] = smem;
  }
  const int spc = systems_per_cta(f);
  const bool vec = f % 4 == 0 && (reinterpret_cast<uintptr_t>(A) |
                                  reinterpret_cast<uintptr_t>(B)) % 16 == 0;
  batch_solve_kernel<<<(m + spc - 1) / spc, spc * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(A, B, X, m, f, vec);
  return static_cast<int>(cudaGetLastError());
}

// The Hermitian kernels shared by hermitian.cu (fused_herm) and
// herm_hbm_accum.cu (the Fig. 7 ablation), so the two differ only in
// where the accumulator lives between slot ranges.
//
// Per row u of a padded-ELL matrix (idx, val, cnt), g = theta[idx[u,k]]:
// - kBin = false (fused_herm): all slots, and the diagonal;
//     A_u = sum_{k < cnt_u} g g^T + diag_u * I,  B_u = sum_{k < cnt_u} val[u,k] g
// - kBin = true (one bin of the ablation): the slots [k0, k1), no diagonal;
//     A_u = sum_{k0 <= k < min(cnt_u, k1)} g g^T,  B_u likewise.
//
// What bounds it on an H100: fp32 operations (f(f+1)/2 + f FMAs per
// rating against 67 TFLOP/s); the bytes (A written once) are a few
// milliseconds less.  So the design keeps the FMA pipes fed:
//
// - Register tiling.  Each slot's row is staged in shared memory as
//   h = [g, val, 0...] of width Fs = 8*Tp >= f+1 (Tp = ceil((f+1)/8)).
//   Thread t owns one 8x8 tile (bi, bj), bi >= bj, of the lower block
//   triangle of h h^T, i.e. the rows R(bi) x columns R(bj) with
//   R(b) = {4b..4b+3} u {4Tp+4b..4Tp+4b+3}; 64 accumulators in
//   registers.  A slot costs the thread four float4 shared-memory loads
//   for 64 FMAs (the earlier design loaded 2 floats per FMA).  The two
//   halves of R(b) sit 4*Tp floats apart so that the 8 distinct tiles a
//   quarter-warp reads fall on distinct banks.  Every tile pair bi >= bj
//   holds each unordered pair {i, j} at least once, so both triangles of A
//   are written from it.
// - B_u from the same FMAs.  val sits in column f of h, so the tile
//   entries (f, j) and (j, f) are B_u[j]: B costs no accumulator, thread
//   or shared-memory load of its own.  Columns past f are zero.
// - Overlapped gather.  The theta rows of the next chunk of kChunk slots
//   are copied into the second shared-memory buffer with cp.async (16 B a
//   thread where the rows are 16-byte aligned, else 4 B) while this
//   chunk's FMAs run; the slot indices run one chunk further ahead.  One
//   CTA barrier per chunk.  (TMA cannot gather scattered rows.)
// - Split heavy rows.  Grid (row, part): part s takes the slots
//   [k0 + s*kSplit, k0 + (s+1)*kSplit).  With one part the CTA writes A
//   and B itself.  With several, each part writes its 64 accumulators per
//   thread to a scratch buffer and herm_reduce sums a row's parts in part
//   order, adds the diagonal and writes A and B: no float atomics, so two
//   calls on the same inputs are bit-equal.  A part that starts past
//   min(cnt_u, k1) exits at once.
// - Coalesced epilogue.  The tiles are staged in shared memory (the chunk
//   buffers are free by then) and A_u, B_u leave in order, float4 where
//   f % 4 == 0, not as the tiles' scattered 4-byte stores.
//
// The loop stops at min(cnt_u, K): padding slots would add exact zeros.
// An index outside [0, n) traps the launch.  fp32 FMAs only (no TF32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace herm {

constexpr int kMaxF = 128;
constexpr int kChunk = 32;                 // slots per shared-memory buffer
constexpr int kMaxTp = (kMaxF + 1 + 7) / 8;
constexpr int kMaxThreads = (kMaxTp * (kMaxTp + 1) / 2 + 31) / 32 * 32;   // 160
// Slots per part of a split row.  The heaviest quarter-Netflix item bin
// (K = 107912) holds 48 rows and 2.47 M ratings: at 2048 slots a part that
// is ~1200 parts, about 9 per SM, the CTAs one SM holds at f = 100, so the
// bin fills all 132 SMs in one wave, while each part is long enough (64
// chunks) that the partial it writes (23 KB at f = 100) costs little
// beside its FMAs.  Bins with K <= kSplit run unsplit.
constexpr int kSplit = 2048;

struct Shape {
  int f, Tp, Fs, npairs, nthreads;
};

__host__ __device__ inline Shape shape_of(int f) {
  Shape s;
  s.f = f;
  s.Tp = (f + 1 + 7) / 8;
  s.Fs = 8 * s.Tp;
  s.npairs = s.Tp * (s.Tp + 1) / 2;
  s.nthreads = (s.npairs + 31) / 32 * 32;
  return s;
}

// thread t < npairs -> tile (bi, bj), row-major over the lower block triangle
__device__ inline void tile_of(int t, int& bi, int& bj) {
  int i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  bi = i;
  bj = t - i * (i + 1) / 2;
}

// local index e < 8 of tile b -> feature index
__device__ inline int feat(int b, int e, int Tp) {
  return e < 4 ? 4 * b + e : 4 * Tp + 4 * b + (e - 4);
}

// Writes one row's tile entries: A both triangles (+ diag on the
// diagonal), B from the entries in row or column f.  Entries computed
// twice (diagonal tiles, (f, j) and (j, f)) are bit-equal, so the repeated
// stores agree.
__device__ inline void write_tile(const float (&acc)[64], int bi, int bj, const Shape& s,
                                  float d, float* sA, float* sB) {
  const int f = s.f;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = feat(bi, a, s.Tp);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = feat(bj, b, s.Tp);
      const float v = acc[a * 8 + b];
      if (i < f && j < f) {
        const float w = i == j ? v + d : v;
        sA[i * f + j] = w;
        sA[j * f + i] = w;
      } else if (i == f && j < f) {
        sB[j] = v;
      } else if (j == f && i < f) {
        sB[i] = v;
      }
    }
  }
}

// The epilogue of a row: the tiles staged in shared memory (sA, f*f + f
// floats, free once every thread is past the slot loop), then A_u and B_u
// written in order, coalesced (float4 when f % 4 == 0).
__device__ inline void store_row(const float (&acc)[64], bool owner, int bi, int bj,
                                 const Shape& s, float d, float* sA,
                                 float* __restrict__ A_u, float* __restrict__ B_u) {
  const int f = s.f;
  float* sB = sA + f * f;
  __syncthreads();
  if (owner) write_tile(acc, bi, bj, s, d, sA, sB);
  __syncthreads();
  if ((f & 3) == 0 && reinterpret_cast<uintptr_t>(A_u) % 16 == 0) {
    for (int t = threadIdx.x; t < f * f / 4; t += blockDim.x)
      reinterpret_cast<float4*>(A_u)[t] = reinterpret_cast<const float4*>(sA)[t];
  } else {
    for (int t = threadIdx.x; t < f * f; t += blockDim.x) A_u[t] = sA[t];
  }
  for (int t = threadIdx.x; t < f; t += blockDim.x) B_u[t] = sB[t];
}

// One part of row u (blockIdx.x): the slots [k0 + s*span, k0 + (s+1)*span)
// with s = blockIdx.y.  parts == nullptr: the only part, write A and B (with
// diag unless kBin).  Otherwise: write the accumulators to
// parts[((u * gridDim.y + s) * 64 + e) * nthreads + t].
template <bool kBin>
__global__ void __launch_bounds__(kMaxThreads)
herm_kernel(const float* __restrict__ theta,
            const int* __restrict__ idx,
            const float* __restrict__ val,
            const int* __restrict__ cnt,
            const float* __restrict__ diag,   // unused when kBin
            float* __restrict__ A,
            float* __restrict__ B,
            float* __restrict__ parts,
            int K, int f, int n, int k0, int k1, int span, int vec) {
  extern __shared__ __align__(16) float smem[];
  const Shape s = shape_of(f);
  float* s_g = smem;                                     // [2][kChunk][Fs]
  int* s_idx = reinterpret_cast<int*>(s_g + 2 * kChunk * s.Fs);   // [2][kChunk]

  const int64_t u = blockIdx.x;
  const int tid = threadIdx.x;
  const int hi = min(min(cnt[u], K), k1);
  const int lo = k0 + static_cast<int>(blockIdx.y) * span;
  const int end = min(hi, lo + span);
  if (lo >= end && parts != nullptr) return;   // this part holds no slot

  const int* idx_u = idx + u * K;
  const float* val_u = val + u * K;
  const int nchunks = lo < end ? (end - lo + kChunk - 1) / kChunk : 0;

  // zero the columns past f of both buffers (never copied into)
  for (int t = tid; t < 2 * kChunk * (s.Fs - f - 1); t += blockDim.x) {
    const int w = s.Fs - f - 1;
    s_g[(t / w) * s.Fs + f + 1 + t % w] = 0.f;
  }
  // indices of chunk 0 now, of chunk 1 with chunk 0's rows
  for (int k = tid; k < kChunk && lo + k < end; k += blockDim.x) s_idx[k] = idx_u[lo + k];
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  auto issue = [&](int c) {   // rows (and val) of chunk c, indices of chunk c + 1
    const int base = lo + c * kChunk;
    const int nk = min(kChunk, end - base);
    float* g = s_g + (c & 1) * kChunk * s.Fs;
    const int* ix = s_idx + (c & 1) * kChunk;
    for (int r = warp; r < nk; r += nwarps) {   // a warp per row, a lane per float4
      const int v = ix[r];
      if (v < 0 || v >= n) __trap();   // corrupt index: fail the launch
      const float* src = theta + static_cast<int64_t>(v) * f;
      float* dst = g + r * s.Fs;
      if (vec) {
        if (4 * lane < f) cp_async16(dst + 4 * lane, src + 4 * lane);
      } else {
        for (int col = lane; col < f; col += 32) cp_async4(dst + col, src + col);
      }
      if (lane == 0) cp_async4(dst + f, val_u + base + r);
    }
    const int nbase = base + kChunk;
    int* nix = s_idx + ((c + 1) & 1) * kChunk;
    for (int r = tid; r < kChunk && nbase + r < end; r += blockDim.x)
      cp_async4(nix + r, idx_u + nbase + r);
    cp_async_commit();
  };

  int bi = 0, bj = 0;
  const bool owner = tid < s.npairs;
  if (owner) tile_of(tid, bi, bj);
  const int oa = 4 * bi, ob = 4 * bj, oh = 4 * s.Tp;

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  if (nchunks > 0) issue(0);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();
    __syncthreads();   // chunk c landed; everyone is done with chunk c - 1
    if (c + 1 < nchunks) issue(c + 1);
    const int nk = min(kChunk, end - (lo + c * kChunk));
    const float* g = s_g + (c & 1) * kChunk * s.Fs;
    if (owner) {
#pragma unroll 2
      for (int k = 0; k < nk; ++k) {
        const float* h = g + k * s.Fs;
        const float4 a0 = *reinterpret_cast<const float4*>(h + oa);
        const float4 a1 = *reinterpret_cast<const float4*>(h + oh + oa);
        const float4 b0 = *reinterpret_cast<const float4*>(h + ob);
        const float4 b1 = *reinterpret_cast<const float4*>(h + oh + ob);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a * 8 + b] = fmaf(av[a], bv[b], acc[a * 8 + b]);
      }
    }
  }
  if (parts != nullptr) {
    if (!owner) return;
    float* p = parts + (u * gridDim.y + blockIdx.y) * 64 * s.nthreads + tid;
#pragma unroll
    for (int e = 0; e < 64; ++e) p[e * s.nthreads] = acc[e];
    return;
  }
  store_row(acc, owner, bi, bj, s, kBin ? 0.f : diag[u], smem, A + u * f * f, B + u * f);
}

// Sums row u's parts in part order (those that hold slots), adds the
// diagonal and writes A_u and B_u.  One CTA of nthreads per row.
__global__ void __launch_bounds__(kMaxThreads)
herm_reduce(const float* __restrict__ parts, const int* __restrict__ cnt,
            const float* __restrict__ diag, float* __restrict__ A, float* __restrict__ B,
            int K, int f, int nparts) {
  extern __shared__ __align__(16) float smem[];
  const Shape s = shape_of(f);
  const int64_t u = blockIdx.x;
  const int tid = threadIdx.x;
  const bool owner = tid < s.npairs;
  int bi = 0, bj = 0;
  if (owner) tile_of(tid, bi, bj);
  const int live = owner ? (min(cnt[u], K) + kSplit - 1) / kSplit : 0;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  for (int p = 0; p < live; ++p) {
    const float* q = parts + (u * nparts + p) * 64 * s.nthreads + tid;
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += q[e * s.nthreads];
  }
  store_row(acc, owner, bi, bj, s, diag[u], smem, A + u * f * f, B + u * f);
}

// Floats of scratch a launch over [0, K) needs (0: unsplit).
inline int64_t scratch_floats(int m, int K, int f) {
  const int nparts = (K + kSplit - 1) / kSplit;
  return nparts > 1 ? static_cast<int64_t>(m) * nparts * 64 * shape_of(f).nthreads : 0;
}

// The two chunk buffers, or the staged A_u and B_u, whichever is larger.
inline size_t smem_bytes(int f) {
  const Shape s = shape_of(f);
  const size_t chunks = 2 * kChunk * (s.Fs * sizeof(float) + sizeof(int));
  const size_t staged = static_cast<size_t>(f) * (f + 1) * sizeof(float);
  return chunks > staged ? chunks : staged;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return bytes > 48 * 1024
      ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes))
      : cudaSuccess;
}

// Validates the shapes and launches over the slots [k0, k1) of every row:
// unsplit when k1 - k0 <= kSplit or kBin, else split into parts written
// to `parts` (scratch_floats(m, K, f) floats) and summed by herm_reduce.
// Returns a cudaError_t (0 on success).
template <bool kBin>
int launch(const float* theta, const int* idx, const float* val,
           const int* cnt, const float* diag, float* A, float* B, float* parts,
           int m, int K, int f, int n, int k0, int k1, int device,
           void* stream) {
  if (m <= 0 || K <= 0 || f <= 0 || f > kMaxF || n <= 0 || k0 < 0 || k1 <= k0 || k1 > K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nparts = kBin ? 1 : (k1 - k0 + kSplit - 1) / kSplit;
  if (nparts > 65535 || (nparts > 1 && parts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s = shape_of(f);
  const int vec = (f % 4 == 0) && (reinterpret_cast<uintptr_t>(theta) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(f);
  if ((err = allow_smem(herm_kernel<kBin>, smem)) != cudaSuccess) return static_cast<int>(err);
  herm_kernel<kBin><<<dim3(m, nparts), s.nthreads, smem, st>>>(
      theta, idx, val, cnt, diag, A, B, nparts > 1 ? parts : nullptr, K, f, n, k0, k1,
      nparts > 1 ? kSplit : k1 - k0, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || nparts == 1) return static_cast<int>(err);
  const size_t staged = static_cast<size_t>(f) * (f + 1) * sizeof(float);
  if ((err = allow_smem(herm_reduce, staged)) != cudaSuccess) return static_cast<int>(err);
  herm_reduce<<<m, s.nthreads, staged, st>>>(parts, cnt, diag, A, B, K, f, nparts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace herm

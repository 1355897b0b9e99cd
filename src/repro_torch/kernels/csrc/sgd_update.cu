// Batch-Hogwild SGD tile sweep for Hopper (sm_90a): CuMF_SGD's block update.
//
// Replaces the Pallas TPU kernel repro/kernels/sgd_update.py
// sgd_tile_pallas (_sgd_tile_kernel).
//
// One (stacked) tile of a padded-ELL block (idx, val, cnt), slots k = 0..K-1
// in order.  Within slot k every active row u (cnt[u] > k) computes against
// the factors as they stood before the slot:
//   e      = val[u,k] - <x_u, theta_v>,         v = idx[u,k]
//   x_u   += lr * (e * theta_v - lam * x_u)
//   th_v  += lr * (mean_{u hits v in slot k} e * x_u - lam * th_v)
// Items hit by no row in the slot stay unchanged.
//
// The TPU kernel keeps x [mb, f] and theta [nb, f] in VMEM for all K slots
// and does the gather and the collision scatter as one-hot MXU matmuls.
// On the card one stacked call holds all of X and Theta (48 MB and 7 MB at
// quarter-Netflix), far beyond one SM, and slot k+1 must see the theta
// that slot k wrote, which blocks cannot pass to each other.  So:
//
// Design (first, simple version): two kernels per slot, in stream order,
// launched by one C entry point that loops over the K slots.
// - sgd_rows: one warp per row.  An inactive row returns at once.  An
//   active row gathers theta_v, reduces the dot over the warp, updates x_u
//   in place (rows are disjoint), and adds its contribution e * x_u, taken
//   with the PRE-update x_u, into a per-item accumulator, plus one hit.
// - sgd_items: one warp per item.  An item with hits > 0 takes the mean
//   (sum / hits), applies th_v += lr * (mean - lam * th_v), and clears its
//   accumulator for the next slot.
// Determinism without float atomics: the accumulator is 64-bit fixed point
// with a 2^-32 scale, added with integer atomics.  Integer addition is
// associative, so two runs on the same inputs give bit-equal outputs, and
// each contribution is rounded to a multiple of 2^-32 (the mean's error is
// about 1e-10).  A contribution that is not finite or is too large for the
// per-item sum to stay inside 64 bits (|e x_u| >= 2^30 / mb: a diverged
// run) marks its item, and that item's theta row becomes NaN, as the
// float update would.  All floating-point work of a slot is here: the dot,
// both updates, the collision sums and the mean.
// An index outside [0, nb) traps the launch.
//
// Bound on an H100: bytes and operations are close.  Per call, each input
// read once and each output written once (x and theta in and out, idx/val
// of the live slots, cnt), against 3.35 TB/s; about 6f fp32 flops per
// live rating against 67 TFLOP/s.  This version is far from either: it
// rereads x_u from device memory every slot (the TPU kept x resident),
// scans all nb items per slot, serialises the most popular items' atomics
// in L2, and makes 2K launches per call.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxF = 128;
constexpr int kPerLane = kMaxF / 32;
constexpr float kFixScale = 4294967296.0f;   // 2^32
constexpr double kFixUnit = 1.0 / 4294967296.0;

__global__ void __launch_bounds__(kThreads)
sgd_rows_kernel(float* __restrict__ x,
                const float* __restrict__ theta,
                const int* __restrict__ idx,
                const float* __restrict__ val,
                const int* __restrict__ cnt,
                unsigned long long* __restrict__ acc,
                int* __restrict__ hits,
                int* __restrict__ bad,
                int mb, int nb, int K, int f, int k,
                float lr, float lam, float limit) {
  const int lane = threadIdx.x & 31;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (u >= mb || cnt[u] <= k) return;          // inactive: x_u untouched
  const int v = idx[u * K + k];
  if (v < 0 || v >= nb) __trap();              // corrupt index: fail the launch
  const float r = val[u * K + k];
  float* x_u = x + u * f;
  const float* t_v = theta + static_cast<int64_t>(v) * f;

  float xv[kPerLane], tv[kPerLane];
  float dot = 0.f;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int j = lane + 32 * s;
    xv[s] = j < f ? x_u[j] : 0.f;
    tv[s] = j < f ? t_v[j] : 0.f;
    dot = fmaf(xv[s], tv[s], dot);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  const float e = r - dot;

  unsigned long long* acc_v = acc + static_cast<int64_t>(v) * f;
  bool overflow = false;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int j = lane + 32 * s;
    if (j < f) {
      x_u[j] = xv[s] + lr * (e * tv[s] - lam * xv[s]);
      const float c = e * xv[s];               // pre-update x_u
      if (fabsf(c) < limit) {
        atomicAdd(acc_v + j, static_cast<unsigned long long>(__float2ll_rn(c * kFixScale)));
      } else {
        overflow = true;                       // also catches NaN
      }
    }
  }
  if (overflow) atomicOr(bad + v, 1);
  if (lane == 0) atomicAdd(hits + v, 1);
}

__global__ void __launch_bounds__(kThreads)
sgd_items_kernel(float* __restrict__ theta,
                 unsigned long long* __restrict__ acc,
                 int* __restrict__ hits,
                 int* __restrict__ bad,
                 int nb, int f, float lr, float lam) {
  const int lane = threadIdx.x & 31;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (v >= nb) return;
  const int h = hits[v];
  if (h == 0) return;                          // not hit: theta_v untouched
  const bool poisoned = bad[v] != 0;
  float* t_v = theta + v * f;
  unsigned long long* acc_v = acc + v * f;
  const double inv = kFixUnit / static_cast<double>(h);
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int j = lane + 32 * s;
    if (j < f) {
      const long long q = static_cast<long long>(acc_v[j]);
      acc_v[j] = 0ull;
      const float mean = static_cast<float>(static_cast<double>(q) * inv);
      const float th = t_v[j];
      t_v[j] = poisoned ? __int_as_float(0x7fc00000) : th + lr * (mean - lam * th);
    }
  }
  __syncwarp();
  if (lane == 0) {
    hits[v] = 0;
    bad[v] = 0;
  }
}

}  // namespace

// Plain C entry point for ctypes: sweeps slots 0..K-1 of one tile, two
// launches per slot on `stream`.  x [mb, f] and theta [nb, f] are updated
// in place (the wrapper passes fresh copies); acc [nb, f] int64, hits and
// bad [nb] int32 must be zero on entry and are zero again on return.
// Returns a cudaError_t (0 on success).
extern "C" int sgd_tile_launch(float* x, float* theta, const int* idx,
                               const float* val, const int* cnt,
                               unsigned long long* acc, int* hits, int* bad,
                               int mb, int nb, int K, int f, float lr,
                               float lam, int device, void* stream) {
  if (mb <= 0 || nb <= 0 || K < 0 || f <= 0 || f > kMaxF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (mb + kWarps - 1) / kWarps;
  const int item_blocks = (nb + kWarps - 1) / kWarps;
  // every |contribution| < 2^30 / mb keeps any per-item sum of at most mb
  // of them below 2^30, i.e. below 2^62 in fixed point
  const float limit = ldexpf(1.f, 30) / static_cast<float>(mb);
  for (int k = 0; k < K; ++k) {
    sgd_rows_kernel<<<row_blocks, kThreads, 0, s>>>(x, theta, idx, val, cnt, acc, hits,
                                                    bad, mb, nb, K, f, k, lr, lam, limit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sgd_items_kernel<<<item_blocks, kThreads, 0, s>>>(theta, acc, hits, bad, nb, f, lr, lam);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Fused squared error for Hopper (sm_90a): the objective's sum over the
// nonzeros of a padded-ELL batch (idx, val, cnt), and their count,
//   sse = sum_u sum_{k < cnt_u} (val[u,k] - x[r_u] . theta[idx[u,k]])^2,
//   nnz = sum_u cnt_u,
// with r_u = rows[u] where a row map is given, else u, added into a
// float64 accumulator out = (sse, nnz) in device memory, so that several
// calls (the degree bins of one matrix) share one total.
//
// Replaces no TPU kernel: the reference's objective
// (repro/core/objective.py _sq_err_padded) is a plain jnp gather and
// einsum.  It takes the place of that gather and einsum in the port
// (kernels/sq_err.py sq_err_plain), which writes theta[idx] to device
// memory as a [rows, K, f] tensor, reads it back for the einsum, and does
// both for every padding slot up to the bin's K.
//
// What bounds it on an H100: the theta row fetched per rating.  idx and
// val are read once (8 B a slot), each x row once, and the 2f flops a
// rating are nothing beside 67 TFLOP/s; but every rating reads a whole
// theta row, 4f bytes (400 B at f = 100): 39.6 GB for Netflix's 99 M
// ratings, served by L2 where Theta fits (7 MB), and 101 GB for Yahoo!
// Music's 252.8 M, partly from HBM, as its 250 MB Theta misses L2.  So
// the design keeps many theta rows in flight and spends L2 on Theta:
//
// - A warp per work item: one row's slots [c * kSlots, (c + 1) * kSlots)
//   up to cnt_u, so only the row's cnt_u slots are walked (padding is
//   skipped) and a heavy row (K ~ 1e4) is cut into items that spread over
//   the SMs.  The warps of a persistent grid (SMs x resident blocks) take
//   the items in a fixed stride, so the work each warp does depends only
//   on the shapes.
// - x_u in registers.  A rating is taken by a group of kGroup = 8 lanes,
//   lane g holding the elements [V*(g + 8i), V*(g + 8i) + V) of x_u for
//   i < 16 / V (f <= 128), loaded once per item, through the row map.
// - The warp's 32 slots' idx and val come in with one coalesced load each,
//   with the streaming hint (ld.global.cs), so ratings read once do not
//   push theta rows out of L2; they reach the groups by shuffles.
// - Four groups take four ratings a step, and kUnroll steps' theta rows
//   are loaded before any is used: 8 rows in flight per warp, through the
//   read-only path (L1 keeps the popular items), 16 bytes a lane where
//   f % 4 == 0 and the rows are 16-byte aligned (V = 4), else 4 (V = 1).
// - The residual val - x . theta is formed in fp32, the dot product
//   reduced over the group by three shuffles.  Its square is summed in
//   fp32 over the item (on each group's first lane, then over the warp),
//   the items' sums in float64 per warp and per block.  Each block writes
//   its partial (sse, nnz) to scratch, and a second launch of one block
//   adds them in block order into out.  No atomics: two calls on the same
//   inputs are bit-equal.
//
// An index outside [0, n) traps the launch.  fp32 FMAs only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxF = 128;
constexpr int kGroup = 8;                       // lanes per rating
constexpr int kRatings = 32 / kGroup;           // ratings a warp takes per step
constexpr int kUnroll = 2;                      // steps whose theta rows are in flight
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 1024;                    // slots of a work item
constexpr int kReduceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int V> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<1> { using T = float; };

__device__ inline float4 zero_of(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ inline float zero_of(float) { return 0.f; }

__device__ inline float dot_acc(float4 a, float4 b, float d) {
  d = fmaf(a.x, b.x, d);
  d = fmaf(a.y, b.y, d);
  d = fmaf(a.z, b.z, d);
  return fmaf(a.w, b.w, d);
}
__device__ inline float dot_acc(float a, float b, float d) { return fmaf(a, b, d); }

// Partial (sse, nnz) of block b into partial[2b], partial[2b + 1].
template <int V>
__global__ void __launch_bounds__(kThreads)
sq_err_kernel(const float* __restrict__ x, const float* __restrict__ theta,
              const int* __restrict__ idx, const float* __restrict__ val,
              const int* __restrict__ cnt, const int64_t* __restrict__ rows,
              double* __restrict__ partial, int K, int f, int n, int64_t items,
              int chunks) {
  using Vec = typename VecOf<V>::T;
  constexpr int NV = kMaxF / kGroup / V;         // x vectors a lane holds
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kGroup, gl = lane % kGroup;
  const int fv = f / V;                          // vectors of a row
  const Vec* th = reinterpret_cast<const Vec*>(theta);
  double acc = 0.0;
  int64_t nnz = 0;
  for (int64_t it = static_cast<int64_t>(blockIdx.x) * kWarps + warp; it < items;
       it += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t u = it / chunks;
    const int k0 = static_cast<int>(it % chunks) * kSlots;
    const int k1 = min(min(cnt[u], K), k0 + kSlots);
    if (k0 >= k1) continue;                      // the same for the whole warp
    const int64_t xr = rows != nullptr ? rows[u] : u;
    const Vec* xu = reinterpret_cast<const Vec*>(x + xr * f);
    Vec xv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = gl + kGroup * i;
      xv[i] = j < fv ? __ldg(xu + j) : zero_of(Vec{});
    }
    const int* idx_u = idx + u * K;
    const float* val_u = val + u * K;
    float s = 0.f;
    for (int base = k0; base < k1; base += 32) {
      const int nt = min(32, k1 - base);
      int ci = 0;
      float vi = 0.f;
      if (lane < nt) {
        ci = __ldcs(idx_u + base + lane);
        vi = __ldcs(val_u + base + lane);
      }
#pragma unroll
      for (int st = 0; st < 32; st += kRatings * kUnroll) {
        if (st >= nt) break;                     // the same for the whole warp
        Vec t[kUnroll][NV];
        float v[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) {
          const int slot = st + r * kRatings + grp;
          const int c = __shfl_sync(kFull, ci, slot);
          v[r] = __shfl_sync(kFull, vi, slot);
          ok[r] = slot < nt;
          if (ok[r] && (c < 0 || c >= n)) __trap();   // corrupt index: fail the launch
          const Vec* tr = th + static_cast<int64_t>(c) * fv;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int j = gl + kGroup * i;
            t[r][i] = ok[r] && j < fv ? __ldg(tr + j) : zero_of(Vec{});
          }
        }
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) d = dot_acc(xv[i], t[r][i], d);
          d += __shfl_xor_sync(kFull, d, 1);
          d += __shfl_xor_sync(kFull, d, 2);
          d += __shfl_xor_sync(kFull, d, 4);
          const float e = v[r] - d;
          if (ok[r] && gl == 0) s = fmaf(e, e, s);
        }
      }
    }
    s += __shfl_xor_sync(kFull, s, kGroup);      // the groups' first lanes
    s += __shfl_xor_sync(kFull, s, 2 * kGroup);
    acc += static_cast<double>(s);
    nnz += k1 - k0;
  }
  __shared__ double w_sse[kWarps];
  __shared__ int64_t w_nnz[kWarps];
  if (lane == 0) {
    w_sse[warp] = acc;
    w_nnz[warp] = nnz;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0;
    int64_t c = 0;
    for (int w = 0; w < kWarps; ++w) {
      a += w_sse[w];
      c += w_nnz[w];
    }
    partial[2 * blockIdx.x] = a;
    partial[2 * blockIdx.x + 1] = static_cast<double>(c);
  }
}

// out[0] += sum of the blocks' sse, out[1] += their nnz, in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
sq_err_finish(const double* __restrict__ partial, int blocks, double* __restrict__ out) {
  __shared__ double s_sse[kReduceThreads], s_nnz[kReduceThreads];
  double a = 0.0, c = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kReduceThreads) {
    a += partial[2 * b];
    c += partial[2 * b + 1];
  }
  s_sse[threadIdx.x] = a;
  s_nnz[threadIdx.x] = c;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      s_sse[threadIdx.x] += s_sse[threadIdx.x + h];
      s_nnz[threadIdx.x] += s_nnz[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] += s_sse[0];
    out[1] += s_nnz[0];
  }
}

// Blocks of the persistent grid of sq_err_kernel<V> on `device` (SMs x
// resident blocks per SM), or a negated cudaError_t.
template <int V>
int grid_blocks(int device) {
  static int blocks[64] = {0};
  if (device < 0 || device >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (blocks[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sq_err_kernel<V>, kThreads, 0);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (per_sm <= 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
    blocks[device] = sms * per_sm;
  }
  return blocks[device];
}

}  // namespace

// Doubles of scratch a launch on `device` may need (two per block of the
// larger grid), or a negated cudaError_t.
extern "C" long long sq_err_scratch_doubles(int device) {
  const int a = grid_blocks<4>(device), b = grid_blocks<1>(device);
  if (a < 0) return a;
  if (b < 0) return b;
  return 2LL * (a > b ? a : b);
}

// Plain C entry point for ctypes: the squared-error kernel and the launch
// that adds its block partials into out = (sse, nnz), on `stream`.
// `rows` may be null (row u of the batch is row u of x).  `partial` holds
// sq_err_scratch_doubles(device) doubles.  Returns a cudaError_t (0 on
// success).
extern "C" int sq_err_launch(const float* x, const float* theta, const int* idx,
                             const float* val, const int* cnt, const int64_t* rows,
                             double* partial, double* out, int m, int K, int f, int n,
                             int device, void* stream) {
  if (m < 0 || K < 0 || f <= 0 || f > kMaxF || n <= 0 || partial == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || K == 0) return 0;
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(theta) % 16 == 0;
  const int cap = vec ? grid_blocks<4>(device) : grid_blocks<1>(device);
  if (cap < 0) return -cap;
  const int chunks = (K + kSlots - 1) / kSlots;
  const int64_t items = static_cast<int64_t>(m) * chunks;
  const int64_t want = (items + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    sq_err_kernel<4><<<blocks, kThreads, 0, st>>>(x, theta, idx, val, cnt, rows, partial, K, f,
                                                  n, items, chunks);
  else
    sq_err_kernel<1><<<blocks, kThreads, 0, st>>>(x, theta, idx, val, cnt, rows, partial, K, f,
                                                  n, items, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sq_err_finish<<<1, kReduceThreads, 0, st>>>(partial, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

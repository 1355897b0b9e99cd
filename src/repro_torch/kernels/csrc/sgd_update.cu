// Batch-Hogwild SGD tile sweep for Hopper (sm_90a): CuMF_SGD's block update.
//
// Replaces the Pallas TPU kernel repro/kernels/sgd_update.py
// sgd_tile_pallas (_sgd_tile_kernel).
//
// The function: slots k = 0..K-1 of a (stacked) tile in order.  Within
// slot k every active row u (cnt[u] > k), with item v = idx[u,k], updates
// against the factors as they stood before the slot:
//   e      = r - <x_u, theta_v>
//   x_u   += lr * (e * theta_v - lam * x_u)
//   th_v  += lr * (mean over the slot's hits on v of e * x_u - lam * th_v)
// with x_u taken before its update.  Items no row hits stay unchanged.
//
// The TPU kernel keeps x and theta in VMEM for all K slots and does the
// gather and the collision scatter as one-hot MXU matmuls.  On the card a
// stacked call's X and Theta (48 MB and 7 MB at quarter-Netflix) do not
// fit on one SM, and slot k+1 must see what slot k wrote.
//
// Design: the work runs from a slot plan that the wrapper builds once
// from (idx, cnt), which never change between epochs
// (kernels/sgd_update.py, build_plan).  The plan lists each live
// (row, slot) entry once, ordered by (slot, item, row), and cuts each
// slot's entries into units: one item's collision group, or a part of at
// most P rows of a longer group.
// - One warp per unit.  It holds theta_v in registers (f <= 128: four
//   floats a lane), walks the unit's rows in order with the next kDepth
//   rows' x loads in flight (a ring in registers: a row is one float4 per
//   lane), reduces e over the warp, adds e * x_u to the unit's fp32 sum in
//   row order, and writes x_u back.  Each row is in one unit per slot, so
//   the x writes never conflict.  A whole group then writes theta_v; a
//   part writes its sum to scratch.  A slot's units, longest first, are
//   dealt to the W warps in rounds, forward and backward in turn; a warp
//   loads its next unit's head (descriptor, theta_v, the first 32 rows'
//   ids and ratings) while it runs the current one.
// - After a grid barrier, a warp per split group adds its parts' sums in
//   part order and writes theta_v.  Only slots with split groups pay
//   for this second step.
// - One cooperative launch per call: a persistent grid of SMs x occupancy
//   blocks walks every slot of the plan, with a grid barrier (a counter
//   in device memory) between steps.  The units of a slot are dealt to
//   warps in a fixed order; no result depends on which warp ran a unit.
// - No atomics in any sum and no fixed point: every sum is fp32 in a fixed
//   order, so reruns are bit-equal by construction.  A diverged run gives
//   inf/NaN through the float update itself.  A row or item id outside
//   x or theta traps the launch.
// - Factors that other blocks write during the launch are read through
//   L2 (ld.global.cg); plan arrays, which nothing writes, through the
//   read-only path.
//
// What bounds it on an H100: bytes.  Each live entry reads and writes its
// x_u (8f bytes), so at quarter-Netflix (19.76 M entries per epoch, f=100)
// the floor of this design is 15.8 GB / 3.35 TB/s = 4.7 ms per epoch, less
// where L2 keeps a slot's active rows for the next slot.  The first
// design's five costs, and what this one does about each:
// 1. 2K launches per call: one launch, a grid barrier per slot step.
// 2. Every launch scanned all rows and all items: warps walk only the
//    plan's units; dead rows, unhit items and empty slots are not in it.
// 3. Dead trailing slots: the plan holds no slot without a live entry.
// 4. 64-bit integer atomics per feature for the collision sum, serialised
//    in L2 on popular items: the sum is a warp's registers; groups longer
//    than P rows are cut into parts summed in a fixed order.
// 5. x re-read with 4-byte loads and no prefetch: float4 loads (f % 4 ==
//    0), kDepth rows in flight, the next unit's head loaded ahead.
// What is left (PERF.md has the card's numbers): about half the time
// scales with the row bytes, the rest is per-slot latency that the grid
// barrier exposes: each slot starts with dependent loads (heads, then x
// rows) and ends with its busiest warp.  More resident warps help, so the
// part sums' loads in flight are kept to kPartDepth, which keeps the
// kernel at three blocks per SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxF = 128;
constexpr int kDepth = 4;              // rows whose x loads are in flight
constexpr int kPartDepth = 4;          // part sums whose loads are in flight

struct Params {
  float* x;                  // [nx, f]      updated in place
  float* theta;              // [ntheta, f]  updated in place
  const int* rows;           // [L]  x row of each entry, plan order
  const float* vals;         // [L]  rating of each entry
  const int4* units;         // [U]  (item, first entry, rows, scratch row or -1)
  const int* unit_offs;      // [S+1] each slot's units
  const int4* splits;        // [G]  (item, first scratch row, parts, rows)
  const int* split_offs;     // [S+1] each slot's split groups
  float* scratch;            // [n_scratch, f] part sums of one slot
  unsigned* bar;             // grid barrier counter, 0 at launch
  int n_slots, nx, ntheta, f;
  float lr, lam;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Every block arrives once per barrier, so arrival b of a launch sees
// the counter in [b * nblocks, (b + 1) * nblocks) and waits for the end
// of that range.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned old = atom_add_acq_rel(bar, 1u);
    const unsigned target = (old / gridDim.x + 1u) * gridDim.x;
    while (ld_acquire(bar) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// A row of f floats, four a lane: lane l holds 4l..4l+3 (kVec) or
// l, l+32, l+64, l+96.
template <bool kVec>
__device__ __forceinline__ void load_row(float (&r)[4], const float* p, int lane, int f) {
  if (kVec) {
    if (4 * lane < f) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p) + lane);
      r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
    } else {
      r[0] = r[1] = r[2] = r[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) r[s] = lane + 32 * s < f ? __ldcg(p + lane + 32 * s) : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_row(float* p, const float (&r)[4], int lane, int f) {
  if (kVec) {
    if (4 * lane < f) reinterpret_cast<float4*>(p)[lane] = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (lane + 32 * s < f) p[lane + 32 * s] = r[s];
  }
}

// What a unit needs first: its descriptor, theta_v, and the ids and
// ratings of its first 32 rows (a lane each).  Loaded one unit ahead, so
// the loads are in flight while the warp runs the unit before.
struct UnitHead {
  int4 d;
  float t[4];
  int row;
  float val;
};

__device__ __forceinline__ void load_rows(int& row, float& val, const Params& p, int first,
                                          int n, int lane) {
  row = 0;
  val = 0.f;
  if (lane < n) {
    row = __ldg(p.rows + first + lane);
    val = __ldg(p.vals + first + lane);
  }
}

template <bool kVec>
__device__ __forceinline__ UnitHead load_head(const Params& p, int4 d, int lane) {
  UnitHead h;
  h.d = d;
  if (d.x < 0 || d.x >= p.ntheta) __trap();
  load_row<kVec>(h.t, p.theta + static_cast<int64_t>(d.x) * p.f, lane, p.f);
  load_rows(h.row, h.val, p, d.y, min(32, d.z), lane);
  return h;
}

// One unit: its rows in order, their x updates, and the sum of
// e * x_u (pre-update) in row order.
template <bool kVec>
__device__ void run_unit(const Params& p, const UnitHead& h, int lane) {
  const int item = h.d.x, start = h.d.y, len = h.d.z, scratch_row = h.d.w;
  const int f = p.f;
  float t[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < 4; ++s) t[s] = h.t[s];
  int my_row = h.row;
  float my_val = h.val;
  for (int b = 0; b < len; b += 32) {
    const int n = min(32, len - b);
    if (b > 0) load_rows(my_row, my_val, p, start + b, n, lane);
    if (lane < n && (my_row < 0 || my_row >= p.nx)) __trap();
    float xr[kDepth][4];
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
      const int r = __shfl_sync(0xffffffffu, my_row, q);
      if (q < n) load_row<kVec>(xr[q], p.x + static_cast<int64_t>(r) * f, lane, f);
    }
    for (int i = 0; i < n; i += kDepth) {
#pragma unroll
      for (int q = 0; q < kDepth; ++q) {
        const int k = i + q;               // warp-uniform
        if (k < n) {
          const int r = __shfl_sync(0xffffffffu, my_row, k);
          const float val = __shfl_sync(0xffffffffu, my_val, k);
          float dot = 0.f;
#pragma unroll
          for (int s = 0; s < 4; ++s) dot = fmaf(xr[q][s], t[s], dot);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          const float e = val - dot;
          float xn[4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            acc[s] += e * xr[q][s];
            xn[s] = xr[q][s] + p.lr * (e * t[s] - p.lam * xr[q][s]);
          }
          store_row<kVec>(p.x + static_cast<int64_t>(r) * f, xn, lane, f);
          const int next = __shfl_sync(0xffffffffu, my_row, (k + kDepth) & 31);
          if (k + kDepth < n) load_row<kVec>(xr[q], p.x + static_cast<int64_t>(next) * f, lane, f);
        }
      }
    }
  }
  if (scratch_row < 0) {
    const float hits = static_cast<float>(len);
#pragma unroll
    for (int s = 0; s < 4; ++s) t[s] = t[s] + p.lr * (acc[s] / hits - p.lam * t[s]);
    store_row<kVec>(p.theta + static_cast<int64_t>(item) * f, t, lane, f);
  } else {
    store_row<kVec>(p.scratch + static_cast<int64_t>(scratch_row) * f, acc, lane, f);
  }
}

// One split group: its parts' sums added in part order, then theta_v.
template <bool kVec>
__device__ void run_split(const Params& p, int4 d, int lane) {
  const int item = d.x, first = d.y, parts = d.z;
  const int f = p.f;
  if (item < 0 || item >= p.ntheta) __trap();
  float tot[4] = {0.f, 0.f, 0.f, 0.f}, t[4];
  for (int q0 = 0; q0 < parts; q0 += kPartDepth) {
    float part[kPartDepth][4];
#pragma unroll
    for (int q = 0; q < kPartDepth; ++q)
      if (q0 + q < parts)
        load_row<kVec>(part[q], p.scratch + static_cast<int64_t>(first + q0 + q) * f, lane, f);
#pragma unroll
    for (int q = 0; q < kPartDepth; ++q)
      if (q0 + q < parts)
#pragma unroll
        for (int s = 0; s < 4; ++s) tot[s] += part[q][s];
  }
  float* t_v = p.theta + static_cast<int64_t>(item) * f;
  load_row<kVec>(t, t_v, lane, f);
  const float h = static_cast<float>(d.w);
#pragma unroll
  for (int s = 0; s < 4; ++s) t[s] = t[s] + p.lr * (tot[s] / h - p.lam * t[s]);
  store_row<kVec>(t_v, t, lane, f);
}

// The unit a warp runs in round r of a slot whose units start at u0,
// longest first: even rounds deal them to warps 0..W-1, odd rounds to
// W-1..0, so no warp collects the longest unit of every round.
__device__ __forceinline__ int unit_of(int u0, int r, int warp, int n_warps) {
  return u0 + r * n_warps + ((r & 1) ? n_warps - 1 - warp : warp);
}

// All slots of the plan in one cooperative launch, a grid barrier
// between steps.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
sgd_plan_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;
  for (int s = 0; s < p.n_slots; ++s) {
    const int u0 = __ldg(p.unit_offs + s), u1 = __ldg(p.unit_offs + s + 1);
    int u = unit_of(u0, 0, warp, n_warps);
    if (u < u1) {                    // the next unit's head in flight meanwhile
      UnitHead cur = load_head<kVec>(p, __ldg(p.units + u), lane);
      int u_next = unit_of(u0, 1, warp, n_warps);
      int4 d_next = u_next < u1 ? __ldg(p.units + u_next) : cur.d;
      for (int r = 2;; ++r) {
        const int u_after = unit_of(u0, r, warp, n_warps);
        UnitHead next = cur;
        if (u_next < u1) next = load_head<kVec>(p, d_next, lane);
        if (u_after < u1) d_next = __ldg(p.units + u_after);
        run_unit<kVec>(p, cur, lane);
        if (u_next >= u1) break;
        cur = next;
        u_next = u_after;
      }
    }
    const int g0 = __ldg(p.split_offs + s), g1 = __ldg(p.split_offs + s + 1);
    if (g0 < g1) {
      grid_barrier(p.bar);
      for (int g = g0 + warp; g < g1; g += n_warps) run_split<kVec>(p, __ldg(p.splits + g), lane);
    }
    if (s + 1 < p.n_slots) grid_barrier(p.bar);
  }
}

template <bool kVec>
int grid_blocks(int device) {
  static int blocks[64] = {0};
  if (device < 0 || device >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (blocks[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sgd_plan_kernel<kVec>, kThreads, 0);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (per_sm <= 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
    blocks[device] = sms * per_sm;
  }
  return blocks[device];
}

}  // namespace

// Plain C entry point for ctypes.  Runs every slot of a plan on x and
// theta in place, as ONE cooperative launch on `stream`.  `vec` selects
// float4 rows (f % 4 == 0, 16-byte aligned x, theta and scratch).  `bar`
// is one uint32 of device scratch.  Returns a cudaError_t (0 on success);
// a refused cooperative launch (blocks that cannot all be resident) is
// returned, never replaced by another launch.
extern "C" int sgd_plan_launch(float* x, float* theta, const int* rows, const float* vals,
                               const int* units, const int* unit_offs, const int* splits,
                               const int* split_offs, float* scratch, unsigned* bar,
                               int n_slots, int nx, int ntheta, int f, float lr, float lam,
                               int vec, int device, void* stream) {
  if (n_slots < 0 || nx <= 0 || ntheta <= 0 || f <= 0 || f > kMaxF || (vec && f % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_slots == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{x, theta, rows, vals, reinterpret_cast<const int4*>(units), unit_offs,
           reinterpret_cast<const int4*>(splits), split_offs, scratch, bar,
           n_slots, nx, ntheta, f, lr, lam};
  const int blocks = vec ? grid_blocks<true>(device) : grid_blocks<false>(device);
  if (blocks < 0) return -blocks;
  err = cudaMemsetAsync(bar, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  const void* fn = vec ? reinterpret_cast<const void*>(sgd_plan_kernel<true>)
                       : reinterpret_cast<const void*>(sgd_plan_kernel<false>);
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, 0, s);
  return static_cast<int>(err);
}

// Blocks of the persistent grid (SMs x resident blocks per SM), or a
// negated cudaError_t.
extern "C" int sgd_plan_grid_blocks(int vec, int device) {
  return vec ? grid_blocks<true>(device) : grid_blocks<false>(device);
}

// The chain probe on Hopper: one persistent launch of the fused chained
// SpMV shape, split into its floor (A), its full body (B, C) and its carry
// (D), f32, with each block's share of the pack held in shared memory
// across iterations.
//
// Replaces the Pallas kernel of bench_tools/probe_chain.py
// (run_variant.make_call.kernel).  There one pallas_call runs a grid
// (n_iters, T) in order: its x/y slots ping-pong in VMEM, each chunk's
// value and metadata blocks are streamed again every iteration, and chunk
// t of variant D adds a carry that chunk t - 1 left in scratch.  Here one
// cooperative launch runs all n_iters iterations (the index maps are
// stated in vbcs_tpu_torch/probes/probe_chain.py, whose plan() computes
// the same block ranges as this file).  It replaced a streaming design (a
// thread a column, the pack read from L2 every iteration, D's carry
// column computed twice), whose `out` it reproduces bit for bit:
//
// - Plan.  Block b of G owns columns [b X / G, (b + 1) X / G): lengths
//   balanced to within one column.  Its first `nr` columns are resident:
//   the most whose values, positions and x windows (below) fit its
//   shared-memory budget; the others, if any, are streamed.  A column
//   gathers from 8 rows x wblk windows of 128 lanes of its slice (A: the 8
//   rows of its chunk's first window), so a block's resident columns,
//   slices [u0, u1], read only those units' 8 wblk windows.
// - Prologue.  Each block copies its resident columns' 64 values each into
//   dynamic shared memory and decodes each column's 8 gather positions
//   once, into its staged windows (the probe's _gather: window (u - u0) 8
//   wblk + row wblk + d, lane lo; -1 where d >= wblk), with each window's
//   start in the slot (row X + wbase[u wblk + d]).  None depends on x, so
//   the TPU kernel's per-iteration decode is loop-invariant work here.  For
//   D, a block whose range starts at a chunk start c0 = t * 1024, t > 0,
//   also holds column c0 - 1, the halo, and its slice's windows.  The
//   prologue is block-local and iteration 0 reads xin, which no block
//   writes, so a __syncthreads ends it.
// - An iteration, two phases split by __syncthreads.  The windows: the
//   block's threads copy its staged windows from the slot (__ldcg, a
//   float4 a thread, 512 bytes a window; xin starts on 16 bytes, and a
//   window on 512 bytes past it), kBatch loads a thread in flight: one
//   round trip to L2 for 3.7 MB (B at T = 40 on 132 blocks), where
//   gathering each x value from the slot moves ~10 MB of 32-byte sectors
//   (on an H100 that design ran B in 0.74x the streaming design's time
//   an iteration, this one in 0.42x: PERF.md).  The multiply: thread items (column, half) compute 4 outputs each,
//   acc = fmaf(val[8w+s, c], xg[s, c], acc) for s = 0..7, then * 0.999f
//   (A: acc += val, then + xw[w] * 0), xg from the staged windows.  A
//   thread's first item keeps its 32 values and 8 positions in registers
//   for the whole chain, so an iteration reads only its 8 window values
//   from shared memory; further items read all from shared memory.
// - D's carry.  Column c = t * 1024 (t > 0) adds res[w, c - 1], a chunk's
//   last lane, which has no carry itself.  The item of c computes both
//   columns, c - 1 from the block's shared copy or its halo, writes c - 1
//   where the block owns it and c as fmaf(acc[c - 1], 0.999f, res[c]),
//   which is how the compiler contracted the streaming design's carry
//   add; the item of c - 1 is skipped where c is the block's.  So no
//   column is computed twice in a block.
// - Spill.  Columns past the budget (a large T, a small grid or budget)
//   are walked a thread a column from global memory every iteration: the
//   decode, the gather from the slot and the 64 values, as the streaming
//   design did; D's pair rule holds across the resident and streamed
//   parts.  So one kernel covers every T the launcher admits; a budget of
//   0 streams everything.
//
// Every sum is the streaming design's, in its order.  Iteration 0 reads
// xin; iteration i >= 1 reads slot (i - 1) % 2 and writes slot i % 2, or
// `out` at the last.  One grid_barrier (barrier.cuh) ends each iteration
// but the last.  The slots are written inside the launch, so they are
// read with ld.global.cg (L2 only), never through an L1 line that could
// be stale after a barrier.
//
// What bounds it now: the barrier (~1.8 us an iteration on an H100, the
// chain kernel's barrier floor), then one L2 round trip for the windows
// (slices at a range's edges copied by both blocks), then the multiply's
// shared-memory reads (8 window values an item, 32 values and 8
// positions more for items past a thread's first).  Its operations are 2
// x 2,621,440 FMAs an iteration: 0.08 us.
//
// The grid is the occupancy API's count at the chosen shared-memory
// budget; a grid that does not fit is refused by the cooperative launch,
// and a budget over the device's limit by cudaFuncSetAttribute: the error
// is returned, never worked around.

#include <cuda_runtime.h>

#include "barrier.cuh"

namespace {

constexpr int kNS = 1024;  // columns of a chunk (NG == NS)
constexpr int kNV = kNS / 128;
// 96 registers a thread, so a held item's 40 fit beside the copy's 16
// without spilling; 2 x 311 items a block at T = 40 on 132 blocks
constexpr int kThreads = 640;
constexpr int kBatch = 4;  // float4 window loads a thread has in flight
// shared bytes a resident column (64 values, 8 positions) and a staged
// window (128 lanes, its start): probes/probe_chain.py COL_BYTES, WIN_BYTES
constexpr int kColBytes = 4 * (64 + 8);
constexpr int kWinBytes = 4 * (128 + 1);

enum Variant { kA = 0, kB, kC, kD };

struct Args {
  int X;     // columns: T * kNS
  int wblk;  // windows a 128-lane slice
  const float* val;  // [64, X]
  const int* meta;   // [8, X]
  const int* wbase;  // [T * kNV * wblk] window lanes
};

// A block's resident columns [c0, c0 + nr), the halo c0 - 1 last (entry
// nr) where h, and their windows: units [u0, u0 + nwin / K) of U columns,
// K windows each.
struct Range {
  int nr, h, ne, u0, nwin;
};

template <int V>
__device__ __forceinline__ int unit_cols() { return V == kA ? kNS : 128; }

template <int V>
__device__ __forceinline__ int unit_windows(const Args& a) { return V == kA ? 8 : 8 * a.wblk; }

// The most resident columns of [c0, c1) whose bytes fit `budget`
// (probes/probe_chain.py: plan).
template <int V>
__device__ Range plan(const Args& a, int c0, int c1, int budget) {
  const int U = unit_cols<V>(), K = unit_windows<V>(a);
  const int h = V == kD && c0 % kNS == 0 && c0 > 0 ? 1 : 0;
  auto bytes = [&](int nr) -> long long {
    if (nr == 0) return 0;
    return static_cast<long long>(nr + h) * kColBytes +
           static_cast<long long>((c0 + nr - 1) / U - (c0 - h) / U + 1) * K * kWinBytes;
  };
  int lo = 0, hi = c1 - c0;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (bytes(mid) <= budget) lo = mid; else hi = mid - 1;
  }
  Range r;
  r.nr = lo;
  r.h = lo > 0 ? h : 0;
  r.ne = lo + r.h;
  r.u0 = lo > 0 ? (c0 - r.h) / U : 0;
  r.nwin = lo > 0 ? ((c0 + lo - 1) / U - r.u0 + 1) * K : 0;
  return r;
}

// Column c's gather s (B, C, D) in the slot: row * X + b + lo and the
// window (d, row) it lies in; -1 where the gathered value is 0.
__device__ __forceinline__ int decode(const Args& a, int s, int c, int* window) {
  const int q = c / 128;  // the slice: t * kNV + v
  const unsigned m = static_cast<unsigned>(__ldg(a.meta + s * a.X + c));
  const unsigned lo = m & 127;
  const unsigned d = a.wblk == 1 ? 0u : (m >> 7) & 3;
  if (d >= static_cast<unsigned>(a.wblk)) return -1;
  const unsigned at = static_cast<unsigned>(__ldg(a.meta + s * a.X + q * 128 + lo));
  const int row = static_cast<int>((at >> (16 + 3 * d)) & 7);
  *window = row * a.wblk + static_cast<int>(d);
  return row * a.X + __ldg(a.wbase + q * a.wblk + d) + static_cast<int>(lo);
}

// Column c's gather s in the slot (A: the window lane of row s).
template <int V>
__device__ __forceinline__ int position(const Args& a, int s, int c) {
  if constexpr (V == kA) {
    return s * a.X + __ldg(a.wbase + c / kNS * kNV * 2) + c % 128;  // as the TPU body indexes it
  } else {
    int window;
    return decode(a, s, c, &window);
  }
}

// Column c's gather s in the block's staged windows (from unit u0).
template <int V>
__device__ __forceinline__ int local_position(const Args& a, int s, int c, int u0) {
  if constexpr (V == kA) {
    return ((c / kNS - u0) * 8 + s) * 128 + c % 128;
  } else {
    int window;
    const int p = decode(a, s, c, &window);
    return p < 0 ? -1 : ((c / 128 - u0) * 8 * a.wblk + window) * 128 + p % 128;
  }
}

// The slot offset of staged window e (from unit u0).
template <int V>
__device__ __forceinline__ int window_start(const Args& a, int e, int u0) {
  const int K = unit_windows<V>(a), u = u0 + e / K, k = e % K;
  if constexpr (V == kA) return k * a.X + __ldg(a.wbase + u * kNV * 2);
  return (k / a.wblk) * a.X + __ldg(a.wbase + u * a.wblk + k % a.wblk);
}

// kW outputs of one column: B, C, D the unscaled sums over s of
// val(k, s) * g(s) (fmaf, s in order); A the sums of val(k, s), + g(k) * 0.
template <int V, int kW, class Val, class G>
__device__ __forceinline__ void sums(Val val, G g, float (&acc)[kW]) {
  if constexpr (V == kA) {
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      float r = 0.0f;
#pragma unroll
      for (int s = 0; s < 8; ++s) r += val(k, s);
      acc[k] = r + g(k) * 0.0f;
    }
  } else {
    float xg[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) xg[s] = g(s);
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      float r = 0.0f;
#pragma unroll
      for (int s = 0; s < 8; ++s) r = fmaf(val(k, s), xg[s], r);
      acc[k] = r;
    }
  }
}

// An output from its sums (B, C, D scale by 0.999).
template <int V>
__device__ __forceinline__ float scaled(float acc) { return V == kA ? acc : acc * 0.999f; }

// A streamed column's 8 sums, from global memory.
template <int V>
__device__ __forceinline__ void streamed(const Args& a, const float* src, int c,
                                         float (&acc)[8]) {
  sums<V, 8>([&](int k, int s) { return __ldg(a.val + (8 * k + s) * a.X + c); },
             [&](int s) {
               const int p = position<V>(a, s, c);
               return p < 0 ? 0.0f : __ldcg(src + p);
             },
             acc);
}

template <int V>
__global__ void __launch_bounds__(kThreads, 1) probe_chain_kernel(
    int n_iters, Args a, int budget, const float* xin, float* slot0,
    float* slot1, float* out, unsigned* count, unsigned start) {
  extern __shared__ float4 smem[];  // float4: 16-byte alignment
  const int X = a.X;
  const int c0 = static_cast<int>(static_cast<long long>(blockIdx.x) * X / gridDim.x);
  const int c1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * X / gridDim.x);
  const Range r = plan<V>(a, c0, c1, budget);
  const int nr = r.nr, ne = r.ne, nwin = r.nwin;
  float* sval = reinterpret_cast<float*>(smem);           // [64][ne]
  float* swin = sval + 64 * ne;                           // [nwin][128]
  int* spos = reinterpret_cast<int*>(swin + nwin * 128);  // [8][ne]
  int* sstart = spos + 8 * ne;                            // [nwin]

  for (int e = threadIdx.x; e < 64 * ne; e += kThreads) {
    sval[e] = __ldg(a.val + (e / ne) * X + (e % ne < nr ? c0 + e % ne : c0 - 1));
  }
  for (int e = threadIdx.x; e < 8 * ne; e += kThreads) {
    spos[e] = local_position<V>(a, e / ne, e % ne < nr ? c0 + e % ne : c0 - 1, r.u0);
  }
  for (int e = threadIdx.x; e < nwin; e += kThreads) sstart[e] = window_start<V>(a, e, r.u0);
  __syncthreads();

  // the thread's first multiply item (column jm, outputs 4 hm ..), held
  const bool held = threadIdx.x < 2 * nr;
  const int hm = held ? threadIdx.x / nr : 0, jm = held ? threadIdx.x % nr : 0;
  float hv[4][8];
  int hp[8];
  if (held) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int s = 0; s < 8; ++s) hv[k][s] = sval[(8 * (4 * hm + k) + s) * ne + jm];
#pragma unroll
    for (int s = 0; s < 8; ++s) hp[s] = spos[(V == kA ? 4 * hm + (s & 3) : s) * ne + jm];
  }
  // window values of an entry j's gathers (A: of outputs 4 hh + k)
  auto staged = [&](int p) { return p < 0 ? 0.0f : swin[p]; };
  auto shared_sums = [&](int j, int hh, float (&acc)[4]) {
    sums<V, 4>([&](int k, int s) { return sval[(8 * (4 * hh + k) + s) * ne + j]; },
               [&](int s) { return staged(spos[(V == kA ? 4 * hh + s : s) * ne + j]); },
               acc);
  };

  for (int i = 0; i < n_iters; ++i) {
    const float* src = i == 0 ? xin : ((i - 1) % 2 == 0 ? slot0 : slot1);
    float* dst = i == n_iters - 1 ? out : (i % 2 == 0 ? slot0 : slot1);

    // the windows
    for (int e0 = threadIdx.x; e0 < nwin * 32; e0 += kThreads * kBatch) {
      float4 g[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kThreads;
        if (e < nwin * 32) {
          g[k] = __ldcg(reinterpret_cast<const float4*>(src + sstart[e >> 5]) + (e & 31));
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kThreads;
        if (e < nwin * 32) reinterpret_cast<float4*>(swin)[e] = g[k];
      }
    }
    __syncthreads();

    // the multiply, resident columns: item e -> (column j, outputs 4 hh ..)
    for (int e = threadIdx.x; e < 2 * nr; e += kThreads) {
      const int hh = e / nr, j = e % nr, c = c0 + j;
      if (V == kD && c % kNS == kNS - 1 && c + 1 < c1) continue;  // c + 1's item
      float acc[4];
      if (e == static_cast<int>(threadIdx.x)) {
        sums<V, 4>([&](int k, int s) { return hv[k][s]; },
                   [&](int s) { return staged(hp[s]); }, acc);
      } else {
        shared_sums(j, hh, acc);
      }
      float res[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) res[k] = scaled<V>(acc[k]);
      if (V == kD && c % kNS == 0 && c > 0) {
        float prev[4];
        shared_sums(j == 0 ? nr : j - 1, hh, prev);  // the halo, or the column before
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (j > 0) dst[(4 * hh + k) * X + c - 1] = scaled<V>(prev[k]);
          res[k] = fmaf(prev[k], 0.999f, res[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[(4 * hh + k) * X + c] = res[k];
    }

    // streamed columns: a thread a column
    for (int c = c0 + nr + threadIdx.x; c < c1; c += kThreads) {
      if (V == kD && c % kNS == kNS - 1 && c + 1 < c1) continue;
      float acc[8];
      if (V == kD && c % kNS == 0 && c > 0) {
        streamed<V>(a, src, c - 1, acc);
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          if (c - 1 >= c0) dst[w * X + c - 1] = scaled<V>(acc[w]);
        }
        float cur[8];
        streamed<V>(a, src, c, cur);
#pragma unroll
        for (int w = 0; w < 8; ++w) acc[w] = fmaf(acc[w], 0.999f, scaled<V>(cur[w]));
      } else {
        streamed<V>(a, src, c, acc);
#pragma unroll
        for (int w = 0; w < 8; ++w) acc[w] = scaled<V>(acc[w]);
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) dst[w * X + c] = acc[w];
    }

    if (i + 1 < n_iters) {
      grid_barrier(count, start + static_cast<unsigned>(i + 1) * gridDim.x);
    }
  }
}

const void* kernel_of(int variant) {
  switch (variant) {
    case kA: return reinterpret_cast<const void*>(probe_chain_kernel<kA>);
    case kB: return reinterpret_cast<const void*>(probe_chain_kernel<kB>);
    case kC: return reinterpret_cast<const void*>(probe_chain_kernel<kC>);
    case kD: return reinterpret_cast<const void*>(probe_chain_kernel<kD>);
    default: return nullptr;
  }
}

cudaError_t allow_smem(const void* k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// The grid of variant `variant` for a shared-memory budget of *budget
// bytes a block (< 0: the largest a block may opt in to, written back):
// *blocks = every block the occupancy API fits on the card at that size.
// Returns the CUDA error (a budget over the device's limit is
// cudaErrorInvalidValue).
int vbcs_probe_chain_grid(int variant, int* budget, int* blocks) {
  const void* k = kernel_of(variant);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && *budget < 0) *budget = optin;
  if (err == cudaSuccess) err = allow_smem(k, *budget);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, *budget);
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
  cudaGetLastError();  // clear
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

// Launches chain variant `variant` (A-D: 0-3) cooperatively on `stream`:
// `blocks` blocks of 640 threads with `budget` bytes of dynamic shared
// memory each run n_iters >= 1 iterations over T chunks.  val [64, X],
// meta [8, X] int32, xin [8, X] (on 16 bytes), wbase [T * 8 * wblk]
// int32 (lanes, multiples of 128), slot0/slot1/out [8, X] f32 with X = T *
// 1024 and 64 X < 2^31.  `count` is 4 bytes of scratch for the grid
// barrier, set to `start` here on `stream` first.  Returns the first
// error (0 = launched; cudaErrorCooperativeLaunchTooLarge when the grid
// cannot be resident, cudaErrorInvalidValue for a budget over the
// device's limit).
int vbcs_probe_chain(int variant, int n_iters, int T, int wblk,
                     const void* val, const void* meta, const void* xin,
                     const void* wbase, void* slot0, void* slot1, void* out,
                     void* count, unsigned start, int blocks, int budget,
                     void* stream) {
  const void* k = kernel_of(variant);
  if (k == nullptr || budget < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* a_count = static_cast<unsigned*>(count);
  cudaError_t err = allow_smem(k, budget);
  if (err == cudaSuccess) {
    set_counter<<<1, 1, 0, st>>>(a_count, start);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  Args a{T * kNS, wblk, static_cast<const float*>(val),
         static_cast<const int*>(meta), static_cast<const int*>(wbase)};
  const float* a_xin = static_cast<const float*>(xin);
  float* a_s0 = static_cast<float*>(slot0);
  float* a_s1 = static_cast<float*>(slot1);
  float* a_out = static_cast<float*>(out);
  void* args[] = {&n_iters, &a, &budget, &a_xin, &a_s0, &a_s1, &a_out, &a_count, &start};
  err = cudaLaunchCooperativeKernel(k, dim3(blocks), dim3(kThreads), args,
                                    static_cast<size_t>(budget), st);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"

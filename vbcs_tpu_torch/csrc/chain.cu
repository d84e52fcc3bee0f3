// Persistent chain TrSpMV on Hopper: y = (alpha * A.T)^n_iters x, f32,
// square A, one launch for the whole chain, the pack held in shared
// memory across iterations.
//
// Replaces the TPU chain kernel vbcs_tpu/ops/pallas_trspmv3.py
// (_chain_kernel, built by _chain_call, reached through tr_spmv_chain3).
// That kernel's point is its grid (n_iters, T): one pallas_call keeps
// state on chip between iterations.  The card can keep more: 132 SMs of
// 227 KB hold ~30 MB of shared memory, and a pack's values and block rows
// (the flagship's are 11.46 MB) fit in it.  So each block of one
// cooperative launch owns a contiguous range of stripes (ops/chain.py:
// chain_plan, balanced by stored values plus a per-column weight), copies
// that range's values and block rows into dynamic shared memory once, and
// then runs every iteration from there; iterations are separated by one
// grid-wide barrier.  A range larger than the block's byte budget is
// resident up to a stripe boundary and its other stripes are read from
// global memory every iteration, so one kernel covers every size (a
// budget of 0 streams the whole pack).
//
// An iteration: the block's threads take its column groups (up to 4
// adjacent columns of one stripe; ChainPlan.gcol), thread t the groups
// t, t + kThreads, ...; the first one's metadata (the offsets of its
// values and block rows, into the shared copy for a resident stripe and
// into the pack otherwise, the width, the block count) stays in registers
// for the whole chain.  A thread walks its group's block rows kRows at a
// time, their loads in flight together; a block row costs one block-row
// load, one x load and one float4 of values for 4 FMAs (a column alone
// would take three loads an FMA).  A resident stripe's values start
// where its first column does modulo 32 words (ChainPlan.pad), so a
// width-8 row's float4 is aligned and the 32 columns a quarter-warp
// reads as float4s fall in 32 banks.  Where the block's whole range and the window of x rows it
// reads fit in shared memory, the block copies that window in with one
// coalesced read at the start of each iteration and gathers x from
// there; else it gathers x from L2.
//
// Iteration i reads x (i == 0) or buf[(i - 1) % 2] and writes buf[i % 2],
// or y_out at the last iteration; alpha is fused into every store.  One
// barrier per iteration is enough: the buffer iteration i + 1 overwrites
// was last read in iteration i - 1, before the barrier that ended it.
//
// An auto-RCM operator runs its chain on the relabeled pack, in permuted
// space, where its x windows are short (the RCM's locality); the two
// gathers around it (x into permuted space, y out of it: the JAX
// operator's windowed_gather._permute_kernel on each side) are folded into
// this launch as a pass before the first iteration and one after the last,
// each a grid-strided loop behind one more grid barrier: with x_map the
// grid writes buf1[r] = x[x_map[r]] and iteration 0 reads buf1 (iteration
// 1 is the first to write it, after a barrier); with y_map the last
// iteration writes buf[(n_iters - 1) % 2] and the grid then stores its
// column j at y_out[y_map[j]].  Both maps are the relabeling perm (y[perm[j]]
// = out[j]), so a chain split over launches passes x_map to its first and
// y_map to its last; null means natural order.  The passes stay out of the
// iterations: a design that read x and stored y through the map inside the
// first and last iterations slowed every iteration on an H100 (PERF.md),
// the kernel being held to 64 registers a thread at 1,024 threads.
// The barrier is grid_barrier (barrier.cuh), not cooperative_groups'
// grid.sync(): the same arrive-and-wait on one counter, with a release add
// and acquire loads instead of two full fences, which ran the flagship's
// chain faster on an H100 when the two were timed in one run; its target
// is compared wrap-safe, so a launch may run up to INT32_MAX iterations
// (ops/chain.py splits longer chains).  The launch stays cooperative, so
// every block is resident.
//
// Coherence: the ping-pong buffers are written inside this launch, so
// they are read with ld.global.cg (__ldcg, L2 only) and never through the
// read-only path (__ldg) or an L1 line that could be stale after the
// barrier; the pack is never written, so it is read through L1.
//
// What bounds it on this card, once the pack is resident: the grid
// barrier, not bytes.  On an H100 (PERF.md) an iteration of a diagonal
// pack at the full grid (the barrier floor) takes ~1.8 us: the last
// store, the release, the arrival at one L2 counter, the acquire that
// sees it and the window's read are each an L2 round trip.  The
// flagship's iteration adds ~1.5 us of shared-memory loads and FMAs.
//
// The grid is the occupancy API's count at the chosen shared-memory size;
// a caller-given grid that does not fit is refused by the cooperative
// launch, and a budget over the device's limit by cudaFuncSetAttribute:
// the error is returned, not worked around.

#include <cuda_runtime.h>

#include "barrier.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kCols = 4;   // columns of a group (ops/chain.py: GROUP)
constexpr int kRows = 4;   // block rows a thread has in flight at once

// The plan's per-block fields (ops/chain.py: ChainPlan), in the order the
// plan buffer holds them after lo [G + 1]: res, win_lo, win [G each],
// glo [G + 1], pad [L + 1], gcol.
struct Plan {
  const int *lo, *res, *win_lo, *win, *glo, *pad, *gcol;
  __device__ Plan(const int* buf, int G, int L)
      : lo(buf),
        res(lo + G + 1),
        win_lo(res + G),
        win(win_lo + G),
        glo(win + G),
        pad(glo + G + 1),
        gcol(pad + L + 1) {}
};

// The block's resident stripes [s_lo, s_res): their block rows start at
// pos_lo in the pack and at 0 in the shared copy; stripe s's values at
// spl[s] - c_lo + pad[s] - pad_lo there.
struct Range {
  int s_res, pos_lo, c_lo, pad_lo;
  const int* pad;
  bool val_aligned;  // the pack's values start on 16 bytes
};

// A column group: up to kCols adjacent columns of one stripe.
struct Group {
  int v;        // the group's first value in block row 0
  int rows;     // the stripe's first block row
  int w;        // stripe width: the step between block rows' values
  int nb;       // block rows
  int j;        // the group's first column
  int nc;       // its columns, 1..kCols
  bool shared;  // v and rows index the block's shared copy (else the pack)
  bool vec;     // a row's kCols values are one aligned float4
};

__device__ __forceinline__ Group locate(
    int g, const Range& r, const int* __restrict__ gcol,
    const int* __restrict__ spl, const int* __restrict__ pos,
    const int* __restrict__ ofs, const int* __restrict__ col_stripe) {
  Group q;
  q.j = __ldg(gcol + g);
  const int s = __ldg(col_stripe + q.j);
  const int j0 = __ldg(spl + s);
  const int b0 = __ldg(pos + s);
  q.w = __ldg(spl + s + 1) - j0;
  q.nc = min(kCols, j0 + q.w - q.j);
  q.nb = __ldg(pos + s + 1) - b0;
  q.shared = s < r.s_res;
  q.v = q.shared ? (q.j - r.c_lo) + (r.pad[s] - r.pad_lo)
                 : __ldg(ofs + s) + (q.j - j0);
  q.rows = b0 - (q.shared ? r.pos_lo : 0);
  q.vec = q.nc == kCols && q.w % kCols == 0 && q.v % kCols == 0 &&
          (q.shared || r.val_aligned);
  return q;
}

// x[row] for this iteration: from the block's staged window when it has
// one, else from L2 (ld.global.cg: src was written inside this launch).
struct Source {
  const float* src;
  const float* win;  // shared: x[win_lo:win_lo + len], or null
  int win_lo;
  __device__ __forceinline__ float operator()(int row) const {
    return win != nullptr ? win[row - win_lo] : __ldcg(src + row);
  }
};

// acc += group q's block rows times their x, kRows rows at a time so that
// their loads are in flight together: a block row costs one block-row
// load, one x load and one float4 of values (or nc scalars) for nc FMAs.
__device__ __forceinline__ void accumulate(const Group& q, const float* v,
                                           const int* rows, const Source& x,
                                           float (&acc)[kCols]) {
  v += q.v;
  rows += q.rows;
  int b = 0;
  for (; b + kRows <= q.nb; b += kRows) {
    float xv[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) xv[u] = x(rows[b + u]);
    if (q.vec) {
      float4 a[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        a[u] = *reinterpret_cast<const float4*>(v + (b + u) * q.w);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        acc[0] = fmaf(a[u].x, xv[u], acc[0]);
        acc[1] = fmaf(a[u].y, xv[u], acc[1]);
        acc[2] = fmaf(a[u].z, xv[u], acc[2]);
        acc[3] = fmaf(a[u].w, xv[u], acc[3]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (c < q.nc) acc[c] = fmaf(v[(b + u) * q.w + c], xv[u], acc[c]);
        }
      }
    }
  }
  for (; b < q.nb; ++b) {
    const float xv = x(rows[b]);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < q.nc) acc[c] = fmaf(v[b * q.w + c], xv, acc[c]);
    }
  }
}

__device__ __forceinline__ void store(const Group& q, float alpha,
                                      const float (&acc)[kCols], float* dst) {
  float* d = dst + q.j;
  if (q.nc == kCols && (reinterpret_cast<size_t>(d) & 15) == 0) {
    *reinterpret_cast<float4*>(d) = make_float4(
        alpha * acc[0], alpha * acc[1], alpha * acc[2], alpha * acc[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < q.nc) d[c] = alpha * acc[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) tr_spmv_chain_kernel(
    int n_iters, int L, const int* __restrict__ plan_buf,
    const int* __restrict__ spl, const int* __restrict__ pos,
    const int* __restrict__ idx, const int* __restrict__ ofs,
    const int* __restrict__ col_stripe, const float* __restrict__ val,
    const float* x, float alpha, float* buf0, float* buf1, float* y_out,
    const int* __restrict__ x_map, const int* __restrict__ y_map,
    unsigned* count, unsigned start, int smem_bytes) {
  extern __shared__ float4 smem[];  // float4: 16-byte alignment
  const Plan p(plan_buf, gridDim.x, L);
  const int k = blockIdx.x;
  const int s_lo = p.lo[k];
  Range r;
  r.s_res = p.res[k];
  r.pad = p.pad;
  r.pad_lo = p.pad[s_lo];
  r.pos_lo = __ldg(pos + s_lo);
  r.c_lo = __ldg(spl + s_lo);
  r.val_aligned = (reinterpret_cast<size_t>(val) & 15) == 0;
  const int win_lo = p.win_lo[k];
  const int win_len = p.win[k];
  const int g_lo = p.glo[k];
  const int g_hi = p.glo[k + 1];
  // shared: the resident stripes' values (each starting at its first
  // column modulo the plan's alignment), their block rows, the x window
  const int nv = __ldg(spl + r.s_res) - r.c_lo + (p.pad[r.s_res] - r.pad_lo);
  const int nb = __ldg(pos + r.s_res) - r.pos_lo;
  if (4LL * (nv + nb + win_len) > smem_bytes) __trap();  // another budget's plan
  float* sval = reinterpret_cast<float*>(smem);
  int* sidx = reinterpret_cast<int*>(sval + nv);
  float* swin = reinterpret_cast<float*>(sidx + nb);
  for (int s = s_lo + threadIdx.x / 32; s < r.s_res; s += kThreads / 32) {
    const int o = __ldg(ofs + s);
    const int size = __ldg(ofs + s + 1) - o;
    float* to = sval + (__ldg(spl + s) - r.c_lo) + (p.pad[s] - r.pad_lo);
    for (int i = threadIdx.x % 32; i < size; i += 32) to[i] = __ldg(val + o + i);
  }
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    sidx[i] = __ldg(idx + r.pos_lo + i);
  }
  __syncthreads();

  // the auto-RCM gather of x into permuted space, before iteration 0
  const int n = __ldg(spl + L);
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  if (x_map != nullptr) {
    for (int j = tid; j < n; j += stride) buf1[j] = __ldg(x + __ldg(x_map + j));
    grid_barrier(count, start + gridDim.x);
    x = buf1;
  }
  const unsigned round0 = start + (x_map != nullptr ? gridDim.x : 0u);

  // the thread's first group's metadata stays in registers
  const int g0 = g_lo + threadIdx.x;
  const Group mine = g0 < g_hi ? locate(g0, r, p.gcol, spl, pos, ofs, col_stripe)
                               : Group{};
  for (int i = 0; i < n_iters; ++i) {
    const float* src = i == 0 ? x : ((i - 1) % 2 == 0 ? buf0 : buf1);
    float* dst = i == n_iters - 1 && y_map == nullptr ? y_out
                                                      : (i % 2 == 0 ? buf0 : buf1);
    const Source xs{src, win_len > 0 ? swin : nullptr, win_lo};
    if (win_len > 0) {
      // one coalesced read of the rows this block's stripes gather
      for (int t = threadIdx.x; t < win_len; t += kThreads) {
        swin[t] = __ldcg(src + win_lo + t);
      }
      __syncthreads();
    }
    const auto run = [&](const Group& q) {
      float acc[kCols] = {};
      accumulate(q, q.shared ? sval : val, q.shared ? sidx : idx, xs, acc);
      store(q, alpha, acc, dst);
    };
    if (g0 < g_hi) run(mine);
    for (int g = g0 + kThreads; g < g_hi; g += kThreads) {
      run(locate(g, r, p.gcol, spl, pos, ofs, col_stripe));
    }
    if (i + 1 < n_iters) {
      grid_barrier(count, round0 + static_cast<unsigned>(i + 1) * gridDim.x);
    }
  }

  // the auto-RCM gather of y out of permuted space, after the last iteration
  if (y_map != nullptr) {
    const float* last = (n_iters - 1) % 2 == 0 ? buf0 : buf1;
    grid_barrier(count, round0 + static_cast<unsigned>(n_iters) * gridDim.x);
    for (int j = tid; j < n; j += stride) y_out[__ldg(y_map + j)] = __ldcg(last + j);
  }
}

cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(
      reinterpret_cast<const void*>(tr_spmv_chain_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// The grid for a shared-memory budget of *budget bytes a block (< 0: the
// largest a block may opt in to, written back): *blocks = every block the
// occupancy API fits on the card at that size.  Returns the CUDA error
// (a budget over the device's limit is cudaErrorInvalidValue).
int vbcs_chain_grid(int* budget, int* blocks) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && *budget < 0) *budget = optin;
  if (err == cudaSuccess) err = allow_smem(*budget);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tr_spmv_chain_kernel, kThreads, *budget);
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
  cudaGetLastError();  // clear
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

// Launches the chain cooperatively on `stream`: `blocks` blocks of 1024
// threads with `budget` bytes of dynamic shared memory each, under `plan`
// (ChainPlan.buf of ops/chain.py: chain_plan for the same blocks and
// budget, on a pack of L stripes).  `count` is 4 bytes of scratch for the
// grid barrier, set to `start` here on `stream` before the launch (the
// wrapper passes 0; a test starts it near 2^32 to cross the wrap).
// Returns the first error (0 = launched; cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be resident).  buf0/buf1 hold n floats each and may
// be null when n_iters == 1 and there is no map; n_iters >= 1.  x_map
// (iteration 0 reads x[x_map[row]], gathered into buf1 first) and y_map
// (column j of the result lands at y_out[y_map[j]]): int32 permutations of
// [0, n), or null for natural order; each adds a pass and a grid barrier.
int vbcs_tr_spmv_chain(int n_iters, int L, const void* plan, const void* spl,
                       const void* pos, const void* idx, const void* ofs,
                       const void* col_stripe, const void* val, const void* x,
                       float alpha, void* buf0, void* buf1, void* y_out,
                       const void* x_map, const void* y_map,
                       void* count, unsigned start, int blocks, int budget,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* a_count = static_cast<unsigned*>(count);
  cudaError_t err = allow_smem(budget);
  if (err == cudaSuccess) {
    set_counter<<<1, 1, 0, st>>>(a_count, start);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const int* a_plan = static_cast<const int*>(plan);
  const int* a_spl = static_cast<const int*>(spl);
  const int* a_pos = static_cast<const int*>(pos);
  const int* a_idx = static_cast<const int*>(idx);
  const int* a_ofs = static_cast<const int*>(ofs);
  const int* a_cs = static_cast<const int*>(col_stripe);
  const float* a_val = static_cast<const float*>(val);
  const float* a_x = static_cast<const float*>(x);
  float* a_b0 = static_cast<float*>(buf0);
  float* a_b1 = static_cast<float*>(buf1);
  float* a_y = static_cast<float*>(y_out);
  const int* a_xm = static_cast<const int*>(x_map);
  const int* a_ym = static_cast<const int*>(y_map);
  void* args[] = {&n_iters, &L,     &a_plan, &a_spl,   &a_pos,
                  &a_idx,    &a_ofs, &a_cs,   &a_val,   &a_x,
                  &alpha,    &a_b0,  &a_b1,   &a_y,     &a_xm,
                  &a_ym,     &a_count, &start, &budget};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(tr_spmv_chain_kernel), dim3(blocks),
      dim3(kThreads), args, static_cast<size_t>(budget), st);
  const cudaError_t last = cudaGetLastError();  // also clears err
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"

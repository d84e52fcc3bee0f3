// The chain probe on Hopper: one persistent launch of the fused chained
// SpMV shape, split into its floor (A), its full body (B, C) and its carry
// (D), f32.
//
// Replaces the Pallas kernel of bench_tools/probe_chain.py
// (run_variant.make_call.kernel).  There one pallas_call runs a grid
// (n_iters, T) in order: its x/y slots ping-pong in VMEM, each chunk's
// value and metadata blocks are streamed again every iteration, and chunk
// t of variant D adds a carry that chunk t - 1 left in scratch.  Here one
// cooperative launch (every block the occupancy API fits, at most one a
// 256 columns) runs all n_iters iterations: a thread per column computes
// the column's 8 outputs (vbcs_tpu_torch/probes/probe_chain.py states the
// index maps), the slots live in device memory, and the wrap-safe grid
// barrier of barrier.cuh ends every iteration but the last.  Iteration 0
// reads xin itself (the TPU copies it into slot 0 at its first step);
// iteration i >= 1 reads slot (i - 1) % 2 and writes slot i % 2, or `out`
// at the last.  Blocks run in no order, so D's carry does not come from
// another block: the carry is chunk t - 1's last lane of the same
// iteration, which does not depend on any carry (a chunk has more than one
// lane), so the thread of lane 0 computes it itself from the same slot.
//
// Coherence: the slots are written inside the launch, so they (and xin,
// for one code path) are read with ld.global.cg (L2 only), never through
// L1, which may be stale after a barrier; the pack is read through L1.
//
// What bounds it: the barrier and the pack's trip through L2.  The pack
// (val 10.49 MB and meta 1.31 MB at T = 40) must be read every iteration
// (no block holds its columns' share in shared memory, as the port's chain
// kernel does), from L2 where it stays resident: ~2 us an iteration at
// L2 rates; the grid barrier adds ~1.8 us (the chain kernel's barrier
// floor).  Its operations are 2 x 2,621,440 FMAs an iteration: 0.08 us.

#include <cuda_runtime.h>

#include "barrier.cuh"

namespace {

constexpr int kNS = 1024;  // columns of a chunk (NG == NS)
constexpr int kNV = kNS / 128;
constexpr int kThreads = 256;

enum Variant { kA = 0, kB, kC, kD };

struct Args {
  int X;     // columns: T * kNS
  int wblk;  // windows a 128-lane slice
  const float* val;  // [64, X]
  const int* meta;   // [8, X]
  const int* wbase;  // [T * kNV * wblk] window lanes
};

// B's 8 outputs of column c from slot `src` [8, X] (C is B at wblk = 1).
__device__ __forceinline__ void full(const Args& a, const float* src, int c,
                                     float (&res)[8]) {
  const int t = c / kNS, v = (c % kNS) / 128;
  float xg[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const unsigned m = static_cast<unsigned>(__ldg(a.meta + s * a.X + c));
    const unsigned lo = m & 127;
    const unsigned d = a.wblk == 1 ? 0u : (m >> 7) & 3;
    if (d >= static_cast<unsigned>(a.wblk)) {
      xg[s] = 0.0f;
      continue;
    }
    const int b = __ldg(a.wbase + (t * kNV + v) * a.wblk + d);
    const unsigned at = static_cast<unsigned>(
        __ldg(a.meta + s * a.X + t * kNS + v * 128 + lo));
    const unsigned row = (at >> (16 + 3 * d)) & 7;
    xg[s] = __ldcg(src + row * a.X + b + lo);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < 8; ++s) acc = fmaf(__ldg(a.val + (8 * w + s) * a.X + c), xg[s], acc);
    res[w] = acc * 0.999f;
  }
}

// A's 8 outputs: the value rows' sums plus a window read times 0; the
// metadata is streamed as the TPU streams it and consumed by an empty asm.
__device__ __forceinline__ void floor_(const Args& a, const float* src, int c,
                                       float (&res)[8]) {
  const int t = c / kNS;
  const int b = __ldg(a.wbase + t * kNV * 2);  // as the TPU body indexes it
  unsigned mj = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) mj ^= static_cast<unsigned>(__ldg(a.meta + s * a.X + c));
  asm volatile("" ::"r"(mj));
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < 8; ++s) acc += __ldg(a.val + (8 * w + s) * a.X + c);
    res[w] = acc + __ldcg(src + w * a.X + b + c % 128) * 0.0f;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) probe_chain_kernel(
    int n_iters, Args a, const float* xin, float* slot0, float* slot1,
    float* out, unsigned* count, unsigned start) {
  for (int i = 0; i < n_iters; ++i) {
    const float* src = i == 0 ? xin : ((i - 1) % 2 == 0 ? slot0 : slot1);
    float* dst = i == n_iters - 1 ? out : (i % 2 == 0 ? slot0 : slot1);
    for (int c = blockIdx.x * kThreads + threadIdx.x; c < a.X;
         c += gridDim.x * kThreads) {
      float res[8];
      if constexpr (V == kA) {
        floor_(a, src, c, res);
      } else {
        full(a, src, c, res);
        if (V == kD && c % kNS == 0 && c > 0) {
          float carry[8];
          full(a, src, c - 1, carry);
#pragma unroll
          for (int w = 0; w < 8; ++w) res[w] += carry[w];
        }
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) dst[w * a.X + c] = res[w];
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

}  // namespace

extern "C" {

// *blocks = every block of variant `variant` the occupancy API fits on
// the card at 256 threads.  Returns the CUDA error.
int vbcs_probe_chain_grid(int variant, int* blocks) {
  const void* k = kernel_of(variant);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0);
  cudaGetLastError();  // clear
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

// Launches chain variant `variant` (A-D: 0-3) cooperatively on `stream`:
// `blocks` blocks of 256 threads run n_iters >= 1 iterations over T
// chunks.  val [64, X], meta [8, X] int32, xin [8, X], wbase [T * 8 *
// wblk] int32 (lanes, multiples of 128), slot0/slot1/out [8, X] f32 with X
// = T * 1024.  `count` is 4 bytes of scratch for the grid barrier, set to
// `start` here on `stream` first.  Returns the first error (0 = launched).
int vbcs_probe_chain(int variant, int n_iters, int T, int wblk,
                     const void* val, const void* meta, const void* xin,
                     const void* wbase, void* slot0, void* slot1, void* out,
                     void* count, unsigned start, int blocks, void* stream) {
  const void* k = kernel_of(variant);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* a_count = static_cast<unsigned*>(count);
  set_counter<<<1, 1, 0, st>>>(a_count, start);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{T * kNS, wblk, static_cast<const float*>(val),
         static_cast<const int*>(meta), static_cast<const int*>(wbase)};
  const float* a_xin = static_cast<const float*>(xin);
  float* a_s0 = static_cast<float*>(slot0);
  float* a_s1 = static_cast<float*>(slot1);
  float* a_out = static_cast<float*>(out);
  void* args[] = {&n_iters, &a, &a_xin, &a_s0, &a_s1, &a_out, &a_count, &start};
  err = cudaLaunchCooperativeKernel(k, dim3(blocks), dim3(kThreads), args, 0, st);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"

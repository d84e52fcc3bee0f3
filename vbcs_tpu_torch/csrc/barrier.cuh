// The grid barrier of the port's persistent cooperative kernels
// (chain.cu, probe_chain.cu), and the kernel that sets its counter.
//
// All blocks of a cooperative (hence co-resident) grid meet: each block's
// thread 0 adds one to *count with release semantics (the block's stores,
// ordered before it by __syncthreads, become visible first) and waits
// with acquire loads until the count reaches `target`.  A launch sets
// *count to some `start` (set_counter, on the launch's stream) and its
// round k waits for start + k * gridDim.x.  The comparison is wrap-safe:
// `seen` is never more than gridDim.x past the target nor 2^31 behind it,
// so (int)(seen - target) < 0 means "not yet" on either side of 2^32.  A
// plain `seen < target` would stop waiting once the target wraps past
// 2^32 (after ~32.5M rounds at 132 blocks) and let a block race ahead.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count)
                 : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
    } while (static_cast<int>(seen - target) < 0);
  }
  __syncthreads();
}

__global__ void set_counter(unsigned* count, unsigned start) { *count = start; }

}  // namespace

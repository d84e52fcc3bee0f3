// The launch probe on Hopper: the smallest kernel, o = x + 1 on f32
// [8, 128], for the fixed cost of one launch.
//
// Replaces the Pallas kernel of bench_tools/probe_launch.py (main.kern):
// the TPU probe calls it inside a jit'ed fori_loop, one or two calls a
// step, to learn what one pallas_call costs beyond its work.  On the card
// the question is what one launch costs through each path a caller has:
// an eager launch from Python through the port's ctypes wrapper, and the
// same launches replayed from a CUDA graph (the counterpart of the loop
// inside one jit); vbcs_tpu_torch/probes/probe_launch.py times both.
//
// What bounds it: the launch.  Its 8 KB move in ~2.4 ns at 3.35 TB/s; one
// block of 256 threads a 256 elements does the work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) add_one_kernel(
    int n, const float* __restrict__ x, float* __restrict__ o) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) o[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

// o[:n] = x[:n] + 1 (f32) on `stream`.  Returns cudaGetLastError().
int vbcs_probe_add_one(int n, const void* x, void* o, void* stream) {
  if (n <= 0) return 0;
  add_one_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float*>(x), static_cast<float*>(o));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Tile relayout on Hopper: natural x [m] -> the (8, R*128) tile-interleaved
// buffer, f32, zero past m:
//
//   out[s, r*128 + l] = x[r*1024 + s*128 + l]   (0 where that is >= m)
//
// for s < 8, r < R, l < 128.
//
// Replaces the TPU kernel vbcs_tpu/ops/pallas_trspmv3.py
// (_tile_relayout_call), which turns the padded natural x, viewed as
// (Rb*64, 128), into the (8, Rb*1024) buffer with R = 8*Rb; it is the
// layout entry3 builds for entry_mode "tile".  Nothing in either package
// calls it on a path: the port's kernels read natural x directly.
//
// What bounds it on this card: device-memory bytes, a pure copy of
// 4*m bytes in and 4*R*1024 out.  One thread per output element: the
// stores are fully coalesced, and each warp's 32 loads are one
// contiguous 128-byte run of x (l is the fastest index on both sides).

#include <cuda_runtime.h>

namespace {

__global__ void tile_relayout_kernel(int m, int R, const float* __restrict__ x,
                                     float* __restrict__ out) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long row = static_cast<long long>(R) * 128;
  if (o >= 8 * row) return;
  const long long s = o / row;
  const long long rest = o - s * row;
  const long long src = (rest >> 7) * 1024 + s * 128 + (rest & 127);
  out[o] = src < m ? __ldg(x + src) : 0.0f;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// 0 <= m <= R * 1024, R > 0.
int vbcs_tile_relayout(int m, int R, const void* x, void* out, void* stream) {
  const int threads = 256;
  const long long blocks =
      (static_cast<long long>(R) * 1024 + threads - 1) / threads;
  tile_relayout_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      m, R, static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
// 4*m bytes in and 4*R*1024 out, of which a call at the flagship's size
// (1.3 MB) is mostly the launch.  Each thread moves one 16-byte vector:
// both sides are contiguous in l and 128 is a multiple of 4, so four
// consecutive outputs are four consecutive inputs, and a warp's loads and
// stores are each one contiguous 512-byte run.  The vector that holds x's
// end (m % 4 != 0), the zero padding past it, and an x whose address is
// not 16-byte aligned take the scalar path, element by element.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void tile_relayout_kernel(int m, int R, const float* __restrict__ x,
                                     float* __restrict__ out) {
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long row = static_cast<long long>(R) * 128;
  const long long o = 4 * v;  // first of this thread's 4 outputs
  if (o >= 8 * row) return;
  const long long s = o / row;
  const long long rest = o - s * row;
  const long long src = (rest >> 7) * 1024 + s * 128 + (rest & 127);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  float4 q;
  if (aligned && src + 4 <= m) {
    q = __ldg(reinterpret_cast<const float4*>(x + src));
  } else {  // x's last partial vector, the zero padding, or a misaligned x
    q.x = src < m ? __ldg(x + src) : 0.0f;
    q.y = src + 1 < m ? __ldg(x + src + 1) : 0.0f;
    q.z = src + 2 < m ? __ldg(x + src + 2) : 0.0f;
    q.w = src + 3 < m ? __ldg(x + src + 3) : 0.0f;
  }
  *reinterpret_cast<float4*>(out + o) = q;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// 0 <= m <= R * 1024, R > 0; `out` is 16-byte aligned (a fresh allocation).
int vbcs_tile_relayout(int m, int R, const void* x, void* out, void* stream) {
  const int threads = 256;
  const long long vectors = static_cast<long long>(R) * 256;  // R*1024 / 4
  const long long blocks = (vectors + threads - 1) / threads;
  tile_relayout_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      m, R, static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

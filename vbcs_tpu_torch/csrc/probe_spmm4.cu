// The SpMM load-path probe on Hopper: the streaming FMA of the v4 SpMM
// design, f32.
//
// Replaces the Pallas kernel of bench_tools/probe_spmm4.py (main.kern,
// grid (T,)): per chunk t of Rc = 2048 rows, ordered (j, stripe-local p)
// with 8 blocks j of SL = 256 stripes,
//   out[t*2048 + 8p + w, :] = sum_{j<8} Vl[t*2048 + 256j + p, w]
//                                      * Xg[t*2048 + 256j + p, :],
// with k = 128 columns.  The TPU sums 8 big contiguous (SL, 128) slices
// and stores with a stride of 8 rows.  Here a warp takes one (t, p): each
// lane holds 4 of the 128 columns as a float4 and 8 accumulators of them,
// reads the 8 rows of Xg it needs (512 B coalesced each) and their 8 x 8
// values of Vl (the same 32 B for every lane: one broadcast), and writes 8
// whole output rows.  Every byte of Xg and out moves once.
//
// What bounds it: bytes.  Xg 164.62 MB read, out 164.62 MB written and Vl
// 10.29 MB read at T = 157 (7x the 50 MB L2) is 101.35 us at 3.35 TB/s;
// its 82M FMAs are 2.5 us at 67 TFLOP/s.

#include <cuda_runtime.h>

namespace {

constexpr int kSL = 256;  // stripes a chunk
constexpr int kNB = 8;    // blocks a stripe
constexpr int kRc = kSL * kNB;
constexpr int kK = 128;   // columns of Xg and out
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) spmm4_fma_kernel(
    int T, const float4* __restrict__ xg, const float4* __restrict__ vl,
    float4* __restrict__ out) {
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= static_cast<long long>(T) * kSL) return;
  const long long t = warp / kSL, p = warp % kSL;
  float4 acc[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) acc[w] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const long long r = t * kRc + j * kSL + p;
    const float4 x = __ldg(xg + r * (kK / 4) + lane);
    const float4 v0 = __ldg(vl + r * 2), v1 = __ldg(vl + r * 2 + 1);
    const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      acc[w].x = fmaf(v[w], x.x, acc[w].x);
      acc[w].y = fmaf(v[w], x.y, acc[w].y);
      acc[w].z = fmaf(v[w], x.z, acc[w].z);
      acc[w].w = fmaf(v[w], x.w, acc[w].w);
    }
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[(t * kRc + 8 * p + w) * (kK / 4) + lane] = acc[w];
}

}  // namespace

extern "C" {

// out [T * 2048, 128] = the FMA of Xg [T * 2048, 128] and Vl [T * 2048, 8]
// (f32, 16-byte aligned) on `stream`.  Returns cudaGetLastError().
int vbcs_probe_spmm4_fma(int T, const void* xg, const void* vl, void* out,
                         void* stream) {
  if (T <= 0) return 0;
  const long long threads = static_cast<long long>(T) * kSL * 32;
  spmm4_fma_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      T, static_cast<const float4*>(xg), static_cast<const float4*>(vl),
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

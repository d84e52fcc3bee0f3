// Persistent chain TrSpMV on Hopper: y = (alpha * A.T)^n_iters x, f32,
// square A, one launch for the whole chain.
//
// Replaces the TPU chain kernel vbcs_tpu/ops/pallas_trspmv3.py
// (_chain_kernel, built by _chain_call, reached through tr_spmv_chain3).
// That kernel's point is its grid (n_iters, T): one pallas_call keeps the
// x and y slot vectors in VMEM between iterations, so each iteration
// re-reads only the value and metadata streams.  The Hopper counterpart is
// one cooperative kernel whose blocks are all resident: each iteration is
// the stripe kernel's arithmetic (csrc/trspmv.cu) over a grid-stride loop
// of output columns, iterations are separated by a grid-wide barrier, and
// x and y ping-pong between two device buffers that stay in L2.
//
// Iteration i reads x (i == 0) or buf[(i - 1) % 2] and writes buf[i % 2],
// or y_out at the last iteration; alpha is fused into every store.  One
// barrier per iteration is enough: the buffer iteration i + 1 overwrites
// was last read in iteration i - 1, before the barrier that ended it.
//
// Coherence: the ping-pong buffers are written inside this launch, so
// they are read with ld.global.cg (__ldcg, L2 only) and never through the
// read-only path (__ldg) or an L1 line that could be stale after the
// barrier; only the pack and nothing written here goes through __ldg.
//
// What bounds it on this card: bytes per iteration.  The flagship pack
// (values, idx, col_stripe, stripe metadata) plus x and y is ~15.8 MB,
// under a third of the 50 MB L2, so after the first iteration the chain
// runs from L2, as the TPU chain ran from VMEM; the floor is that stream
// over L2 bandwidth, plus one grid barrier per iteration.  Each thread
// keeps its first column's stripe metadata (width, block range, value
// pointer) in registers across iterations, so that column skips the
// col_stripe -> spl/pos/ofs loads after the first; later columns of a
// grid-stride loop reload theirs.  Blocks of 512 threads, at least 2 per
// SM: of the shapes tried on an H100 (128-1024 threads, 1-8 blocks per
// SM, 0-3 cached columns), the fastest on the flagship and the FEM.
//
// The grid is sized by the occupancy API so that every block is
// resident; a caller-given size that does not fit is refused by the
// cooperative launch, and the error is returned, not worked around.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float column(const int* __restrict__ idx,
                                        const float* v, int w, int b0, int b1,
                                        const float* src) {
  float acc = 0.0f;
  for (int b = b0; b < b1; ++b, v += w) {
    acc = fmaf(__ldg(v), __ldcg(src + __ldg(idx + b)), acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads, 2) tr_spmv_chain_kernel(
    int n, int n_iters, const int* __restrict__ spl,
    const int* __restrict__ pos, const int* __restrict__ idx,
    const int* __restrict__ ofs, const int* __restrict__ col_stripe,
    const float* __restrict__ val, const float* x, float alpha, float* buf0,
    float* buf1, float* y_out) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int w0 = 0, b0 = 0, b1 = 0;  // the first column's metadata, kept
  const float* v0 = val;
  if (first < n) {
    const int s = __ldg(col_stripe + first);
    const int j0 = __ldg(spl + s);
    w0 = __ldg(spl + s + 1) - j0;
    b0 = __ldg(pos + s);
    b1 = __ldg(pos + s + 1);
    v0 = val + __ldg(ofs + s) + (first - j0);
  }
  for (int i = 0; i < n_iters; ++i) {
    const float* src = i == 0 ? x : ((i - 1) % 2 == 0 ? buf0 : buf1);
    float* dst = i == n_iters - 1 ? y_out : (i % 2 == 0 ? buf0 : buf1);
    if (first < n) dst[first] = alpha * column(idx, v0, w0, b0, b1, src);
    for (int j = first + stride; j < n; j += stride) {
      const int s = __ldg(col_stripe + j);
      const int j0 = __ldg(spl + s);
      dst[j] = alpha * column(idx, val + __ldg(ofs + s) + (j - j0),
                              __ldg(spl + s + 1) - j0, __ldg(pos + s),
                              __ldg(pos + s + 1), src);
    }
    if (i + 1 < n_iters) grid.sync();
  }
}

// The grid a default launch uses for n columns: every SM's resident
// blocks (occupancy API), at most one thread per column.  Returns 0 on a
// CUDA error (then see cudaGetLastError()).
int default_blocks(int n) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tr_spmv_chain_kernel, kThreads, 0) != cudaSuccess)
    return 0;
  const long long need = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  const long long fit = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(need < fit ? (need > 0 ? need : 1) : fit);
}

}  // namespace

extern "C" {

// Launches the chain cooperatively on `stream` with `blocks` blocks of
// 512 threads (blocks <= 0: every block that fits, at most one thread
// per column; a positive count is for tests of small grids); returns the
// launch's error (0 = launched; cudaErrorCooperativeLaunchTooLarge when
// the grid cannot be resident).  buf0/buf1 hold n floats each and may be
// null when n_iters == 1.  n > 0, n_iters >= 1.
int vbcs_tr_spmv_chain(int n, int n_iters, const void* spl, const void* pos,
                       const void* idx, const void* ofs,
                       const void* col_stripe, const void* val, const void* x,
                       float alpha, void* buf0, void* buf1, void* y_out,
                       int blocks, void* stream) {
  if (blocks <= 0) {
    blocks = default_blocks(n);
    if (blocks == 0) return static_cast<int>(cudaGetLastError());
  }
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
  void* args[] = {&n,     &n_iters, &a_spl, &a_pos, &a_idx, &a_ofs, &a_cs,
                  &a_val, &a_x,     &alpha, &a_b0,  &a_b1,  &a_y};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(tr_spmv_chain_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // also clears err
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"

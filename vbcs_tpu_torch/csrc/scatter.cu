// Column-parallel TrSpMV on Hopper: y = alpha * A.T @ x (+ beta * y_in), f32,
// for the unstructured packs the scatter route takes.
//
// Replaces the TPU scatter kernel vbcs_tpu/ops/pallas_scatter.py
// (_scatter_kernel, reached through tr_spmv_scatter) together with the
// gathers around it: the radix-routed entry gather z = x[row]
// (multipass.apply_multipass), the exit permute of the column totals and
// the COO spill past 64 entries per column.  Those exist because Mosaic
// cannot gather: a column's entries sat in the 8 sublanes of up to 8
// lanes of an (8, Np) buffer, summed over sublanes and then by a
// segmented lane scan.  What it computes is a CSC SpMV:
//
//   y[j] = alpha * sum_{e in [colptr[j], colptr[j+1])} val[e] * x[row[e]]
//          (+ beta * y_in[j])
//
// Design: a group of G lanes (G = 4, 8, 16 or 32, a template parameter the
// wrapper picks from the mean entries per column) owns one column.  The
// lanes stride the column's entries, so row and val are read as one
// coalesced run per column, and the group reduces with __shfl_down_sync
// of width G; lane 0 stores.  A long column is a longer loop, so there is
// no entry cap and no spill.  No atomics: columns are disjoint.
//
// What bounds it on this card: device-memory bytes.  Each entry is used
// once (8 bytes of row and val for 2 flops), plus colptr, x read at most
// once per entry, y in and y out.  The stripe kernel on a width-1 pack
// has the 32 threads of a warp on 32 different columns, so each of its
// loads touches 32 sectors; here a warp's loads cover 32 / G columns'
// contiguous runs.  The x[row] reads stay random: that is the regime.

#include <cuda_runtime.h>

namespace {

template <int G>
__global__ void tr_spmv_scatter_kernel(
    int n, const int* __restrict__ colptr, const int* __restrict__ row,
    const float* __restrict__ val, const float* __restrict__ x,
    const float* __restrict__ y_in, float alpha, float beta,
    float* __restrict__ y_out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int lane = threadIdx.x % G;
  const bool live = t / G < n;
  const int j = live ? static_cast<int>(t / G) : 0;
  float acc = 0.0f;
  if (live) {
    const int e1 = __ldg(colptr + j + 1);
    for (int e = __ldg(colptr + j) + lane; e < e1; e += G) {
      acc = fmaf(__ldg(val + e), __ldg(x + __ldg(row + e)), acc);
    }
  }
  // every lane of the warp takes part in the shuffles (blockDim is a
  // multiple of 32 and G divides 32); dead lanes carry 0
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off, G);
  }
  if (live && lane == 0) {
    float out = alpha * acc;
    if (y_in != nullptr) out = fmaf(beta, y_in[j], out);
    y_out[j] = out;
  }
}

template <int G>
int launch(int n, const int* colptr, const int* row, const float* val,
           const float* x, const float* y_in, float alpha, float beta,
           float* y_out, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks =
      (static_cast<long long>(n) * G + threads - 1) / threads;
  tr_spmv_scatter_kernel<G><<<static_cast<unsigned>(blocks), threads, 0,
                              stream>>>(n, colptr, row, val, x, y_in, alpha,
                                        beta, y_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a lane group other than 4, 8, 16 or 32.
// y_in may be null (then beta is unused).  n > 0.
int vbcs_tr_spmv_scatter(int n, int lanes, const void* colptr,
                         const void* row, const void* val, const void* x,
                         const void* y_in, float alpha, float beta,
                         void* y_out, void* stream) {
  const int* cp = static_cast<const int*>(colptr);
  const int* r = static_cast<const int*>(row);
  const float* v = static_cast<const float*>(val);
  const float* xx = static_cast<const float*>(x);
  const float* yi = static_cast<const float*>(y_in);
  float* yo = static_cast<float*>(y_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 4: return launch<4>(n, cp, r, v, xx, yi, alpha, beta, yo, s);
    case 8: return launch<8>(n, cp, r, v, xx, yi, alpha, beta, yo, s);
    case 16: return launch<16>(n, cp, r, v, xx, yi, alpha, beta, yo, s);
    case 32: return launch<32>(n, cp, r, v, xx, yi, alpha, beta, yo, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

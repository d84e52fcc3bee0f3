// 2-D tile TrSpMV on Hopper: y = alpha * A.T @ x (+ beta * y_in), f32,
// on the 2-D VBC format (u x w dense tiles).
//
// Replaces two TPU kernels on the 2-D operator's route:
// vbcs_tpu/ops/pallas_trspmv2d.py (_class_kernel2d, run by _run_class2d
// through tr_spmv_pallas_2d) for stripes whose tiles share one height,
// and vbcs_tpu/ops/pallas_trspmv2.py (_class_kernel2, run by _run_class2
// through tr_spmv_slots) for the mixed-height stripes that route sends
// to the 1-D stream expansion.  It computes exactly the host oracle
// VBC2D.tr_mul (vbcs_tpu/formats/vbc2d.py):
//
//   y[j] = alpha * sum over the tiles b of stripe s = col_stripe[j],
//          with k = idx[b], i0 = rspl[k], u = rspl[k+1] - i0:
//            sum_{r<u} val[q_b + r*w_s + (j - spl[s])] * x[i0 + r]
//          (+ beta * y_in[j])
//
// where q_b = ofs[s] + the sum of u*w_s over the earlier tiles of the
// stripe.
//
// Design: one thread per output column j, as in trspmv.cu.  Stripes own
// disjoint columns, so no atomics and no cross-block reduction.  The
// thread walks its stripe's tiles in order and loads idx[b] and the
// tile's row range once per tile (not once per row: the 2-D format's
// point), then runs u FMAs down the tile's column.  The value pointer
// steps by w per row, so after a tile it sits at the next tile's row 0:
// the running offset q_b needs no table.  The height is read per tile, so
// uniform and mixed-height stripes, empty row blocks (u = 0) and empty
// stripes run the same code.
//
// The tile's row range hangs off a dependent chain (idx[b], then
// rspl[k] and rspl[k+1], then x), so each iteration loads the next
// tile's row range and the tile-after-next's idx before it runs the
// current tile's rows: those loads are in flight while the FMAs wait on
// theirs.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), L2
// warm: 8.78 -> 6.35 us on bench.blocky2d_matrix() under the equi plan,
// 11.3 -> 9.9 us on the flagship's mostly height-1 default plan, where
// the stripe kernel on the 1-D view still wins (7.6 us): per tile this
// kernel reads two rspl entries more.  The TPU kernels' (u, w) classes, window
// ids, x-tiles, straddle carries, slot space and exit permute existed
// only because Mosaic gathers inside one vreg; here x[i0 + r] is an
// ordinary load and y is written in natural order.
//
// What bounds it on this card: bytes.  Each stored value is used once
// (2 flops per 4-byte value), so the floor is (val + idx + metadata + x
// + y) bytes over bandwidth.  The w_s threads of a stripe are adjacent
// and read the w_s contiguous values of a tile row together (coalesced);
// idx[b], rspl[k] and x[i0 + r] are one address broadcast to them.  A
// warp per stripe, shared-memory x windows and TMA staging are later
// work.

#include <cuda_runtime.h>

namespace {

__global__ void tr_spmv_tile_kernel(
    int n, const int* __restrict__ rspl, const int* __restrict__ spl,
    const int* __restrict__ pos, const int* __restrict__ idx,
    const int* __restrict__ ofs, const int* __restrict__ col_stripe,
    const float* __restrict__ val, const float* __restrict__ x,
    const float* __restrict__ y_in, float alpha, float beta,
    float* __restrict__ y_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int s = col_stripe[j];
  const int j0 = spl[s];
  const int w = spl[s + 1] - j0;
  const int b0 = pos[s];
  const int b1 = pos[s + 1];  // tiles exist only if K >= 1: rspl[1] is valid
  const float* v = val + ofs[s] + (j - j0);
  float acc = 0.0f;
  if (b0 < b1) {
    const int k = __ldg(idx + b0);
    int i0 = __ldg(rspl + k);
    int i1 = __ldg(rspl + k + 1);
    int kn = b0 + 1 < b1 ? __ldg(idx + b0 + 1) : 0;
    for (int b = b0; b < b1; ++b) {
      const int i0n = __ldg(rspl + kn);
      const int i1n = __ldg(rspl + kn + 1);
      const int knn = b + 2 < b1 ? __ldg(idx + b + 2) : 0;
#pragma unroll 4
      for (int r = i0; r < i1; ++r, v += w) {
        acc = fmaf(__ldg(v), __ldg(x + r), acc);
      }
      i0 = i0n;
      i1 = i1n;
      kn = knn;
    }
  }
  float out = alpha * acc;
  if (y_in != nullptr) out = fmaf(beta, y_in[j], out);
  y_out[j] = out;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// y_in may be null (then beta is unused).  n > 0.
int vbcs_tr_spmv_2d(int n, const void* rspl, const void* spl, const void* pos,
                    const void* idx, const void* ofs, const void* col_stripe,
                    const void* val, const void* x, const void* y_in,
                    float alpha, float beta, void* y_out, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  tr_spmv_tile_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int*>(rspl), static_cast<const int*>(spl),
      static_cast<const int*>(pos), static_cast<const int*>(idx),
      static_cast<const int*>(ofs), static_cast<const int*>(col_stripe),
      static_cast<const float*>(val), static_cast<const float*>(x),
      static_cast<const float*>(y_in), alpha, beta,
      static_cast<float*>(y_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

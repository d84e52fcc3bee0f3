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
//   y[j] = alpha * sum over the tiles b of stripe s = col_stripe[j]:
//            sum_{r<u_b} val[tile_ofs[b] + r*w_s + (j - spl[s])]
//                        * x[tile_row[b] + r]
//          (+ beta * y_in[j])
//
// where tile_row[b] = Pi.spl[idx[b]] and tile_ofs[b] is the running sum
// of u*w over the tiles before b; the device pack holds both
// (formats/device.py: VBC2DDevice), so a tile's place is one load, not
// the idx -> Pi.spl chain, and u_b*w_s = tile_ofs[b+1] - tile_ofs[b].
//
// Design: a group of G lanes per stripe (G = 1, 2, ..., 32, a power of
// two the wrapper picks from the pack: ops/trspmv2d.py, lanes_per_stripe;
// 32 / G stripes a warp), its lanes laid out as (tile slot, column).  A
// stripe of width w <= G has G / w slots of w lanes; slot k takes the
// stripe's tiles k, k + slots, ..., kUnroll of them at a time, loads each
// tile's row base and value range once, and walks the tile's rows, lane c
// reading column c.  So the slots read neighbouring tiles together (four
// height-1 tiles of width 8 are one 128-byte load), and a lane has
// kUnroll tiles' loads in flight.  A shuffle reduction across the slots
// gives the w column sums; alpha and beta are fused into the store, and
// y is written in natural order.  Stripes wider than G run in chunks of G
// columns.  The loop reads each tile's height from its value range, so
// tiles of any height (0 included), mixed-height stripes and empty
// stripes run the same code.  The TPU kernels' (u, w) classes, window
// ids, x-tiles, straddle carries, slot space and exit permute existed
// only because Mosaic gathers inside one vreg; here x[tile_row + r] is
// an ordinary load.
//
// What bounds it on this card: the latency of its dependent loads (stripe
// range, then tile places, then values and x), which only occupancy
// hides.  Each stored value is used once (2 flops per 4-byte value), so
// the floor is bytes: values, tile places, the x sectors the tiles touch
// and y.  On an H100 (PERF.md) the best shapes were the smallest ones:
// kUnroll = 2 (40 registers, 48 warps an SM) beat 1, 4 and 8, and G that
// gives each lane ~16 stored values beat wider and narrower groups; a
// warp per stripe ran 4x the warps of the one-thread-per-column design
// for the same work, and lost, and so did slots over rows (a warp
// reading contiguous values) for tiles of one height.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // tiles a lane has in flight at once

// One group of G lanes per stripe, 32 / G stripes per warp.
template <int G>
__global__ void __launch_bounds__(kThreads) tr_spmv_tile_kernel(
    int L, const int* __restrict__ spl, const int* __restrict__ pos,
    const int* __restrict__ tile_row, const int* __restrict__ tile_ofs,
    const float* __restrict__ val, const float* __restrict__ x,
    const float* __restrict__ y_in, float alpha, float beta,
    float* __restrict__ y_out) {
  const int lane = threadIdx.x % 32;
  const int g = lane / G;   // the group in the warp
  const int gl = lane % G;  // the lane in the group
  const int s = (blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * (32 / G) + g;
  if (s >= L) return;  // the whole group
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << G) - 1) << (g * G);
  const int j0 = __ldg(spl + s);
  const int w = __ldg(spl + s + 1) - j0;
  if (w == 0) return;
  const int b0 = __ldg(pos + s);
  const int b1 = __ldg(pos + s + 1);
  const int cw = w < G ? w : G;  // columns of a chunk
  const int slots = G / cw;
  const int slot = gl / cw;
  const int c = gl - slot * cw;
  for (int cb = 0; cb < w; cb += cw) {
    const int col = cb + c;
    const bool live = slot < slots && col < w;
    float acc = 0.0f;
    for (int b = b0 + slot; b < b1; b += kUnroll * slots) {
      int tr[kUnroll], tq[kUnroll], te[kUnroll];  // row, value, u * w
      int emax = 0;
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        const int t = b + m * slots;
        tr[m] = tq[m] = te[m] = 0;
        if (live && t < b1) {
          tr[m] = __ldg(tile_row + t);
          tq[m] = __ldg(tile_ofs + t);
          te[m] = __ldg(tile_ofs + t + 1) - tq[m];
          tq[m] += col;
        }
        emax = max(emax, te[m]);
      }
#pragma unroll 4
      for (int rw = 0, r = 0; rw < emax; rw += w, ++r) {
#pragma unroll
        for (int m = 0; m < kUnroll; ++m) {
          if (rw < te[m]) {
            acc = fmaf(__ldg(val + tq[m] + rw), __ldg(x + tr[m] + r), acc);
          }
        }
      }
    }
    for (int d = 1; d < slots; d *= 2) {
      const float other = __shfl_down_sync(mask, acc, d * cw, G);
      if (slot + d < slots) acc += other;
    }
    if (slot == 0 && col < w) {
      float out = alpha * acc;
      if (y_in != nullptr) out = fmaf(beta, y_in[j0 + col], out);
      y_out[j0 + col] = out;
    }
  }
}

template <int G>
void launch(int L, const int* spl, const int* pos, const int* tile_row,
            const int* tile_ofs, const float* val, const float* x,
            const float* y_in, float alpha, float beta, float* y_out,
            cudaStream_t stream) {
  constexpr int per_block = kThreads / G;  // stripes
  tr_spmv_tile_kernel<G><<<(L + per_block - 1) / per_block, kThreads, 0,
                           stream>>>(L, spl, pos, tile_row, tile_ofs, val, x,
                                     y_in, alpha, beta, y_out);
}

}  // namespace

extern "C" {

// Launches on `stream` with `lanes` (1, 2, 4, 8, 16 or 32) lanes a stripe;
// returns cudaGetLastError() (0 = launched; cudaErrorInvalidValue for
// another lane count).  y_in may be null (then beta is unused).  L > 0.
int vbcs_tr_spmv_2d(int L, int lanes, const void* spl, const void* pos,
                    const void* tile_row, const void* tile_ofs,
                    const void* val, const void* x, const void* y_in,
                    float alpha, float beta, void* y_out, void* stream) {
  auto* f = &launch<32>;
  switch (lanes) {
    case 1: f = &launch<1>; break;
    case 2: f = &launch<2>; break;
    case 4: f = &launch<4>; break;
    case 8: f = &launch<8>; break;
    case 16: f = &launch<16>; break;
    case 32: break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  f(L, static_cast<const int*>(spl), static_cast<const int*>(pos),
    static_cast<const int*>(tile_row), static_cast<const int*>(tile_ofs),
    static_cast<const float*>(val), static_cast<const float*>(x),
    static_cast<const float*>(y_in), alpha, beta, static_cast<float*>(y_out),
    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

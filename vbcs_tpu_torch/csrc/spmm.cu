// Stripe SpMM on Hopper: Y = A.T @ X for a dense row-major RHS X [m, k], f32.
//
// Replaces the TPU SpMM kernels of the operator's tr_mul_mat/mul_mat
// path, each of which computes the same Y on the inputs it accepts:
//   vbcs_tpu/ops/pallas_spmm4.py  _spmm4_kernel      (k <= 128, one class)
//   vbcs_tpu/ops/pallas_spmm3.py  _spmm3_kernel      (one class, KT=32)
//   vbcs_tpu/ops/pallas_spmm.py   _class_kernel_spmm (any plan, KT=4)
//   vbcs_tpu/ops/pallas_trspmv.py _class_kernel      (v1 stripe reduction,
//                                 the v2 SpMM's fallback for classes that
//                                 break its x-window bound; k = 1)
// It computes exactly the host oracle, for every plan, k >= 1 and shape:
//
//   Y[j, c] = sum_{b in stripe s} val[ofs[s] + (b - pos[s]) * w_s
//                                     + (j - spl[s])] * X[idx[b], c]
//
// with s the stripe that owns column j and w_s = spl[s+1] - spl[s].  On a
// natural view of an auto-RCM pack (formats/device.py: natural_view) idx
// holds natural rows and column j is row col_out[j] of Y, so the two row
// gathers the operator ran around the kernel (X rows in, Y rows out) fold
// into it; each Y row is still one coalesced run of k floats, 16-byte
// aligned whenever Y is and k % 4 == 0.  col_out is null in natural order.
//
// Design: a group of G lanes (G a power of two, 32 for k >= 128) owns one
// (stripe, tile of 4*G RHS columns) pair; each lane owns 4 consecutive
// RHS columns, loaded as one float4 when k % 4 == 0 and X, Y are 16-byte
// aligned (else 4 masked scalar loads).  Per block, idx[b] and the w_s
// block values are group-uniform loads (one address broadcast to the
// group), and the lane keeps an acc[8][4] register tile that it stores
// once per stripe column; stripes wider than 8 loop over groups of 8
// columns.  Stripes own disjoint columns (the reference's stripe
// scheduler), so no atomics and no cross-block reduction are needed.  The
// TPU kernels' ring windows, KT passes, slot space and exit permutes
// existed only because Mosaic gathers inside one vreg; here X[idx[b], :]
// is an ordinary coalesced row load.
//
// What bounds it on this card: device-memory bytes.  Each block value
// meets k RHS columns (2k flops per 4-byte value and per 4k-byte X row),
// far below the f32 units' rate, so the floor is (val + idx + metadata +
// the X rows read + Y) bytes over bandwidth.  X and Y offsets are 64-bit:
// idx[b] * k passes 2^31 once m * k does (16.8M rows at k = 128).  Shared-
// memory X staging, TMA and wgmma on 2-D tiles are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <bool kVec>
__device__ __forceinline__ float4 load_row4(const float* __restrict__ row,
                                            int64_t c0, int64_t k) {
  if constexpr (kVec) return __ldg(reinterpret_cast<const float4*>(row + c0));
  float4 v;
  v.x = __ldg(row + c0);
  v.y = c0 + 1 < k ? __ldg(row + c0 + 1) : 0.0f;
  v.z = c0 + 2 < k ? __ldg(row + c0 + 2) : 0.0f;
  v.w = c0 + 3 < k ? __ldg(row + c0 + 3) : 0.0f;
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store_row4(float* __restrict__ row,
                                           int64_t c0, int64_t k,
                                           const float (&a)[4]) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(row + c0) = make_float4(a[0], a[1], a[2], a[3]);
    return;
  }
  row[c0] = a[0];
  if (c0 + 1 < k) row[c0 + 1] = a[1];
  if (c0 + 2 < k) row[c0 + 2] = a[2];
  if (c0 + 3 < k) row[c0 + 3] = a[3];
}

// Work item = (stripe s, k-tile t) = (item % L, item / L): consecutive
// items are neighbouring stripes of one tile, whose X rows overlap on
// banded matrices and so meet in L2.
template <bool kVec>
__global__ void tr_spmm_stripe_kernel(
    int L, int64_t k, int log2_group, int64_t items,
    const int* __restrict__ spl, const int* __restrict__ pos,
    const int* __restrict__ idx, const int* __restrict__ ofs,
    const int* __restrict__ col_out, const float* __restrict__ val,
    const float* __restrict__ X, float* __restrict__ Y) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t item = t >> log2_group;
  if (item >= items) return;
  const int lane = static_cast<int>(t & ((1 << log2_group) - 1));
  const int s = static_cast<int>(item % L);
  const int64_t c0 = ((item / L) << (log2_group + 2)) + 4 * lane;
  if (c0 >= k) return;
  const int j0 = __ldg(spl + s);
  const int w = __ldg(spl + s + 1) - j0;
  const int b0 = __ldg(pos + s);
  const int b1 = __ldg(pos + s + 1);
  const float* vs = val + __ldg(ofs + s);
  for (int g0 = 0; g0 < w; g0 += 8) {
    const int gw = min(8, w - g0);
    float acc[8][4] = {};
    const float* v = vs + g0;
#pragma unroll 2
    for (int b = b0; b < b1; ++b, v += w) {
      const float4 x = load_row4<kVec>(X + __ldg(idx + b) * k, c0, k);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < gw) {
          const float a = __ldg(v + i);
          acc[i][0] = fmaf(a, x.x, acc[i][0]);
          acc[i][1] = fmaf(a, x.y, acc[i][1]);
          acc[i][2] = fmaf(a, x.z, acc[i][2]);
          acc[i][3] = fmaf(a, x.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < gw) {
        const int j = j0 + g0 + i;
        const int64_t jo = col_out != nullptr ? __ldg(col_out + j) : j;
        store_row4<kVec>(Y + jo * k, c0, k, acc[i]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a problem the grid cannot cover.  L >= 1
// stripes, k >= 1 RHS columns; X is [m, k] and Y is [n, k], row-major;
// col_out null (natural order) or a permutation of [0, n).
int vbcs_tr_spmm(int L, int64_t k, const void* spl, const void* pos,
                 const void* idx, const void* ofs, const void* col_out,
                 const void* val, const void* X, void* Y, void* stream) {
  if (L < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  // group of G lanes covers 4*G columns: the smallest power of two >= k/4
  int log2_group = 0;
  while (log2_group < 5 && (int64_t{4} << log2_group) < k) ++log2_group;
  const int64_t tile = int64_t{4} << log2_group;
  const int64_t items = static_cast<int64_t>(L) * ((k + tile - 1) / tile);
  const int threads = 256;
  const int64_t blocks = ((items << log2_group) + threads - 1) / threads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = k % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* spl_ = static_cast<const int*>(spl);
  const auto* pos_ = static_cast<const int*>(pos);
  const auto* idx_ = static_cast<const int*>(idx);
  const auto* ofs_ = static_cast<const int*>(ofs);
  const auto* out_ = static_cast<const int*>(col_out);
  const auto* val_ = static_cast<const float*>(val);
  const auto* X_ = static_cast<const float*>(X);
  auto* Y_ = static_cast<float*>(Y);
  if (vec) {
    tr_spmm_stripe_kernel<true><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        L, k, log2_group, items, spl_, pos_, idx_, ofs_, out_, val_, X_, Y_);
  } else {
    tr_spmm_stripe_kernel<false><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        L, k, log2_group, items, spl_, pos_, idx_, ofs_, out_, val_, X_, Y_);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

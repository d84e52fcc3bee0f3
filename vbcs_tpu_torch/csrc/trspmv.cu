// Stripe TrSpMV on Hopper: y = alpha * A.T @ x (+ beta * y_in), f32.
//
// Replaces the TPU one-shot kernel vbcs_tpu/ops/pallas_trspmv3.py
// (_oneshot_kernel, built by _oneshot_call, reached through
// tr_spmv_oneshot3), including its fused alpha/beta store.  It computes
// exactly the host oracle VBC1D.tr_mul (vbcs_tpu/formats/vbc1d.py):
//
//   y[j] = alpha * sum_{b in stripe s} val[ofs[s] + (b - pos[s]) * w_s
//                                          + (j - spl[s])] * x[idx[b]]
//          (+ beta * y_in[j])
//
// with s = col_stripe[j] and w_s = spl[s+1] - spl[s].  On a natural view
// of an auto-RCM pack (formats/device.py: natural_view) idx holds
// natural rows and y lands at col_out[j] (y_in is read there too), so
// the gathers the JAX operator runs around its kernel for a relabeled
// matrix (windowed_gather._permute_kernel, on x and on y) fold into this
// one launch; col_out is null in natural order.  col_out may also put
// the columns of a format at places in a longer y_out, so that two
// launches on two formats fill one buffer (parallel/stream.py's
// overlapped halo path: its local and its remote stripes, each at its
// natural place in the rank's slice).
//
// What bounds it on this card: device-memory bytes (2 flops a 4-byte
// value): the values, idx, x, y in and out, each once.  The stripes own
// disjoint columns, so no atomics and no cross-block sums are needed.
//
// Design: two thread maps, chosen by the launcher from the format's
// widths; both load the idx and values of kBatch blocks together, then
// their x rows, then the sums (two round trips a batch, not two a
// block).
//
// * Every width a multiple of 4 (VBC1DDevice.quad_widths: the flagship's
//   and every W = 8 plan of the blocky family) and val 16-byte aligned:
//   a thread takes four adjacent columns of one stripe and reads one
//   float4 of values a block, and y as a float4 where col_out is null.
//   A block of 256 threads owns the G consecutive stripes of about 1,024
//   columns; it stages their spl, pos and ofs in shared memory once,
//   coalesced, and a thread finds its stripe by a binary search there;
//   col_stripe is not read.  A quarter of the threads, loads and index
//   reads of a thread a column, and none of col_stripe's bytes: 12%
//   faster than a thread a column at 250 MB a call, 16% warm and 15%
//   flushed on the flagship (PERF.md).
// * Any other widths: a thread a column, its stripe from col_stripe[j]
//   (the w threads of a stripe read each block's w contiguous values
//   together).  There the staged map ran 4-7% slower than this one at
//   190-250 MB a call (its block-wide prologue is amortised over 256
//   columns, not 1,024); the batches gain 3-9% at the flagship's size
//   and nothing at 250 MB (PERF.md).
//
// A warp a stripe, lanes as (block slot, column) with a fixed shuffle
// tree, was built and timed first: at the flagship's shape (w = 8, ~8
// blocks a stripe) a warp's stripe is 64 values, two a lane, and a warp
// walking one stripe or a group of them ran 1.7-4x slower than a thread
// a column (PERF.md).  No TMA or tensor cores: the operands are 4- and
// 16-byte gathers and short runs, not tiles.
//
// Sum order (bitwise determinism): a column's blocks are added in block
// order, acc = fmaf(val, x, acc) from 0, then alpha * acc and
// fmaf(beta, y_in, .), in both maps.  It is a function of the blocks'
// ranks in the column's stripe alone (not of pos, ofs, G, the map or the
// thread's place in the launch): two launches give the same bits, a
// format cut at stripe boundaries (the distributed paths' shards, the
// overlap's two formats, a halo stage's remapped rows) the whole
// format's, and the two maps each other's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;        // blocks whose loads a thread sends together
constexpr int kQuadCols = 1024;  // columns a block owns on the float4 map
constexpr int kMaxGroup = 2048;  // its stripes at most: 24 KB of shared memory

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

__device__ __forceinline__ void fma_into(float (&acc)[1], float a, float x) {
  acc[0] = fmaf(a, x, acc[0]);
}

__device__ __forceinline__ void fma_into(float (&acc)[4], float4 a, float x) {
  acc[0] = fmaf(a.x, x, acc[0]);
  acc[1] = fmaf(a.y, x, acc[1]);
  acc[2] = fmaf(a.z, x, acc[2]);
  acc[3] = fmaf(a.w, x, acc[3]);
}

// acc += blocks b0 .. b1 - 1 of a stripe, in block order, for the
// column(s) whose value of block b0 is at v (each next block `stride`
// further on): the idx and values of kBatch blocks loaded together, then
// their x rows.
template <typename Vals, int kCols>
__device__ __forceinline__ void sum_blocks(float (&acc)[kCols], const Vals* v,
                                           int stride, int b0, int b1,
                                           const int* __restrict__ idx,
                                           const float* __restrict__ x) {
  for (int b = b0; b < b1; b += kBatch) {
    int r[kBatch];
    Vals a[kBatch];
    float xv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      r[u] = 0;
      a[u] = Vals{};
      if (b + u < b1) {
        r[u] = __ldg(idx + b + u);
        a[u] = __ldg(v + (b + u - b0) * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) xv[u] = b + u < b1 ? __ldg(x + r[u]) : 0.0f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (b + u < b1) fma_into(acc, a[u], xv[u]);
  }
}

// y_out at column j's place = alpha * acc (+ beta * y_in at that place).
__device__ __forceinline__ void store(float acc, int j, const int* col_out,
                                      const float* y_in, float alpha, float beta,
                                      float* y_out) {
  const int jo = col_out != nullptr ? __ldg(col_out + j) : j;
  float out = alpha * acc;
  if (y_in != nullptr) out = fmaf(beta, y_in[jo], out);
  y_out[jo] = out;
}

// A thread a column.
__global__ void __launch_bounds__(kThreads)
tr_spmv_column_kernel(int n, const int* __restrict__ spl,
                      const int* __restrict__ pos, const int* __restrict__ idx,
                      const int* __restrict__ ofs,
                      const int* __restrict__ col_stripe,
                      const int* __restrict__ col_out,
                      const float* __restrict__ val,
                      const float* __restrict__ x, const float* y_in,
                      float alpha, float beta, float* y_out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int s = __ldg(col_stripe + j);
  const int j0 = __ldg(spl + s);
  float acc[1] = {0.0f};
  sum_blocks(acc, val + __ldg(ofs + s) + (j - j0), __ldg(spl + s + 1) - j0,
             __ldg(pos + s), __ldg(pos + s + 1), idx, x);
  store(acc[0], j, col_out, y_in, alpha, beta, y_out);
}

// Four columns a thread, a float4 of values a block; a block owns G
// stripes.
__global__ void __launch_bounds__(kThreads)
tr_spmv_quad_kernel(int L, int G, const int* __restrict__ spl,
                    const int* __restrict__ pos, const int* __restrict__ idx,
                    const int* __restrict__ ofs, const int* __restrict__ col_out,
                    const float* __restrict__ val, const float* __restrict__ x,
                    const float* y_in, float alpha, float beta, float* y_out) {
  extern __shared__ int meta[];  // spl, pos, ofs of the block's G + 1 splits
  const long long s0 = static_cast<long long>(blockIdx.x) * G;
  const int g_n = static_cast<int>(min(static_cast<long long>(G), L - s0));
  int* m_spl = meta;
  int* m_pos = meta + g_n + 1;
  int* m_ofs = meta + 2 * (g_n + 1);
  for (int i = threadIdx.x; i <= g_n; i += kThreads) {
    m_spl[i] = __ldg(spl + s0 + i);
    m_pos[i] = __ldg(pos + s0 + i);
    m_ofs[i] = __ldg(ofs + s0 + i);
  }
  __syncthreads();
  const int c1 = m_spl[g_n];
  for (int j = m_spl[0] + 4 * threadIdx.x; j < c1; j += 4 * kThreads) {
    // the stripe g with spl[g] <= j < spl[g + 1] (never a zero-width one)
    int g = 0, hi = g_n;
    while (hi - g > 1) {
      const int mid = (g + hi) >> 1;
      if (m_spl[mid] <= j) g = mid; else hi = mid;
    }
    const int j0 = m_spl[g];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    sum_blocks(acc, reinterpret_cast<const float4*>(val + m_ofs[g] + (j - j0)),
               (m_spl[g + 1] - j0) / 4, m_pos[g], m_pos[g + 1], idx, x);
    if (col_out == nullptr && aligned16(y_out + j) &&
        (y_in == nullptr || aligned16(y_in + j))) {  // y as one float4
      float4 out = make_float4(alpha * acc[0], alpha * acc[1], alpha * acc[2],
                               alpha * acc[3]);
      if (y_in != nullptr) {
        const float4 yv = *reinterpret_cast<const float4*>(y_in + j);
        out = make_float4(fmaf(beta, yv.x, out.x), fmaf(beta, yv.y, out.y),
                          fmaf(beta, yv.z, out.z), fmaf(beta, yv.w, out.w));
      }
      *reinterpret_cast<float4*>(y_out + j) = out;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store(acc[i], j + i, col_out, y_in, alpha, beta, y_out);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  n is
// the column count, L the stripe count (spl, pos and ofs hold L + 1
// entries); quads says that every stripe width is a multiple of 4 (the
// float4 map, taken when val is 16-byte aligned too).  y_in may be null
// (then beta is unused), col_out null (natural order; else an injection
// of the n columns into y_out's entries: a natural view's permutation,
// or the overlapped halo path's places of two formats' columns in one
// buffer; y_in is read at the same places).  n > 0.
int vbcs_tr_spmv(int n, int L, int quads, const void* spl, const void* pos,
                 const void* idx, const void* ofs, const void* col_stripe,
                 const void* col_out, const void* val, const void* x,
                 const void* y_in, float alpha, float beta, void* y_out,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* i_spl = static_cast<const int*>(spl);
  const int* i_pos = static_cast<const int*>(pos);
  const int* i_idx = static_cast<const int*>(idx);
  const int* i_ofs = static_cast<const int*>(ofs);
  const int* i_out = static_cast<const int*>(col_out);
  const float* f_val = static_cast<const float*>(val);
  const float* f_x = static_cast<const float*>(x);
  const float* f_y = static_cast<const float*>(y_in);
  float* f_out = static_cast<float*>(y_out);
  if (quads != 0 && aligned16(val)) {
    // the stripes of about kQuadCols columns, at least one
    const long long per = static_cast<long long>(L) * kQuadCols / n;
    const int G = per < 1 ? 1 : per > kMaxGroup ? kMaxGroup : static_cast<int>(per);
    const unsigned blocks =
        static_cast<unsigned>((static_cast<long long>(L) + G - 1) / G);
    tr_spmv_quad_kernel<<<blocks, kThreads, 3 * (G + 1) * sizeof(int), st>>>(
        L, G, i_spl, i_pos, i_idx, i_ofs, i_out, f_val, f_x, f_y, alpha, beta,
        f_out);
  } else {
    const unsigned blocks =
        static_cast<unsigned>((static_cast<long long>(n) + kThreads - 1) / kThreads);
    tr_spmv_column_kernel<<<blocks, kThreads, 0, st>>>(
        n, i_spl, i_pos, i_idx, i_ofs, static_cast<const int*>(col_stripe),
        i_out, f_val, f_x, f_y, alpha, beta, f_out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vbcs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

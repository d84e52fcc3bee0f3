// Stripe TrSpMV on Hopper: y = alpha * A.T @ x (+ beta * y_in), f32, and
// f64 on the staged map (vbcs_tr_spmv_f64).
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
// with s the stripe that owns column j and w_s = spl[s+1] - spl[s].  On a natural view
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
// What bounds it on this card: device-memory bytes (2 flops a 4- or
// 8-byte value): the values, idx, x, y in and out, each once.  The
// stripes own disjoint columns, so no atomics and no cross-block sums
// are needed.
//
// Design: two thread maps, chosen on the host from the format
// (ops/trspmv.thread_map); each adds each column's blocks in block order.
//
// * Every width a multiple of 4 (VBC1DDevice.quad_widths: the flagship's
//   and every W = 8 plan of the blocky family) and val 16-byte aligned:
//   a thread takes four adjacent columns of one stripe and reads one
//   float4 of values a block, and y as a float4 where col_out is null.
//   A block of 256 threads owns the G consecutive stripes of about 1,024
//   columns; it stages their spl, pos and ofs in shared memory once,
//   coalesced, and a thread finds its stripe by a binary search there.
//   It loads the idx and values of kBatch blocks together, then their x
//   rows, then sums (two round trips a batch, not two a block): 12%
//   faster than a thread a column at 250 MB a call (PERF.md).
// * Every other format, the staged map: a block owns a run of whole
//   consecutive stripes (ops/trspmv.stage_plan, cut on the device once
//   per format).  A run's values and block rows are contiguous in val
//   and idx (ofs and pos run in stripe order), so the block copies them
//   into shared memory with 16-byte cp.async copies (each window rounded
//   out to 16-byte boundaries), marked evict-first in L2 since each is
//   read once; then it gathers x[idx[b]] once a block row (not once for
//   each of the stripe's w columns, as a thread a column did) and, on a
//   natural view, y_in at each column's place, with 4-byte cp.async
//   copies; then a thread a column sums from shared memory.  cp.async
//   holds no register, so a block sends all of a stage's copies at once:
//   three round trips a run.  Neighbouring threads of narrow stripes no
//   longer read separate sectors of device memory for every value.  A
//   stripe whose values do not fit a stage (long, wide or both) is a run
//   of its own, walked in passes of a block's columns and, in each, in
//   chunks of block rows, its columns' sums carried across the chunks.
//   The map is templated on the value type: in f64 (HPCG's precision) a
//   value and a block row's x take 8 bytes, so a run stages half as many
//   of them in the same bytes, and a block row's idx is copied by its own
//   thread into the low word of the 8-byte slot that its x then fills.
//   It replaced a thread a column (its stripe from col_stripe[j]), which
//   gave the same bits: 1.1-2.6x slower on the benchmark's packs, up to
//   28% faster on formats of about 1M blocks whose x is local (PERF.md).
//   (An earlier staged map, which staged only spl/pos/ofs and read
//   values, idx and x a thread a column, ran 4-7% slower than a thread a
//   column; batched register loads in place of cp.async ran 1.3-2.2x
//   slower than this one: PERF.md.)

// A warp a stripe, lanes as (block slot, column) with a fixed shuffle
// tree, was built and timed first: at the flagship's shape (w = 8, ~8
// blocks a stripe) a warp's stripe is 64 values, two a lane, and a warp
// walking one stripe or a group of them ran 1.7-4x slower than a thread
// a column (PERF.md).  No tensor cores: the operands are 4- and 16-byte
// gathers and short runs, not tiles.
//
// Sum order (bitwise determinism): a column's blocks are added in block
// order, acc = fmaf(val, x, acc) from 0, then alpha * acc and
// fmaf(beta, y_in, .), in every map (fma in f64).  It is a
// function of the blocks' ranks in the column's stripe alone (not of
// pos, ofs, G, the runs, the
// map or the thread's place in the launch): two launches give the same
// bits, a format cut at stripe boundaries (the distributed paths'
// shards, the overlap's two formats, a halo stage's remapped rows) the
// whole format's, and the maps each other's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;        // blocks whose loads a thread sends together
constexpr int kQuadCols = 1024;  // columns a block owns on the float4 map
constexpr int kMaxGroup = 2048;  // its stripes at most: 24 KB of shared memory
// The staged map (ops/trspmv.py: STAGE_COLS, STAGE_STRIPES, STAGE_WORDS):
// a block of kThreads threads a run of at most kRunCols columns (a thread
// a column of each pass of kThreads), kRunStripes stripes and kStageWords
// words of values and block rows (in f64, two words each).  Shared
// memory: the stage (the values' and the block rows' windows, each
// rounded out to 16 bytes: up to 12 words more), the run's spl/pos/ofs,
// and on a natural view its col_out window and the y_in gathered at
// those places.
constexpr int kRunCols = 2 * kThreads;
constexpr int kRunStripes = kThreads;
constexpr int kStageWords = 7168;
constexpr int kStageCap = kStageWords + 16;
constexpr int kMetaWords = (3 * (kRunStripes + 1) + 3) & ~3;
// A run's stage in elements of its value type T: each value and each block
// row takes one (ops/trspmv.stage_elements); the f64 map's stage is the
// same kStageCap words, so it holds half as many.
template <typename T>
constexpr int kStageElems = kStageWords * 4 / static_cast<int>(sizeof(T));
// Shared memory a staged block: the stage, the run's spl/pos/ofs, its
// col_out window and the y_in gathered at those places (in T).
template <typename T>
constexpr int kStagedSmem =
    (kStageCap + kMetaWords + kRunCols + 8) * 4 + kRunCols * static_cast<int>(sizeof(T));
// Blocks of the staged map an SM: the launcher splits an SM's unified L1
// and shared memory so that this many blocks' stages fit and no more,
// and the rest is L1, which the x gathers (cp.async.ca) hit.  Five and
// six blocks an SM, with the L1 cut to match, ran 6% and 45% slower on
// the benchmark's random-row pack (PERF.md).
constexpr int kStagedPerSM = 4;
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
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

// a * b + c, rounded once
__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }

// y_out at column j's place = alpha * acc (+ beta * y_in at that place).
template <typename T>
__device__ __forceinline__ void store(T acc, int j, const int* col_out, const T* y_in,
                                      T alpha, T beta, T* y_out) {
  const int jo = col_out != nullptr ? __ldg(col_out + j) : j;
  T out = alpha * acc;
  if (y_in != nullptr) out = mad(beta, y_in[jo], out);
  y_out[jo] = out;
}

// The stripe g of the n_g staged splits with spl[g] <= j < spl[g + 1]
// (never a zero-width one).
__device__ __forceinline__ int find_stripe(const int* m_spl, int n_g, int j) {
  int g = 0, hi = n_g;
  while (hi - g > 1) {
    const int mid = (g + hi) >> 1;
    if (m_spl[mid] <= j) g = mid; else hi = mid;
  }
  return g;
}

// cp.async (Ampere and later): copies into shared memory that hold no
// register, so a block sends all of a stage's loads at once.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// 16 bytes, streamed: marked evict-first in L2 (each is read once)
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       unsigned long long policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
               :: "r"(shared_addr(dst)), "l"(src), "l"(policy));
}

// 4 bytes, gathered (x's and y's lines stay in L2 as they are)
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(shared_addr(dst)), "l"(src));
}

// 8 bytes, gathered, as copy4
__device__ __forceinline__ void copy8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(shared_addr(dst)), "l"(src));
}

// one element of the value type, gathered
__device__ __forceinline__ void copy_elem(float* dst, const float* src) { copy4(dst, src); }
__device__ __forceinline__ void copy_elem(double* dst, const double* src) { copy8(dst, src); }

// Wait for every copy this thread sent, then for the block's.
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Copy elements [w0, w1) of an array of 4- or 8-byte elements E into dst
// (16-byte aligned), the window rounded out to 16-byte boundaries of the
// array's addresses (it may start on any element: a view): element w
// lands at dst[w - first].  Returns (first, the window's last element +
// 1).  Every thread calls it.
template <typename E>
__device__ __forceinline__ int2 copy_window(void* dst, const E* src, int w0, int w1,
                                            unsigned long long policy) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(E));  // elements a copy
  constexpr int kShift = sizeof(E) == 4 ? 2 : 1;
  const int mis = static_cast<int>(
      (reinterpret_cast<unsigned long long>(src) / sizeof(E)) & (kPer - 1));
  const int first = w0 - ((w0 + mis) & (kPer - 1));
  const int end = w1 + ((kPer - ((w1 + mis) & (kPer - 1))) & (kPer - 1));
  const char* s = reinterpret_cast<const char*>(src) + static_cast<long long>(sizeof(E)) * first;
  for (int i = threadIdx.x; i < (end - first) >> kShift; i += kThreads)
    copy16(static_cast<char*>(dst) + 16 * i, s + 16LL * i, policy);
  return make_int2(first, end);
}

// A run's stage: value v at vals[v - v_first], block b's row (its idx,
// then x[idx]) at rows[b - b_first].
template <typename T>
struct Stage {
  T* vals;
  T* rows;
  int v_first, b_first;
};

// Send the copies of the idx of block rows [cb, ce) into rows; returns
// b_first.
// f32: one window of 16-byte copies.  f64: a row's idx by the thread
// that gathers its x, into the low word of its 8-byte slot.  Every thread
// calls it.
__device__ __forceinline__ int stage_rows(float* rows, int cb, int ce,
                                          const int* __restrict__ idx,
                                          unsigned long long policy) {
  return copy_window(rows, idx, cb, ce, policy).x;
}

__device__ __forceinline__ int stage_rows(double* rows, int cb, int ce,
                                          const int* __restrict__ idx,
                                          unsigned long long) {
  for (int b = cb + threadIdx.x; b < ce; b += kThreads) copy4(rows + (b - cb), idx + b);
  return cb;
}

// Send the copies of blocks [cb, ce) of a run, their values val[cv0,
// cv1): the values' window from stage[0], then the block rows' idx.
// Every thread calls it.
template <typename T>
__device__ __forceinline__ Stage<T> stage_windows(T* stage, int cv0, int cv1, int cb,
                                                  int ce, const int* __restrict__ idx,
                                                  const T* __restrict__ val,
                                                  unsigned long long policy) {
  const int2 v = copy_window(stage, val, cv0, cv1, policy);
  T* rows = stage + (v.y - v.x);
  return Stage<T>{stage, rows, v.x, stage_rows(rows, cb, ce, idx, policy)};
}

// Once the idx are in: replace each block row's idx by x[idx].
template <typename T>
__device__ __forceinline__ void gather_rows(const Stage<T>& st, int cb, int ce,
                                            const T* __restrict__ x) {
  for (int b = cb + threadIdx.x; b < ce; b += kThreads) {
    T* slot = st.rows + (b - st.b_first);
    copy_elem(slot, x + *reinterpret_cast<const int*>(slot));
  }
}

// acc += column j's blocks of its stripe g (staged splits) among [cb,
// ce), in block order, from the stage.
template <typename T>
__device__ __forceinline__ T sum_staged(T acc, const Stage<T>& st, const int* m_spl,
                                        const int* m_pos, const int* m_ofs, int g, int j,
                                        int cb, int ce) {
  const int w = m_spl[g + 1] - m_spl[g];
  const int bl = max(m_pos[g], cb), bh = min(m_pos[g + 1], ce);
  const T* v = st.vals + (m_ofs[g] + (bl - m_pos[g]) * w + (j - m_spl[g]) - st.v_first);
  const T* r = st.rows + (bl - st.b_first);
#pragma unroll 4
  for (int k = 0; k < bh - bl; ++k) acc = mad(v[k * w], r[k], acc);
  return acc;
}

// The staged map: block k owns run k of the plan, whose splits (stripe,
// column, block, value) are runs[k] and runs[k + 1].  Three round trips
// to device memory, each of all the block's copies at once: the splits;
// the stage's values and block rows, the run's spl/pos/ofs and (a natural
// view) its col_out; the x of each block row and (a natural view) y_in at
// each column's place.  Then a thread a column, from shared memory.  T is
// the value type of val, x, y_in, y_out and the sums (float or double).
template <typename T>
__global__ void __launch_bounds__(kThreads)
tr_spmv_staged_kernel(const int4* __restrict__ runs, const int* __restrict__ spl,
                      const int* __restrict__ pos, const int* __restrict__ idx,
                      const int* __restrict__ ofs, const int* __restrict__ col_out,
                      const T* __restrict__ val, const T* __restrict__ x,
                      const T* y_in, T alpha, T beta, T* y_out) {
  extern __shared__ __align__(16) float smem[];  // kStageCap words, then:
  T* stage = reinterpret_cast<T*>(smem);
  int* m_spl = reinterpret_cast<int*>(smem + kStageCap);
  int* m_pos = m_spl + kRunStripes + 1;
  int* m_ofs = m_pos + kRunStripes + 1;
  int* m_out = m_spl + kMetaWords;  // the col_out window: kRunCols + 8
  T* m_y = reinterpret_cast<T*>(m_out + kRunCols + 8);  // kRunCols
  const int4 h0 = __ldg(runs + blockIdx.x), h1 = __ldg(runs + blockIdx.x + 1);
  const int s0 = h0.x, g_n = h1.x - h0.x;
  const int c0 = h0.y, c1 = h1.y, b0 = h0.z, b1 = h1.z, v0 = h0.w, v1 = h1.w;
  const unsigned long long policy = evict_first_policy();
  for (int i = threadIdx.x; i <= g_n; i += kThreads) {
    copy4(m_spl + i, spl + s0 + i);
    copy4(m_pos + i, pos + s0 + i);
    copy4(m_ofs + i, ofs + s0 + i);
  }
  if ((v1 - v0) + (b1 - b0) <= kStageElems<T>) {  // the whole run, staged once
    // a natural view's places and y_in, staged beside it
    const bool placed = col_out != nullptr && c1 - c0 <= kRunCols;
    const int o_first = placed ? copy_window(m_out, col_out, c0, c1, policy).x : 0;
    const Stage<T> st = stage_windows(stage, v0, v1, b0, b1, idx, val, policy);
    copies_done();
    gather_rows(st, b0, b1, x);
    if (placed && y_in != nullptr)
      for (int j = c0 + threadIdx.x; j < c1; j += kThreads)
        copy_elem(m_y + (j - c0), y_in + m_out[j - o_first]);
    copies_done();
    for (int j = c0 + threadIdx.x; j < c1; j += kThreads) {
      const int g = find_stripe(m_spl, g_n, j);
      const T acc = sum_staged(T(0), st, m_spl, m_pos, m_ofs, g, j, b0, b1);
      if (placed) {
        T out = alpha * acc;
        if (y_in != nullptr) out = mad(beta, m_y[j - c0], out);
        y_out[m_out[j - o_first]] = out;
      } else {
        store(acc, j, col_out, y_in, alpha, beta, y_out);
      }
    }
    return;
  }
  // one stripe whose values and block rows do not fit a stage (long,
  // wide or both): passes of kThreads columns; in each, chunks of whole
  // block rows, a chunk's columns of the pass (element copies) and its x
  // staged, each column's sum carried across the chunks
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes
  const int w = c1 - c0;
  for (int jb = c0; jb < c1; jb += kThreads) {
    const int pw = min(kThreads, c1 - jb);  // the pass's columns
    const int chunk = kStageElems<T> / (pw + 1);
    const int j = jb + threadIdx.x;
    T acc = T(0);
    for (int cb = b0; cb < b1; cb += chunk) {
      const int ce = min(cb + chunk, b1), words = (ce - cb) * pw;
      const T* src = val + v0 + static_cast<long long>(cb - b0) * w + (jb - c0);
      __syncthreads();  // the stage is free again
      for (int i = threadIdx.x; i < words; i += kThreads) {
        const int r = i / pw;  // block cb + r's value of column jb + i - r * pw
        copy_elem(stage + i, src + static_cast<long long>(r) * w + (i - r * pw));
      }
      T* rows = stage + ((words + kPer - 1) & ~(kPer - 1));
      const Stage<T> st{stage, rows, 0, stage_rows(rows, cb, ce, idx, policy)};
      copies_done();
      gather_rows(st, cb, ce, x);
      copies_done();
      if (j < c1) {
        const T* r = rows + (cb - st.b_first);
#pragma unroll 4
        for (int k = 0; k < ce - cb; ++k) acc = mad(stage[k * pw + threadIdx.x], r[k], acc);
      }
    }
    if (j < c1) store(acc, j, col_out, y_in, alpha, beta, y_out);
  }
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
    const int g = find_stripe(m_spl, g_n, j);
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

// Once a device and value type: the carve-out of shared memory that holds
// kStagedPerSM staged blocks (each its stage and the per-block reserve),
// as a share of the most an SM has, rounded up; CUDA takes the next split
// it has (on an H100 164 of 228 KB: four blocks, 92 KB of L1, in f32 and
// in f64 alike).
template <typename T>
cudaError_t carve_staged() {
  static bool carved[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && carved[dev])) return e;
  int most = 0, reserved = 0;
  if ((e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                  dev)) != cudaSuccess)
    return e;
  const long long want = static_cast<long long>(kStagedPerSM) * (kStagedSmem<T> + reserved);
  const long long share = (100 * want + most - 1) / most;
  e = cudaFuncSetAttribute(tr_spmv_staged_kernel<T>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           share < 100 ? static_cast<int>(share) : 100);
  if (e == cudaSuccess && dev < kMaxDevices) carved[dev] = true;
  return e;
}

// The staged map's launch: R blocks, one a run of `runs` (R + 1 splits,
// 16-byte aligned, else cudaErrorInvalidValue).
template <typename T>
cudaError_t launch_staged(int R, const void* runs, const int* spl, const int* pos,
                          const int* idx, const int* ofs, const int* col_out,
                          const void* val, const void* x, const void* y_in, T alpha,
                          T beta, void* y_out, cudaStream_t st) {
  if (R < 1 || !aligned16(runs)) return cudaErrorInvalidValue;
  static_assert(kStagedSmem<T> <= 48 * 1024, "above 48 KB a block needs an attribute");
  const cudaError_t carved = carve_staged<T>();
  if (carved != cudaSuccess) return carved;
  tr_spmv_staged_kernel<T><<<static_cast<unsigned>(R), kThreads, kStagedSmem<T>, st>>>(
      static_cast<const int4*>(runs), spl, pos, idx, ofs, col_out,
      static_cast<const T*>(val), static_cast<const T*>(x), static_cast<const T*>(y_in),
      alpha, beta, static_cast<T*>(y_out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  n is
// the column count, L the stripe count (spl, pos and ofs hold L + 1
// entries).  The thread map (ops/trspmv.thread_map): runs null, the
// float4 map (every stripe width a multiple of 4 and val 16-byte aligned,
// else cudaErrorInvalidValue); else the staged map, runs the R + 1 splits
// of ops/trspmv.stage_plan, each (stripe, column, block, value), 16-byte
// aligned.  y_in may be null (then beta is unused), col_out null (natural
// order; else an injection of the n columns into y_out's entries: a
// natural view's permutation, or the overlapped halo path's places of
// two formats' columns in one buffer; y_in is read at the same places).
// n > 0.
int vbcs_tr_spmv(int n, int L, int R, const void* runs, const void* spl,
                 const void* pos, const void* idx, const void* ofs,
                 const void* col_out, const void* val, const void* x,
                 const void* y_in, float alpha, float beta, void* y_out,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* i_spl = static_cast<const int*>(spl);
  const int* i_pos = static_cast<const int*>(pos);
  const int* i_idx = static_cast<const int*>(idx);
  const int* i_ofs = static_cast<const int*>(ofs);
  const int* i_out = static_cast<const int*>(col_out);
  if (runs != nullptr)
    return static_cast<int>(launch_staged<float>(R, runs, i_spl, i_pos, i_idx, i_ofs,
                                                 i_out, val, x, y_in, alpha, beta,
                                                 y_out, st));
  if (!aligned16(val)) return static_cast<int>(cudaErrorInvalidValue);
  // the stripes of about kQuadCols columns, at least one
  const long long per = static_cast<long long>(L) * kQuadCols / n;
  const int G = per < 1 ? 1 : per > kMaxGroup ? kMaxGroup : static_cast<int>(per);
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(L) + G - 1) / G);
  tr_spmv_quad_kernel<<<blocks, kThreads, 3 * (G + 1) * sizeof(int), st>>>(
      L, G, i_spl, i_pos, i_idx, i_ofs, i_out, static_cast<const float*>(val),
      static_cast<const float*>(x), static_cast<const float*>(y_in), alpha, beta,
      static_cast<float*>(y_out));
  return static_cast<int>(cudaGetLastError());
}

// The f64 stripe TrSpMV: the staged map in double (values, x, y_in, y_out,
// alpha, beta and the sums), runs those of ops/trspmv.stage_plan at the
// f64 stage (runs null: cudaErrorInvalidValue; the float4 map is f32's
// alone).  Otherwise as vbcs_tr_spmv.
int vbcs_tr_spmv_f64(int /* n */, int /* L */, int R, const void* runs,
                     const void* spl, const void* pos, const void* idx,
                     const void* ofs, const void* col_out, const void* val,
                     const void* x, const void* y_in, double alpha, double beta,
                     void* y_out, void* stream) {
  return static_cast<int>(launch_staged<double>(
      R, runs, static_cast<const int*>(spl), static_cast<const int*>(pos),
      static_cast<const int*>(idx), static_cast<const int*>(ofs),
      static_cast<const int*>(col_out), val, x, y_in, alpha, beta, y_out,
      static_cast<cudaStream_t>(stream)));
}

const char* vbcs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

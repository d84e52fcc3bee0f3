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
// Thread map: a group of G lanes (G a power of two, 32 for k >= 128) owns
// one (stripe, tile of 4*G RHS columns) pair; each lane owns 4
// consecutive RHS columns, loaded as one float4 when k % 4 == 0 and X, Y
// are 16-byte aligned (else 4 masked scalar loads).  Stripes own disjoint
// columns (the reference's stripe scheduler), so no atomics and no
// cross-block reduction are needed.  The TPU kernels' ring windows, KT
// passes, slot space and exit permutes existed only because Mosaic
// gathers inside one vreg; here X[idx[b], :] is an ordinary row load.
//
// What bounds it on this card: the X rows.  Each block value meets k RHS
// columns (2k flops per 4-byte value and per 4k-byte X row), far below the
// f32 units' rate, so the floor is (val + idx + X + Y) bytes over the
// device-memory rate; but every block reads its X row again (a flagship
// A.T pack reads 324 MB of X rows a k = 32 call for 41 MB of X), through
// its idx: two dependent loads for 4k bytes.  The slice-2 kernel walked a
// lane's blocks two at a time, so its time was that chain of round trips
// (0.13 of the bound on the A.T packs, 0.012 on a 2,608-block stripe).
// This one keeps more X rows in flight (PERF.md §6, slice 16):
//
// * Width classes.  The accumulator is kW stripe columns x 4 RHS columns,
//   kW in {1, 2, 4, 8} from VBC1DDevice.width_class (computed once on the
//   pack); a wider stripe is walked in passes of kW columns, each pass
//   re-reading the stripe's X rows.  A narrow pack so holds 4-8 registers
//   of accumulator, not the 32 of a fixed 8-column tile.
// * Batches.  A lane loads kBatch blocks' X rows together; classes 1-4
//   (and 8 on a deep pack) load each next batch's idx one batch ahead, so
//   a batch costs one round trip, not two, and whole batches run without
//   predicates.  Where every width is a multiple of 4
//   (VBC1DDevice.quad_widths) and val is 16-byte aligned, classes 4 and 8
//   read a block's values as float4s.
// * Long stripes (more than long_blocks blocks: VBC1DDevice.long_stripes,
//   the clipped rows of the generators' bands) are walked by a whole
//   thread block each, their X rows staged in shared memory by cp.async a
//   chunk at a time, launched first: a lane alone would walk 2,608 blocks
//   as one chain.
// * Y rows are written with streaming float4 stores, which leave the X
//   rows in L2.
//
// Tried and slower (PERF.md): the group's idx and values loaded by one lane
// each and shuffled; streaming loads of val and idx; X with an L2
// evict-last policy; the thread blocks an SM starts with given
// neighbouring stripes; a thread block for every stripe of more than 16-48
// blocks.
//
// Sum order (bitwise determinism): each Y[j, c] is fmaf(val, x, acc) over
// the stripe's blocks in order b0 .. b1-1 from 0, whatever the class,
// batch, pass, long path or place of the stripe in the grid: the slice-2
// kernel's order, so Y is its bits, two launches agree, and a format cut
// at stripe boundaries (dist_tr_spmm's shards) gives the whole format's
// rows.
//
// X and Y offsets are 64-bit: idx[b] * k passes 2^31 once m * k does
// (16.8M rows at k = 128).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// a long stripe's chunk: its X rows staged in shared memory, at most
// kChunkQuads float4s (32 KB) and kChunkMax blocks
constexpr int kChunkQuads = 2048;
constexpr int kChunkMax = 256;
constexpr int kLongCols = 8;  // a long stripe's columns a pass
constexpr int kChunkLoads = kChunkQuads / kThreads;

// A lane's walk of its stripe's blocks, by class: whole batches with each
// next batch's idx loaded one batch ahead ("piped": a round trip a batch),
// or the idx and values of a batch, then its X rows (two).  Class 8 pipes
// only on a deep pack (a mean of kDeepBlocks blocks a stripe or more: the
// 2-D views), four blocks a batch: on the flagship's 8 blocks a stripe the
// piped walk ran 7% slower at k = 128, on 2-D (a)'s 31.5 it ran 9% faster.
// On the scalar path (k % 4 != 0) class 8 takes one block a step, two steps
// unrolled: batches of 2 ran 6% slower at k = 130.
constexpr int kDeepBlocks = 16;
__host__ __device__ constexpr bool piped(int kW, bool deep) { return kW < 8 || deep; }
// blocks whose X rows a lane has in flight together
__host__ __device__ constexpr int batch_of(int kW, bool deep, bool vec) {
  return kW == 4 || (kW == 8 && deep) ? 4 : kW == 8 && !vec ? 1 : 2;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct Args {
  int L;
  int64_t k;
  int log2_group;     // lanes of a short stripe's group, log2
  int64_t items;      // (stripe, k-tile) items of the short map
  int long_blocks;    // a stripe of more blocks is long
  int n_long;         // long stripes
  int long_quads;     // float4 columns of a long stripe's k-tile (Q)
  int long_tiles;     // its k-tiles
  int chunk;          // its chunk, blocks (C)
  const int* long_ids;
  const int* spl;
  const int* pos;
  const int* idx;
  const int* ofs;
  const int* col_out;
  const float* val;
  const float* X;
  float* Y;
};

// Y is written once: a streaming store, which leaves the X rows, read
// again, in L2.
template <typename T>
__device__ __forceinline__ void store_once(T* p, T v) { __stcs(p, v); }

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

// A Y row's 4 columns at c0.
template <bool kVec>
__device__ __forceinline__ void store_row4(float* __restrict__ row,
                                           int64_t c0, int64_t k,
                                           const float (&a)[4]) {
  if constexpr (kVec) {
    store_once(reinterpret_cast<float4*>(row + c0),
               make_float4(a[0], a[1], a[2], a[3]));
    return;
  }
  row[c0] = a[0];  // plain: streaming stores of a part row cost 2% (k = 130)
  if (c0 + 1 < k) row[c0 + 1] = a[1];
  if (c0 + 2 < k) row[c0 + 2] = a[2];
  if (c0 + 3 < k) row[c0 + 3] = a[3];
}

// 16 bytes from device memory into shared memory without a register
// (cp.async, held in L2 only); cp_async_wait() waits for this thread's.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 x) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
  acc[2] = fmaf(a, x.z, acc[2]);
  acc[3] = fmaf(a, x.w, acc[3]);
}

// The kW values of columns g0 .. g0 + gw - 1 of one block at v (0 past gw).
template <int kW, bool kQuad>
__device__ __forceinline__ void load_vals(float (&a)[kW], const float* v,
                                          bool on, int gw) {
  if constexpr (kQuad) {
#pragma unroll
    for (int q = 0; q < kW / 4; ++q) {
      const float4 f = on && 4 * q < gw
                           ? __ldg(reinterpret_cast<const float4*>(v) + q)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      a[4 * q] = f.x;
      a[4 * q + 1] = f.y;
      a[4 * q + 2] = f.z;
      a[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kW; ++i) a[i] = on && i < gw ? __ldg(v + i) : 0.0f;
  }
}

// A short stripe: the G lanes of a group, each 4 RHS columns of all its
// stripe columns, kW at a time.  Work item = (stripe s, k-tile t) =
// (item % L, item / L): consecutive items are neighbouring stripes of one
// tile, whose X rows overlap on banded matrices and so meet in L1 and L2.
template <bool kVec, int kW, bool kQuad, bool kDeep, bool kLong>
__device__ __forceinline__ void short_stripe(const Args& p, int64_t t) {
  constexpr int kBatch = batch_of(kW, kDeep, kVec);
  const int64_t item = t >> p.log2_group;
  if (item >= p.items) return;
  const int lane = static_cast<int>(t & ((1 << p.log2_group) - 1));
  const int s = static_cast<int>(item % p.L);
  const int64_t k = p.k;
  const int64_t c0 = ((item / p.L) << (p.log2_group + 2)) + 4 * lane;
  if (c0 >= k) return;
  const int b0 = __ldg(p.pos + s);
  const int b1 = __ldg(p.pos + s + 1);
  if (kLong && b1 - b0 > p.long_blocks) return;  // a long stripe's block walks it
  const int j0 = __ldg(p.spl + s);
  const int w = __ldg(p.spl + s + 1) - j0;
  const float* vs = p.val + __ldg(p.ofs + s);
  const float* Xc = p.X + c0;
  for (int g0 = 0; g0 < w; g0 += kW) {
    const int gw = min(kW, w - g0);
    float acc[kW][4] = {};
    int b = b0;
    if constexpr (piped(kW, kDeep)) {
      int r[kBatch];  // the next batch's X rows, loaded one batch ahead
#pragma unroll
      for (int u = 0; u < kBatch; ++u) r[u] = b0 + u < b1 ? __ldg(p.idx + b0 + u) : 0;
      for (; b + kBatch <= b1; b += kBatch) {  // whole batches: no predicates
        float a[kBatch][kW];
        float4 x[kBatch];
        int next[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          x[u] = load_row4<kVec>(Xc + r[u] * k, 0, k - c0);
          load_vals<kW, kQuad>(a[u], vs + (b + u - b0) * w + g0, true, gw);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          next[u] = b + kBatch + u < b1 ? __ldg(p.idx + b + kBatch + u) : 0;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
          for (int i = 0; i < kW; ++i)
            if (i < gw) fma4(acc[i], a[u][i], x[u]);
          r[u] = next[u];
        }
      }
      if (b < b1) {  // the last, partial batch
        float a[kBatch][kW];
        float4 x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool on = b + u < b1;
          x[u] = on ? load_row4<kVec>(Xc + r[u] * k, 0, k - c0)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          load_vals<kW, kQuad>(a[u], vs + (b + u - b0) * w + g0, on, gw);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (b + u < b1) {
#pragma unroll
            for (int i = 0; i < kW; ++i)
              if (i < gw) fma4(acc[i], a[u][i], x[u]);
          }
        }
      }
    } else {
#pragma unroll(kBatch == 1 ? 2 : 1)
      for (; b < b1; b += kBatch) {
        int r[kBatch];
        float a[kBatch][kW];
        float4 x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool on = b + u < b1;
          r[u] = on ? __ldg(p.idx + b + u) : 0;
          load_vals<kW, kQuad>(a[u], vs + (b + u - b0) * w + g0, on, gw);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          x[u] = b + u < b1 ? load_row4<kVec>(Xc + r[u] * k, 0, k - c0)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (b + u < b1) {
#pragma unroll
            for (int i = 0; i < kW; ++i)
              if (i < gw) fma4(acc[i], a[u][i], x[u]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      if (i < gw) {
        const int j = j0 + g0 + i;
        const int64_t jo = p.col_out != nullptr ? __ldg(p.col_out + j) : j;
        store_row4<kVec>(p.Y + jo * k, c0, k, acc[i]);
      }
    }
  }
}

// A long stripe (more than long_blocks blocks), one k-tile of 4*Q RHS
// columns, by the whole thread block: chunk by chunk of C blocks, every
// thread loads a share of the chunk's idx and values, then of its X rows
// (up to kChunkLoads float4s each, by cp.async: all in flight together and
// no registers held) into shared memory,
// then thread (i, q) adds the chunk to column i's 4 RHS columns at q, in
// block order.  A lane alone would walk such a stripe's blocks as one
// chain of round trips (2,608 blocks on 2-D (a)'s A.T view).
template <bool kVec>
__device__ __forceinline__ void long_stripe(const Args& p, int li, int tile,
                                            float* smem) {
  const int Q = p.long_quads, C = p.chunk, tid = threadIdx.x;
  float4* xs = reinterpret_cast<float4*>(smem);  // [C][Q]
  float* vsm = smem + 4 * C * Q;                 // [C][kLongCols]
  int* ids = reinterpret_cast<int*>(vsm + kLongCols * C);
  const int64_t k = p.k;
  const int64_t c_base = static_cast<int64_t>(tile) * 4 * Q;
  const int s = __ldg(p.long_ids + li);
  const int j0 = __ldg(p.spl + s);
  const int w = __ldg(p.spl + s + 1) - j0;
  const int b0 = __ldg(p.pos + s);
  const int b1 = __ldg(p.pos + s + 1);
  const float* vs = p.val + __ldg(p.ofs + s);
  const int i = tid / Q, q = tid - (tid / Q) * Q;
  const int64_t c = c_base + 4 * q;
  for (int g0 = 0; g0 < w; g0 += kLongCols) {
    const int gw = min(kLongCols, w - g0);
    const bool mine = i < gw && c < k;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int cb = b0; cb < b1; cb += C) {
      const int n = min(C, b1 - cb);
      if (tid < n) ids[tid] = __ldg(p.idx + cb + tid);
      float v[kLongCols];
#pragma unroll
      for (int r = 0; r < kLongCols; ++r) {
        const int e = tid + r * kThreads;  // < kChunkMax * kLongCols
        const int u = e / gw;
        v[r] = u < n ? __ldg(vs + (cb - b0 + u) * w + g0 + (e - u * gw)) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kLongCols; ++r) {
        const int e = tid + r * kThreads, u = e / gw;
        if (u < n) vsm[u * kLongCols + e - u * gw] = v[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kChunkLoads; ++r) {
        const int e = tid + r * kThreads, u = e / Q;
        const int64_t cc = c_base + 4 * (e - u * Q);
        if (u < n && cc < k) {
          if constexpr (kVec) copy16(xs + e, p.X + ids[u] * k + cc);
          else xs[e] = load_row4<false>(p.X + ids[u] * k, cc, k);
        }
      }
      if constexpr (kVec) cp_async_wait();
      __syncthreads();
      if (mine)
        for (int u = 0; u < n; ++u) fma4(acc, vsm[u * kLongCols + i], xs[u * Q + q]);
      __syncthreads();
    }
    if (mine) {
      const int j = j0 + g0 + i;
      const int64_t jo = p.col_out != nullptr ? __ldg(p.col_out + j) : j;
      store_row4<kVec>(p.Y + jo * k, c, k, acc);
    }
  }
}

// With long stripes (kLong), the first n_long * long_tiles thread blocks
// take them (so that their chains start first) and the rest the short
// map; without, the kernel holds no long path (and no registers for it).
template <bool kVec, int kW, bool kQuad, bool kDeep, bool kLong>
__global__ void __launch_bounds__(kThreads)
tr_spmm_stripe_kernel(const Args p) {
  int64_t first = 0;  // the short map's first thread
  if constexpr (kLong) {
    extern __shared__ float4 smem_quads[];
    const int64_t long_ctas = static_cast<int64_t>(p.n_long) * p.long_tiles;
    if (blockIdx.x < long_ctas) {
      long_stripe<kVec>(p, blockIdx.x / p.long_tiles, blockIdx.x % p.long_tiles,
                        reinterpret_cast<float*>(smem_quads));
      return;
    }
    first = long_ctas * kThreads;
  }
  short_stripe<kVec, kW, kQuad, kDeep, kLong>(
      p, static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - first);
}

template <bool kVec, int kW, bool kQuad, bool kDeep>
void launch(unsigned blocks, size_t smem, cudaStream_t st, const Args& p) {
  if (p.n_long > 0)
    tr_spmm_stripe_kernel<kVec, kW, kQuad, kDeep, true>
        <<<blocks, kThreads, smem, st>>>(p);
  else
    tr_spmm_stripe_kernel<kVec, kW, kQuad, kDeep, false>
        <<<blocks, kThreads, 0, st>>>(p);
}

template <bool kVec, int kW, bool kQuad>
void launch_deep(bool deep, unsigned blocks, size_t smem, cudaStream_t st,
                 const Args& p) {
  if (deep) launch<kVec, kW, kQuad, true>(blocks, smem, st, p);
  else launch<kVec, kW, kQuad, false>(blocks, smem, st, p);
}

template <bool kVec>
void launch_class(int width, bool quad, bool deep, unsigned blocks, size_t smem,
                  cudaStream_t st, const Args& p) {
  switch (width) {  // the piped classes take no kDeep
    case 1: launch<kVec, 1, false, false>(blocks, smem, st, p); break;
    case 2: launch<kVec, 2, false, false>(blocks, smem, st, p); break;
    case 4:
      if (quad) launch<kVec, 4, true, false>(blocks, smem, st, p);
      else launch<kVec, 4, false, false>(blocks, smem, st, p);
      break;
    default:
      if (quad) launch_deep<kVec, 8, true>(deep, blocks, smem, st, p);
      else launch_deep<kVec, 8, false>(deep, blocks, smem, st, p);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a problem the grid cannot cover.  L >= 1
// stripes, k >= 1 RHS columns; X is [m, k] and Y is [n, k], row-major;
// col_out null (natural order) or a permutation of [0, n).  width is the
// accumulator's class, 1, 2, 4 or 8 (any stripe width is right under any
// class; VBC1DDevice.width_class picks the fastest); quads says that
// every stripe width is a multiple of 4 (float4 values where val is
// 16-byte aligned and the class is 4 or 8).  blocks_total is pos[L] (the
// walk's depth).  long_ids holds the n_long stripes of more than
// long_blocks blocks, every one of them in any order; with n_long 0 the
// lanes take every stripe.
int vbcs_tr_spmm(int L, int64_t k, int width, int quads, int64_t blocks_total,
                 int long_blocks, int n_long, const void* long_ids, const void* spl,
                 const void* pos, const void* idx, const void* ofs,
                 const void* col_out, const void* val, const void* X, void* Y,
                 void* stream) {
  if (L < 1 || k < 1 || blocks_total < 0 || n_long < 0 || long_blocks < 0 ||
      (width != 1 && width != 2 && width != 4 && width != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.L = L;
  p.k = k;
  // group of G lanes covers 4*G columns: the smallest power of two >= k/4
  p.log2_group = 0;
  while (p.log2_group < 5 && (int64_t{4} << p.log2_group) < k) ++p.log2_group;
  const int64_t tile = int64_t{4} << p.log2_group;
  p.items = static_cast<int64_t>(L) * ((k + tile - 1) / tile);
  p.long_blocks = long_blocks;
  p.n_long = n_long;
  p.long_quads = static_cast<int>(k >= 128 ? 32 : (k + 3) / 4);
  p.long_tiles = static_cast<int>((k + 4 * p.long_quads - 1) / (4 * p.long_quads));
  p.chunk = kChunkQuads / p.long_quads < kChunkMax ? kChunkQuads / p.long_quads
                                                   : kChunkMax;
  const int64_t blocks = static_cast<int64_t>(n_long) * p.long_tiles +
                         ((p.items << p.log2_group) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      n_long == 0 ? 0
                  : static_cast<size_t>(p.chunk) *
                        (16 * p.long_quads + 4 * kLongCols + 4);
  p.long_ids = static_cast<const int*>(long_ids);
  p.spl = static_cast<const int*>(spl);
  p.pos = static_cast<const int*>(pos);
  p.idx = static_cast<const int*>(idx);
  p.ofs = static_cast<const int*>(ofs);
  p.col_out = static_cast<const int*>(col_out);
  p.val = static_cast<const float*>(val);
  p.X = static_cast<const float*>(X);
  p.Y = static_cast<float*>(Y);
  const bool vec = k % 4 == 0 && aligned16(X) && aligned16(Y);
  const bool quad = quads != 0 && width >= 4 && aligned16(val);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  const bool deep = blocks_total >= static_cast<int64_t>(kDeepBlocks) * L;
  if (vec) launch_class<true>(width, quad, deep, grid, smem, st, p);
  else launch_class<false>(width, quad, deep, grid, smem, st, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

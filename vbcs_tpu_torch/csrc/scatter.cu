// Entry-tiled TrSpMV on Hopper: y = alpha * A.T @ x (+ beta * y_in), f32,
// for the unstructured packs the scatter route takes.
//
// Replaces the TPU scatter kernel vbcs_tpu/ops/pallas_scatter.py
// (_scatter_kernel, reached through tr_spmv_scatter) together with the
// gathers around it: the radix-routed entry gather z = x[row]
// (multipass.apply_multipass), the exit permute of the column totals and
// the COO spill past 64 entries per column.  Those exist because Mosaic
// cannot gather: a column's entries sat in the 8 sublanes of up to 8
// lanes of an (8, Np) buffer, summed over sublanes and then by a
// segmented lane scan.  What it computes is a CSC SpMV, with q counting
// the nonempty columns:
//
//   y[out(q)] = alpha * sum_{e in column q} val[e] * x[row[e]]
//               (+ beta * y_in[out(q)])
//
// out(q) is q's column, or perm of it on the natural view of an auto-RCM
// pack (formats/device.py: ScatterTiles.out, built from col_out), so the
// operator's gathers of x and y fold into this launch; the empty columns
// get beta * y_in (or 0).
//
// What bounds it on this card: bytes, 8 per entry (row, val) plus x, y
// and the tile words (2 bytes an entry).  At the route's sizes (5-25 MB)
// the entries sit in the 50 MB L2 between calls, and what sets the time
// is the random x gather (one 32-byte sector per entry), how many
// dependent round trips a warp waits for and how evenly the entries are
// spread over the warps: a column per lane group left most lanes one
// entry, paid colptr -> row -> x -> shuffles -> y_in one after another,
// and let one long column (328 entries on the flagship's A.T) run as a
// serial loop in one group while the grid drained.
//
// Design: work goes by entries, not columns.  The entries are cut into
// tiles of whole columns, at most TILE = 128 entries each (ScatterTiles,
// a greedy cut at pack time); a warp takes one tile and each lane E = 4
// consecutive entries, so every warp does about the same work whatever
// the column lengths.  A lane's own word places its entries, so it reads
// its rows and values at once (one 16-byte load each where the entries
// are aligned) and then issues its x loads together; meanwhile it loads
// the output places and y_in of the columns it ends: two round trips for
// the entries.  The lane sums its entries column by column; a segmented
// scan across the warp (shuffles keyed by column) hands each lane the
// partial of the column it starts in, and the lane holding a column's
// last entry stores it.  A column longer than a tile (the flagship's
// 328-entry columns, a 10,000-entry column: 79 tiles) fills tiles of its
// own and is finished without float atomics: each of its tiles stores
// its sum in a scratch slot and counts its arrival, and the last to
// arrive adds the sums in tile order.  A cut through short columns would
// need that handshake, an atomic round trip, at nearly every tile; whole
// columns keep it to the long ones.  Sums run in a fixed order, so two
// calls give bitwise-equal y.  Warps after the tiles write the empty
// columns, 32 a warp.  The arrival counts return to 0 in the call that
// used them, ready for the next one on the stream.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int E = 4;          // entries a lane (SCATTER_LANE_ENTRIES)
constexpr int TILE = 32 * E;  // entries a warp (SCATTER_TILE)
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  int n_tiles;
  int n_empty;
  const int4* tiles;       // [n_tiles]: first entry, its q, first and last
                           // tile of a column that spans several
  const long long* lanes;  // [n_tiles * 32]: first entry | q less the
                           // tile's << 32 | ends << 40 | entries << 48
  const int* row;
  const float* val;
  const int* out;    // [nonempty] output place of column q, or null: q
  const int* empty;  // [n_empty] output places of the empty columns
  int* count;        // [n_tiles] arrivals at a long column's first tile
  float* part;       // [n_tiles] each tile's sum of its long column
  const float* x;
  const float* y_in;  // may be null
  float alpha;
  float beta;
  float* y_out;
};

__device__ __forceinline__ float result(const Args& a, float acc, float y) {
  const float r = a.alpha * acc;
  return a.y_in != nullptr ? fmaf(a.beta, y, r) : r;
}

// One arrival at a counter, ordered after this thread's stores (release)
// and before its later loads (acquire): no full fence on the path.
__device__ __forceinline__ int arrive_count(int* count) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(count)
               : "memory");
  return old;
}

// A long column (output place o, y_in there y) fills tiles [ta, tb];
// tile t stores its sum and arrives; the last of the tb - ta + 1
// arrivals adds the sums in tile order.
__device__ __forceinline__ void arrive(const Args& a, int t, int ta, int tb,
                                       int o, float y, float partial) {
  a.part[t] = partial;
  if (arrive_count(a.count + ta) != tb - ta) return;
  float acc = __ldcg(a.part + ta);
  for (int s = ta + 1; s <= tb; ++s) acc += __ldcg(a.part + s);
  a.count[ta] = 0;  // for the next call: the launch boundary orders it
  a.y_out[o] = result(a, acc, y);
}

template <bool kVec>
__global__ void __launch_bounds__(THREADS) tr_spmv_scatter_kernel(Args a) {
  const int warp = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= a.n_tiles) {  // warp-uniform: the empty columns
    const long long i = static_cast<long long>(warp - a.n_tiles) * 32 + lane;
    if (i < a.n_empty) {
      const int o = __ldg(a.empty + i);
      a.y_out[o] = result(a, 0.0f, a.y_in != nullptr ? __ldg(a.y_in + o) : 0.0f);
    }
    return;
  }
  // the lane's word alone places its entries: their loads wait for
  // nothing but it
  const long long word = __ldg(a.lanes + static_cast<long long>(warp) * 32 + lane);
  const int4 tile = __ldg(a.tiles + warp);
  const long long e0 = word & 0xffffffffLL;
  const unsigned ends = static_cast<unsigned>(word >> 40) & 0xffu;
  const int nv = static_cast<int>(word >> 48) & 0xf;
  const int q0 = tile.y + (static_cast<int>(word >> 32) & 0xff);

  int r[E];
  float v[E];
  if (kVec && nv == E && (e0 & 3) == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const int4 rr = __ldg(reinterpret_cast<const int4*>(a.row + e0) + i);
      const float4 vv = __ldg(reinterpret_cast<const float4*>(a.val + e0) + i);
      r[4 * i] = rr.x; r[4 * i + 1] = rr.y; r[4 * i + 2] = rr.z; r[4 * i + 3] = rr.w;
      v[4 * i] = vv.x; v[4 * i + 1] = vv.y; v[4 * i + 2] = vv.z; v[4 * i + 3] = vv.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      r[k] = k < nv ? __ldg(a.row + e0 + k) : 0;
      v[k] = k < nv ? __ldg(a.val + e0 + k) : 0.0f;
    }
  }
  // the places and y_in of the columns this lane ends, and of the tile's
  // last column if it goes on into the next tile, beside the x loads
  int o[E];
  float yv[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int q = q0 + __popc(ends & ((1u << k) - 1u));
    const bool end = k < nv && ((ends >> k) & 1u);
    o[k] = end && a.out != nullptr ? __ldg(a.out + q) : q;
    yv[k] = end && a.y_in != nullptr ? __ldg(a.y_in + o[k]) : 0.0f;
  }
  const int key = nv > 0 ? q0 + __popc(ends) : -1;
  const int nv_next = __shfl_down_sync(FULL, nv, 1);
  const bool last_lane = nv > 0 && (lane == 31 || nv_next == 0);
  const bool open = last_lane && !((ends >> (nv - 1)) & 1u);
  const int o_open = open && a.out != nullptr ? __ldg(a.out + key) : key;
  const float y_open = open && a.y_in != nullptr ? __ldg(a.y_in + o_open) : 0.0f;
  float p[E];
#pragma unroll
  for (int k = 0; k < E; ++k) p[k] = k < nv ? v[k] * __ldg(a.x + r[k]) : 0.0f;

  // the lane's open tail (entries after its last column end), keyed by
  // its column; the warp's segmented inclusive scan of the tails
  float tail = 0.0f;
#pragma unroll
  for (int k = 0; k < E; ++k) tail = ((ends >> k) & 1u) ? 0.0f : tail + p[k];
  float s = tail;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float so = __shfl_up_sync(FULL, s, off);
    const int ko = __shfl_up_sync(FULL, key, off);
    if (lane >= off && ko == key) s += so;
  }
  // the lane before ends on the column this lane starts on (or on the one
  // before it, with an empty tail): its scan is this lane's carry
  float acc = __shfl_up_sync(FULL, s, 1);
  if (lane == 0) acc = 0.0f;
  const bool long_column = tile.z != tile.w;  // warp-uniform

#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (k < nv) {
      acc += p[k];
      if ((ends >> k) & 1u) {
        if (long_column) {
          arrive(a, warp, tile.z, tile.w, o[k], yv[k], acc);
        } else {
          a.y_out[o[k]] = result(a, acc, yv[k]);
        }
        acc = 0.0f;
      }
    }
  }
  // a long column's tile before its last: the sum is the last lane's scan
  if (open) arrive(a, warp, tile.z, tile.w, o_open, y_open, s);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a grid past 2^31 - 1 blocks.  The arrays are
// those of ScatterTiles (formats/device.py); scratch is its [2 * n_tiles]
// int32 buffer, zero between calls.  out_col may be null (column q goes
// to q), y_in may be null (then beta is unused).
int vbcs_tr_spmv_scatter(int n_tiles, int n_empty, const void* tiles,
                         const void* lanes, const void* row,
                         const void* val, const void* out_col,
                         const void* empty_col, void* scratch, const void* x,
                         const void* y_in, float alpha, float beta, void* y_out,
                         void* stream) {
  Args a;
  a.n_tiles = n_tiles;
  a.n_empty = n_empty;
  a.tiles = static_cast<const int4*>(tiles);
  a.lanes = static_cast<const long long*>(lanes);
  a.row = static_cast<const int*>(row);
  a.val = static_cast<const float*>(val);
  a.out = static_cast<const int*>(out_col);
  a.empty = static_cast<const int*>(empty_col);
  a.count = static_cast<int*>(scratch);
  a.part = reinterpret_cast<float*>(a.count + n_tiles);
  a.x = static_cast<const float*>(x);
  a.y_in = static_cast<const float*>(y_in);
  a.alpha = alpha;
  a.beta = beta;
  a.y_out = static_cast<float*>(y_out);
  const long long warps = n_tiles + (n_empty + 31LL) / 32;
  const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(row) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(val) % 16 == 0;
  if (vec) {
    tr_spmv_scatter_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(a);
  } else {
    tr_spmv_scatter_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

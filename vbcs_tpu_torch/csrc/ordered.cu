// Ordered scatter on Hopper: Y = alpha * A @ X (+ beta * Y_in) from A's own
// column pack, f32, X [n, k] and Y [m, k] row-major (a vector is k = 1).
//
// Replaces no TPU kernel.  The JAX package computes A @ X as (A.T).T @ X on
// the pack of A.T (vbcs_tpu/operator.py mul_mat, the SpMM kernels csrc/spmm.cu
// ports), which reads one X row for every block of that pack: on blocky_w8's
// relabeled A.T pack, 38.1M blocks, 4.88 GB of X rows a k = 32 call for an X
// of 0.655 GB, and the gather kernel was at 75% of the card's rate on that
// traffic (PERF.md §6).  On A's own pack each stripe's w columns are w rows of
// X, read once, and each of its blocks, a 1 x w row slice of A, gives one
// whole row of products P_b = sum_i val[b, i] * X[col_i, :] for one row of Y.
// What bounds it: bytes, X once, the values and maps once, Y once, and twice
// the rows of products that share a row of Y (written, then read back).
//
// A row of Y that several blocks meet is a sum across stripes, and thread
// blocks run in no order, so it takes a second launch (no float atomics):
//
// * products (vbcs_ordered_products): a group of G lanes owns one (stripe,
//   tile of 4G RHS columns) pair, each lane 4 columns (a float4 where
//   k % 4 == 0 and the operands sit on 16 bytes).  It loads the stripe's
//   w <= kMaxW X rows once into registers (through col_out on a natural
//   view), then for kBatch blocks at a time loads their values (float4s
//   where every width is a multiple of 4) and dest, sums each P_b over
//   i = 0 .. w-1 by fmaf from 0, and stores it whole: to Y as
//   alpha * P_b (+ beta * Y_in) where dest[b] >= 0 (the block is its row's
//   only one), else to slot -dest[b] - 1 of the partial buffer.  A wider
//   stripe reads its X rows again for each block.  Stripes of more than
//   long_blocks blocks (VBC1DDevice.long_stripes) are walked by a whole
//   thread block each, its groups taking every (256 / G)-th block.  The
//   kernel is held to 80 registers, three thread blocks an SM.
// * rows (vbcs_ordered_rows): a group owns one (row, tile); a row with slots
//   loads them kRowBatch at a time and sums them in slot order, which is
//   its blocks' stripe order (acc = the first, then acc += each next), and
//   stores alpha * acc (+ beta * Y_in); an empty row stores 0 (+ beta *
//   Y_in); a row of one block is done.
//
// Below k = 8 a row of Y is narrower than a 32-byte sector, and a store of
// it at a random row costs the sector (the card's memory writes whole ECC
// sectors: a partial one is read, merged and written back).  There the
// launches run *by block*: the products launch writes block b's row to
// slot b (dest null), in block order, whole sectors, and the rows launch
// sums every row's blocks through the row -> blocks map (blk, formats/
// device.py RowBlocks), the same order, so Y is bitwise the same as by
// slot; each row of Y is written once, in row order.
//
// The maps (formats/device.py OrderedMaps) are built once with the pack,
// the row -> blocks map on the first call below k = 8.
// Every sum has one order, whatever the grid, the path or the batch, so Y
// is bitwise the same on every call.  X, Y and slot offsets are 64-bit.
//
// On blocky_w8's pack at k = 32 (PERF.md §6; an H100 80GB HBM3 at
// 700 W): products 688 us, rows 385 us, 2.35 GB a call at 2.2 TB/s.
// Tried and slower there: 99-120 registers, two thread blocks an SM
// (products 790 us); four (64 registers, 836); kBatch 8 (759-1,229); the
// group's lanes loading a block's values and dest each and shuffling them
// (743-848); a row's slots loaded one after another past the first four
// (rows 526) or four at a time (414); two or four rows a group (399, 411
// against 389); below k = 32, 8 / G groups sharing a stripe (k = 1: 365
// against 356 us); a batch's Y_in rows loaded before its stores (k = 1
// with beta: 539 against 501 us).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxW = 8;    // stripe columns whose X rows a lane holds
constexpr int kBatch = 4;   // blocks whose loads a lane issues together
constexpr int kRowBatch = 2;  // slots a lane of the rows launch loads together

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__host__ __device__ __forceinline__ int group_log2(int64_t k) {
  int g = 0;  // the smallest power of two of lanes whose 4 columns cover k, at most 32
  while (g < 5 && (int64_t{4} << g) < k) ++g;
  return g;
}

struct Products {
  int L;
  int64_t k;
  int log2_group;
  int64_t items;    // (stripe, k-tile) items of the short map
  int tiles;        // k-tiles
  int long_blocks;  // a stripe of more blocks is long
  int n_long;
  const int* long_ids;
  const int* spl;
  const int* pos;
  const int* ofs;
  const int* col_out;  // X row of stripe column j (null: j)
  const int* dest;  // null: block b's row goes to slot b (by block, kByBlock)
  const float* val;
  const float* X;
  const float* y_in;  // null: no beta term
  float alpha;
  float beta;
  float* Y;
  float* part;
};

struct Rows {
  int m;
  int64_t k;
  int log2_group;
  int64_t items;  // (row, k-tile) items
  const int* row_ptr;
  const int* blk;  // null: a row's slots are part's rows lo .. hi-1; else blk[lo .. hi-1]
  const float* part;
  const float* y_in;
  float alpha;
  float beta;
  float* Y;
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

// 4 columns at c0 of a row (c0 < k); the scalar path masks those past k.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int64_t c0,
                                        int64_t k) {
  if constexpr (kVec) return __ldg(reinterpret_cast<const float4*>(row + c0));
  float4 v;
  v.x = __ldg(row + c0);
  v.y = c0 + 1 < k ? __ldg(row + c0 + 1) : 0.0f;
  v.z = c0 + 2 < k ? __ldg(row + c0 + 2) : 0.0f;
  v.w = c0 + 3 < k ? __ldg(row + c0 + 3) : 0.0f;
  return v;
}

// The same, for a row read once (the partial buffer): a streaming load.
template <bool kVec>
__device__ __forceinline__ float4 load4_once(const float* row, int64_t c0, int64_t k) {
  if constexpr (kVec) return __ldcs(reinterpret_cast<const float4*>(row + c0));
  float4 v;
  v.x = __ldcs(row + c0);
  v.y = c0 + 1 < k ? __ldcs(row + c0 + 1) : 0.0f;
  v.z = c0 + 2 < k ? __ldcs(row + c0 + 2) : 0.0f;
  v.w = c0 + 3 < k ? __ldcs(row + c0 + 3) : 0.0f;
  return v;
}

// A row written once (Y, a slot): streaming float4 stores; the scalar
// path's part rows (k = 1: a 4-byte value at a random row) stay in L2
// with plain stores (2% faster at k = 1; streaming and plain tie at 32).
template <bool kVec>
__device__ __forceinline__ void store4(float* row, int64_t c0, int64_t k, float4 v) {
  if constexpr (kVec) {
    __stcs(reinterpret_cast<float4*>(row + c0), v);
    return;
  }
  row[c0] = v.x;
  if (c0 + 1 < k) row[c0 + 1] = v.y;
  if (c0 + 2 < k) row[c0 + 2] = v.z;
  if (c0 + 3 < k) row[c0 + 3] = v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, float4 x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// alpha * acc (+ beta * y_in at the row's columns), stored to the row of Y.
template <bool kVec>
__device__ __forceinline__ void store_y(const float* y_in, float alpha, float beta,
                                        float* Y, int64_t r, int64_t c0, int64_t k,
                                        float4 acc) {
  float4 out = make_float4(alpha * acc.x, alpha * acc.y, alpha * acc.z, alpha * acc.w);
  if (y_in != nullptr) {
    const float4 y = load4<kVec>(y_in + r * k, c0, k);
    out = make_float4(fmaf(beta, y.x, out.x), fmaf(beta, y.y, out.y),
                      fmaf(beta, y.z, out.z), fmaf(beta, y.w, out.w));
  }
  store4<kVec>(Y + r * k, c0, k, out);
}

// A block's product row goes to Y (dest >= 0) or to its slot; by block
// with plain stores, which keep the slots in L2 for the rows launch.
template <bool kVec, bool kByBlock>
__device__ __forceinline__ void emit(const Products& p, int d, int64_t c0, float4 acc) {
  if (d >= 0) {
    store_y<kVec>(p.y_in, p.alpha, p.beta, p.Y, d, c0, p.k, acc);
    return;
  }
  float* row = p.part + static_cast<int64_t>(-d - 1) * p.k;
  if constexpr (kVec && kByBlock) *reinterpret_cast<float4*>(row + c0) = acc;
  else store4<kVec>(row, c0, p.k, acc);
}

// The kMaxW values of one block at v, 0 past w (a float4 each 4 with kQuad).
template <bool kQuad>
__device__ __forceinline__ void load_vals(float (&a)[kMaxW], const float* v, bool on,
                                          int w) {
  if constexpr (kQuad) {
#pragma unroll
    for (int q = 0; q < kMaxW / 4; ++q) {
      const float4 f = on && 4 * q < w ? __ldg(reinterpret_cast<const float4*>(v) + q)
                                       : zero4();
      a[4 * q] = f.x;
      a[4 * q + 1] = f.y;
      a[4 * q + 2] = f.z;
      a[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxW; ++i) a[i] = on && i < w ? __ldg(v + i) : 0.0f;
  }
}

// Block b's destination: dest[b], or slot b by block (a template
// argument, so the path by slot compiles as if there were no other).
template <bool kByBlock>
__device__ __forceinline__ int dest_of(const Products& p, int b) {
  if constexpr (kByBlock) return -b - 1;
  else return __ldg(p.dest + b);
}

__device__ __forceinline__ int x_row(const Products& p, int j) {
  return p.col_out != nullptr ? __ldg(p.col_out + j) : j;
}

// Blocks first, first + stride, ... of stripe s at the lane's 4 columns.
template <bool kVec, bool kQuad, bool kByBlock>
__device__ __forceinline__ void walk(const Products& p, int s, int64_t c0, int first,
                                     int stride) {
  const int64_t k = p.k;
  const int j0 = __ldg(p.spl + s);
  const int w = __ldg(p.spl + s + 1) - j0;
  const int b0 = __ldg(p.pos + s);
  const int b1 = __ldg(p.pos + s + 1);
  const float* vs = p.val + __ldg(p.ofs + s);
  if (w > kMaxW) {  // a wide stripe: its X rows again for each block
    for (int b = b0 + first; b < b1; b += stride) {
      const float* v = vs + static_cast<int64_t>(b - b0) * w;
      float4 acc = zero4();
      for (int i = 0; i < w; ++i)
        fma4(acc, __ldg(v + i), load4<kVec>(p.X + x_row(p, j0 + i) * k, c0, k));
      emit<kVec, kByBlock>(p, dest_of<kByBlock>(p, b), c0, acc);
    }
    return;
  }
  float4 x[kMaxW];
#pragma unroll
  for (int i = 0; i < kMaxW; ++i)
    x[i] = i < w ? load4<kVec>(p.X + static_cast<int64_t>(x_row(p, j0 + i)) * k, c0, k)
                 : zero4();
  for (int b = b0 + first; b < b1; b += kBatch * stride) {
    float a[kBatch][kMaxW];
    int d[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int bu = b + u * stride;
      const bool on = bu < b1;
      d[u] = on ? dest_of<kByBlock>(p, bu) : 0;
      load_vals<kQuad>(a[u], vs + static_cast<int64_t>(bu - b0) * w, on, w);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (b + u * stride < b1) {
        float4 acc = zero4();
#pragma unroll
        for (int i = 0; i < kMaxW; ++i)
          if (i < w) fma4(acc, a[u][i], x[i]);
        emit<kVec, kByBlock>(p, d[u], c0, acc);
      }
    }
  }
}

// With long stripes (kLong), the first n_long * tiles thread blocks take
// them, the rest the short map, which skips them.
template <bool kVec, bool kQuad, bool kLong, bool kByBlock>
__global__ void __launch_bounds__(kThreads, 3) ordered_products_kernel(const Products p) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int group = 1 << p.log2_group;
  if constexpr (kLong) {
    const int64_t long_ctas = static_cast<int64_t>(p.n_long) * p.tiles;
    if (blockIdx.x < long_ctas) {
      const int s = __ldg(p.long_ids + blockIdx.x / p.tiles);
      const int64_t tile = blockIdx.x % p.tiles;
      const int lane = threadIdx.x & (group - 1);
      const int64_t c0 = (tile << (p.log2_group + 2)) + 4 * lane;
      if (c0 < p.k)
        walk<kVec, kQuad, kByBlock>(p, s, c0, threadIdx.x >> p.log2_group,
                                    kThreads >> p.log2_group);
      return;
    }
    t -= long_ctas * kThreads;
  }
  const int64_t item = t >> p.log2_group;
  if (item >= p.items) return;
  const int lane = static_cast<int>(t & (group - 1));
  const int s = static_cast<int>(item % p.L);
  const int64_t c0 = ((item / p.L) << (p.log2_group + 2)) + 4 * lane;
  if (c0 >= p.k) return;
  if (kLong && __ldg(p.pos + s + 1) - __ldg(p.pos + s) > p.long_blocks) return;
  walk<kVec, kQuad, kByBlock>(p, s, c0, 0, 1);
}

__device__ __forceinline__ int slot_start(int v) { return v >= 0 ? v : -v - 1; }

template <bool kVec, bool kByBlock>
__global__ void __launch_bounds__(kThreads) ordered_rows_kernel(const Rows p) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t item = t >> p.log2_group;
  if (item >= p.items) return;
  const int lane = static_cast<int>(t & ((1 << p.log2_group) - 1));
  const int r = static_cast<int>(item % p.m);
  const int64_t k = p.k;
  const int64_t c0 = ((item / p.m) << (p.log2_group + 2)) + 4 * lane;
  if (c0 >= k) return;
  const int lo = __ldg(p.row_ptr + r);
  if (lo < 0) return;  // a row of one block: the products launch wrote it
  const int hi = slot_start(__ldg(p.row_ptr + r + 1));
  // kRowBatch slots' loads in flight at once (most rows have 2-3), each
  // added in slot order after the first: an empty row sums to 0
  float4 acc = zero4();
  for (int s = lo; s < hi; s += kRowBatch) {
    float4 v[kRowBatch];
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
      const int slot = !kByBlock || s + u >= hi ? s + u : __ldg(p.blk + s + u);
      v[u] = s + u < hi ? load4_once<kVec>(p.part + static_cast<int64_t>(slot) * k, c0, k)
                        : zero4();
    }
    if (s == lo) acc = v[0];
    else add4(acc, v[0]);
#pragma unroll
    for (int u = 1; u < kRowBatch; ++u)
      if (s + u < hi) add4(acc, v[u]);
  }
  store_y<kVec>(p.y_in, p.alpha, p.beta, p.Y, r, c0, k, acc);
}

template <bool kVec, bool kQuad, bool kByBlock>
void launch_products(unsigned blocks, cudaStream_t st, const Products& p) {
  if (p.n_long > 0)
    ordered_products_kernel<kVec, kQuad, true, kByBlock><<<blocks, kThreads, 0, st>>>(p);
  else
    ordered_products_kernel<kVec, kQuad, false, kByBlock><<<blocks, kThreads, 0, st>>>(p);
}

template <bool kByBlock>
void dispatch_products(bool vec, bool quad, unsigned blocks, cudaStream_t st,
                       const Products& p) {
  if (vec) {
    if (quad) launch_products<true, true, kByBlock>(blocks, st, p);
    else launch_products<true, false, kByBlock>(blocks, st, p);
  } else {
    if (quad) launch_products<false, true, kByBlock>(blocks, st, p);
    else launch_products<false, false, kByBlock>(blocks, st, p);
  }
}

template <bool kVec>
void launch_rows(unsigned blocks, cudaStream_t st, const Rows& p) {
  if (p.blk != nullptr) ordered_rows_kernel<kVec, true><<<blocks, kThreads, 0, st>>>(p);
  else ordered_rows_kernel<kVec, false><<<blocks, kThreads, 0, st>>>(p);
}

}  // namespace

extern "C" {

// Launch 1 on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a problem the grid cannot cover.  L >= 1 stripes
// of a pack of A (m x n), k >= 1; X is [n, k], Y and y_in (null: no beta
// term) [m, k]; col_out null (natural order) or the X row of each stripe
// column; dest (null: by block, slot b for block b) and long_ids as
// formats/device.py makes them; part holds a row of k floats a slot.  quads says that every stripe width is a multiple
// of 4.
int vbcs_ordered_products(int L, int64_t k, int quads, int long_blocks, int n_long,
                          const void* long_ids, const void* spl, const void* pos,
                          const void* ofs, const void* col_out, const void* dest,
                          const void* val, const void* X, const void* y_in, float alpha,
                          float beta, void* Y, void* part, void* stream) {
  if (L < 1 || k < 1 || n_long < 0 || long_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Products p;
  p.L = L;
  p.k = k;
  p.log2_group = group_log2(k);
  const int64_t tile = int64_t{4} << p.log2_group;
  p.tiles = static_cast<int>((k + tile - 1) / tile);
  p.items = static_cast<int64_t>(L) * p.tiles;
  p.long_blocks = long_blocks;
  p.n_long = n_long;
  const int64_t blocks = static_cast<int64_t>(n_long) * p.tiles +
                         ((p.items << p.log2_group) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.long_ids = static_cast<const int*>(long_ids);
  p.spl = static_cast<const int*>(spl);
  p.pos = static_cast<const int*>(pos);
  p.ofs = static_cast<const int*>(ofs);
  p.col_out = static_cast<const int*>(col_out);
  p.dest = static_cast<const int*>(dest);
  p.val = static_cast<const float*>(val);
  p.X = static_cast<const float*>(X);
  p.y_in = static_cast<const float*>(y_in);
  p.alpha = alpha;
  p.beta = beta;
  p.Y = static_cast<float*>(Y);
  p.part = static_cast<float*>(part);
  const bool vec = k % 4 == 0 && aligned16(X) && aligned16(Y) && aligned16(part) &&
                   aligned16(y_in);
  const bool quad = quads != 0 && aligned16(val);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  if (p.dest == nullptr) dispatch_products<true>(vec, quad, grid, st, p);
  else dispatch_products<false>(vec, quad, grid, st, p);
  return static_cast<int>(cudaGetLastError());
}

// Launch 2 on `stream`, after launch 1 on the same stream: the rows of Y
// with no block or several (row_ptr as formats/device.py OrderedMaps makes
// it, blk null), or by block every row (row_ptr and blk as RowBlocks).
int vbcs_ordered_rows(int m, int64_t k, const void* row_ptr, const void* blk,
                      const void* part, const void* y_in, float alpha, float beta,
                      void* Y, void* stream) {
  if (m < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  Rows p;
  p.m = m;
  p.k = k;
  p.log2_group = group_log2(k);
  const int64_t tile = int64_t{4} << p.log2_group;
  p.items = static_cast<int64_t>(m) * ((k + tile - 1) / tile);
  const int64_t blocks = ((p.items << p.log2_group) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.blk = static_cast<const int*>(blk);
  p.part = static_cast<const float*>(part);
  p.y_in = static_cast<const float*>(y_in);
  p.alpha = alpha;
  p.beta = beta;
  p.Y = static_cast<float*>(Y);
  const bool vec = k % 4 == 0 && aligned16(part) && aligned16(Y) && aligned16(y_in);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  if (vec) launch_rows<true>(grid, st, p);
  else launch_rows<false>(grid, st, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

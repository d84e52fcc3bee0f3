// The split-point DP's recurrence as a parallel (min,+) scan, in f64:
//
//   opt[jp] = min_{1 <= w <= W} opt[jp - w] + S[jp - 1, w - 1]   (opt[<0] = inf)
//
// Replaces vbcs_tpu/plan/jax_dp.py's lax.scan (dp_partition_jax :54 and
// dp_partition_jax_2d :155; not a Pallas kernel) beside csrc/dp.cu's serial
// kernel, for exact cost tables only: the wrapper (ops/dp.py) routes here
// when every finite entry of S is a multiple of 2^-e and n * max|S| <
// 2^(52 - e) (ops/dp.exact_tables), so that every sum along every path is
// exact in f64 and any grouping of the sums gives the serial fold's bits.
//
// The recurrence is linear in the (min,+) semiring over the state v_j =
// (opt[j], opt[j - 1], ..., opt[j - We + 1]), We = min(W, n): one row of S
// is a We x We transfer matrix.  Matrices are stored column-major, entry
// (i, k) at k * We + i: out[i] = min_k M(i, k) + in[k].
//
// * vbcs_dp_scan pass 1 (dp_scan_chunks): chunks of L rows, B chunks a
//   block.  Lane k of a chunk runs the chunk's L steps from the unit start
//   e_k (0 in slot k, inf elsewhere) over a ring of its last We values; at
//   the end its ring is column k of the chunk's transfer matrix M_c.  All
//   chunks at once; the S rows are staged in shared memory a slab of
//   kSlabRows rows at a time with cp.async, double-buffered.  Then the block
//   scans its chunks' matrices (Hillis-Steele: log2 B rounds, Q_c <- Q_c (x)
//   Q_{c-d}) into the prefix products Q_c = M_c (x) ... (x) M_first; the
//   last is the block's aggregate.
// * pass 2 (dp_scan_replay): block b walks one (min,+) chain of
//   matrix-vector products from v_0 = (0, inf, ...) over the aggregates of
//   the blocks before it (one warp, the vector in registers, the matrices
//   through shared memory in tiles, double-buffered with cp.async): the
//   start of its first chunk.  Each chunk's start is then one product with
//   its prefix Q_{c-1}, all at once.  Then one thread a chunk replays its L
//   rows from its start vector, the rows staged as in pass 1, and writes
//   opt and prev: the smallest w whose candidate is the minimum, jp - 1
//   when all are inf (the host's strict < over ascending w).
//
// The dependent path: L steps (pass 1), log2 B rounds, a chain of nb - 1
// matrix-vector products (the blocks, n / (L B) of them), one product, L
// steps; no chain over the n / L chunks.  Work: n * We^2 adds and mins in
// pass 1 against n * We for the serial fold.  Bound: the bytes of S (read
// once), opt and prev; the card's f64 rate is far off.  No tensor-core
// instruction computes a (min,+) product, so the adds and mins run on the
// f64 units.
//
// We <= kSmallW: a kernel for each power of two Wp >= We, its candidate
// loops unrolled (the loads issued together, the minima a tree), the rows
// padded to Wp candidates with +inf, the rings in registers, the staged
// rows and the matrices in shared memory; a padded candidate is inf and
// changes no sum or minimum, so the result is the unpadded scan's.  Wider
// (We > 16, the ring past what registers hold): rings and
// matrices in a device-memory scratch, rows read in place, loops over We
// (a slow path for widths no planner uses).  Every add is __dadd_rn of the
// same two operands as in the plain version (ops/dp.py
// dp_recurrence_scan_plain), which follows the same chunks, blocks and
// order of products, so kernel and plain version agree bit for bit on any
// finite S, exact or not.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;        // L for We <= kRows; L = We above
constexpr int kThreads = 512;    // a block
constexpr int kMaxChunks = 128;  // B <= kMaxChunks
constexpr int kSmallW = 16;      // the unrolled kernels, a lane's ring in registers
constexpr int kSlabRows = 8;     // rows of a chunk staged at a time
constexpr int kTileBytes = 16 * 1024;  // aggregates staged at a time (pass 2)

struct Layout {
  int We, Wp, L, B;  // Wp: a power of two >= We (small path), else We
  int64_t K, nb;
  bool small;
};

// Wp lanes a chunk, kThreads lanes a block
Layout layout(int64_t n, int W) {
  Layout s;
  s.We = static_cast<int>(n < W ? n : W);
  s.small = s.We <= kSmallW;
  s.Wp = 1;
  while (s.small && s.Wp < s.We) s.Wp *= 2;
  if (!s.small) s.Wp = s.We;
  s.L = s.We > kRows ? s.We : kRows;
  s.K = (n + s.L - 1) / s.L;
  const int b = kThreads / s.Wp;
  s.B = b < 1 ? 1 : (b > kMaxChunks ? kMaxChunks : b);
  s.nb = (s.K + s.B - 1) / s.B;
  return s;
}

// doubles of a chunk's staged slab: kSlabRows rows of Wp and one pad, so
// that the chunks of a warp read their rows from different banks
__host__ __device__ inline int slab_stride(int Wp) { return kSlabRows * Wp + 1; }

__host__ __device__ inline int tile_mats(int We) {
  const int t = kTileBytes / (We * We * static_cast<int>(sizeof(double)));
  return t < 1 ? 1 : t;
}

size_t chunks_smem(const Layout& s) {
  if (!s.small) return 0;
  return sizeof(double) * (2 * static_cast<size_t>(s.B) * s.Wp * s.Wp +
                           2 * s.B * slab_stride(s.Wp));
}

size_t replay_smem(const Layout& s) {
  const size_t vec = sizeof(double) * (2 * s.We + static_cast<size_t>(s.B) * s.We);
  if (!s.small) return vec;
  return vec + sizeof(double) * (2 * tile_mats(s.We) * s.We * s.We +
                                 2 * s.B * slab_stride(s.Wp));
}

// device-memory scratch of the wide path, in doubles a block
__host__ __device__ inline int64_t chunks_scratch(const Layout& s) {
  return s.small ? 0 : 3 * static_cast<int64_t>(s.B) * s.We * s.We;
}
__host__ __device__ inline int64_t replay_scratch(const Layout& s) {
  return s.small ? 0 : static_cast<int64_t>(s.B) * s.We;
}

__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }

// min of c[0 .. N), a tree
template <int N>
__device__ __forceinline__ double tree_min(const double* c) {
  if constexpr (N == 1) {
    return c[0];
  } else {
    return dmin(tree_min<N / 2>(c), tree_min<N - N / 2>(c + N / 2));
  }
}

// (min, its smallest index) of c[0 .. N) with indices i0 .., a tree that
// keeps the left (smaller) index on ties
template <int N>
__device__ __forceinline__ void tree_argmin(const double* c, int i0, double& v,
                                            int& at) {
  if constexpr (N == 1) {
    v = c[0];
    at = i0;
  } else {
    double v1, v2;
    int a1, a2;
    tree_argmin<N / 2>(c, i0, v1, a1);
    tree_argmin<N - N / 2>(c + N / 2, i0 + N / 2, v2, a2);
    const bool right = v2 < v1;
    v = right ? v2 : v1;
    at = right ? a2 : a1;
  }
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [t0, t0 + kSlabRows) of each of the block's nc chunks (c0 on) into
// dst: chunk cl's row t0 + u at dst + cl * slab_stride + u * Wp, candidate
// w - 1 < We from S, +inf past We
template <int Wp>
__device__ __forceinline__ void stage_slab(const double* __restrict__ S,
                                          int64_t n, int W, int We, int L,
                                          int64_t c0, int nc, int t0,
                                          double* dst) {
  constexpr int per = kSlabRows * Wp;
  for (int e = threadIdx.x; e < nc * per; e += blockDim.x) {
    const int cl = e / per;
    const int u = (e % per) / Wp;
    const int w = e % Wp;
    const int t = t0 + u;
    const int64_t r = (c0 + cl) * L + t;
    double* d = dst + cl * slab_stride(Wp) + u * Wp + w;
    if (w >= We)
      *d = CUDART_INF;
    else if (t < L && r < n)
      cp_async8(d, S + r * W + w);
  }
  cp_commit();
}

// the slab loop of both passes: rows staged kSlabRows at a time, double-
// buffered; body(t, slab) for each t (the chunk's row t) in order, every
// thread of the block
template <int Wp, typename Body>
__device__ __forceinline__ void over_slabs(const double* __restrict__ S,
                                          int64_t n, int W, int We, int L,
                                          int B, int64_t c0, int nc,
                                          double* slab, Body body) {
  const int per = B * slab_stride(Wp);
  const int slabs = (L + kSlabRows - 1) / kSlabRows;
  stage_slab<Wp>(S, n, W, We, L, c0, nc, 0, slab);
  for (int q = 0; q < slabs; ++q) {
    if (q + 1 < slabs) {
      stage_slab<Wp>(S, n, W, We, L, c0, nc, (q + 1) * kSlabRows,
                     slab + ((q + 1) & 1) * per);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const double* cur = slab + (q & 1) * per;
    const int t1 = (q + 1) * kSlabRows < L ? (q + 1) * kSlabRows : L;
    for (int t = q * kSlabRows; t < t1; ++t) body(t, cur + (t - q * kSlabRows) * Wp);
    __syncthreads();
  }
}

// The block's prefix products over its nc chunk matrices, Hillis-Steele:
// for d = 1, 2, 4, ...: X_c <- X_c (x) X_{c-d} for c >= d, (A (x) B)(i, k)
// = min_m A(i, m) + B(m, k); X holds nc matrices of D x D row-major (D =
// Wp > 0, the loop unrolled; Wp == 0: D = We, a loop), Y as large.  Returns
// the buffer that holds the result.
template <int Wp>
__device__ __forceinline__ double* prefix_products(double* X, double* Y, int nc,
                                                   int We) {
  const int D = Wp > 0 ? Wp : We;
  const int DD = D * D;
  for (int d = 1; d < nc; d *= 2) {
    for (int e = threadIdx.x; e < nc * DD; e += blockDim.x) {
      const int c = e / DD;
      if (c < d) {
        Y[e] = X[e];
        continue;
      }
      const int i = (e % DD) / D, k = e % D;
      const double* A = X + c * DD + i * D;
      const double* Bm = X + (c - d) * DD + k;
      if constexpr (Wp > 0) {
        double t[Wp];
#pragma unroll
        for (int m = 0; m < Wp; ++m) t[m] = __dadd_rn(A[m], Bm[m * Wp]);
        Y[e] = tree_min<Wp>(t);
      } else {
        double best = CUDART_INF;
        for (int m = 0; m < D; ++m) best = dmin(best, __dadd_rn(A[m], Bm[m * D]));
        Y[e] = best;
      }
    }
    __syncthreads();
    double* t = X;
    X = Y;
    Y = t;
  }
  return X;
}

// ---- pass 1: each chunk's transfer matrix, each block's prefix products ----

// Wp lanes a chunk (lanes k >= We start from a slot no candidate reads and
// stay inf), each lane's ring in registers: o[j] = position t - j, shifted
// each step
template <int Wp>
__global__ void __launch_bounds__(kThreads)
dp_scan_chunks(int64_t n, int W, Layout s, const double* __restrict__ S,
               double* __restrict__ Q) {
  extern __shared__ __align__(16) double smem[];
  const int We = s.We, L = s.L;
  const int64_t blk = blockIdx.x;
  const int64_t c0 = blk * s.B;
  const int nc = static_cast<int>(s.K - c0 < s.B ? s.K - c0 : s.B);
  const int NL = s.B * Wp;
  const int tid = threadIdx.x;
  double* Y = smem;
  double* X = Y + NL * Wp;
  double* slab = X + NL * Wp;
  const double inf = CUDART_INF;
  const bool on = tid < nc * Wp;
  const int cl = tid / Wp, k = tid % Wp;
  double o[Wp];
#pragma unroll
  for (int j = 0; j < Wp; ++j) o[j] = j == k ? 0.0 : inf;
  over_slabs<Wp>(S, n, W, We, L, s.B, c0, nc, slab, [&](int t, const double* rows) {
    if (on && (c0 + cl) * L + t < n) {
      const double* row = rows + cl * slab_stride(Wp);
      double c[Wp];
#pragma unroll
      for (int w = 1; w <= Wp; ++w) c[w - 1] = __dadd_rn(o[w - 1], row[w - 1]);
      double u = c[0];
      if constexpr (Wp > 1) u = dmin(tree_min<Wp - 1>(c + 1), u);
#pragma unroll
      for (int j = Wp - 1; j > 0; --j) o[j] = o[j - 1];
      o[0] = u;
    }
  });
  // M_c(i, k) = position L - i of lane (c, k), into X Wp x Wp row-major
  // (entries past We: a padded lane's inf column, or rows no finite sum
  // reaches)
  if (on) {
#pragma unroll
    for (int i = 0; i < Wp; ++i) X[cl * Wp * Wp + i * Wp + k] = o[i];
  }
  __syncthreads();
  const double* R = prefix_products<Wp>(X, Y, nc, We);
  for (int e = tid; e < nc * We * We; e += blockDim.x) {
    const int c = e / (We * We), kk = (e / We) % We, i = e % We;
    Q[(c0 + c) * We * We + kk * We + i] = R[c * Wp * Wp + i * Wp + kk];
  }
}

// the wide path's pass 1: We lanes a chunk, rings and matrices in device
// memory, rows read in place
__global__ void __launch_bounds__(kThreads)
dp_scan_chunks_wide(int64_t n, int W, Layout s, const double* __restrict__ S,
                    double* __restrict__ Q, double* __restrict__ scratch) {
  const int We = s.We, L = s.L;
  const int64_t blk = blockIdx.x;
  const int64_t c0 = blk * s.B;
  const int nc = static_cast<int>(s.K - c0 < s.B ? s.K - c0 : s.B);
  const int NL = s.B * We;
  const int tid = threadIdx.x;
  double* ring = scratch + blk * chunks_scratch(s);
  double* X = ring + NL * We;
  double* Y = X + NL * We;
  const double inf = CUDART_INF;
  for (int lane = tid; lane < nc * We; lane += blockDim.x) {
    const int k = lane % We;
    for (int j = 0; j < We; ++j)
      ring[((We - j) % We) * NL + lane] = j == k ? 0.0 : inf;
  }
  int h = 1 % We;
  for (int t = 0; t < L; ++t) {
    for (int lane = tid; lane < nc * We; lane += blockDim.x) {
      const int64_t r = (c0 + lane / We) * L + t;
      if (r >= n) continue;
      const double* row = S + r * W;
      double best = inf;
      int idx = h == 0 ? We - 1 : h - 1;  // position t
      for (int w = 1; w <= We; ++w) {
        best = dmin(best, __dadd_rn(ring[idx * NL + lane], row[w - 1]));
        idx = idx == 0 ? We - 1 : idx - 1;
      }
      ring[h * NL + lane] = best;
    }
    h = h + 1 == We ? 0 : h + 1;
  }
  __syncthreads();
  for (int e = tid; e < nc * We * We; e += blockDim.x) {
    const int c = e / (We * We), i = (e / We) % We, k = e % We;
    X[e] = ring[((L - i) % We) * NL + c * We + k];
  }
  __syncthreads();
  const double* R = prefix_products<0>(X, Y, nc, We);
  for (int e = tid; e < nc * We * We; e += blockDim.x) {
    const int c = e / (We * We), k = (e / We) % We, i = e % We;
    Q[(c0 + c) * We * We + k * We + i] = R[c * We * We + i * We + k];
  }
}

// ---- pass 2: the starts, then the replay -----------------------------------

// st[cl * We + j] = opt[start of chunk cl - j]: the block's start v (the
// chain over the aggregates before it, from v_0), then each chunk's, Q of
// the chunk before (x) v.  Wp > 0: the aggregates staged in tiles, one warp
// walks them, v in its lanes' registers; Wp == 0: read in place, the
// whole block, v in shared memory.
template <int Wp>
__device__ __forceinline__ void starts(const double* __restrict__ Q, int We,
                                       int B, int64_t blk, int64_t c0, int nc,
                                       double* v, double* st, double* tiles) {
  const int tid = threadIdx.x;
  const double inf = CUDART_INF;
  const int mats = We * We;
  // aggregate j: the last prefix product of block j
  auto agg = [&](int64_t j) { return Q + ((j + 1) * B - 1) * mats; };
  if constexpr (Wp > 0) {
    const int TP = tile_mats(We);
    auto stage = [&](int64_t j0, double* dst) {
      const int cnt = static_cast<int>(blk - j0 < TP ? blk - j0 : TP);
      for (int e = tid; e < cnt * mats; e += blockDim.x)
        cp_async8(dst + e, agg(j0 + e / mats) + e % mats);
      cp_commit();
    };
    if (tid < We) v[tid] = tid == 0 ? 0.0 : inf;
    const int64_t tiles_n = (blk + TP - 1) / TP;
    if (tiles_n > 0) stage(0, tiles);
    for (int64_t q = 0; q < tiles_n; ++q) {
      if (q + 1 < tiles_n) {
        stage((q + 1) * TP, tiles + ((q + 1) & 1) * TP * mats);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const double* tile = tiles + (q & 1) * TP * mats;
      const int64_t j1 = (q + 1) * TP < blk ? (q + 1) * TP : blk;
      if (tid < 32) {  // out[i] = min_k A(i, k) + in[k], A column-major
        for (int64_t j = q * TP; j < j1; ++j) {
          const double* A = tile + (j - q * TP) * mats;
          const double* in = v + (j & 1) * We;
          if (tid < We) {
            double c[Wp];
#pragma unroll
            for (int kk = 0; kk < Wp; ++kk)
              c[kk] = kk < We ? __dadd_rn(A[kk * We + tid], in[kk]) : inf;
            v[(~j & 1) * We + tid] = tree_min<Wp>(c);
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }
    if (tid < We) st[tid] = v[(blk & 1) * We + tid];
  } else {
    for (int i = tid; i < We; i += blockDim.x) v[i] = i == 0 ? 0.0 : inf;
    __syncthreads();
    for (int64_t j = 0; j < blk; ++j) {
      const double* A = agg(j);
      const double* in = v + (j & 1) * We;
      for (int i = tid; i < We; i += blockDim.x) {
        double best = inf;
        for (int kk = 0; kk < We; ++kk) best = dmin(best, __dadd_rn(A[kk * We + i], in[kk]));
        v[(~j & 1) * We + i] = best;
      }
      __syncthreads();
    }
    for (int i = tid; i < We; i += blockDim.x) st[i] = v[(blk & 1) * We + i];
  }
  __syncthreads();
  for (int e = tid; e < (nc - 1) * We; e += blockDim.x) {
    const int cl = e / We + 1, i = e % We;
    const double* A = Q + (c0 + cl - 1) * mats;
    double best = inf;
    for (int kk = 0; kk < We; ++kk) best = dmin(best, __dadd_rn(A[kk * We + i], st[kk]));
    st[cl * We + i] = best;
  }
  __syncthreads();
}

// one thread a chunk replays its rows from its start, its ring in registers
// (o[j] = position t - j); the smallest w whose candidate is the minimum
template <int Wp>
__global__ void __launch_bounds__(kThreads)
dp_scan_replay(int64_t n, int W, Layout s, const double* __restrict__ S,
               const double* __restrict__ Q, double* __restrict__ opt,
               int64_t* __restrict__ prev) {
  extern __shared__ __align__(16) double smem[];
  const int We = s.We, L = s.L, B = s.B;
  const int64_t blk = blockIdx.x;
  const int64_t c0 = blk * B;
  const int nc = static_cast<int>(s.K - c0 < B ? s.K - c0 : B);
  const int tid = threadIdx.x;
  double* st = smem + 2 * We;  // each chunk's start: st[cl * We + j] = opt[start - j]
  double* tiles = st + B * We;
  double* slab = tiles + 2 * tile_mats(We) * We * We;
  if (blk == 0 && tid == 0) {
    opt[0] = 0.0;
    prev[0] = 0;
  }
  starts<Wp>(Q, We, B, blk, c0, nc, smem, st, tiles);
  const bool on = tid < nc;
  const int cl = on ? tid : 0;
  const double inf = CUDART_INF;
  double o[Wp];
#pragma unroll
  for (int j = 0; j < Wp; ++j) o[j] = on && j < We ? st[cl * We + j] : inf;
  over_slabs<Wp>(S, n, W, We, L, B, c0, nc, slab, [&](int t, const double* rows) {
    const int64_t r = (c0 + cl) * L + t;
    if (on && r < n) {
      const double* row = rows + cl * slab_stride(Wp);
      double c[Wp];
#pragma unroll
      for (int w = 1; w <= Wp; ++w) c[w - 1] = __dadd_rn(o[w - 1], row[w - 1]);
      // the first minimum over ascending w: the tail's tree keeps the
      // smaller index, ties to w = 1
      double best = c[0];
      int bw = 1;
      if constexpr (Wp > 1) {
        double tail;
        int tw;
        tree_argmin<Wp - 1>(c + 1, 2, tail, tw);
        if (tail < best) {
          best = tail;
          bw = tw;
        }
      }
      opt[r + 1] = best;
      prev[r + 1] = r + 1 - bw;
#pragma unroll
      for (int j = Wp - 1; j > 0; --j) o[j] = o[j - 1];
      o[0] = best;
    }
  });
}

// the wide path's pass 2
__global__ void __launch_bounds__(kThreads)
dp_scan_replay_wide(int64_t n, int W, Layout s, const double* __restrict__ S,
                    const double* __restrict__ Q, double* __restrict__ opt,
                    int64_t* __restrict__ prev, double* __restrict__ scratch) {
  extern __shared__ __align__(16) double smem[];
  const int We = s.We, L = s.L, B = s.B;
  const int64_t blk = blockIdx.x;
  const int64_t c0 = blk * B;
  const int nc = static_cast<int>(s.K - c0 < B ? s.K - c0 : B);
  const int tid = threadIdx.x;
  double* st = smem + 2 * We;
  double* ring = scratch + blk * replay_scratch(s);
  if (blk == 0 && tid == 0) {
    opt[0] = 0.0;
    prev[0] = 0;
  }
  starts<0>(Q, We, B, blk, c0, nc, smem, st, nullptr);
  if (tid >= nc) return;
  const int cl = tid;
  for (int j = 0; j < We; ++j) ring[((We - j) % We) * B + cl] = st[cl * We + j];
  double x1 = st[cl * We];
  int h = 1 % We;
  for (int t = 0; t < L; ++t) {
    const int64_t r = (c0 + cl) * L + t;
    if (r < n) {
      const double* row = S + r * W;
      double best = CUDART_INF;
      int bw = 1;
      int idx = h;  // position t + 1 - We
      for (int w = We; w >= 2; --w) {
        const double c = __dadd_rn(ring[idx * B + cl], row[w - 1]);
        if (c <= best) {
          best = c;
          bw = w;
        }
        idx = idx + 1 == We ? 0 : idx + 1;
      }
      const double c1 = __dadd_rn(x1, row[0]);
      if (c1 <= best) {
        best = c1;
        bw = 1;
      }
      ring[h * B + cl] = best;
      x1 = best;
      opt[r + 1] = best;
      prev[r + 1] = r + 1 - bw;
    }
    h = h + 1 == We ? 0 : h + 1;
  }
}

template <int Wp>
int launch_small(int64_t n, int W, const Layout& s, const double* S, double* Q,
                 double* opt, int64_t* prev, cudaStream_t st) {
  if (s.K > 1) {
    const size_t smem = chunks_smem(s);
    cudaError_t e = cudaFuncSetAttribute(
        dp_scan_chunks<Wp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dp_scan_chunks<Wp><<<static_cast<unsigned>(s.nb), kThreads, smem, st>>>(
        n, W, s, S, Q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = replay_smem(s);
  const cudaError_t e = cudaFuncSetAttribute(
      dp_scan_replay<Wp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dp_scan_replay<Wp><<<static_cast<unsigned>(s.nb), kThreads, smem, st>>>(
      n, W, s, S, Q, opt, prev);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Doubles of device memory vbcs_dp_scan needs as `scratch` for S[n, W]:
// the chunks' prefix products and (We > 16) the rings and matrices.
int64_t vbcs_dp_scan_scratch_doubles(int64_t n, int W) {
  if (n <= 0 || W < 1) return 0;
  const Layout s = layout(n, W);
  return s.K * s.We * s.We + s.nb * (chunks_scratch(s) + replay_scratch(s));
}

// opt[n+1] f64 and prev[n+1] int64 from S[n, W] by the scan; S's finite
// entries exact in the sense above for the result to be the serial fold's.
// n > 0.  scratch: vbcs_dp_scan_scratch_doubles(n, W) doubles.  Two
// launches on `stream` (one when there is one chunk); returns the first
// CUDA error.
int vbcs_dp_scan(int64_t n, int W, const void* S, void* opt, void* prev,
                 void* scratch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout s = layout(n, W);
  if (n <= 0 || s.We > 46340)  // We * We indexes an int
    return static_cast<int>(cudaErrorInvalidValue);
  double* Q = static_cast<double*>(scratch);
  double* sc1 = Q + s.K * s.We * s.We;
  double* sc2 = sc1 + s.nb * chunks_scratch(s);
  const double* Sd = static_cast<const double*>(S);
  double* o = static_cast<double*>(opt);
  int64_t* p = static_cast<int64_t*>(prev);
  switch (s.small ? s.Wp : 0) {
    case 1: return launch_small<1>(n, W, s, Sd, Q, o, p, st);
    case 2: return launch_small<2>(n, W, s, Sd, Q, o, p, st);
    case 4: return launch_small<4>(n, W, s, Sd, Q, o, p, st);
    case 8: return launch_small<8>(n, W, s, Sd, Q, o, p, st);
    case 16: return launch_small<16>(n, W, s, Sd, Q, o, p, st);
    default: break;
  }
  if (s.K > 1) {
    dp_scan_chunks_wide<<<static_cast<unsigned>(s.nb), kThreads, 0, st>>>(
        n, W, s, Sd, Q, sc1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = replay_smem(s);
  const cudaError_t e = cudaFuncSetAttribute(
      dp_scan_replay_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dp_scan_replay_wide<<<static_cast<unsigned>(s.nb), kThreads, smem, st>>>(
      n, W, s, Sd, Q, o, p, sc2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

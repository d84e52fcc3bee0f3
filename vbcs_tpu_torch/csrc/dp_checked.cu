// The split-point DP's recurrence on fitted (fractional) cost tables as a
// checked speculative fold, in f64:
//
//   opt[jp] = min_{1 <= w <= min(W, jp)} opt[jp - w] + S[jp - 1, w - 1]
//
// with prev[jp] = jp - w of the first minimum over ascending w (jp - 1 when
// every candidate is inf), bit for bit the host C++ DP's fold
// (native/vbc_native.cpp dp_partition) and the serial kernel's (csrc/dp.cu
// vbcs_dp_recurrence).
//
// Replaces vbcs_tpu/plan/jax_dp.py's lax.scan (dp_partition_jax :54 and
// dp_partition_jax_2d :155; not a Pallas kernel) on fitted tables, where
// csrc/dp_scan.cu's (min,+) scan regroups the sums and its opt is off by a
// few ulps (an error the (min,+) semiring never damps: every later value is
// an earlier one plus a cost).
//
// The fixed point.  Let H(v)[jp] be the first minimum over ascending w of
// fl(v[jp - w] + S[jp - 1, w - 1]), as the host computes it, and P(v)[jp]
// its argmin (as jp - w).  H(v)[jp] reads only v[< jp], so by induction the
// host's opt is the only v with v[0] = 0 and v[jp] = H(v)[jp] for every jp:
// a candidate v that passes v == H(v) bit for bit everywhere is the host's
// opt, and P(v) its prev.  Checking a row is W adds and compares on values
// already made, parallel across rows; no order of sums is assumed.
//
// The guess.  g[jp] (a back pointer a row, here the scan's prev on the same
// S) names each row's candidate.  Walking v[jp] = fl(v[g[jp]] + S[jp - 1,
// jp - g[jp] - 1]) in row order, the same two operands as the host's
// candidate, gives the host's values up to the first row whose pointer is
// not the host's choice; the check finds that row r (v[r] != H(v)[r] or
// g[r] != P(v)[r] with every row before it passing), sets v[r] = H(v)[r]
// and g[r] = P(v)[r] (exact: the rows before r are), and the walk resumes
// at r + 1.
//
// One block of kThreads:
// * lane 0 of warp 0, the leader, walks chunk k + 1 (C rows) while warps
//   1-7 check chunk k in the host's order (a thread a row, its S row read
//   in place), stage the entries of chunk k + 2 (a ring of kSlots chunks),
//   and write opt and prev of chunk k - 1, which the check of the step
//   before passed.
// * A row's walk has no select on its dependent path (on Hopper a select
//   that waits on an f64 result waits longer than a dependent f64 fma):
//     v[jp] = fma(v1, m1, fma(v2, m2, y + s))
//   with v1, v2 the last two values made, s = S[jp - 1, d - 1], m1 = [d ==
//   1], m2 = [d == 2] and y = v[jp - d] for d > 2 (from the value ring, loaded
//   three rows ahead), an exact 0 otherwise.  Each product is exactly a value
//   or a zero and no value is -0.0 (v[0] = +0.0, and a sum is -0.0 only of
//   two), so each row is the host's one rounding of v[jp - d] + s.  The
//   helpers stage s, m1, m2 and the row's load and store slots (a 32-byte
//   entry, loaded eight rows ahead); the dependent path of a row is the
//   fma that makes it.  The value ring holds 3C + We values (We = min(W,
//   n)); where shared memory cannot, opt itself is the ring.
// * On the first mismatch r of chunk k the leader sets row r, re-walks
//   r + 1 .. the chunk's end and the step repeats (walking chunk k + 1
//   again): a mismatch costs at most two chunks' walk.  Past `budget`
//   restarts the block finishes by the host-order fold from row r + 1, in
//   this launch: a designed route, counted in stats[2].  The leader folds
//   the values only (a min is exact, so no order of the mins changes a
//   bit), the last We in registers for We <= 16 (kFoldRing) and its S rows
//   staged a chunk ahead by the helpers, which recover the pointers of the
//   chunk before, P(v), from opt.
//
// stats[3] = (restarts, rows re-walked: walked again after a restart, the
// chunk the leader walked beside the failed check included; rows of the
// fold).  The plain version (ops/dp.py dp_recurrence_checked_plain) follows
// the same chunks, restarts and budget and gives the same opt, prev and
// stats on any finite S and valid guess.
//
// Bound: the function's bytes, S read and opt and prev written: 8 n W + 16
// (n + 1) bytes, 7.64 us on the flagship's n = 320,000, W = 8 at 3.35 TB/s
// (the guess, 8 (n + 1) bytes more, is this design's own traffic, not the
// function's); and the leader's dependent path, one fma a row, never a min.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // warp 0: the leader; warps 1-7: the helpers
constexpr int kHelpers = kThreads - 32;
constexpr int kSlots = 4;      // staged chunks: checked, walked, staged, written
constexpr int kMaxChunk = 1024;
constexpr int kFoldRing = 16;  // the fold's values in registers up to this We
constexpr int kWalkRows = 8;   // the walk's unrolled block; entries padded by it
constexpr int kNone = INT_MAX;

// a row of the walk: v = fma(v1, m1, fma(v2, m2, ring[slot] + s)) from the
// last two values made (m1 = [d == 1], m2 = [d == 2]; slot: the zero slot
// for d <= 2), stored at ring[sslot]
struct __align__(16) Entry {
  double s, m1, m2;
  int slot, sslot;
};

struct Ring {
  double* p;
  int mask;  // -1: opt itself, indexed by row
  int zero;  // a slot that holds 0.0
  __device__ __forceinline__ double& operator[](int j) const { return p[j & mask]; }
  // v[j], 0.0 before row 0 (never selected: d <= jp)
  __device__ __forceinline__ double get0(int j) const {
    return j >= 0 ? p[j & mask] : 0.0;
  }
};

struct Args {
  int n, W, We, C, K, budget;
  const double* __restrict__ S;
  const int64_t* __restrict__ guess;
  double* opt;
  int64_t* prev;
  int64_t* stats;
};

// the leader's walk of rows [a, b] (b the end of a chunk; e[i]: row a + i's
// entry, padded with kWalkRows entries past b): blocks of kWalkRows rows,
// fully unrolled; each row's place in `cur` is refilled with the entry
// eight rows on as soon as it is used, and the ring value of row i + 3 is
// loaded after row i is stored (its slot is at most row i), from an entry
// loaded five rows before, so no load waits on a load in the leader's
// in-order issue.  A last part block goes a row at a time.
__device__ __forceinline__ void walk(const Ring& ring, const Entry* e, int a, int b) {
  if (a > b) return;
  double v1 = ring.get0(a - 1), v2 = ring.get0(a - 2);
  const int m = b - a + 1;
  int i = 0;
  if (m >= kWalkRows) {
    Entry cur[kWalkRows];
#pragma unroll
    for (int u = 0; u < kWalkRows; ++u) cur[u] = e[u];
    double y0 = ring.p[cur[0].slot], y1 = ring.p[cur[1].slot],
           y2 = ring.p[cur[2].slot];
    for (; i + kWalkRows <= m; i += kWalkRows) {
#pragma unroll
      for (int u = 0; u < kWalkRows; ++u) {
        const Entry c = cur[u];
        const double v = __fma_rn(v1, c.m1, __fma_rn(v2, c.m2, __dadd_rn(y0, c.s)));
        ring.p[c.sslot] = v;
        v2 = v1;
        v1 = v;
        cur[u] = e[i + kWalkRows + u];
        y0 = y1;
        y1 = y2;
        y2 = ring.p[cur[(u + 3) % kWalkRows].slot];
      }
    }
  }
  for (; i < m; ++i) {
    const Entry c = e[i];
    const double v =
        __fma_rn(v1, c.m1, __fma_rn(v2, c.m2, __dadd_rn(ring.p[c.slot], c.s)));
    ring.p[c.sslot] = v;
    v2 = v1;
    v1 = v;
  }
}

// H(v)[r] and P(v)[r] in the host's order, from row r's S row: (value, width)
__device__ __forceinline__ double host_row(const Ring& ring, const double* row,
                                           int lo, int r, int& bw) {
  double best = CUDART_INF;
  bw = 1;
  for (int w = 1; w <= lo; ++w) {
    const double c = __dadd_rn(ring[r - w], row[w - 1]);
    if (c < best) {
      best = c;
      bw = w;
    }
  }
  return best;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ int chunk_rows(const Args& A, int c) {
  const int c0 = c * A.C;
  return A.n - c0 < A.C ? A.n - c0 : A.C;
}

// chunk c's entries and pointer widths (D), thread t of nt; the entries past
// the chunk's rows, to C + kWalkRows, load the zero slot and store nowhere
__device__ __forceinline__ void stage(const Args& A, const Ring& ring, Entry* E,
                                      int* D, int c, int t, int nt) {
  const int c0 = c * A.C;
  const int rows = chunk_rows(A, c);
  for (int i = t; i < A.C + kWalkRows; i += nt) {
    Entry e = {0.0, 0.0, 0.0, ring.zero, ring.zero};
    if (i < rows) {
      const int jp = c0 + 1 + i;
      const int d = jp - static_cast<int>(A.guess[jp]);
      e.s = A.S[static_cast<int64_t>(jp - 1) * A.W + d - 1];
      e.m1 = d == 1 ? 1.0 : 0.0;
      e.m2 = d == 2 ? 1.0 : 0.0;
      e.slot = d > 2 ? (jp - d) & ring.mask : ring.zero;
      e.sslot = jp & ring.mask;
      D[i] = d;
    }
    E[i] = e;
  }
}

// the check of chunk c's rows: the first row whose value is not H(v) or
// whose pointer is not P(v), into *fail
__device__ __forceinline__ void check(const Ring& ring, const Args& A,
                                      const int* D, int c, int* fail, int t,
                                      int nt) {
  const int c0 = c * A.C;
  const int rows = chunk_rows(A, c);
  for (int i = t; i < rows; i += nt) {
    const int jp = c0 + 1 + i;
    int bw;
    const double best = host_row(ring, A.S + static_cast<int64_t>(jp - 1) * A.W,
                                 jp < A.We ? jp : A.We, jp, bw);
    if (bw != D[i] || ring[jp] != best) atomicMin(fail, jp);
  }
}

// opt and prev of rows [c0 + 1 + i0, c0 + 1 + i1) of the chunk at c0
__device__ __forceinline__ void emit(const Ring& ring, const Args& A, const int* D,
                                     int c0, int i0, int i1, bool shared_ring,
                                     int t, int nt) {
  for (int i = i0 + t; i < i1; i += nt) {
    const int jp = c0 + 1 + i;
    if (shared_ring) A.opt[jp] = ring[jp];
    A.prev[jp] = jp - D[i];
  }
}

// the S rows of chunk c into F (rows of R, the entries past We left as
// they are), thread t of nt, by cp.async; complete when the thread leaves
template <int R>
__device__ __forceinline__ void stage_rows(const Args& A, double* F, int c, int t,
                                           int nt) {
  const int c0 = c * A.C;
  const int rows = chunk_rows(A, c);
  for (int e = t; e < rows * A.We; e += nt) {
    const int i = e / A.We, w = e % A.We;
    cp_async8(F + i * R + w, A.S + static_cast<int64_t>(c0 + i) * A.W + w);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }

// one row of the fold in registers: o[t] = v[jp - 1 - t] (inf before row 0)
// on entry, v[jp] at o[0] on exit; s: the row's S row of R (inf past We),
// 16-byte aligned; nothing is predicated, so the unrolled rows interleave
template <int R>
__device__ __forceinline__ double fold_row(double (&o)[R], const double* s) {
  double x[R];
#pragma unroll
  for (int w = 0; w < R; w += 2) {
    const double2 p = *reinterpret_cast<const double2*>(s + w);
    x[w] = p.x;
    x[w + 1] = p.y;
  }
  double m = CUDART_INF;
#pragma unroll
  for (int w = R; w >= 2; --w) m = dmin(m, __dadd_rn(o[w - 1], x[w - 1]));
  const double best = dmin(m, __dadd_rn(o[0], x[0]));
#pragma unroll
  for (int t = R - 1; t > 0; --t) o[t] = o[t - 1];
  o[0] = best;
  return best;
}

// the fold's values of rows [a, b] into opt (row jp's S row at rows +
// (jp - a) * stride): R > 0, We <= R: the last R values in o, the rows
// staged with stride R, blocks of R rows unrolled so the ring's moves are
// renamings; R = 0: any We, the earlier values from the ring
template <int R>
__device__ __forceinline__ void fold(const Ring& ring, double (&o)[R > 0 ? R : 1],
                                     const double* __restrict__ rows, int stride,
                                     int We, int a, int b, double* __restrict__ opt) {
  if constexpr (R > 0) {
    int jp = a;
    for (; jp + R - 1 <= b; jp += R) {
      double out[R];  // stored after the block: no row's loads wait on a store
#pragma unroll
      for (int u = 0; u < R; ++u) out[u] = fold_row(o, rows + (jp + u - a) * stride);
#pragma unroll
      for (int u = 0; u < R; ++u) opt[jp + u] = out[u];
    }
    for (; jp <= b; ++jp) opt[jp] = fold_row(o, rows + (jp - a) * stride);
  } else {
    double v1 = ring[a - 1];
    for (int jp = a; jp <= b; ++jp) {
      const double* s = rows + static_cast<int64_t>(jp - a) * stride;
      const int lo = jp < We ? jp : We;
      double m = CUDART_INF;
      for (int w = 2; w <= lo; ++w) m = dmin(m, __dadd_rn(ring[jp - w], s[w - 1]));
      v1 = dmin(m, __dadd_rn(v1, s[0]));
      ring[jp] = v1;
      opt[jp] = v1;
    }
  }
}

// prev of rows [a, b] from opt, P(v), thread t of nt
__device__ __forceinline__ void recover(const Args& A, int a, int b, int t, int nt) {
  const Ring vals = {A.opt, -1, 0};
  for (int jp = a + t; jp <= b; jp += nt) {
    int bw;
    host_row(vals, A.S + static_cast<int64_t>(jp - 1) * A.W, jp < A.We ? jp : A.We,
             jp, bw);
    A.prev[jp] = jp - bw;
  }
}

// the budget spent at row r of chunk k (row r set, the rows up to it
// written): the host-order fold of rows r + 1 .. n, a chunk at a time; the
// leader folds chunk f (fold<R>) while the helpers stage the S rows of
// chunk f + 1 (R > 0: into F, two chunks of rows of R, inf past We; R = 0:
// read in place) and recover the pointers of chunk f - 1
template <int R>
__device__ __forceinline__ void finish(const Ring& ring, const Args& A, double* F,
                                       int r, int k) {
  const int tid = threadIdx.x;
  auto rows = [&](int f) { return F + (f % 2) * A.C * R; };
  auto first = [&](int f) { return f == k ? r + 1 : f * A.C + 1; };
  auto last = [&](int f) { return (f + 1) * A.C < A.n ? (f + 1) * A.C : A.n; };
  if constexpr (R > 0) {
    for (int e = tid; e < 2 * A.C * R; e += kThreads)
      if (e % R >= A.We) F[e] = CUDART_INF;
    stage_rows<R>(A, rows(k), k, tid, kThreads);
  }
  double o[R > 0 ? R : 1];
  if (tid == 0) {
#pragma unroll
    for (int t = 0; t < R; ++t) o[t] = r - t >= 0 ? ring[r - t] : CUDART_INF;
  }
  __syncthreads();
  for (int f = k; f < A.K; ++f) {
    const int a = first(f);
    if (tid == 0) {
      if constexpr (R > 0)
        fold<R>(ring, o, rows(f) + (a - f * A.C - 1) * R, R, A.We, a, last(f), A.opt);
      else
        fold<R>(ring, o, A.S + static_cast<int64_t>(a - 1) * A.W, A.W, A.We, a,
                last(f), A.opt);
    } else if (tid >= 32) {
      if constexpr (R > 0) {
        if (f + 1 < A.K) stage_rows<R>(A, rows(f + 1), f + 1, tid - 32, kHelpers);
      }
      if (f > k) recover(A, first(f - 1), last(f - 1), tid - 32, kHelpers);
    }
    __syncthreads();
  }
  recover(A, first(A.K - 1), A.n, tid, kThreads);
}

// shared memory: kSlots chunks of C + kWalkRows entries, then kSlots chunks
// of C pointer widths (rounded up to 16 bytes), the value ring (M doubles
// and the zero slot, M + 2 with a pad) when in shared memory, then the
// fold's two chunks of S rows of kFoldRing for We <= kFoldRing
__host__ __device__ inline size_t stage_bytes(int C) {
  const size_t widths = sizeof(int) * kSlots * static_cast<size_t>(C);
  return sizeof(Entry) * kSlots * static_cast<size_t>(C + kWalkRows) +
         (widths + 15) / 16 * 16;
}

template <bool kSharedRing>
__global__ void __launch_bounds__(kThreads)
dp_checked_kernel(Args A, int ring_mask) {
  extern __shared__ __align__(16) double smem[];
  __shared__ int fail[3];
  const int CE = A.C + kWalkRows;
  Entry* stage_buf = reinterpret_cast<Entry*>(smem);
  int* width_buf = reinterpret_cast<int*>(stage_buf + kSlots * CE);
  double* after = smem + stage_bytes(A.C) / sizeof(double);
  Ring ring;
  if constexpr (kSharedRing) {
    ring.p = after;
    ring.mask = ring_mask;
    ring.zero = ring_mask + 1;
    after += ring_mask + 3;
  } else {
    ring.p = A.opt;
    ring.mask = -1;
    ring.zero = 0;  // v[0]
  }
  auto slot = [&](int c) { return stage_buf + (c % kSlots) * CE; };
  auto widths = [&](int c) { return width_buf + (c % kSlots) * A.C; };
  auto chunk_end = [&](int c) { return (c + 1) * A.C < A.n ? (c + 1) * A.C : A.n; };
  // row r to H(v)[r], its width to P(v)[r] (the leader)
  auto fix = [&](int r) {
    const int c = (r - 1) / A.C;
    int bw;
    ring[r] = host_row(ring, A.S + static_cast<int64_t>(r - 1) * A.W,
                       r < A.We ? r : A.We, r, bw);
    widths(c)[r - c * A.C - 1] = bw;
  };
  const int tid = threadIdx.x;
  const int ht = tid - 32;
  const bool leader = tid == 0, helper = tid >= 32;
  const int K = A.K;

  if (tid < 3) fail[tid] = kNone;
  if (leader) {
    A.opt[0] = 0.0;
    A.prev[0] = 0;
    ring[0] = 0.0;
    ring.p[ring.zero] = 0.0;
  }
  stage(A, ring, slot(0), widths(0), 0, tid, kThreads);
  __syncthreads();
  if (leader) {
    walk(ring, slot(0), 1, chunk_end(0));
  } else if (helper && K > 1) {
    stage(A, ring, slot(1), widths(1), 1, ht, kHelpers);
  }
  __syncthreads();

  int staged = K < 2 ? K : 2;  // chunks [0, staged) staged
  int emitted = 0;             // chunks [0, emitted) written
  int restarts = 0, k = 0, it = 0, r = kNone;
  int64_t rewalked = 0;
  while (k < K) {
    if (leader) {
      if (k + 1 < K) walk(ring, slot(k + 1), (k + 1) * A.C + 1, chunk_end(k + 1));
    } else if (helper) {
      if (ht == 0) fail[(it + 1) % 3] = kNone;
      check(ring, A, widths(k), k, &fail[it % 3], ht, kHelpers);
      if (k + 2 < K && staged < k + 3)
        stage(A, ring, slot(k + 2), widths(k + 2), k + 2, ht, kHelpers);
      if (emitted < k)
        emit(ring, A, widths(k - 1), (k - 1) * A.C, 0, A.C, kSharedRing, ht,
             kHelpers);
    }
    __syncthreads();
    r = fail[it % 3];
    if (k + 2 < K && staged < k + 3) staged = k + 3;
    emitted = k;
    ++it;
    if (r == kNone) {
      ++k;
      continue;
    }
    if (restarts == A.budget) break;
    ++restarts;
    const int end = chunk_end(k);
    rewalked += end - r + (k + 1 < K ? chunk_end(k + 1) - (k + 1) * A.C : 0);
    if (leader) {
      fix(r);
      walk(ring, slot(k) + (r - k * A.C), r + 1, end);
    }
    __syncthreads();
  }

  int64_t folded = 0;
  if (k < K) {
    // the budget is spent: row r set and the rows up to it written, then
    // the host-order fold from r + 1
    if (leader) fix(r);
    __syncthreads();
    emit(ring, A, widths(k), k * A.C, 0, r - k * A.C, kSharedRing, tid, kThreads);
    if (A.We <= 8)
      finish<8>(ring, A, after, r, k);
    else if (A.We <= kFoldRing)
      finish<kFoldRing>(ring, A, after, r, k);
    else
      finish<0>(ring, A, nullptr, r, k);
    folded = A.n - r;
  } else if (emitted < K) {
    emit(ring, A, widths(K - 1), (K - 1) * A.C, 0, chunk_end(K - 1) - (K - 1) * A.C,
         kSharedRing, tid, kThreads);
  }
  if (leader) {
    A.stats[0] = restarts;
    A.stats[1] = rewalked;
    A.stats[2] = folded;
  }
}

}  // namespace

extern "C" {

// opt[n+1] f64, prev[n+1] int64 and stats[3] int64 (restarts, rows
// re-walked, rows folded) from S[n, W] f64 (finite where w <= jp; inf
// allowed where w > jp) and guess[n+1] int64 (jp - min(W, jp) <= guess[jp] <
// jp for jp >= 1), chunks of C rows (1 <= C <= 1024), at most `budget`
// restarts before the host-order fold.  0 < n < 2^30.  Launches one block on
// `stream`; returns cudaGetLastError().
int vbcs_dp_recurrence_checked(int64_t n, int W, int C, int budget,
                               const void* S, const void* guess, void* opt,
                               void* prev, void* stats, void* stream) {
  if (n < 1 || n >= (int64_t{1} << 30) || W < 1 || C < 1 || C > kMaxChunk ||
      budget < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args A;
  A.n = static_cast<int>(n);
  A.W = W;
  A.We = static_cast<int>(n < W ? n : W);
  A.C = C;
  A.K = static_cast<int>((n + C - 1) / C);
  A.budget = budget;
  A.S = static_cast<const double*>(S);
  A.guess = static_cast<const int64_t*>(guess);
  A.opt = static_cast<double*>(opt);
  A.prev = static_cast<int64_t*>(prev);
  A.stats = static_cast<int64_t*>(stats);
  int64_t M = 1;
  while (M < 3 * static_cast<int64_t>(C) + A.We) M *= 2;
  // the static shared words (the check's flags) come off the block's limit
  const size_t limit = static_cast<size_t>(smem_max) - 1024;
  const size_t ring_bytes = sizeof(double) * (M + 2);
  size_t smem = stage_bytes(C);
  if (A.We <= kFoldRing) smem += sizeof(double) * 2 * static_cast<size_t>(C) * kFoldRing;
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  const bool shared_ring = smem + ring_bytes <= limit;
  if (shared_ring) smem += ring_bytes;
  auto kernel = shared_ring ? dp_checked_kernel<true> : dp_checked_kernel<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, shared_ring ? static_cast<int>(M - 1) : -1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

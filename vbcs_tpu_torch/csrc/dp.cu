// The split-point DP of plan/dynamic.dp_partition on Hopper, in f64:
//
//   opt[jp] = min_{1 <= w <= min(W, jp)} opt[jp - w] + S[jp, w]
//
// with S[jp, w] the cost of the stripe of columns [jp - w, jp): alpha[w]
// plus, for each of R weighted counters, (the weight of the distinct
// groups in the stripe) * beta[r][w].
//
// Replaces vbcs_tpu/plan/jax_dp.py (dp_partition_jax :54 and
// dp_partition_jax_2d :155, a lax.scan over the columns that pads every
// column to the longest one and computes in f32; not a Pallas kernel).
// The scan is not ported step by step: only the chain of opt values is
// sequential, and the rest runs in parallel.
//
// * vbcs_dp_table: one thread per end column jp computes the row S[jp, :].
//   The host DP (native/vbc_native.cpp dp_partition) keeps a counter per
//   column, cnt[c] = the weight of the groups whose last occurrence in
//   [0, jp) is column c; a stripe's distinct weight is a suffix sum of the
//   counters.  A counter changes only while its own column and later ones
//   are swept, so the thread replays the updates of columns jp-W .. jp-1
//   (per nonzero: -= at the column of the previous occurrence of its group,
//   prevcol, when that lies in the window, then += at its own column) into
//   a window in shared memory, in the host's order, and gets the host's
//   counters bit for bit.  Then the suffix sums and stripe = alpha[w];
//   stripe += a_r * beta[r][w], each product and sum rounded apart (no
//   FMA: a contraction flips ties on fractional cost tables).  A block's
//   threads share their windows' columns: the block stages those columns'
//   pointers and nonzeros (prevcol, and grp with weights) in shared memory
//   once with cp.async, so each nonzero is read from device memory once a
//   block, not once a window; with one counter (R = 1) the counters of the
//   swept column and the one before it stay in registers.  Windows too
//   large for shared memory go to a device-memory scratch.  Bound: the
//   bytes of S (8 n W) and of the index arrays.
//
// * vbcs_dp_recurrence, the serial fold (csrc/dp_scan.cu holds the scan
//   that ops/dp.py takes on exact cost tables; this kernel alone
//   reproduces the host's fold on fitted, fractional ones): one block.
//   W <= 8 (the widths the planners use):
//   lane 0 of warp 0 runs the chain; the last 8 opt values stay in
//   registers (a ring of 8 slots, the steps unrolled 8 at a time), the S
//   rows come from shared memory, padded to 8 candidates with +inf.  The
//   width-1 candidate, the only one that needs the value just made, meets
//   the min of the others last, so a step's dependent path is one f64 add
//   and one min; the others' adds and min tree run beside it.  Warps 1-3
//   load the next chunk of S rows into a ring of three buffers and, behind
//   the chain, recover the back pointers of the chunk before from the opt
//   values the chain left beside its rows: prev[jp] = jp - w for the
//   smallest w whose candidate equals opt[jp] (the host's strict < over
//   ascending w keeps the first minimum), jp - 1 when opt[jp] is inf.
//   W > 8: lane 0 runs a plain loop over the widths, the rows read in place
//   from S and the earlier opt values from opt, and the block recovers the
//   back pointers after it.  Bound: n dependent steps, not bytes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kTableThreads = 128;
constexpr int kSmemBytes = 48 * 1024;  // the table's counter windows
constexpr int kStagePos = 256;         // the table's staged column pointers
constexpr int kStageNnz = 1152;        // the table's staged nonzeros
constexpr int kRing = 8;               // the ring kernel's slots: W <= 8
constexpr int kRecThreads = 128;       // warp 0: the chain; warps 1-3: loads
constexpr int kRecBuffers = 3;         // chunk loading, chained, recovered
constexpr int kRecSmemBytes = 96 * 1024;  // the ring kernel's three buffers
constexpr int kAnyThreads = 1024;      // W > 8: the back pointers' threads

// ---- the stripe-cost table -----------------------------------------------

// threads a block of the table kernel when each thread's counter window
// (R * W doubles) lies in shared memory; 0 when not even 32 windows fit,
// and the windows go to a scratch buffer in device memory
int table_smem_threads(int W, int R) {
  const size_t per = static_cast<size_t>(R) * W * sizeof(double);
  for (int t = kTableThreads; t >= 32; t /= 2)
    if (per * t <= static_cast<size_t>(kSmemBytes)) return t;
  return 0;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

// a block: blockDim.x consecutive end columns jp (one a thread), columns
// [cs, ce) the union of their windows.  Their pointers and (up to
// kStageNnz) their nonzeros' prevcol (and, with weights, grp) are staged
// in shared memory once, coalesced, with cp.async; nonzero q0 + e at
// stage_at(e) = e + e / 16, a pad a 16 so that the threads of a warp, each
// sweeping a neighbouring column, read distinct banks; the rest is read in
// place.  kOne: one counter (R == 1), the counters of the column being
// swept and of the one before it (most nonzeros' previous column) kept in
// registers.  The rows of S go out through the shared windows, coalesced.
__device__ __forceinline__ int stage_at(int e) { return e + (e >> 4); }

template <bool kOne>
__global__ void __launch_bounds__(kTableThreads)
dp_table_kernel(int64_t n, int W, int R, int64_t G,
                const int64_t* __restrict__ pos,
                const int64_t* __restrict__ grp,
                const int64_t* __restrict__ prevcol,
                const double* __restrict__ wts,
                const double* __restrict__ alpha,
                const double* __restrict__ beta,
                double* __restrict__ S, double* __restrict__ scratch) {
  extern __shared__ __align__(16) double smem[];
  const int T = blockDim.x;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * T;
  const int64_t cs = j0 + 1 - W > 0 ? j0 + 1 - W : 0;
  const int64_t ce = j0 + T < n ? j0 + T : n;
  const int ncol = static_cast<int>(ce - cs);
  const bool smem_win = scratch == nullptr;
  const int sw = T + 1;  // the shared windows' stride
  int64_t* s_pos = reinterpret_cast<int64_t*>(
      smem + (smem_win ? static_cast<int64_t>(R) * W * sw : 0));
  int64_t* s_prev = s_pos + kStagePos + 1;
  int64_t* s_grp = s_prev + stage_at(kStageNnz);
  const int tid = threadIdx.x;
  const bool pos_staged = ncol <= kStagePos;
  if (pos_staged)
    for (int i = tid; i <= ncol; i += T) cp_async8(s_pos + i, pos + cs + i);
  const int64_t q0 = pos[cs];
  const int64_t qn = pos[ce] - q0;
  const int ns = static_cast<int>(qn < kStageNnz ? qn : kStageNnz);
  for (int e = tid; e < ns; e += T) {
    cp_async8(s_prev + stage_at(e), prevcol + q0 + e);
    if (wts != nullptr) cp_async8(s_grp + stage_at(e), grp + q0 + e);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  auto pos_at = [&](int64_t c) { return pos_staged ? s_pos[c - cs] : pos[c]; };

  const int64_t jp = j0 + tid + 1;
  const bool active = jp <= n;
  const int weff = static_cast<int>(jp < W ? jp : W);
  const int64_t base = jp - weff;
  // counter (r, column base + s) at win[(r * W + s) * st]
  double* win;
  int64_t st;
  if (smem_win) {
    win = smem + tid;
    st = sw;
  } else {
    win = scratch + (jp - 1);
    st = n;
  }
  if (active) {
    for (int r = 0; r < R; ++r)
      for (int s = 0; s < weff; ++s) win[(r * W + s) * st] = 0.0;
    // kOne: the counters of the column being swept (cur, 0 until its
    // sweep) and of the one before it (last) in registers, each stored
    // when the sweep has passed it; every update of a counter still in the
    // host's order
    double last = 0.0;
    for (int64_t c = base; c < jp; ++c) {
      const int s = static_cast<int>(c - base);
      const int e1 = static_cast<int>(pos_at(c + 1) - q0);
      double cur = 0.0;
      for (int e = static_cast<int>(pos_at(c) - q0); e < e1; ++e) {
        const bool staged = e < ns;
        // the previous column, relative to the window (< 0: before it)
        const int old = static_cast<int>(
            (staged ? s_prev[stage_at(e)] : prevcol[q0 + e]) - base);
        const int64_t g = wts == nullptr
                              ? 0
                              : (staged ? s_grp[stage_at(e)] : grp[q0 + e]);
        if (kOne) {
          const double wgt = wts != nullptr ? wts[g] : 1.0;
          if (old == s) {
            cur = __dsub_rn(cur, wgt);
          } else if (old == s - 1) {
            last = __dsub_rn(last, wgt);
          } else if (old >= 0) {
            double* p = win + old * st;
            *p = __dsub_rn(*p, wgt);
          }
          cur = __dadd_rn(cur, wgt);
        } else {
          for (int r = 0; r < R; ++r) {
            const double wgt = wts != nullptr ? wts[r * G + g] : 1.0;
            if (old >= 0) {
              double* p = win + (r * W + old) * st;
              *p = __dsub_rn(*p, wgt);
            }
            double* p = win + (r * W + s) * st;
            *p = __dadd_rn(*p, wgt);
          }
        }
      }
      if (kOne) {
        if (s > 0) win[(s - 1) * st] = last;
        last = cur;
      }
    }
    if (kOne) win[(weff - 1) * st] = last;
    // a_r(w) = cnt_r[jp-1] + ... + cnt_r[jp-w], from 0.0 in that order, in place
    for (int r = 0; r < R; ++r) {
      double a = 0.0;
      for (int w = 1; w <= weff; ++w) {
        double* p = win + (r * W + (weff - w)) * st;
        a = __dadd_rn(a, *p);
        *p = a;
      }
    }
    // stripe(w) in place of a_0(w)
    for (int w = 1; w <= weff; ++w) {
      double stripe = alpha[w - 1];
      for (int r = 0; r < R; ++r)
        stripe = __dadd_rn(
            stripe, __dmul_rn(win[(r * W + (weff - w)) * st], beta[r * W + w - 1]));
      win[(weff - w) * st] = stripe;
    }
    if (!smem_win) {
      double* row = S + (jp - 1) * W;
      for (int w = 1; w <= W; ++w)  // no stripe reaches before column 0
        row[w - 1] = w <= weff ? win[(weff - w) * st] : CUDART_INF;
    }
  }
  if (!smem_win) return;
  __syncthreads();
  const int rows = static_cast<int>(ce - j0);
  for (int e = tid; e < rows * W; e += T) {
    const int i = e / W, w = e % W + 1;
    const int we = j0 + i + 1 < W ? static_cast<int>(j0 + i + 1) : W;
    S[j0 * W + e] = w <= we ? smem[(we - w) * sw + i] : CUDART_INF;
  }
}

// ---- the recurrence ---------------------------------------------------------

// min of two candidates: with finite cost tables no candidate is NaN or
// -0.0 (opt[0] is +0.0, and a sum is -0.0 only of two), so equal
// candidates are equal bits and any min gives the host's value
__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }

// chunk k of the ring kernel: C rows of kRing candidates (+inf past W and
// past n), then kRing + C opt values (opt[r0 - kRing + 1 .. r0 + C])
__device__ __forceinline__ void load_padded(const double* __restrict__ S,
                                            int64_t n, int W, int64_t r0,
                                            int C, double* dst, int t, int nt) {
#pragma unroll 4
  for (int i = t; i < C * kRing; i += nt) {
    const int64_t r = r0 + i / kRing;
    const int w = i % kRing;
    // an unconditional load in bounds, so that the unrolled loads overlap
    const double v = __ldg(S + (r < n ? r : n - 1) * W + (w < W ? w : W - 1));
    dst[i] = (r < n && w < W) ? v : CUDART_INF;
  }
}

// back pointers of rows [r0, r1) (row r ends at column jp = r + 1): the
// smallest w whose candidate equals opt[jp], jp - 1 when opt[jp] is inf
__device__ __forceinline__ void recover_ring(const double* rows,
                                             const double* os, int64_t r0,
                                             int64_t r1, int W, int64_t* prev,
                                             int t, int nt) {
  for (int64_t r = r0 + t; r < r1; r += nt) {
    const int i = static_cast<int>(r - r0);
    const int64_t jp = r + 1;
    const double best = os[kRing + i];
    const double* s = rows + i * kRing;
    int64_t j = jp - 1;
    if (best < CUDART_INF) {
      const int weff = static_cast<int>(jp < W ? jp : W);
      for (int w = 1; w <= weff; ++w) {
        if (__dadd_rn(os[kRing + i - w], s[w - 1]) == best) {
          j = jp - w;
          break;
        }
      }
    }
    prev[jp] = j;
  }
}

__device__ __forceinline__ void load_row(const double* row, double (&s)[kRing]) {
  const double2* v = reinterpret_cast<const double2*>(row);
#pragma unroll
  for (int k = 0; k < kRing / 2; ++k) {
    const double2 x = v[k];
    s[2 * k] = x.x;
    s[2 * k + 1] = x.y;
  }
}

// min over the widths 3 .. kRing of opt[jp - w] + row[w - 1], for the step
// at ring position u (its jp in slot (u + 1) % kRing): a tree over values
// at least three steps old
__device__ __forceinline__ double tail_min(const double (&o)[kRing],
                                           const double (&row)[kRing], int u) {
  double c[kRing];
#pragma unroll
  for (int w = 3; w <= kRing; ++w)
    c[w - 1] = __dadd_rn(o[(u + 1 - w + 2 * kRing) % kRing], row[w - 1]);
#pragma unroll
  for (int st = 1; st < kRing - 2; st *= 2)
#pragma unroll
    for (int i = 2; i + st < kRing; i += 2 * st) c[i] = dmin(c[i], c[i + st]);
  return c[2];
}

// the chain over the rows of one chunk (r0 a multiple of kRing), software-
// pipelined over three steps: o[t] holds opt[j] for the newest j with
// j % kRing == t (opt[j < 0] = inf).  While step u takes the min of its
// width-1 candidate (the value just made) and B (the min over widths >= 2,
// from the step before), the same instructions build B for step u + 1 (its
// width 2 is the value of two steps back) and the tail over widths >= 3
// for step u + 2; so the dependent path of a step is one add and one min.
// The rows are read two steps ahead (past the chunk's last row, the opt
// values beside it: unused); a block's 8 rows are loaded up front.
__device__ __forceinline__ void chain_ring(const double* __restrict__ rows,
                                           double* __restrict__ os, int64_t r0,
                                           int64_t r1, double (&o)[kRing],
                                           double* __restrict__ opt) {
  const int steps = static_cast<int>(r1 - r0);
  double z[kRing];
  load_row(rows, z);
  double x0 = z[0];  // width 1 of step u
  double b0 = dmin(tail_min(o, z, 0), __dadd_rn(o[kRing - 1], z[1]));
  load_row(rows + kRing, z);
  double p0 = z[0], p1 = z[1];  // widths 1 and 2 of step u + 1
  double a1 = tail_min(o, z, 1);
  for (int i0 = 0; i0 < steps; i0 += kRing) {
    double blk[kRing][kRing];
#pragma unroll
    for (int k = 0; k < kRing; ++k) load_row(rows + (i0 + k + 2) * kRing, blk[k]);
#pragma unroll
    for (int u = 0; u < kRing; ++u) {
#pragma unroll
      for (int w = 0; w < kRing; ++w) z[w] = blk[u][w];
      const double c1 = __dadd_rn(o[u], x0);
      const double b1 = dmin(a1, __dadd_rn(o[u], p1));
      const double a2 = tail_min(o, z, u + 2);
      const double best = dmin(b0, c1);
      o[(u + 1) % kRing] = best;
      os[kRing + i0 + u] = best;
      if (i0 + u < steps) opt[r0 + i0 + u + 1] = best;
      x0 = p0;
      p0 = z[0];
      p1 = z[1];
      b0 = b1;
      a1 = a2;
    }
  }
}

// W <= kRing: chunks of C rows (a multiple of kRing) in a ring of three
// buffers
__global__ void __launch_bounds__(kRecThreads)
dp_recurrence_ring(int64_t n, int W, int C, const double* __restrict__ S,
                   double* opt, int64_t* prev) {
  extern __shared__ __align__(16) double buf[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int stride = C * kRing + kRing + C;
  auto rows = [&](int64_t k) { return buf + (k % kRecBuffers) * stride; };
  auto opts = [&](int64_t k) { return rows(k) + C * kRing; };
  const int64_t chunks = (n + C - 1) / C;
  if (tid == 0) {
    opt[0] = 0.0;
    prev[0] = 0;
  }
  if (tid >= 32) load_padded(S, n, W, 0, C, rows(0), tid - 32, nt - 32);
  __syncthreads();
  double o[kRing];
#pragma unroll
  for (int t = 0; t < kRing; ++t) o[t] = t == 0 ? 0.0 : CUDART_INF;
  for (int64_t k = 0; k < chunks; ++k) {
    const int64_t r0 = k * C;
    const int64_t r1 = r0 + C < n ? r0 + C : n;
    if (tid >= 32) {
      if (k + 1 < chunks)
        load_padded(S, n, W, r1, C, rows(k + 1), tid - 32, nt - 32);
      if (k > 0)
        recover_ring(rows(k - 1), opts(k - 1), r0 - C, r0, W, prev, tid - 32,
                     nt - 32);
    } else if (tid == 0) {
      double* os = opts(k);  // opt[r0 - kRing + 1 + t] sits in o[(t + 1) % kRing]
#pragma unroll
      for (int t = 0; t < kRing; ++t) os[t] = o[(t + 1) % kRing];
      chain_ring(rows(k), os, r0, r1, o, opt);
    }
    __syncthreads();
  }
  if (chunks > 0)
    recover_ring(rows(chunks - 1), opts(chunks - 1), (chunks - 1) * C, n, W,
                 prev, tid, nt);
}

// W > kRing: lane 0 walks the chain, the rows read in place from S, the
// width-1 candidate's value in a register and the others read back from
// opt; then every thread recovers back pointers
__global__ void __launch_bounds__(kAnyThreads)
dp_recurrence_any(int64_t n, int W, const double* __restrict__ S, double* opt,
                  int64_t* prev) {
  if (threadIdx.x == 0) {
    opt[0] = 0.0;
    prev[0] = 0;
    double last = 0.0;
    for (int64_t jp = 1; jp <= n; ++jp) {
      const double* s = S + (jp - 1) * W;
      const int weff = static_cast<int>(jp < W ? jp : W);
      double part = CUDART_INF;
      for (int w = weff; w >= 2; --w)
        part = dmin(part, __dadd_rn(opt[jp - w], s[w - 1]));
      last = dmin(part, __dadd_rn(last, s[0]));
      opt[jp] = last;
    }
  }
  __syncthreads();
  for (int64_t jp = threadIdx.x + 1; jp <= n; jp += blockDim.x) {
    const double best = opt[jp];
    int64_t j = jp - 1;
    if (best < CUDART_INF) {
      const double* s = S + (jp - 1) * W;
      const int weff = static_cast<int>(jp < W ? jp : W);
      for (int w = 1; w <= weff; ++w) {
        if (__dadd_rn(opt[jp - w], s[w - 1]) == best) {
          j = jp - w;
          break;
        }
      }
    }
    prev[jp] = j;
  }
}

// the recurrence's dependent path alone, to time its n-step floor: one
// thread, each step one f64 add and one min on the value just made, the
// operands in registers (s[0..7] the addends, s[8] the cap)
__global__ void dp_chain_floor_kernel(int64_t n, const double* __restrict__ s,
                                      double* __restrict__ out) {
  double v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = s[k];
  const double cap = s[8];
  double x = 0.0;
  for (int64_t i = 0; i < n; i += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) x = dmin(cap, __dadd_rn(x, v[k]));
  }
  out[0] = x;
}

}  // namespace

extern "C" {

// The doubles of device memory vbcs_dp_table needs as its `scratch`: 0
// when the counter windows of 32 threads (R * W doubles each) fit in
// shared memory, else n * R * W.
int64_t vbcs_dp_table_scratch_doubles(int64_t n, int W, int R) {
  return table_smem_threads(W, R) > 0 ? 0 : n * R * W;
}

// S[n, W] (row jp - 1 for the stripes ending at column jp; inf where
// w > jp).  pos[n+1], grp[nnz], prevcol[nnz] int64; wts[R * G] f64 or null
// (unit weights, then R must be 1 and grp is not read); alpha[W], beta[R * W]
// f64.  scratch: vbcs_dp_table_scratch_doubles(n, W, R) doubles of device
// memory, null when that is 0.  n > 0.  Launches on `stream`; returns
// cudaGetLastError().
int vbcs_dp_table(int64_t n, int W, int R, int64_t G, const void* pos,
                  const void* grp, const void* prevcol, const void* wts,
                  const void* alpha, const void* beta, void* S, void* scratch,
                  void* stream) {
  const int smem_threads = table_smem_threads(W, R);
  if ((smem_threads == 0) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = smem_threads > 0 ? smem_threads : kTableThreads;
  const size_t smem =
      (smem_threads > 0 ? static_cast<size_t>(R) * W * sizeof(double) * (threads + 1)
                        : 0) +
      sizeof(int64_t) * (kStagePos + 1 + (kStageNnz + kStageNnz / 16) *
                                             (wts != nullptr ? 2 : 1));
  const int64_t blocks = (n + threads - 1) / threads;
  auto kernel = R == 1 ? dp_table_kernel<true> : dp_table_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      n, W, R, G, static_cast<const int64_t*>(pos),
      static_cast<const int64_t*>(grp), static_cast<const int64_t*>(prevcol),
      static_cast<const double*>(wts), static_cast<const double*>(alpha),
      static_cast<const double*>(beta), static_cast<double*>(S),
      static_cast<double*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// opt[n+1] f64 and prev[n+1] int64 from S[n, W] (vbcs_dp_table's, its
// finite entries from finite tables).  n > 0.
int vbcs_dp_recurrence(int64_t n, int W, const void* S, void* opt, void* prev,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* s = static_cast<const double*>(S);
  double* o = static_cast<double*>(opt);
  int64_t* p = static_cast<int64_t*>(prev);
  if (W > kRing) {
    dp_recurrence_any<<<1, kAnyThreads, 0, st>>>(n, W, s, o, p);
    return static_cast<int>(cudaGetLastError());
  }
  const int per = kRecSmemBytes / static_cast<int>(sizeof(double)) / kRecBuffers;
  const int C = (per - kRing) / (kRing + 1) / kRing * kRing;
  const size_t smem = static_cast<size_t>(kRecBuffers) *
                      (C * kRing + kRing + C) * sizeof(double);
  const cudaError_t e = cudaFuncSetAttribute(
      dp_recurrence_ring, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dp_recurrence_ring<<<1, kRecThreads, smem, st>>>(n, W, C, s, o, p);
  return static_cast<int>(cudaGetLastError());
}

// out[0] = x after n steps of x = min(s[8], x + s[i % 8]) from x = 0 (n a
// multiple of 8); s[9] f64.  One thread.
int vbcs_dp_chain_floor(int64_t n, const void* s, void* out, void* stream) {
  dp_chain_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const double*>(s), static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

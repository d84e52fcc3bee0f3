// The chunk probes on Hopper: the stripe kernel's chunk split into its
// value stream, its x gather and its reduction, f32.
//
// Replaces the Pallas bodies of two TPU probes, both called through one
// pallas_call each: bench_tools/probe_kernel.py (run_variant.kern, grid
// (T,), variants 0-6) and bench_tools/probe_kernel2.py (run_variant.kern,
// grid (T,), variants a-f).  On the TPU each grid step takes one chunk of
// NG = 1024 columns (val [64, NG], metadata [8, NG], x windows chosen by a
// scalar-prefetched table) and the variants ask what the vector unit pays
// for a sublane ladder, a lane take, a roll or an MXU reduction.  Those
// costs are the TPU's; on the card the same functions are a coalesced
// stream, a random load from L1/L2 per gathered value, and FMAs.  So one
// kernel computes every variant's output (vbcs_tpu_torch/probes/chunk.py
// states each index map) with one thread per output column: it loads the
// column's metadata (coalesced across the warp), gathers its 8 x values
// from the windows the table names, and stores 8 outputs, or reduces them
// against the column's 64 values (coalesced) first.  Variants the TPU
// computed in different ways but that give the same function are one
// variant here.
//
// What bounds it: bytes.  The full chunk (val 10.22 MB, metadata 1.28-2.56
// MB, x, out 1.28 MB at T = 39) is 13-18 MB, 4-5.5 us at 3.35 TB/s, and
// fits the 50 MB L2, so a warm call reads it from L2 (the probes time
// both warm and with L2 flushed).  The gathered values come from x tables
// of 0.19-4.19 MB, L1/L2-resident.  The `stream` variant reads every value
// row and the metadata, as the Pallas pipeline streams them, though its
// output needs rows 0-15 only; the rest is consumed by an empty asm so
// that the loads stay.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNG = 1024;  // columns of a chunk
constexpr int kThreads = 256;

enum Variant {
  kStream = 0, kLadder, kSub3, kSub1, kRoll, kWide, kAxis0, kLadderRed,
  kConstRed, kSub3Red, kWinSum, kTake2, kTake2Red, kRollAdd
};

struct Args {
  int n;                // columns: T * kNG
  int wblk;             // probe_kernel2's windows a 128-lane slice
  const float* val;     // [64, n]
  const void* m0;       // [8, n] metadata (row / loA), int32 or int16
  const void* m1;       // [8, n] hiA or null
  const float* x;       // [rows, 128]
  const int* tab;       // xtile (window ids) or wbase (window rows)
  float* out;           // [8, n]
};

template <typename M>
__device__ __forceinline__ unsigned meta(const void* m, int i) {
  // sign-extend as the TPU's astype(int32), then read as uint32 (logical
  // shifts)
  return static_cast<unsigned>(static_cast<int>(__ldg(static_cast<const M*>(m) + i)));
}

// probe_kernel's window k: x rows 8 * tab[k] .. + 8
__device__ __forceinline__ float win(const Args& a, int k, int row, int lane) {
  return __ldg(a.x + (8 * __ldg(a.tab + k) + row) * 128 + lane);
}

// The x value output row s of column c reads.
template <int V, typename M>
__device__ __forceinline__ float gather(const Args& a, int s, int c) {
  const int g = c / kNG, v = (c % kNG) / 128, l = c % 128;
  const int k0 = (g * 8 + v) * 3;
  const unsigned r = meta<M>(a.m0, s * a.n + c);
  if constexpr (V == kLadder || V == kLadderRed) {
    const unsigned hi = r >> 7, d = hi >> 3;
    return d < 3 ? win(a, k0 + d, hi & 7, r & 127) : 0.0f;
  } else if constexpr (V == kSub3 || V == kSub3Red) {
    const unsigned d = r >> 10;
    return d < 3 ? win(a, k0 + d, s, r & 127) : 0.0f;
  } else if constexpr (V == kSub1) {
    return win(a, k0, s, r & 127);
  } else if constexpr (V == kRoll) {
    return win(a, k0, (r >> 10) == 0 ? s : (s + 1) & 7, r & 127);
  } else if constexpr (V == kWide) {
    const unsigned lo = r & 1023;
    return win(a, (g * 8 + lo / 128) * 3, s, lo & 127);
  } else if constexpr (V == kAxis0) {
    return win(a, k0, (r >> 7) & 7, l);
  } else if constexpr (V == kConstRed) {
    return win(a, g * 24, s, l);
  } else {  // kTake2, kTake2Red
    const unsigned lo = r & 127;
    const unsigned d = a.wblk == 1 ? 0u : r >> 7;
    if (d >= static_cast<unsigned>(a.wblk)) return 0.0f;
    const int b = __ldg(a.tab + (g * 8 + v) * a.wblk + d);
    const unsigned at = meta<M>(a.m1, s * a.n + g * kNG + v * 128 + lo);
    return __ldg(a.x + (b + ((at >> (3 * d)) & 7)) * 128 + lo);
  }
}

template <int V, typename M>
__global__ void __launch_bounds__(kThreads) chunk_kernel(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.n) return;
  const int n = a.n;
  if constexpr (V == kStream) {
    float junk = 0.0f;
    for (int k = 16; k < 64; ++k) junk += __ldg(a.val + k * n + c);
    unsigned mj = 0;
    for (int s = 0; s < 8; ++s) {
      mj ^= meta<M>(a.m0, s * n + c);
      if (a.m1 != nullptr) mj ^= meta<M>(a.m1, s * n + c);
    }
    asm volatile("" ::"f"(junk), "r"(mj));  // keep the streamed loads
    for (int s = 0; s < 8; ++s) {
      a.out[s * n + c] = __ldg(a.val + s * n + c) + __ldg(a.val + (8 + s) * n + c);
    }
  } else if constexpr (V == kRollAdd) {
    const int l = c % 128;
    for (int s = 0; s < 8; ++s) {
      a.out[s * n + c] = __ldg(a.x + ((s + 1) & 7) * 128 + l) + __ldg(a.val + s * n + c);
    }
  } else if constexpr (V == kWinSum) {
    const int g = c / kNG, l = c % 128;
    for (int s = 0; s < 8; ++s) {
      float acc = 0.0f;
      for (int v = 0; v < 8; ++v) {
        for (int d = 0; d < a.wblk; ++d) {
          acc += __ldg(a.x + (__ldg(a.tab + (g * 8 + v) * a.wblk + d) + s) * 128 + l);
        }
      }
      a.out[s * n + c] = acc;
    }
  } else if constexpr (V == kLadderRed || V == kConstRed || V == kSub3Red ||
                       V == kTake2Red) {
    float xg[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) xg[s] = gather<V, M>(a, s, c);
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < 8; ++s) acc = fmaf(__ldg(a.val + (8 * w + s) * n + c), xg[s], acc);
      a.out[w * n + c] = acc;
    }
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s) a.out[s * n + c] = gather<V, M>(a, s, c);
  }
}

template <int V, typename M>
cudaError_t launch(const Args& a, cudaStream_t st) {
  chunk_kernel<V, M><<<(a.n + kThreads - 1) / kThreads, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename M>
cudaError_t dispatch(int variant, const Args& a, cudaStream_t st) {
  switch (variant) {
    case kStream: return launch<kStream, M>(a, st);
    case kLadder: return launch<kLadder, M>(a, st);
    case kSub3: return launch<kSub3, M>(a, st);
    case kSub1: return launch<kSub1, M>(a, st);
    case kRoll: return launch<kRoll, M>(a, st);
    case kWide: return launch<kWide, M>(a, st);
    case kAxis0: return launch<kAxis0, M>(a, st);
    case kLadderRed: return launch<kLadderRed, M>(a, st);
    case kConstRed: return launch<kConstRed, M>(a, st);
    case kSub3Red: return launch<kSub3Red, M>(a, st);
    case kWinSum: return launch<kWinSum, M>(a, st);
    case kTake2: return launch<kTake2, M>(a, st);
    case kTake2Red: return launch<kTake2Red, M>(a, st);
    case kRollAdd: return launch<kRollAdd, M>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches chunk variant `variant` (probes/chunk.py: VARIANTS) on `stream`
// over n = T * 1024 columns: val [64, n] f32; m0, m1 [8, n] int16 when
// meta16 else int32 (m1 may be null but for take2/take2_red); x [rows,
// 128] f32; tab int32; out [8, n] f32.  Returns cudaGetLastError() after
// the launch.
int vbcs_probe_chunk(int variant, int n, int wblk, int meta16, const void* val,
                     const void* m0, const void* m1, const void* x,
                     const void* tab, void* out, void* stream) {
  if (n <= 0) return 0;
  const Args a{n, wblk, static_cast<const float*>(val), m0, m1,
               static_cast<const float*>(x), static_cast<const int*>(tab),
               static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(meta16 ? dispatch<int16_t>(variant, a, st)
                                 : dispatch<int>(variant, a, st));
}

}  // extern "C"

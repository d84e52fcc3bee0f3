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
// of an auto-RCM pack (formats/device.py: natural_view) idx holds natural
// rows and y lands at col_out[j] (y_in is read there too), so the gathers
// the JAX operator runs around its kernel for a relabeled matrix
// (windowed_gather._permute_kernel, on x and on y) fold into this one
// launch; col_out is null in natural order.  col_out may also put the
// columns of a format at places in a longer y_out, so that two launches
// on two formats fill one buffer (parallel/stream.py's overlapped halo
// path: its local and its remote stripes, each at its natural place in
// the rank's slice).
//
// Design: one thread per output column j.  Stripes own disjoint columns
// (the reference's stripe scheduler, multiply_1DVBC.jl:169-177), so no
// atomics and no cross-block reduction are needed, and every width,
// multi-class plan, long (multi-group) stripe and rectangular shape runs
// the same code.  The TPU kernel's A-tables, window ids, slot space and
// exit permute existed only because Mosaic gathers inside one vreg; here
// x[idx[b]] is an ordinary load.
//
// What bounds it on this card: device-memory bytes.  Each value is used
// once (2 flops per 4-byte value), far fewer flops per byte than the
// card's f32 units can consume, so the floor is (val + idx + metadata +
// x + y) bytes over bandwidth.  The simple design reads each value exactly
// once, coalesced: the w_s threads of a stripe are adjacent and read the
// w_s contiguous values of a block together, and x[idx[b]] is one
// address broadcast to those threads.  It reads idx once per column,
// not once per block, and consecutive stripes in a warp may walk blocks
// of different counts; a warp-per-stripe or shared-memory idx stage is
// later work.

#include <cuda_runtime.h>

namespace {

__global__ void tr_spmv_stripe_kernel(
    int n, const int* __restrict__ spl, const int* __restrict__ pos,
    const int* __restrict__ idx, const int* __restrict__ ofs,
    const int* __restrict__ col_stripe, const int* __restrict__ col_out,
    const float* __restrict__ val, const float* __restrict__ x,
    const float* __restrict__ y_in, float alpha, float beta,
    float* __restrict__ y_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int s = col_stripe[j];
  const int j0 = spl[s];
  const int w = spl[s + 1] - j0;
  const int b1 = pos[s + 1];
  const float* v = val + ofs[s] + (j - j0);
  float acc = 0.0f;
  for (int b = pos[s]; b < b1; ++b, v += w) {
    acc = fmaf(__ldg(v), __ldg(x + __ldg(idx + b)), acc);
  }
  const int jo = col_out != nullptr ? __ldg(col_out + j) : j;
  float out = alpha * acc;
  if (y_in != nullptr) out = fmaf(beta, y_in[jo], out);
  y_out[jo] = out;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// y_in may be null (then beta is unused), col_out null (natural order;
// else an injection of the n columns into y_out's entries: a natural
// view's permutation, or the overlapped halo path's places of two
// formats' columns in one buffer; y_in is read at the same places).
// n > 0.
int vbcs_tr_spmv(int n, const void* spl, const void* pos, const void* idx,
                 const void* ofs, const void* col_stripe, const void* col_out,
                 const void* val, const void* x, const void* y_in, float alpha,
                 float beta, void* y_out, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  tr_spmv_stripe_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int*>(spl), static_cast<const int*>(pos),
      static_cast<const int*>(idx), static_cast<const int*>(ofs),
      static_cast<const int*>(col_stripe), static_cast<const int*>(col_out),
      static_cast<const float*>(val),
      static_cast<const float*>(x), static_cast<const float*>(y_in), alpha,
      beta, static_cast<float*>(y_out));
  return static_cast<int>(cudaGetLastError());
}

const char* vbcs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

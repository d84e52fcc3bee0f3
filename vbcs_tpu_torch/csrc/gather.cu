// Static gather on Hopper: out[i] = mask[i] ? src[perm[i]] : 0, f32.
//
// Replaces the TPU permute kernels vbcs_tpu/ops/windowed_gather.py
// (_permute_kernel via apply_permute, _clos_kernel via apply_clos /
// _apply_clos_arrays) and the pass chain of vbcs_tpu/ops/multipass.py
// (apply_multipass).  Those route a static map through aligned
// 1024-element windows because Mosaic gathers only inside one vreg; a
// GPU thread loads any address, so one pass serves every map, including
// the ones the TPU router refuses.
//
// What bounds it on this card: device-memory bytes (perm + mask + out,
// plus one 4-byte read of src per element, coalesced only as far as the
// map is local).  One thread per output element: the perm, mask and out
// accesses are fully coalesced, and masked-out elements read no src.
//
// The tile copy (vbcs_gather_tiles) is the same function on a map of whole
// 1,024-element tiles, the only maps left on the port's paths (the halo
// tiles a rank sends, and the 2-D halo path's pool; every other gather is
// folded into the kernel beside it: the stripe kernel's block rows, its
// col_out, the chain's perm).  The map is one int32 a tile, loaded by every
// thread of the tile's block from one address (a broadcast, served by L1
// after the first warp), and the tile moves as 256 float4 loads and stores,
// so an element costs 8 bytes of device memory, not 12.  One block of 256
// threads a tile: a halo call moves a few to a few dozen tiles, so the
// launch, not the grid, sets its time, and the simplest grid serves.

#include <cuda_runtime.h>

namespace {

__global__ void gather_kernel(int n, const float* __restrict__ src,
                              const int* __restrict__ perm,
                              const unsigned char* __restrict__ mask,
                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.0f;
  if (mask == nullptr || mask[i]) v = __ldg(src + __ldg(perm + i));
  out[i] = v;
}

constexpr int kTileVec = 1024 / 4;  // float4s of a tile (parallel/shard.py: TILE)

__global__ void __launch_bounds__(kTileVec) gather_tiles_kernel(
    const float4* __restrict__ src, const int* __restrict__ tiles,
    float4* __restrict__ out) {
  const long long from = static_cast<long long>(__ldg(tiles + blockIdx.x)) * kTileVec;
  const long long to = static_cast<long long>(blockIdx.x) * kTileVec;
  out[to + threadIdx.x] = __ldg(src + from + threadIdx.x);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// mask may be null (every element produced).  n > 0.
int vbcs_gather(int n, const void* src, const void* perm, const void* mask,
                void* out, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  gather_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float*>(src), static_cast<const int*>(perm),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out[t * 1024 + i] = src[tiles[t] * 1024 + i] for t < n_tiles, i < 1024:
// one block a tile.  src and out 16-byte aligned.  n_tiles > 0.
int vbcs_gather_tiles(int n_tiles, const void* src, const void* tiles,
                      void* out, void* stream) {
  gather_tiles_kernel<<<n_tiles, kTileVec, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(src), static_cast<const int*>(tiles),
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

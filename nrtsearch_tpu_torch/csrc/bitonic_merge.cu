// Compare-exchange stages of the bitonic merge over [B, N] (docs, contribs)
// pairs, in place: `near_stages` (every stage d0, d0/2, ..., 1 inside one
// shared-memory tile) and `far_stage` (one stage at a distance too long for a
// tile).
//
// Replaces: nrtsearch_tpu/ops/pallas_merge.py `near_stages` / `_near_kernel`
// and `far_stage` / `_far_kernel`, which `merge_level_pallas` composes for
// ops/merge_scoring.py `merge_sorted_runs`.
//
// Bound on the card: device-memory traffic. A stage does one compare per pair
// and moves 8 bytes per pair each way (int32 doc + f32 contrib).
//
// Design: near_stages loads a tile of `tile` pairs (NEAR_TILE = 8192 pairs =
// 64 KB, or the whole row when it is shorter) into dynamic shared memory and
// runs all log2(d0) + 1 stages there with a barrier between stages, so those
// stages cost one read and one write of the tile instead of one each. The TPU
// tile of 2^17 pairs does not fit the 227 KB a Hopper block can hold, so more
// stages go to far_stage than on the TPU. far_stage runs one thread per pair
// (i, i + d) for d >= tile.
//
// Tie rule, both kernels: ascending mode swaps only when lo > hi strictly, so
// equal docs keep their stream order (segmented sums add equal docs in stream
// order, so this order fixes the f32 scores bit for bit). Alternating mode
// (m != 0) flips the comparison inside odd m-blocks, as the Pallas kernels do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNearThreads = 1024;
constexpr int kFarThreads = 256;

__device__ __forceinline__ void exchange(int32_t* docs, float* contribs,
                                         int64_t lo, int64_t hi, bool desc) {
  const int32_t a = docs[lo];
  const int32_t b = docs[hi];
  if ((a > b) != desc) {
    docs[lo] = b;
    docs[hi] = a;
    const float t = contribs[lo];
    contribs[lo] = contribs[hi];
    contribs[hi] = t;
  }
}

__global__ void near_stages_kernel(int32_t* __restrict__ docs,
                                   float* __restrict__ contribs, int n,
                                   int tile, int d0, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sd = reinterpret_cast<int32_t*>(smem);
  float* sc = reinterpret_cast<float*>(sd + tile);
  const int64_t tile_start = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n + tile_start;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    sd[i] = docs[base + i];
    sc[i] = contribs[base + i];
  }
  __syncthreads();
  const int half = tile >> 1;
  for (int d = d0; d >= 1; d >>= 1) {
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int lo = ((p & ~(d - 1)) << 1) | (p & (d - 1));
      const bool desc = m != 0 && ((tile_start + lo) & m) != 0;
      exchange(sd, sc, lo, lo + d, desc);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    docs[base + i] = sd[i];
    contribs[base + i] = sc[i];
  }
}

__global__ void far_stage_kernel(int32_t* __restrict__ docs,
                                 float* __restrict__ contribs, int n, int d,
                                 int m) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n / 2) return;
  const int64_t lo = ((p & ~static_cast<int64_t>(d - 1)) << 1) |
                     (p & static_cast<int64_t>(d - 1));
  const bool desc = m != 0 && (lo & m) != 0;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  exchange(docs + base, contribs + base, lo, lo + d, desc);
}

}  // namespace

// docs int32 [B, n], contribs f32 [B, n], n a multiple of tile, tile a power
// of two, 2 * d0 <= tile, m = 0 (ascending) or the sort-block size.
extern "C" int nrt_near_stages(void* docs, void* contribs, int B, int n,
                               int tile, int d0, int m, void* stream) {
  const int smem = tile * 8;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        near_stages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = tile / 2 < kNearThreads ? tile / 2 : kNearThreads;
  dim3 grid(n / tile, B);
  near_stages_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(docs), static_cast<float*>(contribs), n, tile, d0,
      m);
  return static_cast<int>(cudaGetLastError());
}

// One stage at distance d (a power of two, 2 * d <= n) over [B, n], in place.
extern "C" int nrt_far_stage(void* docs, void* contribs, int B, int n, int d,
                             int m, void* stream) {
  const int64_t pairs = n / 2;
  dim3 grid(static_cast<unsigned>((pairs + kFarThreads - 1) / kFarThreads), B);
  far_stage_kernel<<<grid, kFarThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(docs), static_cast<float*>(contribs), n, d, m);
  return static_cast<int>(cudaGetLastError());
}

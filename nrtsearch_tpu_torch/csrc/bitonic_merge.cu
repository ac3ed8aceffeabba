// Compare-exchange stages of the bitonic merge over [B, N] (docs, contribs)
// pairs, in place: `near_stages` (every stage d0, d0/2, ..., 1 inside one
// shared-memory tile), `far_stage` (one stage at a distance too long for a
// tile) and `far_pair_stage` (two such stages, d and d/2, in one pass).
//
// Replaces: nrtsearch_tpu/ops/pallas_merge.py `near_stages` / `_near_kernel`,
// `far_stage` / `_far_kernel` and `far_pair_stage` / `_far_pair_kernel`,
// which `merge_level_pallas` and `merge_sorted_runs_alt` compose for
// ops/merge_scoring.py `merge_score_topk`.
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
// (i, i + d) for d >= tile. far_pair_stage runs one thread per quad: the
// four entries i, i + d/2, i + d, i + 3d/2 of one 2d block take both stages
// in registers (stage d exchanges quarters 0-2 and 1-3, stage d/2 then 0-1
// and 2-3), so two stages cost one read and one write instead of two each.
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

__device__ __forceinline__ void exchange_regs(int32_t& da, int32_t& db,
                                              float& ca, float& cb, bool desc) {
  if ((da > db) != desc) {
    const int32_t td = da;
    da = db;
    db = td;
    const float tc = ca;
    ca = cb;
    cb = tc;
  }
}

__global__ void far_pair_stage_kernel(int32_t* __restrict__ docs,
                                      float* __restrict__ contribs, int n,
                                      int d, int m) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n / 4) return;
  const int64_t q = d / 2;  // quarter length
  const int64_t start = (p & ~(q - 1)) * 4;  // the 2d block's first entry
  const int64_t i = start + (p & (q - 1));
  const bool desc = m != 0 && (start & m) != 0;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n;
  int32_t* rd = docs + base;
  float* rc = contribs + base;
  int32_t d0 = rd[i], d1 = rd[i + q], d2 = rd[i + 2 * q], d3 = rd[i + 3 * q];
  float c0 = rc[i], c1 = rc[i + q], c2 = rc[i + 2 * q], c3 = rc[i + 3 * q];
  exchange_regs(d0, d2, c0, c2, desc);  // stage d
  exchange_regs(d1, d3, c1, c3, desc);
  exchange_regs(d0, d1, c0, c1, desc);  // stage d/2
  exchange_regs(d2, d3, c2, c3, desc);
  rd[i] = d0;
  rd[i + q] = d1;
  rd[i + 2 * q] = d2;
  rd[i + 3 * q] = d3;
  rc[i] = c0;
  rc[i + q] = c1;
  rc[i + 2 * q] = c2;
  rc[i + 3 * q] = c3;
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

// Stages d and d/2 (d a power of two, 2 <= d, 2 * d <= n) over [B, n], in
// place; m = 0 (ascending) or the sort-block size.
extern "C" int nrt_far_pair_stage(void* docs, void* contribs, int B, int n,
                                  int d, int m, void* stream) {
  const int64_t quads = n / 4;
  dim3 grid(static_cast<unsigned>((quads + kFarThreads - 1) / kFarThreads), B);
  far_pair_stage_kernel<<<grid, kFarThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(docs), static_cast<float*>(contribs), n, d, m);
  return static_cast<int>(cudaGetLastError());
}

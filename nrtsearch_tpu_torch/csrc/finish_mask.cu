// One-pass finish of the merge path's accelerator branch: the doc-sorted
// [B, n] stream (docs int32, contribs f32) -> f32 [B, n], the per-doc sum at
// each doc's last entry where that entry is valid (no sentinel), the sum is
// > 0 and, with require_all, the doc has at least n_terms[b] entries; -inf
// everywhere else.
//
// Replaces: nrtsearch_tpu/ops/pallas_merge.py `finish_mask_pallas` /
// `_finish_kernel` (the bounded-distance segmented scan and the tail mask on
// a VMEM tile with an 8-row halo).
//
// Sums: the same Hillis-Steele scan as ops/merge_scoring.py
// `segmented_scores`, in the same order: for d = 1, 2, 4, ... < max_seg,
// s[p] += (docs[p] == docs[p - d]) ? s[p - d] : 0.0f. Adds only, so no FMA
// can arise, and the scores are bit-equal to the plain version.
//
// Bound on the card: device-memory traffic, one read of the stream and one
// write of the output (the shifted-add scan in plain torch makes
// 2 * log2(max_seg) passes).
//
// Design: each block takes a tile of `tile` entries of one row and loads it
// into shared memory with the `halo` entries before it (halo = 1 + 2 + ...,
// the scan's reach, max_seg - 1 for a power-of-two max_seg) and the one entry
// after it (for the last-entry test). The halo is clipped at the row start;
// an entry with no predecessor at distance d adds nothing, as the plain
// version's shift fills. The steps ping-pong between two buffers with a
// barrier between them. The TPU kernel's roll emulation has no counterpart,
// and unlike it (pallas_merge.py:420) the halo never reads before the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int32_t kHigh = 2147483647;    // DOC_SENTINEL
constexpr int32_t kLow = -2147483647;    // DOC_SENTINEL_LOW
constexpr int32_t kNoDoc = -2;           // the row end's "next doc"

__global__ void finish_mask_kernel(const int32_t* __restrict__ docs,
                                   const float* __restrict__ contribs,
                                   const int32_t* __restrict__ n_terms,
                                   float* __restrict__ out, int n, int tile,
                                   int halo, int max_seg, int require_all) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cap = tile + halo;  // largest window
  int32_t* sd = reinterpret_cast<int32_t*>(smem);     // cap + 1 docs
  float* sa = reinterpret_cast<float*>(sd + cap + 1);  // sums, ping
  float* sb = sa + cap;                                // sums, pong
  int32_t* ca = reinterpret_cast<int32_t*>(sb + cap);  // counts (require_all)
  int32_t* cb = ca + cap;

  const int64_t row = static_cast<int64_t>(blockIdx.y) * n;
  const int t0 = blockIdx.x * tile;
  const int t1 = min(t0 + tile, n);
  const int w0 = max(t0 - halo, 0);
  const int W = t1 - w0;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const int32_t doc = docs[row + w0 + i];
    sd[i] = doc;
    sa[i] = contribs[row + w0 + i];
    if (require_all) ca[i] = (doc != kHigh && doc != kLow) ? 1 : 0;
  }
  if (threadIdx.x == 0) sd[W] = t1 < n ? docs[row + t1] : kNoDoc;
  __syncthreads();

  for (int d = 1; d < max_seg; d <<= 1) {
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      const bool same = i >= d && sd[i] == sd[i - d];
      sb[i] = sa[i] + (same ? sa[i - d] : 0.0f);
      if (require_all) cb[i] = ca[i] + (same ? ca[i - d] : 0);
    }
    __syncthreads();
    float* ts = sa;
    sa = sb;
    sb = ts;
    int32_t* tc = ca;
    ca = cb;
    cb = tc;
  }

  const float neg_inf = -__int_as_float(0x7f800000);
  const int32_t need = require_all ? n_terms[blockIdx.y] : 0;
  for (int i = (t0 - w0) + threadIdx.x; i < W; i += blockDim.x) {
    const int32_t doc = sd[i];
    const float s = sa[i];
    bool ok = doc != sd[i + 1] && doc != kHigh && doc != kLow && s > 0.0f;
    if (require_all) ok = ok && ca[i] >= need;
    out[row + w0 + i] = ok ? s : neg_inf;
  }
}

}  // namespace

// docs int32 [B, n], contribs f32 [B, n], n_terms int32 [B], out f32 [B, n];
// `smem` bytes of dynamic shared memory: (tile + halo + 1) * 4 +
// (tile + halo) * 8 (* 2 with require_all). Returns cudaGetLastError().
extern "C" int nrt_finish_mask(const void* docs, const void* contribs,
                               const void* n_terms, void* out, int B, int n,
                               int tile, int halo, int max_seg,
                               int require_all, int smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        finish_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((n + tile - 1) / tile, B);
  finish_mask_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(docs), static_cast<const float*>(contribs),
      static_cast<const int32_t*>(n_terms), static_cast<float*>(out), n, tile,
      halo, max_seg, require_all);
  return static_cast<int>(cudaGetLastError());
}

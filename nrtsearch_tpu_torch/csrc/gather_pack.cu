// Gather + pack of the bucket path: per (query, bucket) row, the row's slice
// of each of the query's T term runs, back to back in slot order, one int32
// key per posting, `local_doc << 16 | clamp((int)(w * imp + 0.5), 1, 32000)`
// (I32_SENT for a deleted posting, impact <= 0), I32_SENT past the slices.
//
// Replaces: nrtsearch_tpu/ops/bucket_retrieval.py `gather_pack_pallas` /
// `_gather_pack_kernel` (one DMA ring per slot sized by static capacities,
// a dynamic roll to place each slice, a take-mask to keep it).
//
// Semantics: slot t of row q * m + b covers source entries
// [toffs[q, t] + bounds[q, t, b], toffs[q, t] + bounds[q, t, b + 1]) and
// takes room only when wts[q, t] != 0. The contribution is one FMA with a
// single rounding (__fmaf_rn), the form the reference's compiled kernel
// takes, then truncated toward zero. An entry outside [0, P) is a caller bug
// and traps.
//
// Bound on the card: device-memory traffic, 8 bytes read per posting and
// 4 bytes written per tile position (the tile is the batch's largest bucket
// sum rounded up to a power of two, so most rows are mostly padding).
//
// Design: one block per row with a block-stride loop over its tile. Thread 0
// puts the <= 16 slot starts, ends (inclusive prefix of the lengths) and
// weights in shared memory; each position finds its slot by a scan over the
// ends. Neighbouring positions read neighbouring postings of one slot, so
// loads coalesce. The TPU kernel's DMA ring, roll and capacities have no
// counterpart: a position reads only inside its slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSlots = 16;
constexpr int32_t kSent = 2147483647;  // I32_SENT
constexpr int32_t kQmax = 32000;

__global__ void gather_pack_kernel(const int32_t* __restrict__ post_docs,
                                   const float* __restrict__ post_impacts,
                                   int64_t n_postings,
                                   const int32_t* __restrict__ toffs,
                                   const int32_t* __restrict__ bounds,
                                   const float* __restrict__ wts,
                                   int32_t* __restrict__ keys, int T, int m,
                                   int tile, int bucket_bits) {
  __shared__ int64_t s_start[kMaxSlots];
  __shared__ int s_end[kMaxSlots];
  __shared__ float s_w[kMaxSlots];
  const int row = blockIdx.x;  // q * m + bkt
  const int q = row / m;
  const int bkt = row - q * m;
  if (threadIdx.x == 0) {
    int end = 0;
    for (int t = 0; t < T; ++t) {
      const int32_t* b = bounds + (static_cast<int64_t>(q) * T + t) * (m + 1);
      const float w = wts[q * T + t];
      s_start[t] = static_cast<int64_t>(toffs[q * T + t]) + b[bkt];
      if (w != 0.0f) end += b[bkt + 1] - b[bkt];
      s_end[t] = end;
      s_w[t] = w;
    }
  }
  __syncthreads();

  const int32_t base = bkt << bucket_bits;
  const int32_t mask = (1 << bucket_bits) - 1;
  int32_t* out = keys + static_cast<int64_t>(row) * tile;
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    int t = 0;
    while (t < T && p >= s_end[t]) ++t;
    int32_t key = kSent;
    if (t < T) {
      const int dest = t ? s_end[t - 1] : 0;
      const int64_t src = s_start[t] + (p - dest);
      if (src < 0 || src >= n_postings) __trap();
      const float imp = post_impacts[src];
      if (imp > 0.0f) {
        const int32_t local = (post_docs[src] - base) & mask;
        int quant = static_cast<int>(__fmaf_rn(s_w[t], imp, 0.5f));
        quant = min(max(quant, 1), kQmax);
        key = (local << 16) | quant;
      }
    }
    out[p] = key;
  }
}

}  // namespace

// post_docs int32 [P], post_impacts f32 [P]; toffs int32 [B, T]; bounds
// int32 [B, T, m + 1]; wts f32 [B, T]; keys int32 [B * m, tile]. T <= 16.
// Returns cudaGetLastError() after the launch.
extern "C" int nrt_gather_pack(const void* post_docs, const void* post_impacts,
                               long long n_postings, const void* toffs,
                               const void* bounds, const void* wts, void* keys,
                               int B, int T, int m, int tile, int bucket_bits,
                               void* stream) {
  const unsigned blocks = static_cast<unsigned>(B) * static_cast<unsigned>(m);
  gather_pack_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(post_docs),
      static_cast<const float*>(post_impacts), n_postings,
      static_cast<const int32_t*>(toffs), static_cast<const int32_t*>(bounds),
      static_cast<const float*>(wts), static_cast<int32_t*>(keys), T, m, tile,
      bucket_bits);
  return static_cast<int>(cudaGetLastError());
}

// Finish of the bucket path: per (query, bucket) row of packed keys
// (`local_doc << 16 | contrib`, I32_SENT padding), the per-doc sum of the
// contributions and the doc's posting count, written as dense rank keys in
// global doc order: rank[q, bkt * bucket_docs + doc] = min(sum, 32000) where
// count > 0, sum > 0 and, with require_all, count >= n_terms[q]; I32_MIN
// everywhere else.
//
// Replaces: nrtsearch_tpu/ops/bucket_retrieval.py `sort_finish_pallas` /
// `_sort_finish_kernel` (a bitonic sort of the key tile in VMEM, a bounded
// segmented scan over equal docs and a tail mask, emitting (rank, doc) per
// tile position).
//
// Semantics: the reference sorts only to group equal docs. A doc's postings
// are summed here in an int32 shared-memory accumulator with integer
// atomics, so the order of the adds does not matter and the result is
// bit-exact: the same ranks the reference emits at each doc's tail, laid out
// by doc id, so a position is the doc id and lax.top_k's lower-index tie
// rule over the reference's layout (buckets ascend, docs ascend in a sorted
// tile) is the lower-position rule here. A doc field at or past bucket_docs
// is a caller bug and traps.
//
// Bound on the card: device-memory traffic, 4 bytes read per tile position
// and 4 bytes written per doc; shared-memory atomics in between. A tile of
// 2^16 keys (256 KB) does not fit a block's 227 KB, so a block-by-block port
// of the sort would need passes over device memory; the accumulator needs
// bucket_docs * 4 bytes (64 KB at 16384 docs).
//
// Design: one block per row. The block zeroes acc[bucket_docs], adds
// (1 << 20) | contrib for every key that is not I32_SENT (a sum is at most
// 16 * 32000 < 2^20, a count at most 16 slots, in bits 20-24), then writes
// the doc's rank key; neighbouring threads write neighbouring docs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int32_t kSent = 2147483647;             // I32_SENT
constexpr int32_t kMin = -2147483647 - 1;         // I32_MIN
constexpr int32_t kQmax = 32000;
constexpr int kCountShift = 20;

__global__ void sort_finish_kernel(const int32_t* __restrict__ keys,
                                   const int32_t* __restrict__ n_terms,
                                   int32_t* __restrict__ rank, int m, int tile,
                                   int bucket_bits, int require_all) {
  extern __shared__ int32_t acc[];
  const int bd = 1 << bucket_bits;
  const int row = blockIdx.x;  // q * m + bkt
  const int q = row / m;
  for (int i = threadIdx.x; i < bd; i += blockDim.x) acc[i] = 0;
  __syncthreads();

  const int32_t* in = keys + static_cast<int64_t>(row) * tile;
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    const int32_t key = in[p];
    if (key == kSent) continue;
    const int32_t doc = key >> 16;
    if (static_cast<uint32_t>(doc) >= static_cast<uint32_t>(bd)) __trap();
    atomicAdd(&acc[doc], (1 << kCountShift) | (key & 0xFFFF));
  }
  __syncthreads();

  const int32_t need = require_all ? n_terms[q] : 0;
  int32_t* out = rank + static_cast<int64_t>(row) * bd;  // = q * m * bd + bkt * bd
  for (int i = threadIdx.x; i < bd; i += blockDim.x) {
    const int32_t a = acc[i];
    const int32_t count = a >> kCountShift;
    const int32_t sum = a & ((1 << kCountShift) - 1);
    bool ok = count > 0 && sum > 0;
    if (require_all) ok = ok && count >= need;
    out[i] = ok ? min(sum, kQmax) : kMin;
  }
}

}  // namespace

// keys int32 [B * m, tile]; n_terms int32 [B]; rank int32 [B, m * 2^bucket_bits];
// `smem` = 2^bucket_bits * 4 bytes of dynamic shared memory. Returns
// cudaGetLastError() after the launch.
extern "C" int nrt_sort_finish(const void* keys, const void* n_terms,
                               void* rank, int B, int m, int tile,
                               int bucket_bits, int require_all, int smem,
                               void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(B) * static_cast<unsigned>(m);
  sort_finish_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(n_terms),
      static_cast<int32_t*>(rank), m, tile, bucket_bits, require_all);
  return static_cast<int>(cudaGetLastError());
}

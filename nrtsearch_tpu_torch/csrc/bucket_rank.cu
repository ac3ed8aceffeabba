// The bucket path in one pass: per (query, bucket) row, every posting of the
// row's slice of each of the query's T term runs is summed straight into a
// shared-memory accumulator, then the row's dense rank keys are written:
// rank[q, bkt * bucket_docs + doc] = min(sum, 32000) where the doc has a
// posting, a positive sum and, with require_all, at least n_terms[q]
// postings; I32_MIN everywhere else.
//
// Replaces: nrtsearch_tpu/ops/bucket_retrieval.py `gather_pack_pallas` /
// `_gather_pack_kernel` (a DMA ring per slot packing `local_doc << 16 |
// contrib` keys into a key tile) and `sort_finish_pallas` /
// `_sort_finish_kernel` (a bitonic sort of that tile in VMEM, a bounded
// segmented scan over equal docs, a tail mask), both in one kernel.
//
// Semantics: slot t of row q * m + b covers postings [toffs[q, t] +
// bounds[q, t, b], toffs[q, t] + bounds[q, t, b + 1]) and counts only when
// wts[q, t] != 0. A posting with impact <= 0 (deleted) adds nothing; any
// other adds (1 << 20) | clamp((int)fma(w, imp, 0.5), 1, 32000) at
// acc[(doc - b * bucket_docs) & (bucket_docs - 1)]: the contribution with
// one rounding (the form the reference's compiled kernel takes), truncated,
// and the count in bits 20-24 (a sum is at most 16 * 32000 < 2^20, a count
// at most 16 slots). The reference sorts only to group equal docs; integer
// adds give the same sums in any order, so the result is bit-exact, laid
// out by doc id (lax.top_k's lower-index tie rule over the reference's
// layout, buckets ascending and docs ascending in a sorted tile, is the
// lower-position rule here). A live slice outside [0, P) is a caller bug and
// traps; it is checked once per slot.
//
// Bound on the card: device-memory traffic, 8 bytes read per posting of a
// live slot and 4 bytes written per doc of the row. The accumulator stays in
// shared memory (bucket_docs * 4 bytes: 64 KB at 16384 docs, so three
// 256-thread blocks fit an SM). The two kernels this replaces also wrote and
// read back a [B * m, tile] key tile, mostly padding (tile: the batch's
// largest row rounded up to a power of two).
//
// Design: one block per row. The block zeroes the accumulator with 16-byte
// stores while one warp puts the row's live slots (start, length, weight,
// the vectors before it) in shared memory, compacted by ballot and summed
// by shuffles. Each slice is read as 16-byte vectors of docs and impacts,
// its unaligned ends (< 4 postings each) as scalars by 8 threads a slot.
// The vectors are dealt to the threads over the slices back to back (a
// thread's first vector in a slice is rotated by the vectors before it), so
// short slices keep every thread busy, and each thread has kUnroll vector
// pairs in flight before it adds. After one barrier the row's keys are
// written with 16-byte stores. No position searches for its slot. (A
// two-stage ring of 1-D bulk copies, cp.async.bulk into 32 KB of shared
// memory with an mbarrier per stage, read 2% slower on the H100: it costs a
// block per SM and a barrier per stage, and these loads already coalesce.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 16;
constexpr int kUnroll = 4;
constexpr int32_t kMin = -2147483647 - 1;  // I32_MIN
constexpr int32_t kQmax = 32000;
constexpr int kCountShift = 20;

struct SlotTable {
  long long start[kMaxSlots];  // first posting of the slice
  long long vbase[kMaxSlots];  // first posting of its 16-byte aligned part
  int len[kMaxSlots];
  int head[kMaxSlots];         // postings before the aligned part (< 4)
  int nvec[kMaxSlots];         // 4-posting vectors of the aligned part
  int pre[kMaxSlots];          // vectors of the row's slices before it
  float w[kMaxSlots];
  int n;                       // live slots
};

__device__ __forceinline__ void add_posting(int32_t* acc, int32_t doc, float imp,
                                            float w, int32_t base, int32_t mask) {
  if (imp > 0.0f) {
    int quant = static_cast<int>(__fmaf_rn(w, imp, 0.5f));
    quant = min(max(quant, 1), kQmax);
    atomicAdd(&acc[(doc - base) & mask], (1 << kCountShift) | quant);
  }
}

__device__ __forceinline__ void add_vector(int32_t* acc, int4 d, float4 im, float w,
                                           int32_t base, int32_t mask) {
  add_posting(acc, d.x, im.x, w, base, mask);
  add_posting(acc, d.y, im.y, w, base, mask);
  add_posting(acc, d.z, im.z, w, base, mask);
  add_posting(acc, d.w, im.w, w, base, mask);
}

__device__ __forceinline__ int32_t rank_key(int32_t a, int32_t need) {
  const int32_t count = a >> kCountShift;
  const int32_t sum = a & ((1 << kCountShift) - 1);
  return (count > 0 && sum > 0 && count >= need) ? min(sum, kQmax) : kMin;
}

// The first of a thread's vectors in a stretch [lo, hi) of the row's vectors
// dealt round-robin from vector 0, as an offset from lo.
__device__ __forceinline__ int first_from(int lo) {
  const int r = lo % kThreads;
  return threadIdx.x >= r ? threadIdx.x - r : threadIdx.x + kThreads - r;
}

__global__ void __launch_bounds__(kThreads) bucket_rank_kernel(
    const int32_t* __restrict__ post_docs, const float* __restrict__ post_impacts,
    long long n_postings, const int32_t* __restrict__ toffs,
    const int32_t* __restrict__ bounds, const float* __restrict__ wts,
    const int32_t* __restrict__ n_terms, int32_t* __restrict__ rank, int T, int m,
    int bucket_bits, int require_all) {
  extern __shared__ int4 smem[];
  __shared__ SlotTable s;
  int32_t* acc = reinterpret_cast<int32_t*>(smem);
  const int bd = 1 << bucket_bits;
  const int row = blockIdx.x;  // q * m + bkt
  const int q = row / m;
  const int bkt = row - q * m;

  for (int i = threadIdx.x; i < bd / 4; i += kThreads) smem[i] = make_int4(0, 0, 0, 0);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long start = 0;
    int len = 0;
    float w = 0.0f;
    if (lane < T) {
      const int32_t* b = bounds + (static_cast<long long>(q) * T + lane) * (m + 1);
      w = wts[q * T + lane];
      start = static_cast<long long>(toffs[q * T + lane]) + b[bkt];
      len = b[bkt + 1] - b[bkt];
      if (w == 0.0f) {
        len = 0;      // a zero-weight slot takes no room in the reference's tile
      } else if (len < 0 || start < 0 || start + len > n_postings) {
        __trap();
      }
    }
    const unsigned live = __ballot_sync(0xffffffffu, len > 0);
    const int head = min(len, static_cast<int>((-start) & 3));
    const int nvec = (len - head) >> 2;
    int incl = nvec;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    if (len > 0) {
      const int i = __popc(live & ((1u << lane) - 1));
      s.start[i] = start;
      s.vbase[i] = start + head;
      s.len[i] = len;
      s.head[i] = head;
      s.nvec[i] = nvec;
      s.pre[i] = incl - nvec;
      s.w[i] = w;
    }
    if (lane == 0) s.n = __popc(live);
  }
  __syncthreads();

  const int32_t base = bkt << bucket_bits;
  const int32_t mask = bd - 1;
  // the unaligned ends: slot i's head by threads 8i..8i+3, its tail by 8i+4..8i+7
  {
    const int i = threadIdx.x >> 3, j = threadIdx.x & 7;
    if (i < s.n) {
      const int tail = s.head[i] + 4 * s.nvec[i];
      const int off = j < 4 ? j : tail + j - 4;
      if (j < 4 ? j < s.head[i] : off < s.len[i]) {
        const long long p = s.start[i] + off;
        add_posting(acc, post_docs[p], post_impacts[p], s.w[i], base, mask);
      }
    }
  }

  // the 16-byte vectors, dealt round-robin over the slices back to back
  int i = 0;
  int v = s.n ? first_from(s.pre[0]) : 0;
  for (;;) {
    int4 d[kUnroll];
    float4 im[kUnroll];
    float w[kUnroll];
    unsigned valid = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      while (i < s.n && v >= s.nvec[i]) {
        ++i;
        if (i < s.n) v = first_from(s.pre[i]);
      }
      if (i < s.n) {
        const long long p = s.vbase[i] + 4LL * v;
        d[u] = __ldg(reinterpret_cast<const int4*>(post_docs + p));
        im[u] = __ldg(reinterpret_cast<const float4*>(post_impacts + p));
        w[u] = s.w[i];
        valid |= 1u << u;
        v += kThreads;
      }
    }
    if (!valid) break;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (valid >> u & 1) add_vector(acc, d[u], im[u], w[u], base, mask);
    }
  }
  __syncthreads();

  const int32_t need = require_all ? n_terms[q] : 0;
  int4* out = reinterpret_cast<int4*>(rank + static_cast<long long>(row) * bd);
  for (int i = threadIdx.x; i < bd / 4; i += kThreads) {
    const int4 a = smem[i];
    out[i] = make_int4(rank_key(a.x, need), rank_key(a.y, need), rank_key(a.z, need),
                       rank_key(a.w, need));
  }
}

}  // namespace

// post_docs int32 [P], post_impacts f32 [P], both 16-byte aligned; toffs int32
// [B, T]; bounds int32 [B, T, m + 1]; wts f32 [B, T]; n_terms int32 [B];
// rank int32 [B, m * 2^bucket_bits]. 1 <= T <= 16, 2 <= bucket_bits <= 15.
// Returns cudaGetLastError() after the launch (or the error of raising the
// block's shared-memory limit).
extern "C" int nrt_bucket_rank(const void* post_docs, const void* post_impacts,
                               long long n_postings, const void* toffs,
                               const void* bounds, const void* wts,
                               const void* n_terms, void* rank, int B, int T, int m,
                               int bucket_bits, int require_all, void* stream) {
  const int smem = 4 << bucket_bits;
  // always: the static slot table counts against the default 48 KB too
  const cudaError_t err = cudaFuncSetAttribute(
      bucket_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(B) * static_cast<unsigned>(m);
  bucket_rank_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(post_docs), static_cast<const float*>(post_impacts),
      n_postings, static_cast<const int32_t*>(toffs),
      static_cast<const int32_t*>(bounds), static_cast<const float*>(wts),
      static_cast<const int32_t*>(n_terms), static_cast<int32_t*>(rank), T, m,
      bucket_bits, require_all);
  return static_cast<int>(cudaGetLastError());
}

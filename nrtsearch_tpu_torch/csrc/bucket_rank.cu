// The bucket path in one pass: per (query, bucket) row, every posting of the
// row's slice of each of the query's T term runs is summed straight into a
// shared-memory accumulator. Two entries share that accumulate phase and
// differ in what the row hands on:
//
// - nrt_bucket_rank writes the row's dense rank keys:
//   rank[q, bkt * bucket_docs + doc] = min(sum, 32000) where the doc has a
//   posting, a positive sum and, with require_all, at least n_terms[q]
//   postings; I32_MIN everywhere else. The dense tail of ops/dense_head.py
//   reads it, since it adds head scores at every doc.
// - nrt_bucket_rank_topk writes only the row's top kk = min(k, bucket_docs)
//   by (rank key desc, doc asc), I32_MIN docs included, as int64 keys
//   (key << 32) | (2^32 - 1 - global doc), and adds the row's hit count
//   (keys other than I32_MIN) into hits[q]. Any entry of a query's top k is
//   in its own row's top kk under the same order, so the top k of the
//   query's m * kk candidates is the top k of the dense keys, bit for bit,
//   I32_MIN fillers and their docs included.
//
// Replaces: nrtsearch_tpu/ops/bucket_retrieval.py `gather_pack_pallas` /
// `_gather_pack_kernel` (a DMA ring per slot packing `local_doc << 16 |
// contrib` keys into a key tile) and `sort_finish_pallas` /
// `_sort_finish_kernel` (a bitonic sort of that tile in VMEM, a bounded
// segmented scan over equal docs, a tail mask), both in one kernel; the top-k
// entry also replaces `_hierarchical_topk_i32` over the dense keys (the
// port's dense write plus ops/topk.py `topk_i32_lowest_index`) by a
// selection inside the block.
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
// live slot, plus 4 bytes written per doc of the row (dense entry) or 8
// bytes per candidate, kk a row (top-k entry: 0.8 KB a row at k = 100
// against 64 KB of dense keys at 16384 docs). The accumulator stays in
// shared memory (bucket_docs * 4 bytes: 64 KB at 16384 docs, so three
// 256-thread blocks fit an SM; the top-k entry adds 1.6 KB of histograms).
// The two kernels this replaces also wrote and read back a [B * m, tile]
// key tile, mostly padding (tile: the batch's largest row rounded up to a
// power of two).
//
// Design of the accumulate phase: one block per row. The block zeroes the
// accumulator with 16-byte stores while one warp puts the row's live slots
// (start, length, weight, the vectors before it) in shared memory, compacted
// by ballot and summed by shuffles. Each slice is read as 16-byte vectors of
// docs and impacts, its unaligned ends (< 4 postings each) as scalars by 8
// threads a slot. The vectors are dealt to the threads over the slices back
// to back (a thread's first vector in a slice is rotated by the vectors
// before it), so short slices keep every thread busy, and each thread has
// kUnroll vector pairs in flight before it adds. No position searches for
// its slot. (A two-stage ring of 1-D bulk copies, cp.async.bulk into 32 KB
// of shared memory with an mbarrier per stage, read 2% slower on the H100:
// it costs a block per SM and a barrier per stage, and these loads already
// coalesce.) The dense entry then writes the keys with 16-byte stores.
//
// Design of the selection (top-k entry), all in shared memory: keys are at
// most 32000 (15 bits), so the row's threshold key tau (its kk-th largest)
// comes from two histograms, 128 bins of the high bits (filled while the
// keys are formed in place, hits only) and 256 bins of the low bits within
// the chosen high bin, each searched by one warp with a shuffle scan. A row
// with at most kk hits skips both: tau is the no-hit key. Entries above tau
// take the first slots (their order does not matter), and the first kk -
// (entries above tau) entries equal to tau the rest, in doc order. Each
// warp owns an eighth of the row and reads it 128 entries a step (a lane's
// 16 bytes). The warps' counts of entries above and equal to tau (from the
// first pass where tau is the no-hit key, else from one more) give each
// warp its first slot and rank; one ballot per entry of the lanes' vectors
// gives them within a step, so the candidates' order is the same on every
// run. A step with nothing to emit costs one vote, and a warp stops as soon
// as its own entries above tau have slots and its equal entries are past
// the last rank. At the bucket cell's shape on the H100 (B = 32, m = 1024,
// half the rows over k hits) the accumulate phase takes 0.62 of 1.20 ms,
// the histograms and threshold 0.23 and the emission 0.35, bound by
// instruction throughput in rows whose top k is spread over most steps (a
// shared slot counter instead of the ballots read the same; ballots per
// step for the ranks of every entry, 0.47 of 1.30). Only the kk candidates
// reach device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 16;
constexpr int kUnroll = 4;
constexpr int32_t kMin = -2147483647 - 1;  // I32_MIN
constexpr int32_t kQmax = 32000;
constexpr int kCountShift = 20;
constexpr int kHiBins = 128;               // key >> 8 (keys < 2^15)
constexpr int kLoBins = 256;               // key & 255

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

// The top-k entry's selection state.
struct Selection {
  int hist_hi[kHiBins];
  int hist_lo[kLoBins];
  int warp_eq[kWarps];         // entries equal to tau in each warp's part
  int warp_up[kWarps];         // entries above tau in each warp's part
  int hits;
  int bin, above;              // select_bin's answer
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

// The accumulate phase of row (q, bkt): acc[local doc] = (count << 20) | sum
// over the row's live slots. Ends with a barrier.
__device__ __forceinline__ void accumulate_row(
    int4* smem, SlotTable& s, const int32_t* __restrict__ post_docs,
    const float* __restrict__ post_impacts, long long n_postings,
    const int32_t* __restrict__ toffs, const int32_t* __restrict__ bounds,
    const float* __restrict__ wts, int T, int m, int bucket_bits, int q, int bkt) {
  int32_t* acc = reinterpret_cast<int32_t*>(smem);
  const int bd = 1 << bucket_bits;

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
}

__global__ void __launch_bounds__(kThreads) bucket_rank_kernel(
    const int32_t* __restrict__ post_docs, const float* __restrict__ post_impacts,
    long long n_postings, const int32_t* __restrict__ toffs,
    const int32_t* __restrict__ bounds, const float* __restrict__ wts,
    const int32_t* __restrict__ n_terms, int32_t* __restrict__ rank, int T, int m,
    int bucket_bits, int require_all) {
  extern __shared__ int4 smem[];
  __shared__ SlotTable s;
  const int bd = 1 << bucket_bits;
  const int row = blockIdx.x;  // q * m + bkt
  const int q = row / m;
  const int bkt = row - q * m;
  accumulate_row(smem, s, post_docs, post_impacts, n_postings, toffs, bounds, wts, T, m,
                 bucket_bits, q, bkt);

  const int32_t need = require_all ? n_terms[q] : 0;
  int4* out = reinterpret_cast<int4*>(rank + static_cast<long long>(row) * bd);
  for (int i = threadIdx.x; i < bd / 4; i += kThreads) {
    const int4 a = smem[i];
    out[i] = make_int4(rank_key(a.x, need), rank_key(a.y, need), rank_key(a.z, need),
                       rank_key(a.w, need));
  }
}

// A row entry's selection score: its rank key, or 0 for I32_MIN (keys of
// hits are >= 1). Hits count and fill the high-bit histogram.
__device__ __forceinline__ int32_t score_of(int32_t a, int32_t need, Selection& sel,
                                            int& hits) {
  const int32_t key = rank_key(a, need);
  if (key == kMin) return 0;
  ++hits;
  atomicAdd(&sel.hist_hi[key >> 8], 1);
  return key;
}

// A candidate's int64 key: (rank key << 32) | (2^32 - 1 - global doc), the
// no-hit score 0 as I32_MIN.
__device__ __forceinline__ long long candidate(int32_t sv, long long doc) {
  const uint32_t key = static_cast<uint32_t>(sv > 0 ? sv : kMin);
  const uint32_t low = 0xffffffffu - static_cast<uint32_t>(doc);
  return static_cast<long long>((static_cast<unsigned long long>(key) << 32) | low);
}

__device__ __forceinline__ void add_low_bin(int32_t sv, int hi, Selection& sel) {
  if (sv > 0 && (sv >> 8) == hi) atomicAdd(&sel.hist_lo[sv & 255], 1);
}

// By warp 0: the bin b of hist (32 * kPer bins, ascending keys) holding the
// target-th largest entry, with above = the entries of the bins over it, so
// that above < target <= above + hist[b]. The histogram holds at least
// target entries.
template <int kPer>
__device__ __forceinline__ void select_bin(const int* hist, int target, Selection& sel) {
  const int lane = threadIdx.x & 31;
  const int top = 32 * kPer - 1;  // lane l holds bins top - kPer l - u, u < kPer
  int c[kPer];
  int local = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    c[u] = hist[top - kPer * lane - u];
    local += c[u];
  }
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += x;
  }
  const unsigned reach = __ballot_sync(0xffffffffu, incl >= target);
  if (lane == __ffs(reach) - 1) {
    int above = incl - local;
    bool found = false;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (!found && above + c[u] >= target) {
        sel.bin = top - kPer * lane - u;
        sel.above = above;
        found = true;
      }
      if (!found) above += c[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads) bucket_rank_topk_kernel(
    const int32_t* __restrict__ post_docs, const float* __restrict__ post_impacts,
    long long n_postings, const int32_t* __restrict__ toffs,
    const int32_t* __restrict__ bounds, const float* __restrict__ wts,
    const int32_t* __restrict__ n_terms, long long* __restrict__ cands,
    int32_t* __restrict__ hits, int T, int m, int bucket_bits, int require_all, int kk) {
  extern __shared__ int4 smem[];
  __shared__ SlotTable s;
  __shared__ Selection sel;
  const int bd = 1 << bucket_bits;
  const int row = blockIdx.x;  // q * m + bkt
  const int q = row / m;
  const int bkt = row - q * m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < kHiBins + kLoBins; i += kThreads) {
    if (i < kHiBins) sel.hist_hi[i] = 0;
    else sel.hist_lo[i - kHiBins] = 0;
  }
  if (threadIdx.x == 0) sel.hits = 0;
  accumulate_row(smem, s, post_docs, post_impacts, n_postings, toffs, bounds, wts, T, m,
                 bucket_bits, q, bkt);

  // Each warp owns an eighth of the row, in doc order, read as 16-byte
  // vectors (4 entries a lane, 128 a step). First: scores in place, the
  // warp's hits and the high-bit histogram.
  const int part = max(bd / kWarps, 4);
  const int lo = min(warp * part, bd), end = min(lo + part, bd);
  const int32_t need = require_all ? n_terms[q] : 0;
  int my_hits = 0;
  for (int i = lo + 4 * lane; i < end; i += 128) {
    const int4 a = smem[i >> 2];
    smem[i >> 2] = make_int4(score_of(a.x, need, sel, my_hits),
                             score_of(a.y, need, sel, my_hits),
                             score_of(a.z, need, sel, my_hits),
                             score_of(a.w, need, sel, my_hits));
  }
  my_hits = __reduce_add_sync(0xffffffffu, my_hits);
  if (lane == 0) {
    sel.warp_up[warp] = my_hits;               // above tau = 0, if it is
    sel.warp_eq[warp] = (end - lo) - my_hits;  // equal to it
    if (my_hits) atomicAdd(&sel.hits, my_hits);
  }
  __syncthreads();
  const int n_hits = sel.hits;
  if (threadIdx.x == 0 && n_hits) atomicAdd(&hits[q], n_hits);

  // tau: the kk-th largest score; above: the entries over it. At most kk
  // hits: all of them, then the first no-hit docs (tau 0, counted above).
  int tau = 0, above = n_hits;
  if (n_hits > kk) {
    if (warp == 0) select_bin<kHiBins / 32>(sel.hist_hi, kk, sel);
    __syncthreads();
    const int hi = sel.bin, above_hi = sel.above;
    for (int i = lo + 4 * lane; i < end; i += 128) {
      const int4 a = smem[i >> 2];
      add_low_bin(a.x, hi, sel);
      add_low_bin(a.y, hi, sel);
      add_low_bin(a.z, hi, sel);
      add_low_bin(a.w, hi, sel);
    }
    __syncthreads();
    if (warp == 0) select_bin<kLoBins / 32>(sel.hist_lo, kk - above_hi, sel);
    __syncthreads();
    tau = (hi << 8) | sel.bin;
    above = above_hi + sel.above;
    int up = 0, eq = 0;  // the warp's entries above and equal to tau
    for (int i = lo + 4 * lane; i < end; i += 128) {
      const int4 a = smem[i >> 2];
      up += (a.x > tau) + (a.y > tau) + (a.z > tau) + (a.w > tau);
      eq += (a.x == tau) + (a.y == tau) + (a.z == tau) + (a.w == tau);
    }
    up = __reduce_add_sync(0xffffffffu, up);
    eq = __reduce_add_sync(0xffffffffu, eq);
    if (lane == 0) {
      sel.warp_up[warp] = up;
      sel.warp_eq[warp] = eq;
    }
    __syncthreads();
  }
  // this warp's next slot above tau, and rank among the entries equal to it
  int slot = 0, rank = 0;
  for (int w = 0; w < warp; ++w) {
    slot += sel.warp_up[w];
    rank += sel.warp_eq[w];
  }
  int up_left = sel.warp_up[warp];

  const int n_eq = kk - above;
  const unsigned before = (1u << lane) - 1;
  const long long base = static_cast<long long>(bkt) << bucket_bits;
  long long* out = cands + static_cast<long long>(row) * kk;
  // warp-uniform: the loop ends once this warp's entries above tau have
  // their slots and its equal entries are past the last rank
  for (int b = lo; b < end && (up_left > 0 || rank < n_eq); b += 128) {
    const int i = b + 4 * lane;
    const int4 a = i < end ? smem[i >> 2] : make_int4(-1, -1, -1, -1);
    const int32_t v[4] = {a.x, a.y, a.z, a.w};
    const bool ranked = rank < n_eq;
    const bool has_up = max(max(a.x, a.y), max(a.z, a.w)) > tau;
    const bool has_eq = ranked && (a.x == tau || a.y == tau || a.z == tau || a.w == tau);
    if (!__any_sync(0xffffffffu, has_up || has_eq)) continue;
    if (__any_sync(0xffffffffu, has_up)) {  // entries above tau, in any order
      int n_up = 0, u = slot;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned up = __ballot_sync(0xffffffffu, v[j] > tau);
        n_up += __popc(up);
        u += __popc(up & before);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (v[j] > tau) out[u++] = candidate(v[j], base + i + j);
      }
      slot += n_up;
      up_left -= n_up;
    }
    if (ranked) {  // entries equal to tau, in doc order while ranks are left
      int n_same = 0, r = rank;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned same = __ballot_sync(0xffffffffu, v[j] == tau);
        n_same += __popc(same);
        r += __popc(same & before);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (v[j] == tau) {
          if (r < n_eq) out[above + r] = candidate(v[j], base + i + j);
          ++r;
        }
      }
      rank += n_same;
    }
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

// The inputs of nrt_bucket_rank; cands int64 [B, m * kk] with
// 1 <= kk <= 2^bucket_bits; hits int32 [B], zeroed by the caller (each row
// adds its count).
extern "C" int nrt_bucket_rank_topk(const void* post_docs, const void* post_impacts,
                                    long long n_postings, const void* toffs,
                                    const void* bounds, const void* wts,
                                    const void* n_terms, void* cands, void* hits, int B,
                                    int T, int m, int bucket_bits, int require_all,
                                    int kk, void* stream) {
  const int smem = 4 << bucket_bits;
  const cudaError_t err = cudaFuncSetAttribute(
      bucket_rank_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(B) * static_cast<unsigned>(m);
  bucket_rank_topk_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(post_docs), static_cast<const float*>(post_impacts),
      n_postings, static_cast<const int32_t*>(toffs),
      static_cast<const int32_t*>(bounds), static_cast<const float*>(wts),
      static_cast<const int32_t*>(n_terms), static_cast<long long*>(cands),
      static_cast<int32_t*>(hits), T, m, bucket_bits, require_all, kk);
  return static_cast<int>(cudaGetLastError());
}

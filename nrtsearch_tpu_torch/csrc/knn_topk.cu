// Exact kNN of one segment in one pass: the f32 products of up to 32 queries
// against every row of a vector column, the similarity's score, the mask and
// each block's top k of each query, without writing a score to device memory.
//
//   key[q, r] = (order(score(q, r)) << 32) | (2^32 - 1 - r)   (int64)
//
// where score(q, r) is ops/knn.py `_transform` of the f32 dot of query q and
// row r, -inf where mask[r] is false, and order() the int32 key whose signed
// order is the f32 total order (ops/topk.py `f32_order_keys`): the keys of
// ops/topk.py `lowest_index_keys`. They are unique, so the top k of them is
// one set: the k highest by (score desc, row asc), as ops/topk.py
// `masked_top_k` ranks, fillers past the eligible rows included (masked rows
// at -inf, lowest rows first). A ceiling per query, when given, leaves out
// every key at or above it: the next k keys after a top k already taken,
// which is how ops/knn.py `fused_segment_top_k` serves a k past one buffer.
//
// Replaces no TPU kernel: the JAX package leaves kNN to XLA
// (nrtsearch_tpu/ops/knn.py `_scores` by lax.dot_general, then lax.top_k);
// the port's plain version is `_scores` + `masked_top_k`, which writes the
// [B, rows] scores, rewrites them several times, widens them to int64 keys
// and radix-selects over those.
//
// Bound on the card: device-memory traffic and the FFMA units, about
// equally. Every row is read once per 32 queries (rows * dims * 4 bytes:
// 3.4 GB for a 1.1M x 768 segment, 1.01 ms at 3.35 TB/s), against 2 * 32 *
// rows * dims f32 operations (0.81 ms at the data sheet's 67 TFLOP/s). The
// product runs in full f32, one fmaf a dim into f32 sums, never on a tensor
// core. So the kernel overlaps its loads with its products and keeps its
// selection short; at that segment and B = 32 the products' loop alone, with
// no loads and no selection, runs at about 36 TFLOP/s, and sets the pace.
//
// Design: a persistent grid, one block of 256 threads per SM (226 KB of
// shared memory), blockIdx.y a tile of 32 queries. A block walks row tiles
// x, x + G, x + 2G, ... of 384 rows; a tile is read in chunks of 32 dims
// through a ring of 3 cp.async stages, two chunks in flight (each stage: 384
// rows of 128 bytes, their 16-byte pieces swizzled by row so that a warp's
// reads of 32 rows hit distinct banks; the 32 queries' same 32 dims, which
// stay in L2 for every block; with a tile's last chunk its squared norms and
// mask bytes). The ring runs across tile boundaries, so the next chunks
// stream in while a tile's epilogue runs. Warp w computes queries 8 (w / 2)
// .. 8 (w / 2) + 7 against rows 32 (w % 2) + lane + 64 i, i < 6: per 4 dims
// 14 16-byte shared loads (the query loads broadcast) feed 192 fmaf. Each
// (query, row) sum adds the dims in ascending order, a chunk of 32 at a time
// into its own f32 sum (one fmaf a dim) and each chunk's sum to the row's,
// whatever the row's tile or block: identical rows score identically and
// reruns are bit-identical; no atomics. (One chain of fmaf over all dims
// rounds as badly as n * 2^-24 of the products' magnitudes; two levels keep
// it near a blocked sum's.) Warps whose queries are all past B skip the
// products.
// Epilogue: the score with __fadd_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn
// (nothing contracted, so it is torch's op-by-op rounding), the mask, and
// the int32 order keys into the stage just read. Then warp w takes queries
// w, w + 8, ..., a tile at a time (select_tile): the keys above the query's
// threshold and under its ceiling join its buffer of 256 candidates in
// shared memory, placed by a prefix sum over the lanes; when they do not
// fit, the warp sorts the buffer (a bitonic sort in registers, 8 keys a
// lane), keeps the top k and raises the threshold to the k-th key. A block
// publishes its thresholds (atomicMax into g_thr) and starts each query's
// tile from the highest one published: a key under any block's k-th key is
// in no top k. That changes which keys reach the buffers, never the top k:
// the keys are unique. After the last tile each buffer is sorted and its
// top k written (kNoKey past its keys), and block x writes its count of
// eligible rows. The [B, G * k] candidates then go through one torch.topk
// (ops/knn.py `fused_segment_top_k`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueries = 32;                  // queries per block tile
constexpr int kRowsPerThread = 6;             // a thread's register tile: 8 queries x 6 rows
constexpr int kRowThreads = 64;               // threads per query group (two warps)
constexpr int kTileRows = kRowThreads * kRowsPerThread;   // 384 rows per tile
constexpr int kChunk = 32;                    // dims per stage
constexpr int kStages = 3;
// a staged row is 8 pieces of 16 bytes, piece p at p ^ (row & 7): a warp's
// reads of one piece of 32 rows hit distinct banks
// a stage: the rows' chunk, the queries' chunk, and with a tile's last chunk
// the tile's squared norms and mask bytes
constexpr int kQueriesAt = kTileRows * kChunk;
constexpr int kVsqAt = kQueriesAt + kQueries * kChunk;
constexpr int kMaskAt = kVsqAt + kTileRows;
constexpr int kStageFloats = kMaskAt + kTileRows / 4;
constexpr int kCap = 256;                     // candidates buffered per query
constexpr int kPerLane = kCap / 32;
constexpr int kMaxK = kCap - 32;              // a cut to k leaves room for 32 keys
constexpr long long kNoKey = -9223372036854775807LL - 1;
constexpr long long kTopKey = 9223372036854775807LL;    // no ceiling
// a tile's order keys go where its last chunk's rows were
static_assert(kQueries * kTileRows <= kTileRows * kChunk, "keys fit a stage");

enum Similarity { kL2 = 0, kDot = 1, kCos = 2, kMip = 3 };

constexpr int kStagesBytes = kStages * kStageFloats * 4;
constexpr int kBufBytes = kQueries * kCap * 8;
constexpr int kSmemBytes = kStagesBytes + kBufBytes + kQueries * 8  // buffers, thresholds
                           + kQueries * 4 + kQueries * 4 + kWarps * 4;   // counts, q_sq, hits
static_assert(kSmemBytes <= 232448, "one block per SM");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ops/knn.py `_transform` of one f32 dot, rounding as torch's ops do one by
// one (a division by the Python number 2.0 is torch's multiply by 0.5).
__device__ __forceinline__ float score_of(float dot, float q_sq, float v_sq, int sim) {
  if (sim == kL2) {
    float d2 = __fsub_rn(__fadd_rn(q_sq, v_sq), __fmul_rn(2.0f, dot));
    d2 = d2 < 0.0f ? 0.0f : d2;  // clamp_min: NaN stays NaN
    return __fdiv_rn(1.0f, __fadd_rn(1.0f, d2));
  }
  if (sim == kDot) return __fmul_rn(__fadd_rn(1.0f, dot), 0.5f);
  if (sim == kCos) {
    float den = __fmul_rn(__fsqrt_rn(q_sq), __fsqrt_rn(v_sq));
    den = den < 1e-30f ? 1e-30f : den;
    return __fmul_rn(__fadd_rn(1.0f, __fdiv_rn(dot, den)), 0.5f);
  }
  return dot >= 0.0f ? __fadd_rn(dot, 1.0f) : __fdiv_rn(1.0f, __fsub_rn(1.0f, dot));
}

__device__ __forceinline__ int32_t order_key(float s) {
  const int32_t b = __float_as_int(s);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ long long cand_key(int32_t key, long long row) {
  const unsigned long long hi = static_cast<unsigned long long>(static_cast<uint32_t>(key));
  const unsigned long long lo = 0xffffffffULL - static_cast<unsigned long long>(row);
  return static_cast<long long>((hi << 32) | lo);
}

// A warp's kCap keys, kPerLane a lane (key lane * kPerLane + j in v[j]),
// sorted descending by a bitonic network; every index is a compile-time one.
__device__ __forceinline__ void warp_sort_desc(long long (&v)[kPerLane], int lane) {
#pragma unroll
  for (int ls = 1; ls <= 8; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int ss = ls - 1; ss >= 0; --ss) {
      const int stride = 1 << ss;
      if (stride >= kPerLane) {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int e = lane * kPerLane + j;
          const long long w = __shfl_xor_sync(0xffffffffu, v[j], stride / kPerLane);
          const bool keep_max = ((e & stride) == 0) == ((e & size) == 0);
          v[j] = keep_max ? (v[j] > w ? v[j] : w) : (v[j] < w ? v[j] : w);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int p = j ^ stride;
          if (p > j) {
            const bool desc = ((lane * kPerLane + j) & size) == 0;
            const long long a = v[j], b = v[p];
            if (desc ? a < b : a > b) {
              v[j] = b;
              v[p] = a;
            }
          }
        }
      }
    }
  }
}

// Sorts a buffer's n live keys descending in place; entries past n become
// kNoKey. Not inlined: one copy of the network keeps the kernel's code small.
// The warp barriers order the lanes' writes to the buffer before its reads,
// here and nowhere else.
__device__ __noinline__ void sort_buffer(long long* b, int n, int lane) {
  __syncwarp();
  long long v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int e = lane * kPerLane + j;
    v[j] = e < n ? b[e] : kNoKey;
  }
  warp_sort_desc(v, lane);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) b[lane * kPerLane + j] = v[j];
  __syncwarp();
}

// A warp's pass over one query's tile of order keys (rows row0 + r, r <
// n_valid; lane l holds rows kPer l .. kPer l + kPer - 1): every key above
// the threshold and under the ceiling joins the buffer b of n keys, in row
// order. When they do not fit, the buffer is first cut to its top k (the
// threshold rising to the k-th key) and the keys are tested again; when
// they still do not fit (a buffer of at most k keys), the first ones fill
// it and the cut repeats. n and thr are the same in every lane.
__device__ __forceinline__ void select_tile(const int32_t* qkeys, long long row0, int n_valid,
                                            long long ceiling, long long* b, int& n,
                                            long long& thr, int k, int lane) {
  constexpr int kPer = kTileRows / 32;
  static_assert(kPer % 4 == 0 && kPer <= 32, "a lane's keys as 16-byte loads");
  int32_t kv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; j += 4) {
    const int4 v = *reinterpret_cast<const int4*>(qkeys + lane * kPer + j);
    kv[j] = v.x;
    kv[j + 1] = v.y;
    kv[j + 2] = v.z;
    kv[j + 3] = v.w;
  }
  const long long lrow = row0 + lane * kPer;
  unsigned pending = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (lane * kPer + j < n_valid && cand_key(kv[j], lrow + j) < ceiling) pending |= 1u << j;
  for (;;) {
    unsigned pass = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if ((pending >> j & 1u) && cand_key(kv[j], lrow + j) > thr) pass |= 1u << j;
    const int c = __popc(pass);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (total == 0) return;
    const int room = kCap - n;
    if (total > room && n > k) {
      sort_buffer(b, n, lane);
      n = k;
      const long long kth = b[k - 1];
      if (kth > thr) thr = kth;
      continue;
    }
    int pos = n + incl - c;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if ((pass >> j & 1u) && pos < kCap) {
        b[pos] = cand_key(kv[j], lrow + j);
        pending &= ~(1u << j);
      }
      if (pass >> j & 1u) ++pos;
    }
    if (total <= room) {
      n += total;
      return;
    }
    n = kCap;
  }
}

template <bool kVec>
__device__ __forceinline__ void load_chunk(float* st, const float* __restrict__ values,
                                           long long ld, const float* __restrict__ queries,
                                           const float* __restrict__ v_sq,
                                           const uint8_t* __restrict__ mask, long long row0,
                                           int d0, int rows, int dims, int q0, int nq) {
  const int tid = threadIdx.x;
  float* qs = st + kQueriesAt;
  if (d0 + kChunk >= dims) {  // the tile's last chunk: its norms and mask bytes too
    for (int i = tid; i < kTileRows; i += kThreads) {
      const long long g = row0 + i;
      cp_async4(st + kVsqAt + i, g < rows ? v_sq + g : v_sq, g < rows ? 4 : 0);
    }
    if (tid < kTileRows / 4) {
      const long long g = row0 + 4 * tid;
      const long long left = rows - g;
      const int n = left >= 4 ? 4 : (left > 0 ? static_cast<int>(left) : 0);
      cp_async4(st + kMaskAt + tid, n ? mask + g : mask, n);
    }
  }
  if (kVec) {
    // thread t copies piece t % 8 of rows t / 8 + 32 it (row & 7 stays put)
    constexpr int kRowStep = kThreads / 8;
    const int rb = tid >> 3, p = tid & 7;
    const int d = d0 + 4 * p;
    const float* src = values + (row0 + rb) * ld + d;
    float* dst = st + rb * kChunk + ((p ^ (rb & 7)) << 2);
    const long long left = d < dims ? rows - row0 - rb : 0;  // rows this thread may copy
#pragma unroll
    for (int it = 0; it < kTileRows / kRowStep; ++it) {
      const bool ok = it * kRowStep < left;
      cp_async16(dst + it * kRowStep * kChunk, ok ? src + it * kRowStep * ld : values,
                 ok ? 16 : 0);
    }
    if (tid < kQueries * kChunk / 4) {
      const int r = tid >> 3, p = tid & 7;
      const int d = d0 + 4 * p;
      const bool ok = r < nq && d < dims;
      cp_async16(qs + r * kChunk + 4 * p,
                 ok ? queries + static_cast<long long>(q0 + r) * dims + d : queries, ok ? 16 : 0);
    }
  } else {
    for (int it = 0; it < kTileRows * kChunk / kThreads; ++it) {
      const int idx = it * kThreads + tid;
      const int r = idx >> 5, e = idx & 31;
      const long long g = row0 + r;
      const int d = d0 + e;
      const bool ok = g < rows && d < dims;
      cp_async4(st + r * kChunk + ((((e >> 2) ^ (r & 7))) << 2) + (e & 3),
                ok ? values + g * ld + d : values, ok ? 4 : 0);
    }
    for (int it = 0; it < kQueries * kChunk / kThreads; ++it) {
      const int idx = it * kThreads + tid;
      const int r = idx >> 5, e = idx & 31;
      const int d = d0 + e;
      const bool ok = r < nq && d < dims;
      cp_async4(qs + r * kChunk + e,
                ok ? queries + static_cast<long long>(q0 + r) * dims + d : queries, ok ? 4 : 0);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) knn_topk_kernel(
    const float* __restrict__ values, long long ld, const float* __restrict__ v_sq,
    const uint8_t* __restrict__ mask, const float* __restrict__ queries,
    const float* __restrict__ q_sq, const long long* __restrict__ ceiling,
    long long* __restrict__ cands, int32_t* __restrict__ part_hits,
    long long* __restrict__ g_thr, int rows, int dims, int B, int k, int sim) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  long long* buf = reinterpret_cast<long long*>(smem + kStagesBytes);
  long long* thr_s = buf + kQueries * kCap;
  int* cnt_s = reinterpret_cast<int*>(thr_s + kQueries);
  float* qsq_s = reinterpret_cast<float*>(cnt_s + kQueries);
  int* hit_s = reinterpret_cast<int*>(qsq_s + kQueries);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kQueries;
  const int nq = min(kQueries, B - q0);
  const int G = gridDim.x;
  const int n_tiles = (rows + kTileRows - 1) / kTileRows;
  const int my_tiles = n_tiles > static_cast<int>(blockIdx.x)
                           ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / G + 1 : 0;
  const int n_chunks = (dims + kChunk - 1) / kChunk;
  const long long total = static_cast<long long>(my_tiles) * n_chunks;
  const bool need_sq = sim == kL2 || sim == kCos;

  if (tid < kQueries) {
    thr_s[tid] = kNoKey;
    cnt_s[tid] = 0;
    qsq_s[tid] = need_sq && tid < nq ? q_sq[q0 + tid] : 0.0f;
  }
  constexpr int kGroupWarps = kRowThreads / 32;
  const int tq = warp / kGroupWarps;                   // queries 8 tq .. 8 tq + 7
  const int tr = (warp % kGroupWarps) * 32 + lane;     // rows tr + kRowThreads i
  static_assert(kThreads == 4 * kRowThreads && kRowThreads % 32 == 0, "4 query groups");
  const bool computes = tq * 8 < nq;
  float acc[8][kRowsPerThread], part[8][kRowsPerThread];  // a row's sum, a chunk's
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[a][i] = part[a][i] = 0.0f;
  int my_hits = 0;

  // the load cursor (tile, chunk, stage) runs kStages - 1 chunks ahead of
  // the compute cursor; both step without a division
  int ld_t = 0, ld_h = 0, ld_s = 0;
  auto load = [&]() {
    if (ld_t < my_tiles) {
      load_chunk<kVec>(stages + ld_s * kStageFloats, values, ld, queries, v_sq, mask,
                       static_cast<long long>(blockIdx.x + ld_t * G) * kTileRows, ld_h * kChunk,
                       rows, dims, q0, nq);
      if (++ld_h == n_chunks) {
        ld_h = 0;
        ++ld_t;
      }
      ld_s = ld_s == kStages - 1 ? 0 : ld_s + 1;
    }
    cp_async_commit();
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) load();
  int cur_t = 0, cur_h = 0, cur_s = 0;
  for (long long c = 0; c < total; ++c) {
    // chunk c has landed (chunks c + 1 .. c + kStages - 2 may be in flight),
    // and every warp is done with chunk c - 1's stage, which the next load
    // fills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load();

    float* st = stages + cur_s * kStageFloats;
    cur_s = cur_s == kStages - 1 ? 0 : cur_s + 1;
    if (computes) {
      const float* rs = st + tr * kChunk;
      const float* qs = st + kQueriesAt + tq * 8 * kChunk;
      const int swz = tr & 7;  // rows tr + kRowThreads i share it
#pragma unroll 2
      for (int kk = 0; kk < kChunk; kk += 4) {
        float4 r[kRowsPerThread], q[8];
        const int piece = ((kk >> 2) ^ swz) << 2;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          r[i] = *reinterpret_cast<const float4*>(rs + i * kRowThreads * kChunk + piece);
#pragma unroll
        for (int a = 0; a < 8; ++a)
          q[a] = *reinterpret_cast<const float4*>(qs + a * kChunk + kk);
        // one dim at a time over the 48 sums: consecutive fmaf are independent
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            part[a][i] = __fmaf_rn(q[a].x, r[i].x, part[a][i]);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            part[a][i] = __fmaf_rn(q[a].y, r[i].y, part[a][i]);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            part[a][i] = __fmaf_rn(q[a].z, r[i].z, part[a][i]);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            part[a][i] = __fmaf_rn(q[a].w, r[i].w, part[a][i]);
      }
      // the chunk's sums into the row's: two levels keep the rounding of a
      // long dot near that of a blocked sum
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          acc[a][i] = __fadd_rn(acc[a][i], part[a][i]);
          part[a][i] = 0.0f;
        }
    }

    if (++cur_h < n_chunks) continue;
    // the tile's epilogue: the order keys into this stage once every warp is
    // done with its rows, then each warp's queries through their buffers
    const long long row0 = static_cast<long long>(blockIdx.x + cur_t * G) * kTileRows;
    cur_h = 0;
    ++cur_t;
    const int n_valid = rows - row0 < kTileRows ? static_cast<int>(rows - row0) : kTileRows;
    int32_t* keys = reinterpret_cast<int32_t*>(st);
    const uint8_t* live_s = reinterpret_cast<const uint8_t*>(st + kMaskAt);
    // the highest thresholds the blocks have published for this warp's
    // queries, loaded now so that their latency passes with the keys
    long long g[kQueries / kWarps], cl[kQueries / kWarps];
#pragma unroll
    for (int m = 0; m < kQueries / kWarps; ++m) {
      const int ql = warp + kWarps * m;
      g[m] = ql < nq ? __ldcg(g_thr + q0 + ql) : kNoKey;
      cl[m] = ceiling != nullptr && ql < nq ? ceiling[q0 + ql] : kTopKey;
    }
    __syncthreads();
    if (computes) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int lr = tr + kRowThreads * i;
        const bool live = lr < n_valid && live_s[lr] != 0;
        const float vs = st[kVsqAt + lr];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int ql = tq * 8 + a;
          keys[ql * kTileRows + lr] = order_key(
              live ? score_of(acc[a][i], qsq_s[ql], vs, sim) : -__int_as_float(0x7f800000));
          acc[a][i] = 0.0f;
        }
        if (tq == 0 && live) ++my_hits;  // query group 0 holds every row
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kQueries / kWarps; ++m) {
      const int ql = warp + kWarps * m;
      if (ql < nq) {
        // no key under a published threshold (some block's k-th key) is in
        // the top k
        long long thr = thr_s[ql] > g[m] ? thr_s[ql] : g[m];
        int n = cnt_s[ql];
        select_tile(keys + ql * kTileRows, row0, n_valid, cl[m], buf + ql * kCap, n, thr, k,
                    lane);
        if (lane == 0) {
          cnt_s[ql] = n;
          thr_s[ql] = thr;
          if (thr > g[m]) atomicMax(g_thr + q0 + ql, thr);
        }
      }
    }
  }
  cp_async_wait<0>();

  for (int m = 0; m < kQueries / kWarps; ++m) {
    const int ql = warp + kWarps * m;
    if (ql >= nq) break;
    long long* b = buf + ql * kCap;
    sort_buffer(b, cnt_s[ql], lane);
    long long* out = cands + (static_cast<long long>(q0 + ql) * G + blockIdx.x) * k;
    for (int i = lane; i < k; i += 32) out[i] = b[i];
  }
  my_hits = __reduce_add_sync(0xffffffffu, my_hits);
  if (lane == 0) hit_s[warp] = my_hits;
  __syncthreads();
  if (tid == 0 && blockIdx.y == 0) {
    int h = 0;
    for (int w = 0; w < kWarps; ++w) h += hit_s[w];
    part_hits[blockIdx.x] = h;
  }
}

template <bool kVec>
int launch(const void* values, long long ld, const void* v_sq, const void* mask,
           const void* queries, const void* q_sq, const void* ceiling, void* cands,
           void* part_hits, void* g_thr, int rows, int dims, int B, int k, int sim, int G,
           cudaStream_t stream) {
  auto kern = knn_topk_kernel<kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (B + kQueries - 1) / kQueries;
  kern<<<dim3(G, q_tiles), kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(values), ld, static_cast<const float*>(v_sq),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(queries),
      static_cast<const float*>(q_sq), static_cast<const long long*>(ceiling),
      static_cast<long long*>(cands), static_cast<int32_t*>(part_hits),
      static_cast<long long*>(g_thr), rows, dims, B, k, sim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values: f32 [rows, dims] with row stride ld (floats); v_sq: f32 [rows]
// (read for l2_norm and cosine); mask: bool [rows]; queries: f32 [B, dims],
// contiguous; q_sq: f32 [B] (l2_norm and cosine; else may be null); ceiling:
// int64 [B] (only keys below a query's ceiling count) or null; sim: 0
// l2_norm, 1 dot_product, 2 cosine, 3 max_inner_product; g_thr: int64 [B]
// filled with INT64_MIN (the thresholds the blocks publish); G <= the row
// tiles of 384. Outputs: cands int64 [B, G, k], each block's top k keys of
// each query in descending order (INT64_MIN past its keys), and part_hits
// int32 [G], each block's count of eligible rows. With vec, dims and ld are
// multiples of 4 and values and queries 16-byte aligned. 1 <= k <= 224,
// k <= rows < 2^31, 1 <= B, ceil(B / 32) <= 65535. Returns
// cudaErrorInvalidValue for anything else, else cudaGetLastError() after the
// launch.
extern "C" int nrt_knn_topk(const void* values, long long ld, const void* v_sq,
                            const void* mask, const void* queries, const void* q_sq,
                            const void* ceiling, void* cands, void* part_hits, void* g_thr,
                            int rows, int dims, int B, int k, int sim, int G, int vec,
                            void* stream) {
  const int n_tiles = (rows + kTileRows - 1) / kTileRows;
  if (k < 1 || k > kMaxK || k > rows || B < 1 || dims < 1 || (B - 1) / kQueries >= 65535 ||
      G < 1 || G > n_tiles || sim < kL2 || sim > kMip || ld < dims)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    return launch<true>(values, ld, v_sq, mask, queries, q_sq, ceiling, cands, part_hits,
                        g_thr, rows, dims, B, k, sim, G, st);
  return launch<false>(values, ld, v_sq, mask, queries, q_sq, ceiling, cands, part_hits, g_thr,
                       rows, dims, B, k, sim, G, st);
}

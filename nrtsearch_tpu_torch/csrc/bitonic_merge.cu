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
// Design of near_stages, for Hopper (a stage per shared-memory pass with a
// block-wide barrier between stages would cost as much shared-memory traffic
// as the launch's whole device-memory bound). A block takes a tile of
// `tile` = 2^t pairs (t <= 14) with tile / 32 threads (at least one warp);
// each thread holds kE = 32 entries of the tile in registers. A stage at
// distance 2^k exchanges entries whose tile index differs in bit k, so a
// stage costs no memory traffic when bit k is a register bit of the layout
// (an in-thread exchange) and one __shfl_xor_sync per value when it is a lane
// bit. Two layouts cover all bits:
//   - layout A: register bits t-5..t-1, lane bits 0..4, warp bits 5..t-6.
//     Its loads are coalesced (a warp reads 32 consecutive int32 per
//     register), and it runs the high stages k0..t-5 all inside the thread;
//   - layout B: register bits 0, 1, 5, 6, 7, lane bits 2, 3, 4, 8, 9, warp
//     bits 10 and up. It moves 16-byte vectors (bits 0-1) with every 8-lane
//     phase on 128 consecutive bytes, and runs the low stages: bits 7-5 and
//     1-0 in the thread, bits 9, 8 and 4-2 across lanes.
// When d0 < 1024 (k0 <= 9) a block loads layout B straight from device
// memory, runs every stage in registers and shuffles, and stores it back: no
// shared memory and no barrier. Otherwise it loads layout A, runs the high
// stages, writes the tile to shared memory in A's order (32 consecutive words
// per warp store), passes ONE barrier, reads it back in B's order (16-byte
// vectors, conflict-free) and runs the rest. d0 = 4096 over a tile of 8192:
// 5 + 5 stages in registers, 3 across lanes, 1 barrier (in place of 13
// barriers and 13 passes over shared memory); d0 = 8192 over the port's tile of
// 16384: 10 in registers, 4 across lanes. The direction of a pair is one constant
// per block when m >= tile (or m == 0); short runs (m < tile) take it per
// pair from the index's m bit (the kPerPair instance). Lanes past a tile of
// fewer than 1024 pairs hold entries that only ever pair among themselves
// (a stage keeps the bits above t) and are never stored. The stage sequence
// is the reference's, so the output does not depend on the tile or layout.
//
// far_stage runs one thread per pair (i, i + d) for d >= tile. far_pair_stage
// runs one thread per quad: the four entries i, i + d/2, i + d, i + 3d/2 of
// one 2d block take both stages in registers (stage d exchanges quarters 0-2
// and 1-3, stage d/2 then 0-1 and 2-3), so two stages cost one read and one
// write instead of two each.
//
// Tie rule, both kernels: ascending mode swaps only when lo > hi strictly, so
// equal docs keep their stream order (segmented sums add equal docs in stream
// order, so this order fixes the f32 scores bit for bit). Alternating mode
// (m != 0) flips the comparison inside odd m-blocks, as the Pallas kernels do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFarThreads = 256;
constexpr int kE = 32;              // near_stages: entries per thread
constexpr unsigned kFull = 0xffffffffu;

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

// layout B: the tile index bits that register j sets (bits 0, 1, 5, 6, 7)
__host__ __device__ constexpr int b_reg_bits(int j) {
  return (j & 3) | (((j >> 2) & 7) << 5);
}

// layout B: the tile index bits of (warp, lane): lane bits -> 2, 3, 4, 8, 9
__device__ __forceinline__ int b_thread_bits(int warp, int lane) {
  return ((lane & 7) << 2) | (((lane >> 3) & 3) << 8) | (warp << 10);
}

// the stage on register bit jb: register j against j | 2^jb. `lo(j)` is
// the tile index of register j (for the per-pair direction)
template <bool kPerPair, typename Lo>
__device__ __forceinline__ void reg_stage(int32_t (&d)[kE], float (&c)[kE],
                                          int jb, bool blk_desc, int m, Lo lo) {
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    if (j & (1 << jb)) continue;
    const bool desc = kPerPair ? (lo(j) & m) != 0 : blk_desc;
    exchange_regs(d[j], d[j | (1 << jb)], c[j], c[j | (1 << jb)], desc);
  }
}

// the stage on a lane bit of layout B: lanes lane and lane ^ x swap values
// where the lower one's doc is greater (less, descending); both compute the
// same decision from the same pair
template <bool kPerPair>
__device__ __forceinline__ void lane_stage(int32_t (&d)[kE], float (&c)[kE],
                                           int lane, int x, int bbase,
                                           bool blk_desc, int m) {
  const bool upper = (lane & x) != 0;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int32_t pd = __shfl_xor_sync(kFull, d[j], x);
    const float pc = __shfl_xor_sync(kFull, c[j], x);
    const bool desc = kPerPair ? ((bbase | b_reg_bits(j)) & m) != 0 : blk_desc;
    const int32_t lo = upper ? pd : d[j];
    const int32_t hi = upper ? d[j] : pd;
    if ((lo > hi) != desc) {
      d[j] = pd;
      c[j] = pc;
    }
  }
}

// stages 2^k0 ... 1 over tiles of 2^t pairs of each [B, n] row, in place.
// kPerPair: m < tile, each pair's direction from its index's m bit.
template <bool kPerPair>
__global__ void __launch_bounds__(512)
near_stages_kernel(int32_t* __restrict__ docs, float* __restrict__ contribs,
                   int n, int t, int k0, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = 1 << t;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile_start = static_cast<int64_t>(blockIdx.x) * tile;
  int32_t* gd = docs + static_cast<int64_t>(blockIdx.y) * n + tile_start;
  float* gc = contribs + static_cast<int64_t>(blockIdx.y) * n + tile_start;
  const bool blk_desc = !kPerPair && m != 0 && (tile_start & m) != 0;
  const int bbase = b_thread_bits(warp, lane);

  int32_t d[kE];
  float c[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    d[j] = 0;
    c[j] = 0.0f;
  }
  int b_hi = k0;  // the highest stage bit layout B runs
  if (k0 >= 10) {
    // layout A: register j at tile index a0 + (j << s)
    const int s = t - 5;
    const int a0 = lane | (warp << 5);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      d[j] = gd[a0 + (j << s)];
      c[j] = gc[a0 + (j << s)];
    }
    const auto a_lo = [=](int j) { return a0 + (j << s); };
#pragma unroll
    for (int jb = 4; jb >= 0; --jb) {
      if (jb + s <= k0) reg_stage<kPerPair>(d, c, jb, blk_desc, m, a_lo);
    }
    int32_t* sd = reinterpret_cast<int32_t*>(smem);
    float* sc = reinterpret_cast<float*>(sd + tile);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      sd[a0 + (j << s)] = d[j];
      sc[a0 + (j << s)] = c[j];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kE / 4; ++q) {
      const int i = bbase + b_reg_bits(4 * q);
      const int4 vd = *reinterpret_cast<const int4*>(sd + i);
      const float4 vc = *reinterpret_cast<const float4*>(sc + i);
      d[4 * q] = vd.x; d[4 * q + 1] = vd.y; d[4 * q + 2] = vd.z; d[4 * q + 3] = vd.w;
      c[4 * q] = vc.x; c[4 * q + 1] = vc.y; c[4 * q + 2] = vc.z; c[4 * q + 3] = vc.w;
    }
    b_hi = s - 1;
  } else {
#pragma unroll
    for (int q = 0; q < kE / 4; ++q) {
      const int i = bbase + b_reg_bits(4 * q);
      if (i < tile) {
        const int4 vd = *reinterpret_cast<const int4*>(gd + i);
        const float4 vc = *reinterpret_cast<const float4*>(gc + i);
        d[4 * q] = vd.x; d[4 * q + 1] = vd.y; d[4 * q + 2] = vd.z; d[4 * q + 3] = vd.w;
        c[4 * q] = vc.x; c[4 * q + 1] = vc.y; c[4 * q + 2] = vc.z; c[4 * q + 3] = vc.w;
      }
    }
  }

  // layout B, stage bits b_hi .. 0: 9, 8 lanes; 7, 6, 5 registers (j bits
  // 4, 3, 2); 4, 3, 2 lanes; 1, 0 registers
  const auto b_lo = [=](int j) { return bbase + b_reg_bits(j); };
  if (b_hi >= 9) lane_stage<kPerPair>(d, c, lane, 16, bbase, blk_desc, m);
  if (b_hi >= 8) lane_stage<kPerPair>(d, c, lane, 8, bbase, blk_desc, m);
  if (b_hi >= 7) reg_stage<kPerPair>(d, c, 4, blk_desc, m, b_lo);
  if (b_hi >= 6) reg_stage<kPerPair>(d, c, 3, blk_desc, m, b_lo);
  if (b_hi >= 5) reg_stage<kPerPair>(d, c, 2, blk_desc, m, b_lo);
  if (b_hi >= 4) lane_stage<kPerPair>(d, c, lane, 4, bbase, blk_desc, m);
  if (b_hi >= 3) lane_stage<kPerPair>(d, c, lane, 2, bbase, blk_desc, m);
  if (b_hi >= 2) lane_stage<kPerPair>(d, c, lane, 1, bbase, blk_desc, m);
  if (b_hi >= 1) reg_stage<kPerPair>(d, c, 1, blk_desc, m, b_lo);
  reg_stage<kPerPair>(d, c, 0, blk_desc, m, b_lo);

#pragma unroll
  for (int q = 0; q < kE / 4; ++q) {
    const int i = bbase + b_reg_bits(4 * q);
    if (i < tile) {
      *reinterpret_cast<int4*>(gd + i) =
          make_int4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
      *reinterpret_cast<float4*>(gc + i) =
          make_float4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
    }
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

template <bool kPerPair>
int launch_near(int32_t* docs, float* contribs, int B, int n, int t, int k0,
                int m, cudaStream_t stream) {
  const int tile = 1 << t;
  const int smem = k0 >= 10 ? tile * 8 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        near_stages_kernel<kPerPair>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = tile / kE > 32 ? tile / kE : 32;
  dim3 grid(n / tile, B);
  near_stages_kernel<kPerPair><<<grid, threads, smem, stream>>>(
      docs, contribs, n, t, k0, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// docs int32 [B, n], contribs f32 [B, n], both 16-byte aligned; n a
// multiple of tile, tile a power of two in [4, 16384], 2 * d0 <= tile;
// m = 0 (ascending) or the sort-block size (m >= 2 * d0).
extern "C" int nrt_near_stages(void* docs, void* contribs, int B, int n,
                               int tile, int d0, int m, void* stream) {
  int t = 0, k0 = 0;
  while ((1 << t) < tile) ++t;
  while ((1 << k0) < d0) ++k0;
  if ((1 << t) != tile || t < 2 || t > 14 || (1 << k0) != d0 || k0 >= t) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* dd = static_cast<int32_t*>(docs);
  auto* cc = static_cast<float*>(contribs);
  auto* st = static_cast<cudaStream_t>(stream);
  if (m != 0 && m < tile) return launch_near<true>(dd, cc, B, n, t, k0, m, st);
  return launch_near<false>(dd, cc, B, n, t, k0, m, st);
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

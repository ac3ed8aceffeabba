// Fused head scores: the compact head-row gather folded into the products.
//
//   S[b, d] = W_hi[b]·R[idx, d] + W_hi[b]·L[idx, d] + W_lo[b]·R[idx, d]
//             + W_lo[b]·L[idx, d]                       (f32, [B, D])
//   C[b, d] = (W[b] != 0)·(R[idx, d] > 0)               (f32, [B, D], optional)
//
// for bf16 head rows R [Hp, D], Dekker residual rows L [Hp, D] (optional:
// without them only the first term), int32 idx [U] and bf16 weights W_hi,
// W_lo [B, U]. W != 0 is read as (W_hi != 0 or W_lo != 0), which is W != 0
// for every |W| above 2^-134.
//
// Replaces: nrtsearch_tpu/ops/dense_fused.py `_gather_rows_pallas`, the
// Pallas block copy behind `gather_rows` (its [U, D] output), and the four
// head products plus the require_all indicator product of
// `dense_fused_topk` (dense_fused.py:182-221), which the JAX package leaves
// to XLA.
//
// Bound on the card: device-memory traffic. The gathered row slices are read
// once ((1 + has_lo) * U * D * 2 bytes) and S (and C) written once (B * D * 4
// bytes each); [U, D] never exists in device memory. The products are
// 2 * (2B) * (2U) * D operations on the bf16 tensor cores, well under the
// bytes at every B <= 32.
//
// Design:
// - Persistent blocks (as many as fit on the card) walk tiles of 256 docs;
//   blockIdx.y picks a chunk of 32 queries. Each block keeps a window of
//   up to 512 weight columns of its chunk in shared memory: U <= 512 loads
//   once, a wider U reloads the window as a tile's k-steps reach it, so
//   shared memory stays bounded for any U.
// - Loads: a ring of kStages shared-memory stages, each holding one k-step
//   (16 head rows, and their 16 residual rows) of a tile, filled with 16-byte
//   cp.async addressed through idx (TMA has no row gather). A thread's two
//   idx entries of a stage are loaded from global memory one stage ahead,
//   so their latency hides behind a k-step. The ring runs
//   across tile boundaries, so the next tile's rows stream in while a tile's
//   epilogue runs. K pads to a multiple of 16 with zero-filled rows.
// - Products: mma.sync m16n8k16 bf16 -> f32. Each m16 tile is 8 queries:
//   rows 0-7 hold W_hi, rows 8-15 W_lo of the same queries, so one tile row
//   set times the stacked [R; L] k-steps gives W_hi·(R + L) in c0/c1 and
//   W_lo·(R + L) in c2/c3 of the same thread, and S = c0 + c2, c1 + c3 in
//   registers: the four products are one product of depth 2U. The weights
//   come from shared memory by ldmatrix, the row tile by ldmatrix.trans; each
//   warp owns 32 docs (four n8 tiles).
// - C: the indicator operands are made in registers from the fragments
//   already loaded ((hi | lo) bits != 0 for the weights, bf16 > 0 for the
//   rows), one more mma per 16 queries and n8 tile; nothing without the flag.
// - Epilogue: each warp stages its [queries, 32 docs] f32 tile in shared
//   memory and writes rows of 128 bytes with 16-byte stores; docs past D
//   (D % 8 == 0) and queries past B are masked.
// - No atomics: every output element is one thread's sum in a fixed order,
//   so results repeat bit for bit. An idx outside [0, Hp) traps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 256-doc tiles (512-byte row slices) and 3 stages measured 4 points of the
// bound above 128-doc tiles with 4 stages at U = 128, and level at U = 32
constexpr int kTileDocs = 256;                 // docs per block tile
constexpr int kWarps = kTileDocs / 32;         // 32 docs each
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = 4;                         // n8 tiles per warp
constexpr int kKStep = 16;                     // head rows per k-step
constexpr int kStages = 3;                     // cp.async ring depth
constexpr int kChunksPerRow = kTileDocs / 8;   // 16-byte copies per tile row
constexpr int kPad = 8;                        // bf16 per smem row: 16 bytes
constexpr int kTileStride = kTileDocs + kPad;  // 528-byte rows: ldmatrix without conflicts
constexpr int kQueries = 32;                   // queries per block
constexpr int kStageStride = 40;               // f32 per staged row: float2 writes without conflicts
constexpr int kWinK = 512;                     // weight columns held in shared memory
constexpr int kWinSteps = kWinK / kKStep;
// a stage's copy i of a thread lands in ring row warp + 8i: its head row is
// k-step row warp + 8 * (i & 1), so each thread needs two idx entries
static_assert(kThreads / kChunksPerRow == 8 && kKStep == 16, "two idx entries per thread");

__host__ __device__ constexpr int c_tiles(int mt) { return (mt + 1) / 2; }

__host__ __device__ constexpr int stage_rows(int mt, bool need_c) {
  return need_c ? 16 * c_tiles(mt) : 8 * mt;
}

__host__ __device__ constexpr int win_cols(int upad) { return upad < kWinK ? upad : kWinK; }

// Dynamic shared memory of one block: at most 158,208 bytes (MT = 4, lo and C)
__host__ __device__ constexpr int smem_bytes(int mt, int upad, bool has_lo, bool need_c) {
  return 2 * 16 * mt * (win_cols(upad) + kPad)                       // weight window
         + 2 * kStages * (has_lo ? 2 : 1) * kKStep * kTileStride   // ring
         + 4 * kWarps * stage_rows(mt, need_c) * kStageStride;     // epilogue
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 pair -> (x != 0) as bf16 1.0 / 0.0 per half (-0 counts as zero)
__device__ __forceinline__ uint32_t nonzero2(uint32_t x) {
  const uint32_t m = x & 0x7fff7fffu;
  return ((m & 0xffffu) ? 0x3f80u : 0u) | ((m >> 16) ? 0x3f800000u : 0u);
}

// bf16 pair -> (x > 0) as bf16 1.0 / 0.0 per half (NaN is not > 0)
__device__ __forceinline__ uint32_t positive2(uint32_t x) {
  const uint32_t lo = x & 0xffffu, hi = x >> 16;
  return ((lo - 1u) < 0x7f80u ? 0x3f80u : 0u) | ((hi - 1u) < 0x7f80u ? 0x3f800000u : 0u);
}

// Writes a warp's staged [rows, 32 docs] tile to out[q0 + r, doc0 + ...]
// as 16-byte stores, 8 lanes per 128-byte row.
template <int ROWS>
__device__ __forceinline__ void store_tile(const float* st, float* __restrict__ out,
                                           int q0, int B, int doc0, int D, int lane) {
  const int col = 4 * (lane & 7);
  if (doc0 + col >= D) return;
  for (int r = lane >> 3; r < ROWS; r += 4) {
    if (q0 + r < B) {
      const float4 v = *reinterpret_cast<const float4*>(st + r * kStageStride + col);
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(q0 + r) * D + doc0 + col) = v;
    }
  }
}

template <int MT, bool HAS_LO, bool NEED_C>
__global__ void __launch_bounds__(kThreads)
head_scores_kernel(const __nv_bfloat16* __restrict__ rows,
                   const __nv_bfloat16* __restrict__ rows_lo,
                   const int32_t* __restrict__ idx,
                   const __nv_bfloat16* __restrict__ w_hi,
                   const __nv_bfloat16* __restrict__ w_lo,
                   float* __restrict__ S, float* __restrict__ C,
                   int n_rows, int U, int B, int D) {
  constexpr int MC = c_tiles(MT);
  constexpr int ROWS = (HAS_LO ? 2 : 1) * kKStep;    // ring rows per stage
  constexpr int CHUNKS = ROWS * kChunksPerRow / kThreads;   // 16-byte copies per thread
  constexpr int SROWS = stage_rows(MT, NEED_C);
  const int upad = (U + kKStep - 1) / kKStep * kKStep;
  const int ksteps = upad / kKStep;
  const int wcols = win_cols(upad);
  const int a_stride = wcols + kPad;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_ring = s_a + 16 * MT * a_stride;
  float* s_stage = reinterpret_cast<float*>(s_ring + kStages * ROWS * kTileStride);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kQueries;
  const int n_tiles = (D + kTileDocs - 1) / kTileDocs;
  const int grid_x = static_cast<int>(gridDim.x);
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + grid_x - 1) / grid_x;
  const int total = my_tiles * ksteps;

  // the idx entry of k-step row warp + 8j in stage s (0 past U or the end)
  auto idx_of = [&](int s, int j) {
    const int k = (s % ksteps) * kKStep + warp + 8 * j;
    return s < total && k < U ? __ldg(idx + k) : 0;
  };
  int next[2] = {idx_of(0, 0), idx_of(0, 1)};

  // stage s of this block: k-step s % ksteps of its tile s / ksteps; an
  // empty group past the end keeps the wait counts uniform. Called for
  // s = 0, 1, 2, ... in order: it uses the idx entries loaded by the call
  // before and loads those of s + 1.
  auto issue = [&](int s) {
    const int cur[2] = {next[0], next[1]};
    next[0] = idx_of(s + 1, 0);
    next[1] = idx_of(s + 1, 1);
    if (s < total) {
      const int t = s / ksteps, kk = s - t * ksteps;
      const int doc0 = (static_cast<int>(blockIdx.x) + t * grid_x) * kTileDocs;
      __nv_bfloat16* buf = s_ring + (s % kStages) * ROWS * kTileStride;
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int c = tid + i * kThreads;
        const int rr = c / kChunksPerRow, cc = c % kChunksPerRow, doc = doc0 + 8 * cc;
        const int k = kk * kKStep + (rr & (kKStep - 1));
        const int r = cur[i & 1];
        // every k < U is checked: each tile copies it at its first doc
        if (k < U && (r < 0 || r >= n_rows)) __trap();
        const bool ok = k < U && doc < D;
        const __nv_bfloat16* base = (HAS_LO && rr >= kKStep) ? rows_lo : rows;
        const __nv_bfloat16* src = ok ? base + static_cast<int64_t>(r) * D + doc : base;
        cp_async16(buf + rr * kTileStride + 8 * cc, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // weight window from column k0: m16 tile i holds queries q0 + 8i ..
  // q0 + 8i + 7, rows 0-7 their W_hi and rows 8-15 their W_lo; queries past
  // B and k past U are zero
  auto load_weights = [&](int k0) {
    for (int e = tid; e < 16 * MT * wcols; e += kThreads) {
      const int r = e / wcols, kc = e - r * wcols, k = k0 + kc;
      const int q = q0 + 8 * (r >> 4) + (r & 7);
      __nv_bfloat16 v = __ushort_as_bfloat16(static_cast<unsigned short>(0));
      if (k < U && q < B) {
        if (!(r & 8)) v = w_hi[static_cast<int64_t>(q) * U + k];
        else if (HAS_LO) v = w_lo[static_cast<int64_t>(q) * U + k];
      }
      s_a[r * a_stride + kc] = v;
    }
  };
  load_weights(0);
  __syncthreads();

  float acc[MT][kNT][4];
  float cacc[MC][kNT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
#pragma unroll
  for (int i = 0; i < MC; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) cacc[i][j][v] = 0.f;

  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int a_row = lane & 15, a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * ((lane >> 3) & 1), b_col = warp * 32 + 8 * (lane >> 4);
  float* st = s_stage + warp * SROWS * kStageStride;

  int kk = 0, tile = static_cast<int>(blockIdx.x);
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(s + kStages - 1);
    const __nv_bfloat16* buf = s_ring + (s % kStages) * ROWS * kTileStride;
    const int kw = kk % kWinSteps;   // k-step within the weight window
    if (kw == 0 && s > 0 && ksteps > kWinSteps) {
      // U > kWinK: the next window (or a new tile's first); every warp is
      // past the last window's reads (the barrier above)
      load_weights(kk * kKStep);
      __syncthreads();
    }

    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldmatrix_x4(a[i], s_a + (16 * i + a_row) * a_stride + kw * kKStep + a_col);
    // b[j][0..1]: head rows of n8 tile j; b[j][2..3]: residual rows
    uint32_t b[kNT][4];
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, buf + b_row * kTileStride + b_col + 16 * jp);
      b[2 * jp][0] = r[0]; b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2]; b[2 * jp + 1][1] = r[3];
      if (HAS_LO) {
        ldmatrix_x4_trans(r, buf + (kKStep + b_row) * kTileStride + b_col + 16 * jp);
        b[2 * jp][2] = r[0]; b[2 * jp][3] = r[1];
        b[2 * jp + 1][2] = r[2]; b[2 * jp + 1][3] = r[3];
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
        if (HAS_LO) mma_bf16(acc[i][j], a[i], b[j][2], b[j][3]);
      }
    if (NEED_C) {
      // C tile c: rows 0-7 the queries of m16 tile 2c, rows 8-15 of 2c + 1
#pragma unroll
      for (int c = 0; c < MC; ++c) {
        const bool pair = 2 * c + 1 < MT;
        const int c1 = pair ? 2 * c + 1 : 2 * c;
        uint32_t ai[4];
        ai[0] = nonzero2(a[2 * c][0] | a[2 * c][1]);
        ai[1] = pair ? nonzero2(a[c1][0] | a[c1][1]) : 0u;
        ai[2] = nonzero2(a[2 * c][2] | a[2 * c][3]);
        ai[3] = pair ? nonzero2(a[c1][2] | a[c1][3]) : 0u;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_bf16(cacc[c][j], ai, positive2(b[j][0]), positive2(b[j][1]));
      }
    }

    if (++kk == ksteps) {
      kk = 0;
      const int doc0 = tile * kTileDocs + warp * 32;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          *reinterpret_cast<float2*>(st + (8 * i + g) * kStageStride + 8 * j + 2 * t4) =
              make_float2(acc[i][j][0] + acc[i][j][2], acc[i][j][1] + acc[i][j][3]);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
        }
      __syncwarp();
      store_tile<8 * MT>(st, S, q0, B, doc0, D, lane);
      __syncwarp();
      if (NEED_C) {
#pragma unroll
        for (int c = 0; c < MC; ++c)
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            float* p = st + (16 * c + g) * kStageStride + 8 * j + 2 * t4;
            *reinterpret_cast<float2*>(p) = make_float2(cacc[c][j][0], cacc[c][j][1]);
            *reinterpret_cast<float2*>(p + 8 * kStageStride) =
                make_float2(cacc[c][j][2], cacc[c][j][3]);
#pragma unroll
            for (int v = 0; v < 4; ++v) cacc[c][j][v] = 0.f;
          }
        __syncwarp();
        store_tile<16 * MC>(st, C, q0, B, doc0, D, lane);
        __syncwarp();
      }
      tile += grid_x;
    }
  }
  cp_async_wait<0>();
}

template <int MT, bool HAS_LO, bool NEED_C>
int launch(const void* rows, const void* rows_lo, const void* idx, const void* w_hi,
           const void* w_lo, void* S, void* C, int n_rows, int U, int B, int D,
           cudaStream_t stream) {
  auto kern = head_scores_kernel<MT, HAS_LO, NEED_C>;
  const int upad = (U + kKStep - 1) / kKStep * kKStep;
  const int smem = smem_bytes(MT, upad, HAS_LO, NEED_C);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int chunks = (B + kQueries - 1) / kQueries;
  const int n_tiles = (D + kTileDocs - 1) / kTileDocs;
  int gx = (sms * (per_sm > 0 ? per_sm : 1) + chunks - 1) / chunks;
  gx = gx < n_tiles ? gx : n_tiles;
  kern<<<dim3(gx > 0 ? gx : 1, chunks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(rows), static_cast<const __nv_bfloat16*>(rows_lo),
      static_cast<const int32_t*>(idx), static_cast<const __nv_bfloat16*>(w_hi),
      static_cast<const __nv_bfloat16*>(w_lo), static_cast<float*>(S),
      static_cast<float*>(C), n_rows, U, B, D);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_mt(const void* rows, const void* rows_lo, const void* idx, const void* w_hi,
              const void* w_lo, void* S, void* C, int n_rows, int U, int B, int D,
              cudaStream_t stream) {
  if (rows_lo != nullptr) {
    if (C != nullptr)
      return launch<MT, true, true>(rows, rows_lo, idx, w_hi, w_lo, S, C, n_rows, U, B, D, stream);
    return launch<MT, true, false>(rows, rows_lo, idx, w_hi, w_lo, S, C, n_rows, U, B, D, stream);
  }
  if (C != nullptr)
    return launch<MT, false, true>(rows, rows_lo, idx, w_hi, w_lo, S, C, n_rows, U, B, D, stream);
  return launch<MT, false, false>(rows, rows_lo, idx, w_hi, w_lo, S, C, n_rows, U, B, D, stream);
}

}  // namespace

// rows, rows_lo: bf16 [n_rows, D] (16-byte aligned, D % 8 == 0; rows_lo may
// be null, and then w_lo too); idx: int32 [U]; w_hi, w_lo: bf16 [B, U];
// S: f32 [B, D]; C: f32 [B, D] or null (no count); B, U, D > 0. Returns
// cudaErrorInvalidValue for a shape the grid cannot cover (more than 65535
// chunks of 32 queries, D within a tile of 2^31), else cudaGetLastError()
// after the launch.
extern "C" int nrt_head_scores(const void* rows, const void* rows_lo, const void* idx,
                               const void* w_hi, const void* w_lo, void* S, void* C,
                               int n_rows, int U, int B, int D, void* stream) {
  if (B <= 0 || U <= 0 || D <= 0 || (B - 1) / kQueries >= 65535 ||
      D > 0x7fffffff - kTileDocs)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = ((B < kQueries ? B : kQueries) + 7) / 8;
  switch (mt) {
    case 1: return launch_mt<1>(rows, rows_lo, idx, w_hi, w_lo, S, C, n_rows, U, B, D, st);
    case 2: return launch_mt<2>(rows, rows_lo, idx, w_hi, w_lo, S, C, n_rows, U, B, D, st);
    case 3: return launch_mt<3>(rows, rows_lo, idx, w_hi, w_lo, S, C, n_rows, U, B, D, st);
    default: return launch_mt<4>(rows, rows_lo, idx, w_hi, w_lo, S, C, n_rows, U, B, D, st);
  }
}

extern "C" const char* nrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// Design, for Hopper: the scan's sums stay in registers through every step,
// and shared memory carries only what crosses a warp. A block takes a window
// of W entries of one row (W = 4096, doubled while the halo passes W / 2):
// the `halo` = max_seg - 1 entries before its `tile` = W - halo outputs
// (3.1% of the window at max_seg = 128), clipped at the row start, and the
// one entry after it (for the last-entry test). The window comes in
// coalesced through shared memory, every load of a thread in flight at
// once; then each of the W / 16 threads holds kK = 16 consecutive entries in
// registers (docs, sums, and counts with require_all) and keeps them there
// through every step:
//   - d < 16: in the thread, from the highest entry down, so s[p - d] is
//     still the previous step's; the first d entries take the previous
//     lane's last d by __shfl_up_sync, and lane 0 the previous warp's from
//     shared memory;
//   - 16 <= d < 512: __shfl_up_sync(d / 16) per entry; the first d / 16
//     lanes read the previous warp's last d entries from shared memory;
//   - d >= 512 (max_seg > 512): the warp d / 512 back, from shared memory.
// Each step a warp hands over only the entries the next warp reads, into one
// of two buffers (so one barrier a step). The partner's doc comes from the
// window's docs in shared memory; padding of one word per 16 keeps every
// access of stride 16 free of bank conflicts. An entry with no predecessor
// at distance d inside the window adds nothing, as the plain version's
// shift fills; the halo covers the scan's reach, so every output entry's
// sum is exact. The TPU kernel's roll emulation has no counterpart, and
// unlike it (pallas_merge.py:420) the halo never reads before the row.
//
// A window holds at most 512 threads x 16 entries, so max_seg <= 4096. A
// longer scan (max_seg up to 16384, 8192 with require_all: a merge batch of
// more than 4096 runs) takes the wide kernel: a tile of 2048 outputs and its
// halo in shared memory, the steps ping-ponging between two buffers with a
// barrier between them, in the same order of adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 16;                    // entries per thread
constexpr int kWarpSpan = 32 * kK;        // entries per warp
constexpr int kMaxThreads = 512;          // the register kernel's launch bound
constexpr int kMaxWindow = kMaxThreads * kK;
constexpr int kWideThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kHigh = 2147483647;    // DOC_SENTINEL
constexpr int32_t kLow = -2147483647;    // DOC_SENTINEL_LOW
constexpr int32_t kNoDoc = -2;           // the row end's "next doc"

// shared-memory index with one spare word per 16 (stride-16 accesses of a
// warp land on 32 banks); pad(n) words hold indices 0 .. n - 1
__host__ __device__ constexpr int pad(int p) { return p + (p >> 4); }

// the largest step distance (a power of two below max_seg), capped at a
// warp's span: the entries a warp hands to another per step
int hand_span(int max_seg) {
  int d = 1;
  while (2 * d < max_seg) d *= 2;
  return d < kWarpSpan ? d : kWarpSpan;
}

int smem_bytes(int window, int max_seg, bool counts) {
  const int warps = window / kWarpSpan;
  return 4 * (pad(window + 1) + pad(window) +
              2 * warps * pad(hand_span(max_seg)) * (counts ? 2 : 1));
}

// one scan step at a distance D < kK: in the thread from the highest entry
// down (s[k - D] is still the previous step's), the first D entries from the
// previous lane's last D (lane 0: the previous warp's, handed over in
// shared memory buffer `buf`)
template <int D, bool kCounts, typename Hi>
__device__ __forceinline__ void small_step(const int32_t (&dv)[kK], float (&s)[kK],
                                           int32_t (&c)[kK], const int32_t* sd,
                                           float* hs, int32_t* hc, Hi hi, int lane,
                                           int warp, int p0, int& buf) {
  if (lane == 31) {                      // the warp's last D entries
#pragma unroll
    for (int k = kK - D; k < kK; ++k) {
      hs[hi(buf, warp, k - (kK - D))] = s[k];
      if (kCounts) hc[hi(buf, warp, k - (kK - D))] = c[k];
    }
  }
  __syncthreads();
  float ps[D];
  int32_t pc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    ps[k] = __shfl_up_sync(kFull, s[kK - D + k], 1);
    pc[k] = kCounts ? __shfl_up_sync(kFull, c[kK - D + k], 1) : 0;
    if (lane == 0 && warp > 0) {
      ps[k] = hs[hi(buf, warp - 1, k)];
      if (kCounts) pc[k] = hc[hi(buf, warp - 1, k)];
    }
  }
#pragma unroll
  for (int k = kK - 1; k >= D; --k) {
    const bool same = dv[k] == dv[k - D];
    s[k] = s[k] + (same ? s[k - D] : 0.0f);
    if (kCounts) c[k] = c[k] + (same ? c[k - D] : 0);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int q = p0 + k - D;
    const bool same = q >= 0 && dv[k] == sd[pad(q)];
    s[k] = s[k] + (same ? ps[k] : 0.0f);
    if (kCounts) c[k] = c[k] + (same ? pc[k] : 0);
  }
  buf ^= 1;
}

template <bool kCounts>
__global__ void __launch_bounds__(kMaxThreads, 2)
finish_mask_kernel(const int32_t* __restrict__ docs,
                   const float* __restrict__ contribs,
                   const int32_t* __restrict__ n_terms,
                   float* __restrict__ out, int n, int tile, int halo,
                   int max_seg, int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x * kK;
  const int warps = blockDim.x >> 5;
  int32_t* sd = reinterpret_cast<int32_t*>(smem);      // window docs + next
  float* sf = reinterpret_cast<float*>(sd + pad(W + 1));  // contribs, then out
  float* hs = sf + pad(W);                   // [2][warps][pad(span)] sums
  int32_t* hc = reinterpret_cast<int32_t*>(hs + 2 * warps * pad(span));
  const auto hi = [=](int buf, int warp, int j) {
    return (buf * warps + warp) * pad(span) + pad(j);
  };

  const int64_t row = static_cast<int64_t>(blockIdx.y) * n;
  const int t0 = blockIdx.x * tile;
  const int t1 = min(t0 + tile, n);
  const int w0 = max(t0 - halo, 0);
  const int cnt = min(W, n - w0);
  {
    // all of a thread's loads in flight at once: entry tid + r * threads
    int32_t ld[kK];
    float lc[kK];
#pragma unroll
    for (int r = 0; r < kK; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      ld[r] = i < cnt ? docs[row + w0 + i] : kNoDoc;
      lc[r] = i < cnt ? contribs[row + w0 + i] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kK; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      sd[pad(i)] = ld[r];
      sf[pad(i)] = lc[r];
    }
  }
  if (threadIdx.x == 0) sd[pad(W)] = w0 + W < n ? docs[row + w0 + W] : kNoDoc;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p0 = threadIdx.x * kK;
  int32_t dv[kK];
  float s[kK];
  int32_t c[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    dv[k] = sd[pad(p0 + k)];
    s[k] = sf[pad(p0 + k)];
    c[k] = (dv[k] != kHigh && dv[k] != kLow) ? 1 : 0;
  }

  int buf = 0;
  if (max_seg > 1) small_step<1, kCounts>(dv, s, c, sd, hs, hc, hi, lane, warp, p0, buf);
  if (max_seg > 2) small_step<2, kCounts>(dv, s, c, sd, hs, hc, hi, lane, warp, p0, buf);
  if (max_seg > 4) small_step<4, kCounts>(dv, s, c, sd, hs, hc, hi, lane, warp, p0, buf);
  if (max_seg > 8) small_step<8, kCounts>(dv, s, c, sd, hs, hc, hi, lane, warp, p0, buf);

  for (int d = kK; d < max_seg; d <<= 1) {
    const bool far = d >= kWarpSpan;     // the partner is d / 512 warps back
    const int back = d / kK;             // lanes back (< 32 unless far)
    if (far || lane >= 32 - back) {      // what the next warps read
      const int j0 = far ? lane * kK : (lane - (32 - back)) * kK;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        hs[hi(buf, warp, j0 + k)] = s[k];
        if (kCounts) hc[hi(buf, warp, j0 + k)] = c[k];
      }
    }
    __syncthreads();
    const bool from_smem = far || lane < back;
    const int src = far ? warp - d / kWarpSpan : warp - 1;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float v = far ? 0.0f : __shfl_up_sync(kFull, s[k], back);
      int32_t cv = (far || !kCounts) ? 0 : __shfl_up_sync(kFull, c[k], back);
      const int q = p0 + k - d;
      if (from_smem && q >= 0) {
        v = hs[hi(buf, src, lane * kK + k)];
        if (kCounts) cv = hc[hi(buf, src, lane * kK + k)];
      }
      const bool same = q >= 0 && dv[k] == sd[pad(q)];
      s[k] = s[k] + (same ? v : 0.0f);
      if (kCounts) c[k] = c[k] + (same ? cv : 0);
    }
    buf ^= 1;
  }

  __syncthreads();   // every thread has read its contribs out of sf
  const float neg_inf = -__int_as_float(0x7f800000);
  const int32_t need = kCounts ? n_terms[blockIdx.y] : 0;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int32_t next = k + 1 < kK ? dv[k + 1] : sd[pad(p0 + kK)];
    bool ok = dv[k] != next && dv[k] != kHigh && dv[k] != kLow && s[k] > 0.0f;
    if (kCounts) ok = ok && c[k] >= need;
    sf[pad(p0 + k)] = ok ? s[k] : neg_inf;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kK; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (i >= t0 - w0 && i < t1 - w0) out[row + w0 + i] = sf[pad(i)];
  }
}

int wide_smem_bytes(int window, bool counts) {
  return 4 * (window + 1) + 8 * window * (counts ? 2 : 1);
}

// max_seg > 4096: the tile and its halo in shared memory (docs, then two
// buffers of sums and, with require_all, of counts), the scan ping-ponging
// between the buffers with one barrier a step
__global__ void __launch_bounds__(kWideThreads)
finish_mask_wide_kernel(const int32_t* __restrict__ docs,
                        const float* __restrict__ contribs,
                        const int32_t* __restrict__ n_terms,
                        float* __restrict__ out, int n, int tile, int halo,
                        int max_seg, int require_all) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cap = tile + halo;
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
    bool ok = doc != sd[i + 1] && doc != kHigh && doc != kLow && sa[i] > 0.0f;
    if (require_all) ok = ok && ca[i] >= need;
    out[row + w0 + i] = ok ? sa[i] : neg_inf;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

template <bool kCounts>
int launch_finish(const void* docs, const void* contribs, const void* n_terms,
                  void* out, int B, int n, int tile, int halo, int max_seg,
                  int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(finish_mask_kernel<kCounts>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + tile - 1) / tile, B);
  finish_mask_kernel<kCounts><<<grid, (tile + halo) / kK, smem, stream>>>(
      static_cast<const int32_t*>(docs), static_cast<const float*>(contribs),
      static_cast<const int32_t*>(n_terms), static_cast<float*>(out), n, tile,
      halo, max_seg, hand_span(max_seg));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// docs int32 [B, n], contribs f32 [B, n], n_terms int32 [B], out f32 [B, n];
// each block a window of W = tile + halo entries with `smem` bytes of
// dynamic shared memory. W <= 8192 (the register kernel): W a multiple of
// 512, smem = 4 * (pad(W + 1) + pad(W) + 2 * (W / 512) * pad(hand span) *
// (2 with require_all, else 1)), pad(x) = x + x / 16, the hand span
// min(512, the largest power of two below max_seg). W > 8192 (the wide
// kernel): smem = 4 * (W + 1) + 8 * W * (2 with require_all, else 1).
// Returns cudaGetLastError().
extern "C" int nrt_finish_mask(const void* docs, const void* contribs,
                               const void* n_terms, void* out, int B, int n,
                               int tile, int halo, int max_seg,
                               int require_all, int smem, void* stream) {
  const int window = tile + halo;
  const bool wide = window > kMaxWindow;
  if (tile <= 0 || halo < 0 || max_seg < 1 ||
      (!wide && (window % kWarpSpan ||
                 smem != smem_bytes(window, max_seg, require_all))) ||
      (wide && smem != wide_smem_bytes(window, require_all))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* st = static_cast<cudaStream_t>(stream);
  if (wide) {
    const cudaError_t err = allow_smem(finish_mask_wide_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((n + tile - 1) / tile, B);
    finish_mask_wide_kernel<<<grid, kWideThreads, smem, st>>>(
        static_cast<const int32_t*>(docs), static_cast<const float*>(contribs),
        static_cast<const int32_t*>(n_terms), static_cast<float*>(out), n,
        tile, halo, max_seg, require_all);
    return static_cast<int>(cudaGetLastError());
  }
  if (require_all) {
    return launch_finish<true>(docs, contribs, n_terms, out, B, n, tile, halo,
                               max_seg, smem, st);
  }
  return launch_finish<false>(docs, contribs, n_terms, out, B, n, tile, halo,
                              max_seg, smem, st);
}

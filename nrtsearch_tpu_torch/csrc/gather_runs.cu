// Postings-run gather of the merge path's accelerator branch: [B, R] run
// tables (offset, length, weight) -> docs int32 [B, R, run_len] and
// contribs f32 [B, R, run_len].
//
// Replaces: nrtsearch_tpu/ops/pallas_merge.py `gather_runs_pallas` /
// `_gather_kernel` (one aligned DMA window per (query, run, chunk), realigned
// and, for odd runs in alternating mode, flipped in VMEM).
//
// Semantics: output position p of run r reads source entry q = p, or
// q = run_len - 1 - p for an odd r in alternating mode (the whole run
// reversed, so it reads descending). Where q < len and the weight is not 0
// it holds post_docs[off + q] and weight * post_impacts[off + q] (one f32
// multiply); everywhere else the HIGH sentinel and 0. No read goes past the
// run's length, and an entry outside [0, P) is a caller bug and traps.
//
// Bound on the card: device-memory traffic, 8 bytes read (valid entries
// only) and 8 bytes written per output entry.
//
// Design: one thread per output entry with int64 index arithmetic. The TPU
// kernel's DMA realignment and roll-based flip have no counterpart: a thread
// computes its source index, and a warp of an odd run reads 32 neighbouring
// entries in descending order, which coalesces like ascending reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kHigh = 2147483647;  // DOC_SENTINEL: back padding

__global__ void gather_runs_kernel(const int32_t* __restrict__ post_docs,
                                   const float* __restrict__ post_impacts,
                                   int64_t n_postings,
                                   const int32_t* __restrict__ offs,
                                   const int32_t* __restrict__ lens,
                                   const float* __restrict__ weights,
                                   int32_t* __restrict__ out_docs,
                                   float* __restrict__ out_contribs,
                                   int64_t total, int R, int run_len,
                                   int alternating) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t run = e / run_len;  // b * R + r
  const int p = static_cast<int>(e - run * run_len);
  const bool odd = (run % R) & 1;
  const int q = (alternating && odd) ? run_len - 1 - p : p;
  const float w = weights[run];
  int32_t doc = kHigh;
  float contrib = 0.0f;
  if (q < lens[run] && w != 0.0f) {
    const int64_t src = static_cast<int64_t>(offs[run]) + q;
    if (src < 0 || src >= n_postings) __trap();
    doc = post_docs[src];
    contrib = w * post_impacts[src];
  }
  out_docs[e] = doc;
  out_contribs[e] = contrib;
}

}  // namespace

// post_docs int32 [P], post_impacts f32 [P]; offs, lens int32 [B, R];
// weights f32 [B, R]; out_docs int32 [B, R, run_len], out_contribs f32 alike.
// Returns cudaGetLastError() after the launch.
extern "C" int nrt_gather_runs(const void* post_docs, const void* post_impacts,
                               long long n_postings, const void* offs,
                               const void* lens, const void* weights,
                               void* out_docs, void* out_contribs, int B, int R,
                               int run_len, int alternating, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * R * run_len;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  gather_runs_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(post_docs),
      static_cast<const float*>(post_impacts), n_postings,
      static_cast<const int32_t*>(offs), static_cast<const int32_t*>(lens),
      static_cast<const float*>(weights), static_cast<int32_t*>(out_docs),
      static_cast<float*>(out_contribs), total, R, run_len, alternating);
  return static_cast<int>(cudaGetLastError());
}

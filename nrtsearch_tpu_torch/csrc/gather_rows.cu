// Compact head-row gather: out[u, :] = rows[idx[u], :] for bf16 rows [Hp, D].
//
// Replaces: nrtsearch_tpu/ops/dense_fused.py `_gather_rows_pallas`, the Pallas
// block-copy kernel behind `gather_rows` (one (1, C, 128) DMA per grid step
// with the source row scalar-prefetched).
//
// Bound on the card: device-memory traffic. The kernel computes nothing; it
// reads and writes U * D * 2 bytes (two passes per fused batch when the
// Dekker residual rows are present).
//
// Design: every thread moves 16 bytes (8 bf16 values) with one vector load
// and one vector store, and neighbouring threads touch neighbouring 16-byte
// words, so each warp reads and writes 512 contiguous bytes of one row. The
// grid is (U, ceil(D / (threads * 8))): block x picks the output row, block y
// a chunk of it; each thread reads its source row index from idx itself
// (the counterpart of the TPU kernel's scalar prefetch). An index outside
// [0, Hp) is a caller bug and traps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows_kernel(const uint4* __restrict__ rows,
                                   const int32_t* __restrict__ idx,
                                   uint4* __restrict__ out,
                                   int n_rows, int row_vecs) {
  const int u = blockIdx.x;
  const int v = blockIdx.y * kThreads + threadIdx.x;
  if (v >= row_vecs) return;
  const int src = idx[u];
  if (src < 0 || src >= n_rows) __trap();
  out[(int64_t)u * row_vecs + v] = rows[(int64_t)src * row_vecs + v];
}

}  // namespace

// rows: bf16 [n_rows, D] (16-byte aligned, D % 8 == 0); idx: int32 [U];
// out: bf16 [U, D]. Returns cudaGetLastError() after the launch.
extern "C" int nrt_gather_rows(const void* rows, const void* idx, void* out,
                               int n_rows, int U, int D, void* stream) {
  const int row_vecs = D / 8;
  dim3 grid(U, (row_vecs + kThreads - 1) / kThreads);
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<const int32_t*>(idx),
      static_cast<uint4*>(out), n_rows, row_vecs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

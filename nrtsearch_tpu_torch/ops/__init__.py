"""Torch ops of the search slice: BM25 impacts, the bitonic merge with its
CUDA kernels, merge scoring and the fused dense-head search."""

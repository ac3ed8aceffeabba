"""Segments of the kNN path answered by the port's kernel (``ops/knn.py``
``KNN_SEGMENTS["fused"]``: ``segment_top_k`` through ``kernels.knn_topk``),
per batch of the traced window; 0 for a program without the counter."""

import importlib


def counter() -> int:
    knn = importlib.import_module("nrtsearch_tpu_torch.ops.knn")
    return getattr(knn, "KNN_SEGMENTS", {}).get("fused", 0)


def read(run):
    n = run.counters.get(__name__)
    return None if n is None or not run.batches else n / len(run.batches)

"""BM25 pieces of the search slice (counterpart: nrtsearch_tpu/ops/bm25.py).

    idf(t)  = ln(1 + (docCount - df + 0.5) / (df + 0.5))      [host, plan time]
    impact  = tf / (tf + k1 * (1 - b + b * dl / avgdl))       [device, refresh]

with dl the byte-quantized field length (nrtsearch_tpu/utils/smallfloat.py).
A posting's score contribution is ``idf * boost * impact``.
"""

from __future__ import annotations

import numpy as np
import torch


def lucene_idf(doc_count: int, doc_freq: int) -> float:
    """Lucene BM25Similarity idf."""
    return float(np.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5)))


def precompute_impacts(
    post_docs: torch.Tensor,   # int32 [P]
    post_freqs: torch.Tensor,  # float32 [P]
    doc_lens: torch.Tensor,    # float32 [D] quantized lengths
    live: torch.Tensor,        # bool [D]
    k1: float,
    b: float,
    avgdl: float,
) -> torch.Tensor:
    """Per-posting BM25 tf-norm impact, zeroed for deleted docs.

    The f32 formula runs in the reference's order, with one difference of
    form: the reference's compiled program contracts ``tf + k1 * norm``
    into one fused multiply-add (one rounding). The port computes that
    FMA in f64 (the f32 product is exact there) and rounds once to f32,
    which makes impacts bit-equal to the reference on the same inputs.
    k1, b and avgdl are 0-d f32 tensors on the postings' device: a
    Python-scalar divisor lets CUDA's ``div`` multiply by a rounded
    reciprocal instead."""
    dev = post_docs.device
    k1_t = torch.tensor(k1, dtype=torch.float32, device=dev)
    b_t = torch.tensor(b, dtype=torch.float32, device=dev)
    avgdl_t = torch.tensor(avgdl, dtype=torch.float32, device=dev)
    idx = post_docs.long()
    dl = doc_lens[idx]
    norm = 1.0 - b_t + b_t * dl / avgdl_t
    denom = (k1_t.double() * norm.double() + post_freqs.double()).float()
    impact = post_freqs / denom
    return torch.where(live[idx], impact, torch.zeros((), dtype=torch.float32, device=dev))

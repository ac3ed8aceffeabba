"""Helpers of the fused dense-head search (counterpart: the helpers of
nrtsearch_tpu/ops/dense_head.py that ops/dense_fused.py uses).

The reference's round-4 dense path (``dense_merge_topk``, the bucket-tail
``dense_tail_topk``) is not on the served path and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from nrtsearch_tpu_torch.ops.topk import topk_lowest_index

NEG_INF = np.float32(-np.inf)
_DOC_MAX = 2**31 - 1


def _searchsorted_rows(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-row searchsorted (side left): a [B, N] non-decreasing, v [B, K]."""
    return torch.searchsorted(a, v)


def _topk_docid(s: torch.Tensor, d: torch.Tensor, k: int):
    """Exact top-k under Lucene's (score desc, docid asc) tie contract.

    The reference sorts on the two keys (-score, docid); here two stable
    sorts do the same: by docid, then by score descending. Padding entries
    (-inf) sort last and carry docid 2^31-1, as in the reference."""
    dk = torch.where(s == float(NEG_INF), torch.full_like(d, _DOC_MAX), d)
    o1 = torch.sort(dk, dim=1, stable=True).indices
    s1 = torch.gather(s, 1, o1)
    d1 = torch.gather(dk, 1, o1)
    o2 = torch.sort(s1, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s1, 1, o2), torch.gather(d1, 1, o2)


def _combine_topk_docid(s_a, d_a, s_b, d_b, k: int):
    """Top-k of two candidate sets under (score desc, docid asc).

    Source A's entries must ascend by docid (so the lowest-index tie rule
    IS the docid tie rule); it is cut to k before the small lexicographic
    combine with source B."""
    if s_a.shape[1] > k:
        s_a, ia = topk_lowest_index(s_a, k)
        d_a = torch.gather(d_a, 1, ia)
    return _topk_docid(torch.cat([s_a, s_b], dim=1), torch.cat([d_a, d_b], dim=1), k)


def decode_packed2(packed, k: int):
    """[B, 2k+2] int32 -> (scores f32 [B,k], docs i32 [B,k], hits i64 [B],
    counts_exact bool [B]) as numpy arrays."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    scores = packed[:, :k].view(np.float32)
    docs = packed[:, k : 2 * k]
    hits = packed[:, 2 * k].astype(np.int64)
    exact = packed[:, 2 * k + 1].astype(bool)
    return scores, docs, hits, exact

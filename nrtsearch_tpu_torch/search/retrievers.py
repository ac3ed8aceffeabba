"""Copy of ``nrtsearch_tpu/search/retrievers.py``, kept whole, its imports
pointed at the port.

Multi-retriever hybrid search: independent retrievers + blenders.

Reference: server/search/multiretriever/ (972 LoC) — N named retrievers (text
query or kNN) recalled independently, then blended: weighted-RRF,
weighted-score (SUM/MAX/AVG), or raw merge (proto search.proto:863-953).
Retrievers here run sequentially per request (the whole batch is one device
program each); cross-request batching supersedes the reference's
RETRIEVER-pool concurrency.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from nrtsearch_tpu_torch.core.searcher import Hit, Searcher, TopDocs
from nrtsearch_tpu_torch.query.plan import QueryNode


@dataclass
class RetrieverSpec:
    name: str
    query: Optional[QueryNode] = None
    knn_field: Optional[str] = None
    knn_vector: Optional[np.ndarray] = None
    knn_k: int = 10
    knn_filter: Optional[QueryNode] = None
    window_size: int = 100
    weight: float = 1.0


def run_retrievers(
    searcher: Searcher, specs: Sequence[RetrieverSpec]
) -> dict[str, TopDocs]:
    out = {}
    for spec in specs:
        if spec.query is not None:
            out[spec.name] = searcher.search(spec.query, spec.window_size)
        else:
            out[spec.name] = searcher.knn_search(
                spec.knn_field, spec.knn_vector, spec.window_size,
                filter_node=spec.knn_filter,
            )
    return out


def blend_rrf(
    results: dict[str, TopDocs], weights: dict[str, float], rank_constant: int = 60
) -> list[Hit]:
    """Weighted reciprocal-rank fusion (reference blender WEIGHTED_RRF)."""
    scores: dict[int, float] = {}
    hit_by_ord: dict[int, Hit] = {}
    for name, td in results.items():
        w = weights.get(name, 1.0)
        for rank, h in enumerate(td.hits):
            scores[h.global_ord] = scores.get(h.global_ord, 0.0) + w / (
                rank_constant + rank + 1
            )
            hit_by_ord.setdefault(h.global_ord, h)
    merged = [
        Hit(hit_by_ord[o].segment_idx, hit_by_ord[o].local_id, o, s)
        for o, s in scores.items()
    ]
    merged.sort(key=lambda h: (-h.score, h.global_ord))
    return merged


def blend_weighted_score(
    results: dict[str, TopDocs], weights: dict[str, float], mode: str = "SUM"
) -> list[Hit]:
    """Weighted score blending: SUM / MAX / AVG (reference WEIGHTED_SCORE)."""
    acc: dict[int, list[float]] = {}
    hit_by_ord: dict[int, Hit] = {}
    for name, td in results.items():
        w = weights.get(name, 1.0)
        for h in td.hits:
            acc.setdefault(h.global_ord, []).append(w * h.score)
            hit_by_ord.setdefault(h.global_ord, h)
    merged = []
    for o, vals in acc.items():
        if mode == "MAX":
            s = max(vals)
        elif mode == "AVG":
            s = sum(vals) / len(vals)
        else:
            s = sum(vals)
        merged.append(Hit(hit_by_ord[o].segment_idx, hit_by_ord[o].local_id, o, s))
    merged.sort(key=lambda h: (-h.score, h.global_ord))
    return merged


def blend_raw(results: dict[str, TopDocs], order: Sequence[str]) -> list[Hit]:
    """Scoreless raw merge: retriever order preserved, dedupe by doc."""
    seen = set()
    out = []
    for name in order:
        for h in results[name].hits:
            if h.global_ord not in seen:
                seen.add(h.global_ord)
                out.append(h)
    return out


def blend_plugin(
    registry,
    name: str,
    results: dict[str, TopDocs],
    weights: dict[str, float],
    params: dict,
) -> list[Hit]:
    """Plugin-provided blender (reference: PluginBlender + BlenderCreator,
    search.proto:554). Fails loudly on an unregistered name."""
    fn = (registry.blenders if registry is not None else {}).get(name)
    if fn is None:
        raise ValueError(f"unknown plugin blender: {name!r}")
    return fn(results, weights, params)

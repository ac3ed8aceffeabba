"""Copy of ``nrtsearch_tpu/search/rescore.py``, kept whole but for one line:
the rescore query's per-segment (scores, match) tensors come to the host
through ``.cpu()`` (``np.asarray`` refuses a CUDA tensor). The script
rescorer calls ``script.expr`` with a numpy score, which hands back a
numpy array.

Second-pass rescorers over the top window.

Reference: server/rescore/ (QueryRescore, ScriptRescore, RescoreTask;
proto search.proto:1361-1400). Rescoring is columnar: the rescore query /
script evaluates per segment as dense arrays and per-hit values are gathered
at the window's doc ids.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from nrtsearch_tpu_torch.core.searcher import Hit, Searcher
from nrtsearch_tpu_torch.query import eval as qeval
from nrtsearch_tpu_torch.query.plan import QueryNode


def query_rescore(
    searcher: Searcher,
    hits: Sequence[Hit],
    window_size: int,
    rescore_node: QueryNode,
    query_weight: float,
    rescore_weight: float,
) -> list[Hit]:
    """combined = query_weight * original + rescore_weight * rescore_score."""
    window = list(hits[:window_size])
    rest = list(hits[window_size:])
    seg_arrays = {}
    for h in window:
        if h.segment_idx not in seg_arrays:
            seg = searcher.segments[h.segment_idx]
            ctx = qeval.EvalContext(seg, searcher.field_defs, searcher.stats)
            scores, match = qeval.eval_node(rescore_node, ctx)
            seg_arrays[h.segment_idx] = (scores.cpu().numpy(), match.cpu().numpy())
    out = []
    for h in window:
        scores, match = seg_arrays[h.segment_idx]
        rescore = float(scores[h.local_id]) if match[h.local_id] else 0.0
        out.append(
            Hit(h.segment_idx, h.local_id, h.global_ord,
                query_weight * h.score + rescore_weight * rescore)
        )
    out.sort(key=lambda h: (-h.score, h.global_ord))
    return out + rest


def script_rescore(
    searcher: Searcher,
    hits: Sequence[Hit],
    window_size: int,
    script_source: str,
) -> list[Hit]:
    from nrtsearch_tpu_torch.query.eval import _ScriptDocValues
    from nrtsearch_tpu_torch.script.expr import compile_expression

    fn = compile_expression(script_source)
    window = list(hits[:window_size])
    rest = list(hits[window_size:])
    # evaluate per segment with the hit's original score injected per doc
    seg_scores: dict[int, np.ndarray] = {}
    for h in window:
        seg_scores.setdefault(h.segment_idx, np.zeros(
            searcher.segments[h.segment_idx].capacity, np.float32
        ))[h.local_id] = h.score
    seg_vals = {}
    for seg_idx, score_arr in seg_scores.items():
        seg = searcher.segments[seg_idx]
        seg_vals[seg_idx] = np.asarray(fn(_ScriptDocValues(seg), score_arr))
    out = [
        Hit(h.segment_idx, h.local_id, h.global_ord,
            float(seg_vals[h.segment_idx][h.local_id]))
        for h in window
    ]
    out.sort(key=lambda h: (-h.score, h.global_ord))
    return out + rest

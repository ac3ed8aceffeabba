"""Per-segment query evaluation: plan node -> (scores, match) tensors
(counterpart: nrtsearch_tpu/query/eval.py).

Every leaf produces a dense ``scores [capacity] f32`` and ``match
[capacity] bool`` pair on the segment's device, and boolean composition is
mask algebra, term-at-a-time over the whole segment, as in the reference.
Text leaves score through ``ops.bm25.score_text_clause`` (one scatter per
query term, in term order), doc-value leaves through ``ops.masks``, scripts
through ``script.expr``. Filter-like nodes are cached per (segment,
device, node) in ``search.query_cache``. Every op runs in the reference's
order and precision, so scores are bit-equal to it but where a
transcendental function is involved (scripts, geo distance).

Positional queries (phrase, match-phrase, phrase-prefix, span-near) find
their candidates on the device (docs holding every term), then verify
positions: phrases and phrase-prefixes on the device (``ops.phrase``)
wherever the reference's default path does, span-near in a host loop over
the candidates, as in the reference. Nested queries aggregate child scores
per parent block, and completion queries scan the segment's suggest
entries, on the host as in the reference; every device tensor they read
comes back with ``.cpu()``. ``PHRASE_PATHS`` counts which verification
served each phrase and phrase-prefix query that had candidates.
"""

from __future__ import annotations

import fnmatch
import functools
import math
import re
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.analysis import get_analyzer
from nrtsearch_tpu_torch.core.segment import Segment
from nrtsearch_tpu_torch.device import scalar_f32
from nrtsearch_tpu_torch.ops import bm25 as bm25_ops
from nrtsearch_tpu_torch.ops import masks as mask_ops
from nrtsearch_tpu_torch.query import plan as qp
from nrtsearch_tpu_torch.schema.fields import DocValueKind, FieldDef

# Lucene BM25Similarity defaults
BM25_K1 = 1.2
BM25_B = 0.75


# phrase and phrase-prefix queries (per segment with candidates) served per
# verification path: "device" (ops.phrase) and "host" (``_phrase_freq``)
PHRASE_PATHS = {"device": 0, "host": 0}


class CollectionStats:
    """Index-wide term/field statistics (Lucene CollectionStatistics),
    across all segments of a searcher snapshot; deletions are NOT
    subtracted, matching Lucene."""

    def __init__(self, segments: Sequence[Segment]):
        self.segments = list(segments)
        self._field_doc_count: dict[str, int] = {}
        self._field_sum_len: dict[str, int] = {}
        for seg in segments:
            for name, tfi in seg.fields.items():
                self._field_doc_count[name] = self._field_doc_count.get(name, 0) + tfi.doc_count
                self._field_sum_len[name] = self._field_sum_len.get(name, 0) + tfi.sum_doc_lens

    def doc_count(self, field: str) -> int:
        return self._field_doc_count.get(field, 0)

    def avgdl(self, field: str) -> float:
        dc = self.doc_count(field)
        return (self._field_sum_len.get(field, 0) / dc) if dc else 1.0

    def doc_freq(self, field: str, term: str) -> int:
        return sum(
            seg.fields[field].doc_freq(term) for seg in self.segments if field in seg.fields
        )


@dataclass
class EvalContext:
    segment: Segment
    field_defs: dict[str, FieldDef]
    stats: CollectionStats
    k1: float = BM25_K1
    b: float = BM25_B


def eval_node(node: qp.QueryNode, ctx: EvalContext):
    """Evaluate a plan node against one segment -> (scores, match).

    Filter-like nodes are cached per (segment, device, node): segments are
    immutable, so entries never go stale (search/query_cache.py)."""
    from nrtsearch_tpu_torch.search.query_cache import DEFAULT_QUERY_CACHE as _qc

    if _qc.cacheable(node):
        seg = ctx.segment
        cached = _qc.get(seg.seg_id, node, seg.device)
        if cached is not None:
            return cached
        result = _eval_node_impl(node, ctx)
        _qc.put(seg.seg_id, node, result, seg.device)
        return result
    return _eval_node_impl(node, ctx)


def _zero(ctx: EvalContext) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=ctx.segment.device)


def _eval_node_impl(node: qp.QueryNode, ctx: EvalContext):
    seg = ctx.segment
    if isinstance(node, qp.MatchAllNode):
        return (
            torch.full((seg.capacity,), float(np.float32(node.boost)),
                       dtype=torch.float32, device=seg.device),
            _doc_range_mask(ctx),
        )
    if isinstance(node, qp.TermQueryNode):
        return _eval_term(node, ctx)
    if isinstance(node, qp.TermInSetNode):
        return _eval_term_in_set(node, ctx)
    if isinstance(node, qp.MatchQueryNode):
        fd = _field(ctx, node.field)
        analyzer = get_analyzer(node.analyzer) if node.analyzer else None
        terms = analyzer.terms(node.query) if analyzer else fd.query_terms(node.query)
        if node.fuzzy_max_edits > 0:
            tfi = seg.fields.get(node.field)
            if tfi is not None:
                expanded = []
                for t in terms:
                    expanded.extend(
                        _fuzzy_expand(
                            tfi, t, node.fuzzy_max_edits,
                            node.fuzzy_prefix_length, node.fuzzy_max_expansions,
                        )
                    )
                terms = list(dict.fromkeys(expanded))  # dedupe, keep order
        return _text_clause(
            ctx, node.field, terms, [1.0] * len(terms), node.operator,
            node.minimum_number_should_match, node.boost,
        )
    if isinstance(node, qp.MultiMatchQueryNode):
        return _eval_multi_match(node, ctx)
    if isinstance(node, qp.BooleanQueryNode):
        return _eval_boolean(node, ctx)
    if isinstance(node, qp.RangeQueryNode):
        return _eval_range(node, ctx)
    if isinstance(node, qp.ExistsQueryNode):
        return _eval_exists(node, ctx)
    if isinstance(node, qp.PrefixQueryNode):
        return _eval_prefix(node, ctx)
    if isinstance(node, qp.GeoBoundingBoxNode):
        return _eval_geo_bbox(node, ctx)
    if isinstance(node, qp.GeoRadiusNode):
        return _eval_geo_radius(node, ctx)
    if isinstance(node, (qp.PhraseQueryNode, qp.MatchPhraseQueryNode)):
        return _eval_phrase(node, ctx)
    if isinstance(node, qp.MatchPhrasePrefixQueryNode):
        return _eval_phrase_prefix_impl(
            ctx, node.field, node.query, node.slop, node.analyzer,
            node.max_expansions, node.boost,
        )
    if isinstance(node, qp.FunctionScoreNode):
        return _eval_function_score(node, ctx)
    if isinstance(node, qp.MultiFunctionScoreNode):
        return _eval_multi_function_score(node, ctx)
    if isinstance(node, qp.ConstantScoreNode):
        _, match = eval_node(node.filter or qp.MatchAllNode(), ctx)
        return _const_score(match, node.boost), match
    if isinstance(node, qp.DisjunctionMaxNode):
        return _eval_dismax(node, ctx)
    if isinstance(node, qp.MinScoreNode):
        scores, match = eval_node(node.query or qp.MatchAllNode(), ctx)
        match = match & (scores >= scalar_f32(node.min_score, seg.device))
        return torch.where(match, scores * scalar_f32(node.boost, seg.device), _zero(ctx)), match
    if isinstance(node, qp.FunctionFilterNode):
        from nrtsearch_tpu_torch.script.expr import compile_expression

        fn = compile_expression(node.expression)
        vals = fn(
            _ScriptDocValues(seg),
            torch.zeros(seg.capacity, dtype=torch.float32, device=seg.device),
        )
        match = (vals > 0.0) & seg.live
        return torch.where(match, vals * scalar_f32(node.boost, seg.device), _zero(ctx)), match
    if isinstance(node, qp.ExactVectorQueryNode):
        return _eval_exact_vector(node, ctx)
    if isinstance(node, qp.SpanNearNode):
        return _eval_span_near(node, ctx)
    if isinstance(node, qp.ResolvedJoinNode):
        return _eval_resolved_join(node, ctx)
    if isinstance(node, qp.CrossIndexQueryNode):
        raise ValueError(
            "CrossIndexQuery requires server global state (unresolved node)"
        )
    if isinstance(node, qp.FuzzyQueryNode):
        return _eval_fuzzy(node, ctx)
    if isinstance(node, qp.WildcardQueryNode):
        return _eval_wildcard(node, ctx)
    if isinstance(node, qp.NestedQueryNode):
        return _eval_nested(node, ctx)
    if isinstance(node, qp.CompletionQueryNode):
        return _eval_completion(node, ctx)
    if isinstance(node, qp.GeoPolygonNode):
        return _eval_geo_polygon(node, ctx)
    if isinstance(node, qp.PolygonContainsNode):
        dv = polygon_column(ctx, node.field)
        match = mask_ops.doc_polygons_contain_point(dv.values, dv.present, node.lat, node.lon)
        return _const_score(match, node.boost), match
    raise NotImplementedError(f"query node not yet supported: {type(node).__name__}")


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------


def _field(ctx: EvalContext, name: str) -> FieldDef:
    fd = ctx.field_defs.get(name)
    if fd is None:
        raise KeyError(f"unknown field: {name!r}")
    return fd


def _doc_range_mask(ctx: EvalContext) -> torch.Tensor:
    """True for real (non-padding) docs; deletions are applied by the caller."""
    seg = ctx.segment
    return torch.arange(seg.capacity, device=seg.device) < seg.num_docs


def _none(ctx: EvalContext):
    seg = ctx.segment
    return (torch.zeros(seg.capacity, dtype=torch.float32, device=seg.device),
            torch.zeros(seg.capacity, dtype=torch.bool, device=seg.device))


def text_clause_inputs(ctx: EvalContext, field: str, terms, term_boosts, boost: float):
    """Host arrays of one text clause: per term its postings run (offset,
    length) in this segment and its weight ``idf * term boost * boost`` in
    f32 (0 for a term no segment holds); and the field's (k1, b)."""
    tfi = ctx.segment.fields[field]
    fd = ctx.field_defs.get(field)
    k1 = fd.sim_k1 if fd is not None else ctx.k1
    b = fd.sim_b if fd is not None else ctx.b
    offs = np.zeros(len(terms), np.int64)
    lens = np.zeros(len(terms), np.int64)
    weights = np.zeros(len(terms), np.float32)
    dc = ctx.stats.doc_count(field)
    for i, (term, tb) in enumerate(zip(terms, term_boosts)):
        off, ln = tfi.lookup(term)
        df = ctx.stats.doc_freq(field, term)
        offs[i], lens[i] = off, ln
        weights[i] = bm25_ops.lucene_idf(dc, df) * tb * boost if df else 0.0
    return offs, lens, weights, k1, b


def _text_clause(
    ctx: EvalContext,
    field: str,
    terms: list[str],
    term_boosts: list[float],
    operator: str,
    msm: int,
    boost: float,
):
    """Scored multi-term clause over one field (match/term queries)."""
    seg = ctx.segment
    tfi = seg.fields.get(field)
    if not terms or tfi is None:
        return _none(ctx)
    offs, lens, weights, k1, b = text_clause_inputs(ctx, field, terms, term_boosts, boost)
    scores, counts = bm25_ops.score_text_clause(
        tfi.doc_ids, tfi.freqs, tfi.doc_lens, offs, lens, weights,
        k1, b, ctx.stats.avgdl(field), num_docs=seg.capacity,
    )
    if operator == "MUST":
        match = counts == len(terms)
    else:
        match = counts >= max(1, msm)
    return torch.where(match, scores, _zero(ctx)), match


def _eval_term(node: qp.TermQueryNode, ctx: EvalContext):
    fd = _field(ctx, node.field)
    text = fd.normalize_value(node.text) if node.text is not None else None
    if text is not None and fd.is_text and fd.search:
        return _text_clause(ctx, node.field, [text], [1.0], "MUST", 0, node.boost)
    dv = ctx.segment.doc_values.get(node.field)
    if dv is None:
        return _none(ctx)
    if node.bool_value is not None:
        target = 1 if node.bool_value else 0
    elif node.long_value is not None:
        target = node.long_value
    elif node.double_value is not None:
        target = node.double_value
    elif text is not None and dv.kind == DocValueKind.ORDINAL:
        ordv = (dv.ord_index or {}).get(text, -2)
        match = _ordinal_match(dv, np.asarray([ordv], np.int32))
        return _const_score(match, node.boost), match
    else:
        return _none(ctx)
    match = mask_ops.eq_mask(dv.values, dv.present, _dv_scalar(dv, target))
    match = _mv_any(dv, match, lambda arr: arr == target)
    return _const_score(match, node.boost), match


def _eval_term_in_set(node: qp.TermInSetNode, ctx: EvalContext):
    fd = _field(ctx, node.field)
    texts = [fd.normalize_value(t) for t in node.texts]
    if texts and fd.is_text and fd.search:
        # OR over postings of each term, constant score (Lucene TermInSetQuery)
        _, match = _text_clause(
            ctx, node.field, texts, [0.0] * len(texts), "SHOULD", 0, 0.0
        )
        return _const_score(match, node.boost), match
    dv = ctx.segment.doc_values.get(node.field)
    if dv is None:
        return _none(ctx)
    if texts and dv.kind == DocValueKind.ORDINAL:
        ords = np.asarray([(dv.ord_index or {}).get(t, -2) for t in texts], np.int32)
        match = _ordinal_match(dv, ords)
        return _const_score(match, node.boost), match
    targets = np.asarray(node.long_values or node.double_values, dtype=_np_dtype_of(dv))
    if targets.size == 0:
        return _none(ctx)
    match = mask_ops.in_set_mask(dv.values, dv.present, _dv_array(dv, targets))
    match = _mv_any(dv, match, lambda arr: np.isin(arr, targets))
    return _const_score(match, node.boost), match


def _eval_multi_match(node: qp.MultiMatchQueryNode, ctx: EvalContext):
    """Multi-field match (reference: query/QueryNodeMapper getMultiMatchQuery).

    BEST_FIELDS: dis-max over per-field match queries. PHRASE_PREFIX:
    dis-max over per-field match-phrase-prefix queries. CROSS_FIELDS:
    every term scored against its best field, then summed."""
    dev = ctx.segment.device
    boosts = node.field_boosts or (1.0,) * len(node.fields)
    if node.match_type == "CROSS_FIELDS":
        fd0 = _field(ctx, node.fields[0])
        terms = fd0.query_terms(node.query)
        if not terms:
            return _none(ctx)
        term_score = None
        term_match = []
        for t in terms:
            best = None
            any_m = None
            for f, fb in zip(node.fields, boosts):
                s, m = _text_clause(ctx, f, [t], [fb], "SHOULD", 0, 1.0)
                best = s if best is None else torch.maximum(best, s)
                any_m = m if any_m is None else (any_m | m)
            term_score = best if term_score is None else term_score + best
            term_match.append(any_m)
        matched_n = term_match[0].to(torch.int32)
        for m in term_match[1:]:
            matched_n = matched_n + m.to(torch.int32)
        need = len(terms) if node.operator == "MUST" else max(
            node.minimum_number_should_match, 1
        )
        match = matched_n >= need
        return torch.where(match, term_score * scalar_f32(node.boost, dev), _zero(ctx)), match
    per_field = []
    for f, fb in zip(node.fields, boosts):
        if node.match_type == "PHRASE_PREFIX":
            per_field.append(_eval_phrase_prefix_impl(
                ctx, f, node.query, node.slop, None, node.max_expansions, fb))
            continue
        fd = _field(ctx, f)   # BEST_FIELDS
        terms = fd.query_terms(node.query)
        per_field.append(
            _text_clause(
                ctx, f, terms, [fb] * len(terms), node.operator,
                node.minimum_number_should_match, 1.0,
            )
        )
    total = per_field[0][0]
    for s, _ in per_field[1:]:
        total = total + s
    best = per_field[0][0]
    for s, _ in per_field[1:]:
        best = torch.maximum(best, s)
    scores = best + scalar_f32(node.tie_breaker, dev) * (total - best)
    match = per_field[0][1]
    for _, m in per_field[1:]:
        match = match | m
    return torch.where(match, scores * scalar_f32(node.boost, dev), _zero(ctx)), match


def _eval_resolved_join(node: qp.ResolvedJoinNode, ctx: EvalContext):
    """Join-value matching with per-value aggregated scores (the to-side of
    Lucene JoinUtil.createJoinQuery; the from-side search already ran in the
    handler), on the host columns as in the reference."""
    seg = ctx.segment
    dv = seg.doc_values.get(node.field)
    if dv is None or not node.values:
        return _none(ctx)
    D = seg.capacity
    n = seg.num_docs
    scores_host = np.zeros(D, np.float32)
    match_host = np.zeros(D, bool)
    if dv.mv_offsets is not None:
        val_score = {v: float(s) for v, s in zip(node.values, node.value_scores)}
        for d in range(n):
            lo, hi = int(dv.mv_offsets[d]), int(dv.mv_offsets[d + 1])
            best = None
            for raw in dv.mv_values[lo:hi]:
                key = dv.ord_terms[int(raw)] if dv.ord_terms else raw.item()
                s = val_score.get(key)
                if s is not None:
                    best = s if best is None else max(best, s)
            if best is not None:
                match_host[d] = True
                scores_host[d] = best
    elif dv.kind == DocValueKind.ORDINAL:
        per_ord = np.zeros(max(len(dv.ord_terms or []), 1), np.float32)
        has_ord = np.zeros(max(len(dv.ord_terms or []), 1), bool)
        for v, s in zip(node.values, node.value_scores):
            o = (dv.ord_index or {}).get(str(v))
            if o is not None:
                has_ord[o] = True
                per_ord[o] = s
        hv = dv.host_values[:n]
        pres = dv.host_present[:n] & (hv >= 0)
        safe = np.clip(hv, 0, len(has_ord) - 1)
        sel = pres & has_ord[safe]
        match_host[:n] = sel
        scores_host[:n][sel] = per_ord[safe[sel]]
    else:
        try:
            vs = np.asarray(node.values, dtype=dv.host_values.dtype)
        except (TypeError, ValueError):
            return _none(ctx)
        order = np.argsort(vs, kind="stable")
        svals = vs[order]
        sscores = np.asarray(node.value_scores, np.float32)[order]
        hv = dv.host_values[:n]
        idx = np.clip(np.searchsorted(svals, hv), 0, len(svals) - 1)
        sel = dv.host_present[:n] & (svals[idx] == hv)
        match_host[:n] = sel
        scores_host[:n][sel] = sscores[idx[sel]]
    scores_host *= np.float32(node.boost)
    return (torch.as_tensor(scores_host, device=seg.device),
            torch.as_tensor(match_host, device=seg.device))


def _eval_dismax(node: qp.DisjunctionMaxNode, ctx: EvalContext):
    """Lucene DisjunctionMaxQuery: best disjunct + tieBreaker * others
    (non-matching disjuncts score 0, so max/sum over them is safe)."""
    if not node.disjuncts:
        return _none(ctx)
    dev = ctx.segment.device
    pairs = [eval_node(d, ctx) for d in node.disjuncts]
    best = pairs[0][0]
    total = pairs[0][0]
    match = pairs[0][1]
    for s, m in pairs[1:]:
        best = torch.maximum(best, s)
        total = total + s
        match = match | m
    scores = best + scalar_f32(node.tie_breaker, dev) * (total - best)
    return torch.where(match, scores * scalar_f32(node.boost, dev), _zero(ctx)), match


def exact_vector_inputs(node: qp.ExactVectorQueryNode, ctx: "EvalContext"):
    """(query [1, dims] on the device, the column, its similarity) of an
    exact vector query, after the reference's checks."""
    vc = ctx.segment.vectors.get(node.field)
    fd = ctx.field_defs.get(node.field)
    if vc is None or fd is None:
        raise ValueError(f"{node.field} is not a VECTOR field")
    if len(node.query_vector) != vc.dims:
        raise ValueError(
            f"query vector dimension {len(node.query_vector)} != field dims {vc.dims}"
        )
    q = torch.as_tensor(np.asarray(node.query_vector, np.float32)[None, :],
                        device=ctx.segment.device)
    return q, vc, fd.similarity or "l2_norm"


def _eval_exact_vector(node: qp.ExactVectorQueryNode, ctx: EvalContext):
    """Exact brute-force similarity over the whole segment (reference:
    query/vector/ExactVectorQuery.java): the dequantized f32 matrix and the
    exact squared norms, one product."""
    from nrtsearch_tpu_torch.ops.knn import _scores as knn_scores

    q, vc, similarity = exact_vector_inputs(node, ctx)
    scores = knn_scores(q, vc.device_float(), vc.sq_norms, similarity)[0]
    match = vc.present & ctx.segment.live
    return torch.where(match, scores * scalar_f32(node.boost, ctx.segment.device),
                       _zero(ctx)), match


def _eval_boolean(node: qp.BooleanQueryNode, ctx: EvalContext):
    musts, filters, shoulds, must_nots = [], [], [], []
    for clause in node.clauses:
        pair = eval_node(clause.node, ctx)
        {
            qp.Occur.MUST: musts,
            qp.Occur.FILTER: filters,
            qp.Occur.SHOULD: shoulds,
            qp.Occur.MUST_NOT: must_nots,
        }[clause.occur].append(pair)

    match = _doc_range_mask(ctx)
    for _, m in musts:
        match = match & m
    for _, m in filters:
        match = match & m
    if shoulds:
        should_count = shoulds[0][1].to(torch.int32)
        for _, m in shoulds[1:]:
            should_count = should_count + m.to(torch.int32)
        msm = node.minimum_number_should_match
        if not musts and not filters:
            match = match & (should_count >= max(1, msm))
        elif msm > 0:
            match = match & (should_count >= msm)
    for _, m in must_nots:
        match = match & ~m

    zero = _zero(ctx)
    scores = torch.zeros(ctx.segment.capacity, dtype=torch.float32, device=ctx.segment.device)
    for s, m in musts + shoulds:
        scores = scores + torch.where(m, s, zero)
    scores = scores * scalar_f32(node.boost, ctx.segment.device)
    return torch.where(match, scores, zero), match


def _eval_range(node: qp.RangeQueryNode, ctx: EvalContext):
    dv = ctx.segment.doc_values.get(node.field)
    if dv is None:
        return _none(ctx)
    lower = node.lower if node.lower is not None else -np.inf
    upper = node.upper if node.upper is not None else np.inf
    match = mask_ops.range_mask(
        dv.values, dv.present, _dv_scalar(dv, lower), _dv_scalar(dv, upper),
        not node.lower_exclusive, not node.upper_exclusive,
    )

    def host_pred(arr):
        lo = arr > lower if node.lower_exclusive else arr >= lower
        hi = arr < upper if node.upper_exclusive else arr <= upper
        return lo & hi

    match = _mv_any(dv, match, host_pred)
    return _const_score(match, node.boost), match


def _eval_exists(node: qp.ExistsQueryNode, ctx: EvalContext):
    seg = ctx.segment
    if node.field in seg.doc_values:
        match = seg.doc_values[node.field].present
    elif node.field in seg.fields:
        match = seg.fields[node.field].doc_lens > 0
    elif node.field in seg.vectors:
        match = seg.vectors[node.field].present
    else:
        return _none(ctx)
    match = match & _doc_range_mask(ctx)
    return _const_score(match, node.boost), match


def _eval_prefix(node: qp.PrefixQueryNode, ctx: EvalContext):
    tfi = ctx.segment.fields.get(node.field)
    if tfi is None:
        return _none(ctx)
    companion = prefix_companion(ctx, node)
    if companion is not None:
        # materialized prefix companion (reference PrefixFieldDef): ONE term
        _, match = _text_clause(ctx, companion, [node.prefix], [0.0], "SHOULD", 0, 0.0)
        return _const_score(match, node.boost), match
    expanded = tfi.terms_with_prefix(node.prefix, node.max_expansions)
    if not expanded:
        return _none(ctx)
    _, match = _text_clause(
        ctx, node.field, expanded, [0.0] * len(expanded), "SHOULD", 0, 0.0
    )
    return _const_score(match, node.boost), match


def prefix_companion(ctx: EvalContext, node: qp.PrefixQueryNode):
    """The hidden ``<field>._index_prefix`` field that holds this prefix as
    one term (an ``indexPrefixes`` field's companion), or None."""
    fd = ctx.field_defs.get(node.field)
    if fd is None or fd.index_prefixes is None:
        return None
    lo, hi = fd.index_prefixes
    companion = f"{node.field}._index_prefix"
    if lo <= len(node.prefix) <= hi and companion in ctx.segment.fields:
        return companion
    return None


def _eval_fuzzy(node: qp.FuzzyQueryNode, ctx: EvalContext):
    """Fuzzy term expansion over the segment term dictionary, scored as a
    constant-score OR over the expansions."""
    tfi = ctx.segment.fields.get(node.field)
    if tfi is None or not node.text:
        return _none(ctx)
    expanded = _fuzzy_expand(
        tfi, node.text, node.max_edits, node.prefix_length, node.max_expansions
    )
    if not expanded:
        return _none(ctx)
    _, match = _text_clause(
        ctx, node.field, expanded, [0.0] * len(expanded), "SHOULD", 0, 0.0
    )
    return _const_score(match, node.boost), match


def wildcard_expand(tfi, pattern: str, max_expansions: int) -> list[str]:
    """Terms matching a wildcard pattern: the scan is narrowed to the
    pattern's literal prefix range (binary search over the sorted
    vocabulary), else it runs over the term dictionary in term-id order."""
    lit = re.split(r"[*?\[]", pattern, 1)[0]
    cands = tfi.terms_with_prefix(lit, len(tfi.terms)) if lit else tfi.terms
    return [t for t in cands if fnmatch.fnmatchcase(t, pattern)][:max_expansions]


def _eval_wildcard(node: qp.WildcardQueryNode, ctx: EvalContext):
    tfi = ctx.segment.fields.get(node.field)
    if tfi is None:
        return _none(ctx)
    expanded = wildcard_expand(tfi, node.pattern, node.max_expansions)
    if not expanded:
        return _none(ctx)
    _, match = _text_clause(
        ctx, node.field, expanded, [0.0] * len(expanded), "SHOULD", 0, 0.0
    )
    return _const_score(match, node.boost), match


def _fuzzy_expand(
    tfi, text: str, max_edits: int, prefix_len: int, max_expansions: int
) -> list[str]:
    prefix = text[:prefix_len]
    # with a prefix constraint, binary-search the sorted vocabulary range
    cands = tfi.terms_with_prefix(prefix, len(tfi.terms)) if prefix else tfi.terms
    out = []
    n = len(text)
    for t in cands:
        if len(out) >= max_expansions:
            break
        if abs(len(t) - n) > max_edits:
            continue
        if _levenshtein_at_most(text, t, max_edits):
            out.append(t)
    return out


def _levenshtein_at_most(a: str, b: str, k: int) -> bool:
    """Banded edit distance check (distance <= k)."""
    if a == b:
        return True
    la, lb = len(a), len(b)
    if abs(la - lb) > k:
        return False
    big = k + 1
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        # cells outside the |i-j| <= k band are unreachable within k edits
        cur = [big] * (lb + 1)
        lo = max(1, i - k)
        hi = min(lb, i + k)
        if i <= k:
            cur[0] = i
        for j in range(lo, hi + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        if min(cur[lo : hi + 1]) > k:
            return False
        prev = cur
    return prev[lb] <= k


def _host_pair(ctx: EvalContext, scores_host: np.ndarray, match_host: np.ndarray):
    dev = ctx.segment.device
    return torch.as_tensor(scores_host, device=dev), torch.as_tensor(match_host, device=dev)


def _candidates(ctx: EvalContext, field: str, terms: list[str], operator: str) -> torch.Tensor:
    """Docs holding every term (MUST) or any term (SHOULD), as a match mask
    (the scoreless ``_text_clause`` the reference runs for its candidates:
    the same counts, no scores)."""
    tfi = ctx.segment.fields[field]
    offs, lens = zip(*(tfi.lookup(t) for t in terms))
    _, counts = bm25_ops.score_text_clause(
        tfi.doc_ids, tfi.freqs, tfi.doc_lens, offs, lens, np.zeros(len(terms), np.float32),
        ctx.k1, ctx.b, 1.0, num_docs=ctx.segment.capacity, want_scores=False,
    )
    return counts == len(terms) if operator == "MUST" else counts >= 1


def _candidate_ids(ctx: EvalContext, cand_mask: torch.Tensor) -> torch.Tensor:
    """The candidate doc ids, int64 on the segment's device (one wait)."""
    return torch.nonzero(cand_mask[: ctx.segment.num_docs]).flatten()


def _eval_completion(node: qp.CompletionQueryNode, ctx: EvalContext):
    """Context-suggest completion: prefix (optionally fuzzy) match over the
    segment's suggest entries, scored by the entry's weight (reference:
    ContextSuggestFieldDef + CompletionQuery with MyContextQuery), on the
    host as in the reference."""
    seg = ctx.segment
    entries = seg.suggest.get(node.field)
    if not entries or not node.text:
        return _none(ctx)
    want = node.text.lower()
    ctx_set = set(node.contexts)
    scores_host = np.zeros(seg.capacity, np.float32)
    match_host = np.zeros(seg.capacity, bool)
    for doc, text, weight, contexts in entries:
        lt = text.lower()
        if node.fuzzy:
            ok = _levenshtein_at_most(want, lt[: len(want)], 1)
        else:
            ok = lt.startswith(want)
        if not ok:
            continue
        if ctx_set and not (ctx_set & set(contexts)):
            continue
        if weight * node.boost > scores_host[doc]:
            scores_host[doc] = weight * node.boost
        match_host[doc] = True
    return _host_pair(ctx, scores_host, match_host)


def _eval_nested(node: qp.NestedQueryNode, ctx: EvalContext):
    """Block join: the child query, aggregated per parent block (reference:
    NestedQuery -> Lucene ToParentBlockJoinQuery). Children precede their
    parent, so each block is a ``reduceat`` span over the parent
    boundaries; the child answer is read to the host (``.cpu()``)."""
    from nrtsearch_tpu_torch.core.segment import NESTED_PATH_FIELD

    seg = ctx.segment
    dv = seg.doc_values.get(NESTED_PATH_FIELD)
    parents = seg.parent_positions()
    if dv is None or parents is None or len(parents) == 0:
        return _none(ctx)
    path_ord = (dv.ord_index or {}).get(node.path)
    if path_ord is None:
        return _none(ctx)
    child_scores, child_match = eval_node(node.query or qp.MatchAllNode(), ctx)
    cs = child_scores.cpu().numpy()[: seg.num_docs]
    cm = child_match.cpu().numpy()[: seg.num_docs]
    on_path = dv.host_values[: seg.num_docs] == path_ord
    cm = cm & on_path & seg.host_live
    cs = np.where(cm, cs, 0.0)

    # per-parent block aggregation: block of parents[i] = (parents[i-1], parents[i])
    starts = np.concatenate([[0], parents[:-1] + 1])
    sums = np.add.reduceat(cs, starts) * (starts < seg.num_docs)
    counts = np.add.reduceat(cm.astype(np.int64), starts)
    # reduceat repeats a value for an empty block (start == parent): zero
    # the blocks with no matching child
    empty = counts == 0
    sums = np.where(empty, 0.0, sums)
    if node.score_mode == "MAX" or node.score_mode == "MIN":
        op = np.maximum if node.score_mode == "MAX" else np.minimum
        agg = op.reduceat(np.where(cm, cs, -np.inf if node.score_mode == "MAX" else np.inf),
                          starts)
        agg = np.where(empty, 0.0, agg)
    elif node.score_mode == "AVG":
        agg = np.where(empty, 0.0, sums / np.maximum(counts, 1))
    elif node.score_mode == "NONE":
        agg = (~empty).astype(np.float32)
    else:  # SUM
        agg = sums

    scores_host = np.zeros(seg.capacity, np.float32)
    match_host = np.zeros(seg.capacity, bool)
    scores_host[parents] = (agg * node.boost).astype(np.float32)
    match_host[parents] = ~empty
    scores_host = np.where(match_host[: seg.capacity], scores_host, 0.0)
    return _host_pair(ctx, scores_host, match_host)


def _phrase_score_host(ctx: EvalContext, tfi, cand_ids: np.ndarray, freq_of, sum_idf: float,
                       avgdl: float, boost: float):
    """The host loop's phrase-frequency BM25 over the candidates (the
    reference's, in its numpy arithmetic): ``freq_of(doc)`` gives a doc's
    phrase (or span) frequency."""
    seg = ctx.segment
    doc_lens = tfi.doc_lens.cpu().numpy()
    scores_host = np.zeros(seg.capacity, np.float32)
    match_host = np.zeros(seg.capacity, bool)
    for doc in cand_ids:
        freq = freq_of(int(doc))
        if freq > 0:
            dl = doc_lens[doc]
            tf_norm = freq / (freq + ctx.k1 * (1 - ctx.b + ctx.b * dl / avgdl))
            scores_host[doc] = boost * sum_idf * tf_norm
            match_host[doc] = True
    return _host_pair(ctx, scores_host, match_host)


def _eval_phrase(node, ctx: EvalContext):
    """Phrase matching: the docs holding every term (device), then their
    positions (``ops.phrase`` on the device; the host loop where it returns
    None), scored by BM25 on the phrase frequency with the summed idf of the
    distinct terms (Lucene PhraseQuery)."""
    seg = ctx.segment
    if isinstance(node, qp.MatchPhraseQueryNode):
        fd = _field(ctx, node.field)
        analyzer = fd.search_analyzer or fd.index_analyzer or get_analyzer("standard")
        tokens = analyzer.analyze(node.query)
        if not tokens:
            return _none(ctx)
        base_pos = tokens[0].position
        terms = [t.text for t in tokens]
        req_offsets = [t.position - base_pos for t in tokens]
    else:
        terms = list(node.terms)
        req_offsets = list(range(len(terms)))
    slop = node.slop
    if not terms:
        return _none(ctx)
    tfi = seg.fields.get(node.field)
    if tfi is None or tfi.positions is None:
        return _none(ctx)

    cand_ids = _candidate_ids(ctx, _candidates(ctx, node.field, terms, "MUST"))
    dc = ctx.stats.doc_count(node.field)
    sum_idf = sum(
        bm25_ops.lucene_idf(dc, ctx.stats.doc_freq(node.field, t)) for t in set(terms)
    )
    avgdl = ctx.stats.avgdl(node.field)
    if len(cand_ids):
        from nrtsearch_tpu_torch.ops import phrase as phrase_ops

        res = phrase_ops.run_phrase(tfi, cand_ids, terms, req_offsets, slop)
        if res is not None:
            PHRASE_PATHS["device"] += 1
            return phrase_ops.phrase_scatter(*res, tfi.doc_lens, sum_idf, node.boost,
                                             ctx.k1, ctx.b, avgdl)
        PHRASE_PATHS["host"] += 1
    return _phrase_score_host(
        ctx, tfi, cand_ids.cpu().numpy(),
        lambda doc: _phrase_freq([tfi.positions_of(t, doc) for t in terms], req_offsets, slop),
        sum_idf, avgdl, node.boost)


def _eval_phrase_prefix_impl(
    ctx: EvalContext, field: str, query: str, slop: int,
    analyzer_name, max_expansions: int, boost: float,
):
    """A phrase whose last term expands to up to ``max_expansions`` index
    terms with its prefix (reference: query/MatchPhrasePrefixQuery.java ->
    Lucene MultiPhrasePrefixQuery); it matches where any expansion
    completes it, scored as a phrase with the expansion set as one term
    (df = the sum of the expansions' dfs, capped at the doc count)."""
    seg = ctx.segment
    fd = _field(ctx, field)
    analyzer = (
        get_analyzer(analyzer_name)
        if analyzer_name
        else (fd.search_analyzer or fd.index_analyzer or get_analyzer("standard"))
    )
    tokens = analyzer.analyze(query)
    if not tokens:
        return _none(ctx)
    base_pos = tokens[0].position
    terms = [t.text for t in tokens]
    req_offsets = [t.position - base_pos for t in tokens]
    tfi = seg.fields.get(field)
    if tfi is None or tfi.positions is None:
        return _none(ctx)
    expansions = tfi.terms_with_prefix(terms[-1], max(max_expansions, 1))
    if not expansions:
        return _none(ctx)
    fixed = terms[:-1]

    # candidates: docs with all fixed terms AND any expansion
    cand_mask = _candidates(ctx, field, expansions, "SHOULD")
    if fixed:
        cand_mask = _candidates(ctx, field, fixed, "MUST") & cand_mask
    cand_ids = _candidate_ids(ctx, cand_mask)

    dc = ctx.stats.doc_count(field)
    df_exp = min(sum(ctx.stats.doc_freq(field, t) for t in expansions), max(dc, 1))
    sum_idf = sum(
        bm25_ops.lucene_idf(dc, ctx.stats.doc_freq(field, t)) for t in set(fixed)
    ) + bm25_ops.lucene_idf(dc, df_exp)
    avgdl = ctx.stats.avgdl(field)
    if len(cand_ids) and fixed:
        from nrtsearch_tpu_torch.ops import phrase as phrase_ops

        res = phrase_ops.run_phrase(tfi, cand_ids, fixed, req_offsets[:-1], slop,
                                    expansions=expansions, exp_req=req_offsets[-1])
        if res is not None:
            PHRASE_PATHS["device"] += 1
            return phrase_ops.phrase_scatter(*res, tfi.doc_lens, sum_idf, boost,
                                             ctx.k1, ctx.b, avgdl)
    if len(cand_ids):
        PHRASE_PATHS["host"] += 1

    def freq_of(doc: int) -> int:
        plists = [tfi.positions_of(t, doc) for t in fixed]
        exp_lists = [tfi.positions_of(t, doc) for t in expansions]
        exp_pos = np.unique(np.concatenate(exp_lists) if exp_lists else np.empty(0, np.int32))
        return _phrase_freq(plists + [exp_pos], req_offsets, slop)

    return _phrase_score_host(ctx, tfi, cand_ids.cpu().numpy(), freq_of, sum_idf, avgdl,
                              boost)


def _span_clause_terms(clause: qp.SpanClause, tfi) -> list[str]:
    """Expand one span clause against the segment's term dictionary."""
    if clause.kind == "term":
        return [clause.text] if clause.text in tfi.terms else []
    if clause.kind == "prefix":
        out = tfi.terms_with_prefix(clause.text, len(tfi.terms))
    elif clause.kind == "wildcard":
        lit = re.split(r"[*?\[]", clause.text, 1)[0]
        cands = tfi.terms_with_prefix(lit, len(tfi.terms)) if lit else tfi.terms
        out = [t for t in cands if fnmatch.fnmatchcase(t, clause.text)]
    elif clause.kind == "fuzzy":
        out = _fuzzy_expand(
            tfi, clause.text, clause.max_edits, clause.prefix_length, clause.max_expansions,
        )
    elif clause.kind == "regexp":
        # Lucene RegexpQuery anchors the whole term (search.proto:605); the
        # Python-re-compatible subset of Lucene regexp syntax is supported
        try:
            pat = re.compile(clause.text)
        except re.error as e:
            raise ValueError(f"invalid regexp {clause.text!r}: {e}")
        out = [t for t in tfi.terms if pat.fullmatch(t)]
    elif clause.kind == "term_range":
        lo, hi = clause.text, clause.upper

        def in_range(t: str) -> bool:
            if lo and (t < lo or (t == lo and not clause.include_lower)):
                return False
            if hi and (t > hi or (t == hi and not clause.include_upper)):
                return False
            return True

        out = [t for t in tfi.terms if in_range(t)]
    else:
        raise ValueError(f"unknown span clause kind: {clause.kind!r}")
    return out[: clause.max_expansions]


def _span_leaves(clause: qp.SpanClause):
    """All term-bearing leaf clauses under ``clause`` (depth-first)."""
    if clause.kind == "near":
        for c in clause.near.clauses:
            yield from _span_leaves(c)
    else:
        yield clause


_EMPTY_SPANS = np.empty((0, 2), np.int64)


def _near_match_spans(lists: list[np.ndarray], slop: int, in_order: bool) -> np.ndarray:
    """Greedy span-near matching over per-clause span lists ([n, 2] arrays
    of (start, end), sorted by start). A match picks one span per clause
    with (max_end - min_start) - sum(span widths) <= slop, non-overlapping
    in clause order when ``in_order`` (Lucene NearSpansOrdered), the
    nearest by start otherwise (NearSpansUnordered's minimal interval,
    greedy per first-clause span). Returns the matched (min_start,
    max_end) spans, so near groups nest as clauses of an enclosing near."""
    n = len(lists)
    if any(len(sp) == 0 for sp in lists):
        return _EMPTY_SPANS
    if n == 1:
        return lists[0]
    starts = [sp[:, 0] for sp in lists]
    out = []
    for s0, e0 in lists[0]:
        min_start, max_end = int(s0), int(e0)
        total_len = int(e0) - int(s0)
        prev_start, prev_end = int(s0), int(e0)
        ok = True
        for sp, st in zip(lists[1:], starts[1:]):
            if in_order:
                i = int(np.searchsorted(st, prev_end))
                if i >= len(sp):
                    ok = False
                    break
                s, e = int(sp[i, 0]), int(sp[i, 1])
            else:
                i = int(np.searchsorted(st, prev_start))
                cands = []
                if i < len(sp):
                    cands.append((int(sp[i, 0]), int(sp[i, 1])))
                if i > 0:
                    cands.append((int(sp[i - 1, 0]), int(sp[i - 1, 1])))
                s, e = min(cands, key=lambda se: abs(se[0] - prev_start))
            min_start = min(min_start, s)
            max_end = max(max_end, e)
            total_len += e - s
            prev_start, prev_end = s, e
            if (max_end - min_start) - total_len > slop:
                ok = False
                break
        if ok and (max_end - min_start) - total_len <= slop:
            out.append((min_start, max_end))
    if not out:
        return _EMPTY_SPANS
    spans = np.array(out, np.int64)
    return spans[np.argsort(spans[:, 0], kind="stable")]


def _span_clause_matches(clause: qp.SpanClause, tfi, doc: int, leaf_terms: dict) -> np.ndarray:
    """Spans of one clause in one doc: unit-width spans at term positions
    for leaves, recursive near-match spans for nested near groups."""
    if clause.kind == "near":
        child = [_span_clause_matches(c, tfi, doc, leaf_terms) for c in clause.near.clauses]
        return _near_match_spans(child, clause.near.slop, clause.near.in_order)
    pls = [tfi.positions_of(t, doc) for t in leaf_terms[id(clause)]]
    pos = np.unique(np.concatenate(pls)) if pls else np.empty(0, np.int64)
    if len(pos) == 0:
        return _EMPTY_SPANS
    return np.stack([pos, pos + 1], axis=1).astype(np.int64)


def _eval_span_near(node: qp.SpanNearNode, ctx: EvalContext):
    """SpanNearQuery: the docs matching some term of every leaf clause
    (device), then a host loop over their positions, as in the reference
    (QueryNodeMapper span handling -> Lucene SpanNearQuery); scored like a
    phrase, summed clause idfs with a BM25 tf norm on the span frequency."""
    seg = ctx.segment
    field = node.clauses[0].field
    tfi = seg.fields.get(field)
    if tfi is None or tfi.positions is None:
        return _none(ctx)
    # expand every term-bearing leaf (incl. leaves of nested near groups)
    leaves = [lf for c in node.clauses for lf in _span_leaves(c)]
    leaf_terms = {id(lf): _span_clause_terms(lf, tfi) for lf in leaves}
    if any(not terms for terms in leaf_terms.values()):
        return _none(ctx)

    # a near match needs all of its clauses, recursively: AND over the
    # leaves is exact recall
    cand_mask = None
    for lf in leaves:
        m = _candidates(ctx, field, leaf_terms[id(lf)], "SHOULD")
        cand_mask = m if cand_mask is None else (cand_mask & m)
    cand_ids = _candidate_ids(ctx, cand_mask).cpu().numpy()

    dc = ctx.stats.doc_count(field)
    sum_idf = 0.0
    for lf in leaves:
        terms = leaf_terms[id(lf)]
        df = min(sum(ctx.stats.doc_freq(field, t) for t in terms), max(dc, 1))
        sum_idf += bm25_ops.lucene_idf(dc, df)

    def freq_of(doc: int) -> int:
        clause_spans = [_span_clause_matches(c, tfi, doc, leaf_terms) for c in node.clauses]
        return len(_near_match_spans(clause_spans, node.slop, node.in_order))

    return _phrase_score_host(ctx, tfi, cand_ids, freq_of, sum_idf, ctx.stats.avgdl(field),
                              node.boost)


def _phrase_freq(plists: list[np.ndarray], offsets: list[int], slop: int) -> int:
    """Count phrase occurrences (the host loop; ``ops.phrase`` is its
    device form).

    Exact (slop=0): base positions p where every term i appears at p+offset_i.
    Sloppy: alignments where the total displacement from the exact layout is
    <= slop (greedy nearest-position approximation of Lucene's sloppy freq).
    """
    if any(len(p) == 0 for p in plists):
        return 0
    base = plists[0] - offsets[0]
    if slop == 0:
        count = 0
        sets = [set(p.tolist()) for p in plists]
        for p in base:
            if all((p + off) in s for off, s in zip(offsets[1:], sets[1:])):
                count += 1
        return count
    count = 0
    for p in base:
        total_move = 0
        ok = True
        for off, plist in zip(offsets[1:], plists[1:]):
            want = p + off
            i = np.searchsorted(plist, want)
            best = np.inf
            if i < len(plist):
                best = abs(int(plist[i]) - want)
            if i > 0:
                best = min(best, abs(int(plist[i - 1]) - want))
            total_move += best
            if total_move > slop:
                ok = False
                break
        if ok:
            count += 1
    return count


def polygon_column(ctx: EvalContext, field: str):
    """A POLYGON field's column; ValueError for any other field."""
    dv = ctx.segment.doc_values.get(field)
    if dv is None or dv.kind != DocValueKind.POLYGON:
        raise ValueError(f"{field} should be a POLYGON field for geoPointQuery")
    return dv


def _latlon(ctx: EvalContext, field: str):
    dv = ctx.segment.doc_values.get(field)
    if dv is None or dv.kind != DocValueKind.LAT_LON:
        return None
    return dv


def _eval_geo_bbox(node: qp.GeoBoundingBoxNode, ctx: EvalContext):
    dv = _latlon(ctx, node.field)
    if dv is None:
        return _none(ctx)
    match = mask_ops.geo_bounding_box_mask(
        dv.values, dv.present, node.min_lat, node.max_lat, node.min_lon, node.max_lon
    )
    return _const_score(match, node.boost), match


def _eval_geo_radius(node: qp.GeoRadiusNode, ctx: EvalContext):
    dv = _latlon(ctx, node.field)
    if dv is None:
        return _none(ctx)
    match = mask_ops.geo_radius_mask(
        dv.values, dv.present, node.lat, node.lon, node.radius_meters
    )
    return _const_score(match, node.boost), match


def polygon_rings(poly) -> np.ndarray:
    """One query polygon's outer ring and holes as one f32 [V, 2] edge list
    of closed rings, each followed by a NaN separator."""
    segs = []
    for ring in (poly.points, *poly.holes):
        pts = list(ring)
        if pts[0] != pts[-1]:
            pts.append(pts[0])  # close the ring
        segs.append(np.asarray(pts, np.float32))
        segs.append(np.full((1, 2), np.nan, np.float32))  # ring separator
    return np.concatenate(segs, axis=0)


def _eval_geo_polygon(node: qp.GeoPolygonNode, ctx: EvalContext):
    """LAT_LON points within any query polygon (with holes): even-odd
    parity over each polygon's rings (reference:
    LatLonFieldDef.getGeoPolygonQuery -> LatLonPoint.newPolygonQuery)."""
    dv = _latlon(ctx, node.field)
    if dv is None:
        return _none(ctx)
    match = None
    for poly in node.polygons:
        if len(poly.points) < 3:
            continue
        rings = torch.as_tensor(polygon_rings(poly), device=ctx.segment.device)
        m = mask_ops.point_in_rings_mask(dv.values, dv.present, rings)
        match = m if match is None else (match | m)
    if match is None:
        return _none(ctx)
    return _const_score(match, node.boost), match


def _eval_function_score(node: qp.FunctionScoreNode, ctx: EvalContext):
    from nrtsearch_tpu_torch.script.expr import compile_expression

    scores, match = eval_node(node.query or qp.MatchAllNode(), ctx)
    fn = compile_expression(node.expression)
    new_scores = fn(_ScriptDocValues(ctx.segment), scores)
    new_scores = new_scores * scalar_f32(node.boost, ctx.segment.device)
    return torch.where(match, new_scores, _zero(ctx)), match


def decay_scale(spec: qp.DecaySpec) -> tuple[str, float]:
    """(kind, the decay function's f64 scale) of a decay spec (the
    reference's Linear/Exponential/GuassianDecayFunction computeScale)."""
    if not (0.0 < spec.decay < 1.0):
        raise ValueError(f"decay rate should be between (0, 1) but is {spec.decay}")
    kind = spec.decay_type.replace("DECAY_TYPE_", "")
    if kind == "LINEAR":
        return kind, spec.scale / (1.0 - spec.decay)
    if kind == "GUASSIAN":
        return kind, -(spec.scale**2) / (2.0 * math.log(spec.decay))
    if kind == "EXPONENTIAL":
        return kind, math.log(spec.decay) / spec.scale
    raise ValueError(f"unsupported decay type: {spec.decay_type}")


def decay_values(kind: str, dist: torch.Tensor, offset, scale, present) -> torch.Tensor:
    """Per-doc decay score from the distances (f32; ``offset`` and
    ``scale`` are 0-d f32 tensors); docs with no value score 0.0."""
    zero = torch.zeros((), dtype=torch.float32, device=dist.device)
    delta = torch.maximum(dist - offset, zero)
    if kind == "LINEAR":
        val = torch.maximum((scale - delta) / scale, zero)
    elif kind == "GUASSIAN":
        val = torch.exp(-(delta * delta) / (2.0 * scale))
    else:  # EXPONENTIAL
        val = torch.exp(scale * delta)
    return torch.where(present, val, zero)


def _decay_value(spec: qp.DecaySpec, ctx: EvalContext) -> torch.Tensor:
    """Per-doc decay score from geo distance (reference:
    query/multifunction/GeoPointDecayFilterFunction.java)."""
    kind, scale = decay_scale(spec)
    dv = _latlon(ctx, spec.field)
    if dv is None:
        raise ValueError(f"{spec.field} should be a LAT_LON field to apply geoPoint decay")
    dev = ctx.segment.device
    dist = mask_ops.haversine_meters(dv.values, spec.origin[0], spec.origin[1])
    return decay_values(kind, dist, scalar_f32(spec.offset, dev), scalar_f32(scale, dev), dv.present)


def _eval_multi_function_score(node: qp.MultiFunctionScoreNode, ctx: EvalContext):
    """MultiFunctionScoreQuery: inner scores combined with weighted filter
    functions (reference: query/multifunction/MultiFunctionScoreQuery.java,
    computeFunctionScore + computeFinalScore + MinScoreWrapper)."""
    from nrtsearch_tpu_torch.script.expr import compile_expression

    dev = ctx.segment.device
    inner_scores, match = eval_node(node.query or qp.MatchAllNode(), ctx)
    inner_scores = inner_scores * scalar_f32(node.boost, dev)
    scores = inner_scores
    if node.functions:
        gates, vals = [], []
        for spec in node.functions:
            if spec.filter is not None:
                _, gate = eval_node(spec.filter, ctx)
            else:
                gate = torch.ones_like(match)
            if spec.decay is not None:
                v = _decay_value(spec.decay, ctx)
            elif spec.script is not None:
                fn = compile_expression(spec.script)
                v = fn(_ScriptDocValues(ctx.segment), inner_scores)
            else:
                v = torch.ones_like(inner_scores)  # WeightFilterFunction
            vals.append(v * scalar_f32(spec.weight, dev))
            gates.append(gate)
        scores = combine_functions(node.score_mode, node.boost_mode, inner_scores, gates, vals)
    return apply_min_score(node, scores, match)


def combine_functions(score_mode: str, boost_mode: str, inner_scores, gates, vals):
    """The function score (summed or multiplied over the gated functions)
    and its combination with the inner score."""
    zero = torch.zeros((), dtype=torch.float32, device=inner_scores.device)
    one = torch.ones((), dtype=torch.float32, device=inner_scores.device)
    if score_mode == "SCORE_MODE_SUM":
        total = functools.reduce(
            torch.add, (torch.where(g, v, zero) for g, v in zip(gates, vals))
        )
        any_gate = functools.reduce(torch.logical_or, gates)
        # no function matched -> function score 1.0 (reference semantics)
        fscore = torch.where(any_gate, total, one)
    elif score_mode == "SCORE_MODE_MULTIPLY":
        fscore = torch.ones_like(inner_scores)
        for g, v in zip(gates, vals):
            fscore = fscore * torch.where(g, v, one)
    else:
        raise ValueError(f"unknown score mode: {score_mode}")
    if boost_mode == "BOOST_MODE_SUM":
        return inner_scores + fscore
    if boost_mode == "BOOST_MODE_REPLACE":
        return fscore
    if boost_mode == "BOOST_MODE_MULTIPLY":
        return inner_scores * fscore
    raise ValueError(f"unknown boost mode: {boost_mode}")


def apply_min_score(node: qp.MultiFunctionScoreNode, scores, match):
    zero = torch.zeros((), dtype=torch.float32, device=scores.device)
    scores = torch.where(match, scores, zero)
    if node.min_score > 0.0 or node.min_excluded:
        ms = scalar_f32(node.min_score, scores.device)
        passed = scores > ms if node.min_excluded else scores >= ms
        match = match & passed
        scores = torch.where(match, scores, zero)
    return scores, match


class _ScriptDocValues:
    """Field-name -> dense f32 column accessor for script expressions."""

    def __init__(self, segment: Segment):
        self._segment = segment
        self.device = segment.device

    def __contains__(self, name: str) -> bool:
        return name in self._segment.doc_values

    def __getitem__(self, name: str):
        dv = self._segment.doc_values[name]
        return script_column(dv.values, dv.present)


def script_column(values: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """A doc-value column as a script reads it: f32, 0.0 where missing."""
    zero = torch.zeros((), dtype=torch.float32, device=values.device)
    return torch.where(present, values.to(torch.float32), zero)


# ---------------------------------------------------------------------------
# doc-value helpers (reference: eval.py _const_score .. _mv_any)
# ---------------------------------------------------------------------------


def _const_score(match: torch.Tensor, boost: float) -> torch.Tensor:
    return torch.where(match, float(np.float32(boost)), 0.0).to(torch.float32)


def _np_dtype_of(dv) -> np.dtype:
    return np.asarray(dv.host_values).dtype


def _dv_scalar(dv, value) -> torch.Tensor:
    """Query constant as a 0-d tensor of the column's dtype (f64 columns
    compare in f64, every other column in f32)."""
    if dv.values.dtype == torch.float64:
        return torch.full((), float(np.float64(value)), dtype=torch.float64,
                          device=dv.values.device)
    return scalar_f32(value, dv.values.device)


def _dv_array(dv, values: np.ndarray) -> torch.Tensor:
    dtype = np.float64 if dv.values.dtype == torch.float64 else np.float32
    return torch.as_tensor(values.astype(dtype), device=dv.values.device)


def _ordinal_match(dv, ords: np.ndarray) -> torch.Tensor:
    if dv.mv_offsets is not None:
        return _mv_any(dv, None, lambda arr: np.isin(arr, ords))
    return mask_ops.in_set_mask(dv.values, dv.present,
                                torch.as_tensor(ords, device=dv.values.device))


def _mv_any(dv, single_match, host_pred):
    """Extend a single-valued match to multi-valued columns: the predicate
    runs over the host CSR values, and the doc mask goes to the device."""
    if dv.mv_offsets is None:
        return single_match
    hits = host_pred(dv.mv_values)
    num_docs = len(dv.mv_offsets) - 1
    doc_hit = np.zeros(num_docs, dtype=bool)
    if hits.any():
        doc_of_entry = np.repeat(np.arange(num_docs), np.diff(dv.mv_offsets))
        np.logical_or.at(doc_hit, doc_of_entry[hits], True)
    full = np.zeros(dv.host_values.shape[0], dtype=bool)
    full[:num_docs] = doc_hit
    return torch.as_tensor(full, device=dv.values.device)

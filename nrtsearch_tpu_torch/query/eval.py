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

Not ported: phrase, match-phrase, phrase-prefix and span-near queries need
term positions, and completion, nested and polygon-contains queries need
suggest, nested and POLYGON fields (ROADMAP item 10). Each raises
``NotImplementedError`` naming its item.
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


def not_ported(what: str, item: int = 10, needs: str = "term positions") -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs {needs}, which are not ported yet (ROADMAP item {item})"
    )


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
    if isinstance(node, (qp.PhraseQueryNode, qp.MatchPhraseQueryNode,
                         qp.MatchPhrasePrefixQueryNode)):
        raise not_ported(f"a {type(node).__name__}")
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
        raise not_ported("a span-near query")
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
        raise not_ported("a nested query", 10, "nested documents")
    if isinstance(node, qp.CompletionQueryNode):
        raise not_ported("a completion query", 10, "suggest fields")
    if isinstance(node, qp.GeoPolygonNode):
        return _eval_geo_polygon(node, ctx)
    if isinstance(node, qp.PolygonContainsNode):
        raise not_ported("a geo point-in-polygon-field query", 10, "POLYGON fields")
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

    BEST_FIELDS: dis-max over per-field match queries. CROSS_FIELDS:
    every term scored against its best field, then summed. PHRASE_PREFIX
    needs term positions (ROADMAP item 10)."""
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
    if node.match_type == "PHRASE_PREFIX":
        raise not_ported("a PHRASE_PREFIX multi-match query")
    per_field = []
    for f, fb in zip(node.fields, boosts):   # BEST_FIELDS
        fd = _field(ctx, f)
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
    one term, or None (an index the reference committed may carry one; the
    port's builder refuses indexPrefixes fields, ROADMAP item 10)."""
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

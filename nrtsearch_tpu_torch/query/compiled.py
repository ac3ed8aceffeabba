"""Compiled query trees (counterpart: nrtsearch_tpu/query/compiled.py).

A query tree is prepared on the host into a ``CNode`` structure plus a flat
list of inputs (postings runs and weights, segment columns, bounds,
boosts), then run over the whole segment as torch ops on the segment's
device, followed by the extra filter, the live-and-root mask and the mode's
selection (``match``, ``arrays``, ``topk`` with or without a terminateAfter
budget, ``topk_key`` by a sort key, ``arrays_topk``). The reference traces
the same run into one jitted program per query shape; the port runs it
eagerly, op for op in the reference's order, so masks and scores are
bit-equal to it but where a transcendental function is involved (scripts,
geo distance). The top-k is ``_hierarchical_topk`` (ops/merge_scoring.py),
as in the reference: one host sync per call, and a full stable sort when a
segment has fewer than k matches or a tie plateau at its threshold
(``TOPK_FALLBACKS``).

Node kinds with host-side work keep the eager evaluator (query/eval.py)
and enter as precomputed (scores, match) pairs (``_host_fallback``): f64
and multi-valued doc-value columns, resolved joins, and the positional,
nested and completion queries (phrase, match-phrase, phrase-prefix and
PHRASE_PREFIX multi-match, span-near, nested, completion), as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from nrtsearch_tpu_torch.analysis import get_analyzer
from nrtsearch_tpu_torch.core.segment import NESTED_PATH_FIELD, ROOT_PATH
from nrtsearch_tpu_torch.device import scalar_f32
from nrtsearch_tpu_torch.ops import bm25 as bm25_ops
from nrtsearch_tpu_torch.ops import masks as mask_ops
from nrtsearch_tpu_torch.query import eval as qeval
from nrtsearch_tpu_torch.query import plan as qp
from nrtsearch_tpu_torch.schema.fields import DocValueKind

NEG_INF = float("-inf")


@dataclass(frozen=True)
class CNode:
    """One prepared query node: its kind, static parameters and the indices
    of its inputs (``slots``)."""

    kind: str
    static: tuple = ()
    slots: tuple = ()
    children: tuple = ()


class _Prep:
    """Accumulates the flat input list during tree preparation. Scalars
    are kept as Python numbers rounded through ``np.float32`` (the
    reference's f32 constants); ``f32t`` puts one on the device as a 0-d
    tensor, for a divisor or a compare."""

    def __init__(self, ctx: qeval.EvalContext):
        self.ctx = ctx
        self.inputs: list[Any] = []

    def slot(self, value) -> int:
        self.inputs.append(value)
        return len(self.inputs) - 1

    def f32(self, value) -> int:
        return self.slot(float(np.float32(value)))

    def f32t(self, value) -> int:
        return self.slot(scalar_f32(value, self.ctx.segment.device))

    def i32(self, value) -> int:
        return self.slot(int(np.int32(value)))


# ---------------------------------------------------------------------------
# Preparation (host): query tree -> (CNode, inputs)
# ---------------------------------------------------------------------------


def _host_fallback(node: qp.QueryNode, prep: _Prep) -> CNode:
    """Evaluate a subtree eagerly (with the query cache) and feed its
    (scores, match) pair in."""
    scores, match = qeval.eval_node(node, prep.ctx)
    return CNode("host", slots=(prep.slot(scores), prep.slot(match)))


def _none() -> CNode:
    return CNode("none")


def _prep_text(
    prep: _Prep,
    field: str,
    terms: list[str],
    term_boosts: list[float],
    operator: str,
    msm: int,
    boost: float,
    scored: bool = True,
) -> CNode:
    """Scored or constant multi-term clause: the twin of
    ``qeval._text_clause`` (same ops, same order, bit-equal outputs)."""
    ctx = prep.ctx
    seg = ctx.segment
    tfi = seg.fields.get(field)
    if not terms or tfi is None:
        return _none()
    offs, lens, weights, k1, b = qeval.text_clause_inputs(ctx, field, terms, term_boosts, boost)
    n = len(terms)
    need = n if operator == "MUST" else max(1, msm)
    # SHOULD / a single required term with positive boosts: presence ==
    # score > 0, the counts scatter is elided (scored=False keeps it:
    # constant clauses may carry zero weights)
    need_counts = not (scored and need <= 1
                       and all(b_ > 0 for b_ in term_boosts) and boost > 0)
    return CNode(
        "text",
        static=(scored, need_counts),
        slots=(
            prep.slot(tfi), prep.slot(offs), prep.slot(lens), prep.slot(weights),
            prep.slot((k1, b, ctx.stats.avgdl(field))), prep.i32(need), prep.f32(boost),
        ),
    )


def _dv_compilable(dv) -> bool:
    """f64 columns and multi-valued columns take the eager path."""
    return dv.mv_offsets is None and dv.values.dtype != torch.float64


def _col_targets(dv, values) -> list:
    """Targets as Python numbers in the column's precision: ordinals stay
    integers, everything else rounds to f32."""
    if dv.values.dtype.is_floating_point:
        return [float(np.float32(v)) for v in values]
    return [int(v) for v in values]


def _field_def(ctx, name: str):
    fd = ctx.field_defs.get(name)
    if fd is None:
        raise KeyError(f"unknown field: {name!r}")
    return fd


def _latlon(seg, field: str):
    dv = seg.doc_values.get(field)
    if dv is None or dv.kind != DocValueKind.LAT_LON:
        return None
    return dv


def prepare(node: qp.QueryNode, prep: _Prep) -> CNode:
    ctx = prep.ctx
    seg = ctx.segment
    if isinstance(node, qp.MatchAllNode):
        return CNode("match_all", slots=(prep.f32(node.boost), prep.i32(seg.num_docs)))
    if isinstance(node, qp.TermQueryNode):
        fd = _field_def(ctx, node.field)
        text = fd.normalize_value(node.text) if node.text is not None else None
        if text is not None and fd.is_text and fd.search:
            return _prep_text(prep, node.field, [text], [1.0], "MUST", 0, node.boost)
        dv = seg.doc_values.get(node.field)
        if dv is None:
            return _none()
        if not _dv_compilable(dv):
            return _host_fallback(node, prep)
        if text is not None and dv.kind == DocValueKind.ORDINAL:
            ordv = (dv.ord_index or {}).get(text, -2)
            return CNode("in_set", slots=(
                prep.slot(dv.values), prep.slot(dv.present),
                prep.slot(_col_targets(dv, [ordv])), prep.f32(node.boost),
            ))
        if node.bool_value is not None:
            target = 1.0 if node.bool_value else 0.0
        elif node.long_value is not None:
            target = float(node.long_value)
        elif node.double_value is not None:
            target = float(node.double_value)
        else:
            return _none()
        return CNode("eq", slots=(
            prep.slot(dv.values), prep.slot(dv.present), prep.f32(target),
            prep.f32(node.boost),
        ))
    if isinstance(node, qp.TermInSetNode):
        fd = _field_def(ctx, node.field)
        texts = [fd.normalize_value(t) for t in node.texts]
        if texts and fd.is_text and fd.search:
            return _prep_text(prep, node.field, texts, [0.0] * len(texts), "SHOULD", 0,
                              node.boost, scored=False)
        dv = seg.doc_values.get(node.field)
        if dv is None:
            return _none()
        if not _dv_compilable(dv):
            return _host_fallback(node, prep)
        if texts and dv.kind == DocValueKind.ORDINAL:
            targets = [(dv.ord_index or {}).get(t, -2) for t in texts]
        else:
            targets = list(node.long_values or node.double_values)
        if not targets:
            return _none()
        return CNode("in_set", slots=(
            prep.slot(dv.values), prep.slot(dv.present),
            prep.slot(_col_targets(dv, targets)), prep.f32(node.boost),
        ))
    if isinstance(node, qp.MatchQueryNode):
        fd = _field_def(ctx, node.field)
        analyzer = get_analyzer(node.analyzer) if node.analyzer else None
        terms = analyzer.terms(node.query) if analyzer else fd.query_terms(node.query)
        if node.fuzzy_max_edits > 0:
            tfi = seg.fields.get(node.field)
            if tfi is not None:
                expanded = []
                for t in terms:
                    expanded.extend(qeval._fuzzy_expand(
                        tfi, t, node.fuzzy_max_edits, node.fuzzy_prefix_length,
                        node.fuzzy_max_expansions,
                    ))
                terms = list(dict.fromkeys(expanded))
        return _prep_text(prep, node.field, terms, [1.0] * len(terms), node.operator,
                          node.minimum_number_should_match, node.boost)
    if isinstance(node, qp.MultiMatchQueryNode):
        return _prep_multi_match(node, prep)
    if isinstance(node, qp.BooleanQueryNode):
        occurs = tuple(c.occur.value for c in node.clauses)
        children = tuple(prepare(c.node, prep) for c in node.clauses)
        return CNode(
            "bool",
            static=(occurs, node.minimum_number_should_match),
            slots=(prep.f32(node.boost), prep.i32(seg.num_docs)),
            children=children,
        )
    if isinstance(node, qp.RangeQueryNode):
        dv = seg.doc_values.get(node.field)
        if dv is None:
            return _none()
        if not _dv_compilable(dv):
            return _host_fallback(node, prep)
        # bounds round to f32 before the compare, as in the reference
        lower = node.lower if node.lower is not None else -np.inf
        upper = node.upper if node.upper is not None else np.inf
        return CNode("range", slots=(
            prep.slot(dv.values), prep.slot(dv.present),
            prep.f32(lower), prep.f32(upper),
            prep.slot(not node.lower_exclusive), prep.slot(not node.upper_exclusive),
            prep.f32(node.boost),
        ))
    if isinstance(node, qp.ExistsQueryNode):
        if node.field in seg.doc_values:
            arr = seg.doc_values[node.field].present
        elif node.field in seg.fields:
            return CNode("exists_lens", slots=(
                prep.slot(seg.fields[node.field].doc_lens), prep.i32(seg.num_docs),
                prep.f32(node.boost),
            ))
        elif node.field in seg.vectors:
            arr = seg.vectors[node.field].present
        else:
            return _none()
        return CNode("exists", slots=(
            prep.slot(arr), prep.i32(seg.num_docs), prep.f32(node.boost),
        ))
    if isinstance(node, qp.PrefixQueryNode):
        tfi = seg.fields.get(node.field)
        if tfi is None:
            return _none()
        companion = qeval.prefix_companion(ctx, node)
        if companion is not None:
            return _prep_text(prep, companion, [node.prefix], [0.0], "SHOULD", 0,
                              node.boost, scored=False)
        expanded = tfi.terms_with_prefix(node.prefix, node.max_expansions)
        return _prep_text(prep, node.field, expanded, [0.0] * len(expanded), "SHOULD", 0,
                          node.boost, scored=False)
    if isinstance(node, qp.FuzzyQueryNode):
        tfi = seg.fields.get(node.field)
        if tfi is None or not node.text:
            return _none()
        expanded = qeval._fuzzy_expand(tfi, node.text, node.max_edits,
                                       node.prefix_length, node.max_expansions)
        return _prep_text(prep, node.field, expanded, [0.0] * len(expanded), "SHOULD", 0,
                          node.boost, scored=False)
    if isinstance(node, qp.WildcardQueryNode):
        tfi = seg.fields.get(node.field)
        if tfi is None:
            return _none()
        expanded = qeval.wildcard_expand(tfi, node.pattern, node.max_expansions)
        return _prep_text(prep, node.field, expanded, [0.0] * len(expanded), "SHOULD", 0,
                          node.boost, scored=False)
    if isinstance(node, qp.ConstantScoreNode):
        child = prepare(node.filter or qp.MatchAllNode(), prep)
        return CNode("const_score", slots=(prep.f32(node.boost),), children=(child,))
    if isinstance(node, qp.DisjunctionMaxNode):
        if not node.disjuncts:
            return _none()
        children = tuple(prepare(d, prep) for d in node.disjuncts)
        return CNode("dismax", slots=(prep.f32t(node.tie_breaker), prep.f32t(node.boost)),
                     children=children)
    if isinstance(node, qp.MinScoreNode):
        child = prepare(node.query or qp.MatchAllNode(), prep)
        return CNode("min_score", slots=(prep.f32t(node.min_score), prep.f32t(node.boost)),
                     children=(child,))
    if isinstance(node, qp.FunctionScoreNode):
        child = prepare(node.query or qp.MatchAllNode(), prep)
        names, col_slots = _prep_script_columns(node.expression, prep)
        return CNode("func_score", static=(node.expression, names),
                     slots=(prep.f32t(node.boost),) + col_slots, children=(child,))
    if isinstance(node, qp.FunctionFilterNode):
        names, col_slots = _prep_script_columns(node.expression, prep)
        return CNode("func_filter", static=(node.expression, names),
                     slots=(prep.f32t(node.boost), prep.slot(seg.live)) + col_slots)
    if isinstance(node, qp.MultiFunctionScoreNode):
        return _prep_multi_function(node, prep)
    if isinstance(node, qp.GeoBoundingBoxNode):
        dv = _latlon(seg, node.field)
        if dv is None:
            return _none()
        return CNode("geo_bbox", slots=(
            prep.slot(dv.values), prep.slot(dv.present),
            prep.f32(node.min_lat), prep.f32(node.max_lat),
            prep.f32(node.min_lon), prep.f32(node.max_lon), prep.f32(node.boost),
        ))
    if isinstance(node, qp.GeoRadiusNode):
        dv = _latlon(seg, node.field)
        if dv is None:
            return _none()
        return CNode("geo_radius", slots=(
            prep.slot(dv.values), prep.slot(dv.present), prep.f32(node.lat),
            prep.f32(node.lon), prep.f32(node.radius_meters), prep.f32(node.boost),
        ))
    if isinstance(node, qp.GeoPolygonNode):
        dv = _latlon(seg, node.field)
        if dv is None:
            return _none()
        ring_slots = tuple(
            prep.slot(torch.as_tensor(qeval.polygon_rings(poly), device=seg.device))
            for poly in node.polygons if len(poly.points) >= 3
        )
        if not ring_slots:
            return _none()
        return CNode("geo_rings", slots=(
            prep.slot(dv.values), prep.slot(dv.present), prep.f32(node.boost),
        ) + ring_slots)
    if isinstance(node, qp.PolygonContainsNode):
        dv = qeval.polygon_column(ctx, node.field)
        return CNode("poly_contains", slots=(
            prep.slot(dv.values), prep.slot(dv.present), prep.f32(node.lat),
            prep.f32(node.lon), prep.f32(node.boost),
        ))
    if isinstance(node, qp.ExactVectorQueryNode):
        q, vc, similarity = qeval.exact_vector_inputs(node, prep.ctx)
        return CNode("exact_vector", static=(similarity,), slots=(
            prep.slot(q), prep.slot(vc.device_float()), prep.slot(vc.sq_norms),
            prep.slot(vc.present), prep.slot(seg.live), prep.f32t(node.boost),
        ))
    # host-verified / host-resident node kinds keep the eager path
    return _host_fallback(node, prep)


def _prep_script_columns(expression: str, prep: _Prep):
    """Record which doc-value columns an expression reads, and slot them."""
    from nrtsearch_tpu_torch.script.expr import compile_expression

    seg = prep.ctx.segment
    fn = compile_expression(expression)
    accessed: list[str] = []

    class _Recorder:
        device = torch.device("cpu")

        def __getitem__(self, name: str):
            if name not in accessed:
                accessed.append(name)
            seg.doc_values[name]  # KeyError -> same as eager
            return np.zeros(1, np.float32)

        def __contains__(self, name: str) -> bool:
            return name in seg.doc_values

    fn(_Recorder(), np.zeros(1, np.float32))
    col_slots = []
    for name in accessed:
        dv = seg.doc_values[name]
        col_slots.append(prep.slot(dv.values))
        col_slots.append(prep.slot(dv.present))
    return tuple(accessed), tuple(col_slots)


def _prep_multi_match(node: qp.MultiMatchQueryNode, prep: _Prep) -> CNode:
    ctx = prep.ctx
    boosts = node.field_boosts or (1.0,) * len(node.fields)
    if node.match_type == "PHRASE_PREFIX":
        return _host_fallback(node, prep)
    if node.match_type == "CROSS_FIELDS":
        fd0 = _field_def(ctx, node.fields[0])
        terms = fd0.query_terms(node.query)
        if not terms:
            return _none()
        children = [
            _prep_text(prep, f, [t], [fb], "SHOULD", 0, 1.0)
            for t in terms for f, fb in zip(node.fields, boosts)
        ]
        need = len(terms) if node.operator == "MUST" else max(
            node.minimum_number_should_match, 1
        )
        return CNode("cross_fields", static=(len(terms), len(node.fields)),
                     slots=(prep.i32(need), prep.f32t(node.boost)), children=tuple(children))
    children = []
    for f, fb in zip(node.fields, boosts):   # BEST_FIELDS
        terms = _field_def(ctx, f).query_terms(node.query)
        children.append(_prep_text(prep, f, terms, [fb] * len(terms), node.operator,
                                   node.minimum_number_should_match, 1.0))
    return CNode("best_fields", slots=(prep.f32t(node.tie_breaker), prep.f32t(node.boost)),
                 children=tuple(children))


def _prep_multi_function(node: qp.MultiFunctionScoreNode, prep: _Prep) -> CNode:
    seg = prep.ctx.segment
    children = [prepare(node.query or qp.MatchAllNode(), prep)]
    fn_statics = []
    fn_slots = []
    for spec in node.functions:
        gated = spec.filter is not None
        if gated:
            children.append(prepare(spec.filter, prep))
        weight_slot = prep.f32t(spec.weight)
        if spec.decay is not None:
            d = spec.decay
            kind, scale = qeval.decay_scale(d)
            dv = _latlon(seg, d.field)
            if dv is None:
                raise ValueError(f"{d.field} should be a LAT_LON field to apply geoPoint decay")
            fn_statics.append(("decay", kind, gated))
            fn_slots.append((
                weight_slot, prep.slot(dv.values), prep.slot(dv.present),
                prep.f32(d.origin[0]), prep.f32(d.origin[1]),
                prep.f32t(d.offset), prep.f32t(scale),
            ))
        elif spec.script is not None:
            names, col_slots = _prep_script_columns(spec.script, prep)
            fn_statics.append(("script", spec.script, names, gated))
            fn_slots.append((weight_slot,) + col_slots)
        else:
            fn_statics.append(("weight", gated))
            fn_slots.append((weight_slot,))
    return CNode(
        "multi_func",
        static=(node.score_mode, node.boost_mode, tuple(fn_statics)),
        slots=(prep.f32t(node.boost), prep.slot(node), tuple(fn_slots)),
        children=tuple(children),
    )


# ---------------------------------------------------------------------------
# runner: CNode -> (scores [D], match [D])
# ---------------------------------------------------------------------------


def _const(match: torch.Tensor, boost: float) -> torch.Tensor:
    return torch.where(match, boost, 0.0).to(torch.float32)


def _doc_range(D: int, num_docs: int, dev: torch.device) -> torch.Tensor:
    return torch.arange(D, device=dev) < num_docs


def _zero(dev: torch.device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=dev)


def _run(c: CNode, inp: list, D: int, dev: torch.device):
    if c.kind == "none":
        return (torch.zeros(D, dtype=torch.float32, device=dev),
                torch.zeros(D, dtype=torch.bool, device=dev))
    if c.kind == "host":
        return inp[c.slots[0]], inp[c.slots[1]]
    if c.kind == "match_all":
        boost, num_docs = inp[c.slots[0]], inp[c.slots[1]]
        return (torch.full((D,), 1.0, dtype=torch.float32, device=dev) * boost,
                _doc_range(D, num_docs, dev))
    if c.kind == "text":
        scored, need_counts = c.static
        tfi, offs, lens, weights, (k1, b, avgdl), need, boost = (inp[i] for i in c.slots)
        scores, counts = bm25_ops.score_text_clause(
            tfi.doc_ids, tfi.freqs, tfi.doc_lens, offs, lens, weights, k1, b, avgdl,
            num_docs=D, need_counts=need_counts, want_scores=scored,
        )
        match = counts >= need
        if scored:
            return torch.where(match, scores, _zero(dev)), match
        return _const(match, boost), match
    if c.kind == "eq":
        values, present, target, boost = (inp[i] for i in c.slots)
        match = mask_ops.eq_mask(values, present, target)
        return _const(match, boost), match
    if c.kind == "in_set":
        values, present, targets, boost = (inp[i] for i in c.slots)
        match = mask_ops.in_set_mask(values, present, targets)
        return _const(match, boost), match
    if c.kind == "range":
        values, present, lo, hi, lo_inc, hi_inc, boost = (inp[i] for i in c.slots)
        match = mask_ops.range_mask(values, present, lo, hi, lo_inc, hi_inc)
        return _const(match, boost), match
    if c.kind == "exists":
        arr, num_docs, boost = (inp[i] for i in c.slots)
        match = arr & _doc_range(D, num_docs, dev)
        return _const(match, boost), match
    if c.kind == "exists_lens":
        doc_lens, num_docs, boost = (inp[i] for i in c.slots)
        match = (doc_lens > 0) & _doc_range(D, num_docs, dev)
        return _const(match, boost), match
    if c.kind == "bool":
        return _run_bool(c, inp, D, dev)
    if c.kind == "const_score":
        _, match = _run(c.children[0], inp, D, dev)
        return _const(match, inp[c.slots[0]]), match
    if c.kind == "dismax":
        tie, boost = inp[c.slots[0]], inp[c.slots[1]]
        pairs = [_run(ch, inp, D, dev) for ch in c.children]
        best = pairs[0][0]
        total = pairs[0][0]
        match = pairs[0][1]
        for s, m in pairs[1:]:
            best = torch.maximum(best, s)
            total = total + s
            match = match | m
        scores = best + tie * (total - best)
        return torch.where(match, scores * boost, _zero(dev)), match
    if c.kind == "min_score":
        min_score, boost = inp[c.slots[0]], inp[c.slots[1]]
        scores, match = _run(c.children[0], inp, D, dev)
        match = match & (scores >= min_score)
        return torch.where(match, scores * boost, _zero(dev)), match
    if c.kind == "func_score":
        expr, names = c.static
        boost = inp[c.slots[0]]
        scores, match = _run(c.children[0], inp, D, dev)
        vals = _run_script(expr, names, c.slots[1:], inp, scores, dev)
        return torch.where(match, vals * boost, _zero(dev)), match
    if c.kind == "func_filter":
        expr, names = c.static
        boost, live = inp[c.slots[0]], inp[c.slots[1]]
        vals = _run_script(expr, names, c.slots[2:], inp,
                           torch.zeros(D, dtype=torch.float32, device=dev), dev)
        match = (vals > 0.0) & live
        return torch.where(match, vals * boost, _zero(dev)), match
    if c.kind == "multi_func":
        return _run_multi_func(c, inp, D, dev)
    if c.kind == "geo_bbox":
        latlon, present, min_lat, max_lat, min_lon, max_lon, boost = (inp[i] for i in c.slots)
        match = mask_ops.geo_bounding_box_mask(latlon, present, min_lat, max_lat,
                                               min_lon, max_lon)
        return _const(match, boost), match
    if c.kind == "geo_radius":
        latlon, present, lat, lon, radius, boost = (inp[i] for i in c.slots)
        match = mask_ops.geo_radius_mask(latlon, present, lat, lon, radius)
        return _const(match, boost), match
    if c.kind == "geo_rings":
        latlon, present, boost = (inp[i] for i in c.slots[:3])
        match = None
        for ring_slot in c.slots[3:]:
            m = mask_ops.point_in_rings_mask(latlon, present, inp[ring_slot])
            match = m if match is None else (match | m)
        return _const(match, boost), match
    if c.kind == "poly_contains":
        verts, present, lat, lon, boost = (inp[i] for i in c.slots)
        match = mask_ops.doc_polygons_contain_point(verts, present, lat, lon)
        return _const(match, boost), match
    if c.kind == "exact_vector":
        from nrtsearch_tpu_torch.ops.knn import _scores as knn_scores

        (similarity,) = c.static
        q, vals, sq, present, live, boost = (inp[i] for i in c.slots)
        scores = knn_scores(q, vals, sq, similarity)[0]
        match = present & live
        return torch.where(match, scores * boost, _zero(dev)), match
    if c.kind == "cross_fields":
        n_terms, n_fields = c.static
        need, boost = inp[c.slots[0]], inp[c.slots[1]]
        term_score = None
        matched_n = None
        for ti in range(n_terms):
            best = None
            any_m = None
            for fi in range(n_fields):
                s, m = _run(c.children[ti * n_fields + fi], inp, D, dev)
                best = s if best is None else torch.maximum(best, s)
                any_m = m if any_m is None else (any_m | m)
            term_score = best if term_score is None else term_score + best
            mi = any_m.to(torch.int32)
            matched_n = mi if matched_n is None else matched_n + mi
        match = matched_n >= need
        return torch.where(match, term_score * boost, _zero(dev)), match
    if c.kind == "best_fields":
        tie, boost = inp[c.slots[0]], inp[c.slots[1]]
        per_field = [_run(ch, inp, D, dev) for ch in c.children]
        total = per_field[0][0]
        for s, _ in per_field[1:]:
            total = total + s
        best = per_field[0][0]
        for s, _ in per_field[1:]:
            best = torch.maximum(best, s)
        scores = best + tie * (total - best)
        match = per_field[0][1]
        for _, m in per_field[1:]:
            match = match | m
        return torch.where(match, scores * boost, _zero(dev)), match
    raise AssertionError(f"unknown compiled node kind: {c.kind}")


def _run_bool(c: CNode, inp: list, D: int, dev: torch.device):
    occurs, msm = c.static
    boost, num_docs = inp[c.slots[0]], inp[c.slots[1]]
    musts, filters, shoulds, must_nots = [], [], [], []
    for occur, ch in zip(occurs, c.children):
        pair = _run(ch, inp, D, dev)
        {
            "MUST": musts, "FILTER": filters,
            "SHOULD": shoulds, "MUST_NOT": must_nots,
        }[occur].append(pair)
    match = _doc_range(D, num_docs, dev)
    for _, m in musts:
        match = match & m
    for _, m in filters:
        match = match & m
    if shoulds:
        should_count = shoulds[0][1].to(torch.int32)
        for _, m in shoulds[1:]:
            should_count = should_count + m.to(torch.int32)
        if not musts and not filters:
            match = match & (should_count >= max(1, msm))
        elif msm > 0:
            match = match & (should_count >= msm)
    for _, m in must_nots:
        match = match & ~m
    zero = _zero(dev)
    scores = torch.zeros(D, dtype=torch.float32, device=dev)
    for s, m in musts + shoulds:
        scores = scores + torch.where(m, s, zero)
    scores = scores * boost
    return torch.where(match, scores, zero), match


def _run_script(expr: str, names: tuple, col_slots: tuple, inp: list, score,
                dev: torch.device):
    from nrtsearch_tpu_torch.script.expr import compile_expression

    cols = {
        name: qeval.script_column(inp[col_slots[2 * i]], inp[col_slots[2 * i + 1]])
        for i, name in enumerate(names)
    }

    class _Columns:
        device = dev

        def __getitem__(self, name: str):
            return cols[name]

        def __contains__(self, name: str) -> bool:
            return name in cols

    return compile_expression(expr)(_Columns(), score)


def _run_multi_func(c: CNode, inp: list, D: int, dev: torch.device):
    score_mode, boost_mode, fn_statics = c.static
    boost, node, fn_slots = inp[c.slots[0]], inp[c.slots[1]], c.slots[2]
    inner_scores, match = _run(c.children[0], inp, D, dev)
    inner_scores = inner_scores * boost
    scores = inner_scores
    if fn_statics:
        gates, vals = [], []
        child_i = 1
        for st, slots in zip(fn_statics, fn_slots):
            if st[-1]:
                _, gate = _run(c.children[child_i], inp, D, dev)
                child_i += 1
            else:
                gate = torch.ones_like(match)
            weight = inp[slots[0]]
            if st[0] == "decay":
                latlon, present, olat, olon, offset, scale = (inp[i] for i in slots[1:7])
                dist = mask_ops.haversine_meters(latlon, olat, olon)
                v = qeval.decay_values(st[1], dist, offset, scale, present)
            elif st[0] == "script":
                v = _run_script(st[1], st[2], slots[1:], inp, inner_scores, dev)
            else:  # weight-only
                v = torch.ones_like(inner_scores)
            vals.append(v * weight)
            gates.append(gate)
        scores = qeval.combine_functions(score_mode, boost_mode, inner_scores, gates, vals)
    return qeval.apply_min_score(node, scores, match)


# ---------------------------------------------------------------------------
# execution: tree (+ extra filter) + live mask + the mode's selection
# ---------------------------------------------------------------------------


def _topk_1d(masked: torch.Tensor, k: int):
    """Exact top-k over one [D] masked array by the row-max formulation
    (ops/merge_scoring._hierarchical_topk), ties to the lower doc id."""
    from nrtsearch_tpu_torch.ops.merge_scoring import _hierarchical_topk

    s2, i2 = _hierarchical_topk(masked[None, :], k)
    return s2[0], i2[0]


def budget_mask(match: torch.Tensor, budget: int) -> torch.Tensor:
    """The first ``budget`` matches in doc-id order (terminateAfter within
    a segment)."""
    return match & (torch.cumsum(match.to(torch.int32), dim=0) <= budget)


def _exec(tree: CNode, extra: Optional[CNode], mode: tuple, inputs: list):
    live_root = inputs[0]
    D, dev = live_root.shape[0], live_root.device
    scores, match = _run(tree, inputs, D, dev)
    if extra is not None:
        _, em = _run(extra, inputs, D, dev)
        match = match & em
    match = match & live_root
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    if mode[0] == "match":
        return match
    if mode[0] == "arrays":
        return scores, match
    if mode[0] in ("topk", "topk_b"):
        k = mode[1]
        if mode[0] == "topk_b":
            # within-segment terminateAfter: collect the first ``budget``
            # matches in docid order and count up to recall_cap
            budget, recall_cap = mode[2], mode[3]
            full = match.sum(dtype=torch.int32)
            match = budget_mask(match, budget)
            top_s, top_i = _topk_1d(torch.where(match, scores, neg), k)
            return top_s, top_i, torch.clamp(full, max=recall_cap)
        top_s, top_i = _topk_1d(torch.where(match, scores, neg), k)
        return top_s, top_i, match.sum(dtype=torch.int32)
    if mode[0] in ("topk_key", "topk_key_b"):
        k, ascending, keys = mode[1], mode[2], mode[3]
        if mode[0] == "topk_key_b":
            budget, recall_cap = mode[4], mode[5]
            full = match.sum(dtype=torch.int32)
            match = budget_mask(match, budget)
            total = torch.clamp(full, max=recall_cap)
        else:
            total = match.sum(dtype=torch.int32)
        sortable = -keys if ascending else keys
        top_keys, top_i = _topk_1d(torch.where(match, sortable, neg), k)
        return (-top_keys if ascending else top_keys), top_i, total
    if mode[0] == "arrays_topk":
        top_s, top_i = _topk_1d(torch.where(match, scores, neg), mode[1])
        return scores, match, top_s, top_i, match.sum(dtype=torch.int32)
    raise AssertionError(f"unknown exec mode: {mode}")


class CompiledQuery:
    """One prepared (query, extra filter, segment) triple, executable in
    any mode. Preparation is host work (term-dictionary lookups, constant
    packing, eager subtrees); execution runs the tree's ops on the
    segment's device."""

    def __init__(self, node, extra_filter, ctx: qeval.EvalContext, live_root):
        prep = _Prep(ctx)
        prep.slot(live_root)            # inputs[0]: live & nested-root mask
        self.tree = prepare(node, prep)
        self.extra = prepare(extra_filter, prep) if extra_filter is not None else None
        self.inputs = prep.inputs

    def top_k(self, k: int, budget: int = 0, recall_cap: int = 0):
        if budget:
            return _exec(self.tree, self.extra,
                         ("topk_b", k, budget, max(recall_cap, budget)), self.inputs)
        return _exec(self.tree, self.extra, ("topk", k), self.inputs)

    def top_k_by_key(self, keys, k: int, ascending: bool, budget: int = 0,
                     recall_cap: int = 0):
        if budget:
            return _exec(self.tree, self.extra,
                         ("topk_key_b", k, ascending, keys, budget, max(recall_cap, budget)),
                         self.inputs)
        return _exec(self.tree, self.extra, ("topk_key", k, ascending, keys), self.inputs)

    def arrays(self):
        return _exec(self.tree, self.extra, ("arrays",), self.inputs)

    def arrays_top_k(self, k: int):
        return _exec(self.tree, self.extra, ("arrays_topk", k), self.inputs)

    def match(self):
        return _exec(self.tree, self.extra, ("match",), self.inputs)


def root_mask(seg):
    """Top-level searches return root docs only: a segment committed by the
    reference with nested documents carries a ``_nested_path`` ordinal
    column. True when the segment has no such column, else the mask."""
    dv = seg.doc_values.get(NESTED_PATH_FIELD)
    if dv is None or not dv.ord_index or ROOT_PATH not in dv.ord_index:
        return True
    return dv.values == dv.ord_index[ROOT_PATH]


def live_root_mask(seg) -> torch.Tensor:
    """live AND root mask, cached on the (immutable) segment."""
    cached = getattr(seg, "_live_root_cache", None)
    if cached is not None:
        return cached
    root = root_mask(seg)
    mask = seg.live if root is True else seg.live & root
    object.__setattr__(seg, "_live_root_cache", mask)
    return mask

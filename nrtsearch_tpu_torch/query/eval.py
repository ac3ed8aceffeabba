"""Per-segment query evaluation on doc values (counterpart:
nrtsearch_tpu/query/eval.py).

``CollectionStats`` holds the index-wide BM25 statistics. ``eval_node``
evaluates a plan node against one segment into a dense ``scores [capacity]
f32`` and ``match [capacity] bool`` pair on the segment's device. It serves
the leaves the compiled program (query/compiled.py) sends to the host when a
column is f64 or multi-valued: term, term-in-set, range and exists on doc
values, and boolean trees of them. Text leaves and every other node type
raise ``NotImplementedError`` (ROADMAP item 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.core.segment import Segment
from nrtsearch_tpu_torch.ops import masks as mask_ops
from nrtsearch_tpu_torch.query import plan as qp
from nrtsearch_tpu_torch.schema.fields import DocValueKind, FieldDef

# Lucene BM25Similarity defaults
BM25_K1 = 1.2
BM25_B = 0.75


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the general evaluator, which is not ported yet (ROADMAP item 8)"
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
    """Evaluate a plan node against one segment -> (scores, match)."""
    if isinstance(node, qp.TermQueryNode):
        return _eval_term(node, ctx)
    if isinstance(node, qp.TermInSetNode):
        return _eval_term_in_set(node, ctx)
    if isinstance(node, qp.BooleanQueryNode):
        return _eval_boolean(node, ctx)
    if isinstance(node, qp.RangeQueryNode):
        return _eval_range(node, ctx)
    if isinstance(node, qp.ExistsQueryNode):
        return _eval_exists(node, ctx)
    raise not_ported(f"query node {type(node).__name__}")


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


def _eval_term(node: qp.TermQueryNode, ctx: EvalContext):
    fd = _field(ctx, node.field)
    text = fd.normalize_value(node.text) if node.text is not None else None
    if text is not None and fd.is_text and fd.search:
        raise not_ported(f"a term query on the text field {node.field!r}")
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
        raise not_ported(f"a term-in-set query on the text field {node.field!r}")
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

    zero = torch.zeros((), dtype=torch.float32, device=ctx.segment.device)
    scores = torch.zeros(ctx.segment.capacity, dtype=torch.float32, device=ctx.segment.device)
    for s, m in musts + shoulds:
        scores = scores + torch.where(m, s, zero)
    scores = scores * float(np.float32(node.boost))
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
        return torch.tensor(np.float64(value), dtype=torch.float64, device=dv.values.device)
    return torch.tensor(np.asarray(value).astype(np.float32), device=dv.values.device)


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

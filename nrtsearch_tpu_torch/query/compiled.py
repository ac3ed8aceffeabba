"""Compiled query trees, the columnar subset (counterpart:
nrtsearch_tpu/query/compiled.py).

A query tree is prepared on the host into a ``CNode`` structure plus a flat
list of inputs (segment columns, bounds, boosts), then run over the whole
segment as plain torch ops on the segment's device. The reference traces the
same run into one jitted program; the port runs it eagerly, op for op in the
reference's order, so masks and scores are bit-equal to it.

Prepared node kinds: match-all, term and term-in-set on doc values, range,
exists, constant-score and boolean trees of them. A column that is f64 or
multi-valued is evaluated by the eager leaf evaluator (query/eval.py) and
enters as a precomputed (scores, match) pair (``_host_fallback``), as in the
reference. Text leaves and every other node type raise
``NotImplementedError`` (ROADMAP item 8). Only the ``match`` and ``arrays``
modes exist: the reference's extra filter and top-k modes come with the
general evaluator (item 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from nrtsearch_tpu_torch.ops import masks as mask_ops
from nrtsearch_tpu_torch.query import eval as qeval
from nrtsearch_tpu_torch.query import plan as qp
from nrtsearch_tpu_torch.schema.fields import DocValueKind


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
    reference's f32 constants), so no scalar is copied to the device."""

    def __init__(self, ctx: qeval.EvalContext):
        self.ctx = ctx
        self.inputs: list[Any] = []

    def slot(self, value) -> int:
        self.inputs.append(value)
        return len(self.inputs) - 1

    def f32(self, value) -> int:
        return self.slot(float(np.float32(value)))

    def i32(self, value) -> int:
        return self.slot(int(np.int32(value)))


def _host_fallback(node: qp.QueryNode, prep: _Prep) -> CNode:
    """Evaluate a subtree eagerly and feed its (scores, match) pair in."""
    scores, match = qeval.eval_node(node, prep.ctx)
    return CNode("host", slots=(prep.slot(scores), prep.slot(match)))


def _none() -> CNode:
    return CNode("none")


def _dv_compilable(dv) -> bool:
    """f64 columns and multi-valued columns take the eager path."""
    return dv.mv_offsets is None and dv.values.dtype != torch.float64


def _col_targets(dv, values) -> list:
    """Targets as Python numbers in the column's precision: ordinals stay
    integers, everything else rounds to f32."""
    if dv.values.dtype.is_floating_point:
        return [float(np.float32(v)) for v in values]
    return [int(v) for v in values]


def prepare(node: qp.QueryNode, prep: _Prep) -> CNode:
    ctx = prep.ctx
    seg = ctx.segment
    if isinstance(node, qp.MatchAllNode):
        return CNode("match_all", slots=(prep.f32(node.boost), prep.i32(seg.num_docs)))
    if isinstance(node, qp.TermQueryNode):
        fd = ctx.field_defs.get(node.field)
        if fd is None:
            raise KeyError(f"unknown field: {node.field!r}")
        text = fd.normalize_value(node.text) if node.text is not None else None
        if text is not None and fd.is_text and fd.search:
            raise qeval.not_ported(f"a term query on the text field {node.field!r}")
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
        fd = ctx.field_defs.get(node.field)
        if fd is None:
            raise KeyError(f"unknown field: {node.field!r}")
        texts = [fd.normalize_value(t) for t in node.texts]
        if texts and fd.is_text and fd.search:
            raise qeval.not_ported(f"a term-in-set query on the text field {node.field!r}")
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
    if isinstance(node, qp.ConstantScoreNode):
        child = prepare(node.filter or qp.MatchAllNode(), prep)
        return CNode("const_score", slots=(prep.f32(node.boost),), children=(child,))
    raise qeval.not_ported(f"query node {type(node).__name__}")


# ---------------------------------------------------------------------------
# runner: CNode -> (scores [D], match [D])
# ---------------------------------------------------------------------------


def _const(match: torch.Tensor, boost: float) -> torch.Tensor:
    return torch.where(match, boost, 0.0).to(torch.float32)


def _doc_range(D: int, num_docs: int, dev: torch.device) -> torch.Tensor:
    return torch.arange(D, device=dev) < num_docs


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
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    scores = torch.zeros(D, dtype=torch.float32, device=dev)
    for s, m in musts + shoulds:
        scores = scores + torch.where(m, s, zero)
    scores = scores * boost
    return torch.where(match, scores, zero), match


def _exec(tree: CNode, mode: str, inputs: list):
    live_root = inputs[0]
    scores, match = _run(tree, inputs, live_root.shape[0], live_root.device)
    match = match & live_root
    return match if mode == "match" else (scores, match)


class CompiledQuery:
    """One prepared (query, segment) pair, executable in the ``match`` and
    ``arrays`` modes."""

    def __init__(self, node, ctx: qeval.EvalContext, live_root):
        prep = _Prep(ctx)
        prep.slot(live_root)            # inputs[0]: live & nested-root mask
        self.tree = prepare(node, prep)
        self.inputs = prep.inputs

    def arrays(self):
        return _exec(self.tree, "arrays", self.inputs)

    def match(self):
        return _exec(self.tree, "match", self.inputs)


NESTED_PATH_FIELD = "_nested_path"
ROOT_PATH = "_root"


def live_root_mask(seg) -> torch.Tensor:
    """live AND nested-root mask, cached on the (immutable) segment. A
    segment committed by the reference carries a ``_nested_path`` ordinal
    column; top-level searches keep its root docs only."""
    cached = getattr(seg, "_live_root_cache", None)
    if cached is not None:
        return cached
    mask = seg.live
    dv = seg.doc_values.get(NESTED_PATH_FIELD)
    if dv is not None and dv.ord_index and ROOT_PATH in dv.ord_index:
        mask = seg.live & (dv.values == dv.ord_index[ROOT_PATH])
    object.__setattr__(seg, "_live_root_cache", mask)
    return mask

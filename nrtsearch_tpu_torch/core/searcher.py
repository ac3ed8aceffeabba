"""Searcher: an immutable snapshot over a list of segments (counterpart:
nrtsearch_tpu/core/searcher.py).

This slice ports the fast paths. A match or term query on one text field
becomes a ``QuerySpec`` and runs through the packed field view (the fused
dense path on CUDA, the exact merge path on the CPU). A boolean tree of one
scored text clause plus filter, must-not and columnar scored clauses (range,
term and term-in-set on doc values, exists, constant-score, booleans of
those) decomposes into a filter mask and an additive score column on the
same spec (``_compile_filtered_spec``). A single-field sort ranks matched
docs by a doc-value key (``_global_sort_keys``), and ``fast_search_reduce``
adds facet counts and stats to a merge-path dispatch.

Everything else raises ``NotImplementedError`` naming ROADMAP item 8: shapes
the fast path refuses (the general evaluator), multi-component, f64,
virtual and runtime sorts, ``extra_filter``, ``return_arrays``, timeouts and
``terminate_after``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.query import plan as qp
from nrtsearch_tpu_torch.schema.fields import DocValueKind, FieldDef
from nrtsearch_tpu_torch.core.segment import Segment
from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.query.eval import CollectionStats, EvalContext

_NOT_PORTED = (
    "this query shape needs the general evaluator, which is not ported yet "
    "(ROADMAP item 8)"
)


@dataclass(frozen=True)
class Hit:
    segment_idx: int
    local_id: int
    global_ord: int
    score: float
    sort_key: Optional[float] = None


@dataclass
class TopDocs:
    hits: list[Hit]
    total_hits: int
    relation: str = "EQUAL_TO"     # | GREATER_THAN_OR_EQUAL_TO
    hit_timeout: bool = False
    terminated_early: bool = False


@dataclass(frozen=True)
class SortComponent:
    """One sort key (reference: SortType, search.proto:1066-1081).
    ``missing_last`` places missing values at the end of the NATURAL order
    (before ``reverse`` is applied, matching the reference contract)."""

    field: str
    reverse: bool = False
    missing_last: bool = False


@dataclass(frozen=True)
class SortSpec:
    """Sort specification: one or more components, primary first. The
    port serves single-component doc-value sorts; the others raise."""

    field: str
    reverse: bool = False  # False = ascending
    missing_last: bool = False
    rest: tuple = ()       # additional SortComponent entries beyond the first

    @property
    def components(self) -> tuple:
        return (
            SortComponent(self.field, self.reverse, self.missing_last),
            *self.rest,
        )

    @property
    def is_multi(self) -> bool:
        return bool(self.rest) or self.field in ("docid", "score")


class Searcher:
    """Immutable multi-segment search snapshot."""

    def __init__(
        self,
        segments: Sequence[Segment],
        field_defs: dict[str, FieldDef],
        version: int = 0,
    ):
        self.segments = list(segments)
        self.field_defs = field_defs
        self.version = version
        self.bases = np.cumsum([0] + [s.num_docs for s in self.segments])[:-1]
        self.stats = CollectionStats(self.segments)
        self._packed_views: dict = {}
        self._gsort_cache: dict = {}

    @property
    def num_docs(self) -> int:
        return sum(s.live_doc_count for s in self.segments)

    @property
    def max_doc(self) -> int:
        return sum(s.num_docs for s in self.segments)

    # -- search --------------------------------------------------------------

    def search(
        self,
        node: qp.QueryNode,
        top_hits: int,
        sort: Optional[SortSpec] = None,
        extra_filter: Optional[qp.QueryNode] = None,
        return_arrays: bool = False,
        timeout_sec: float = 0.0,
        terminate_after: int = 0,
    ) -> TopDocs:
        """Recall + top-k over all segments through the fast paths: the
        reference's fast branch (searcher.py:177-197)."""
        if not self.segments:
            return TopDocs([], 0)
        if extra_filter is not None or return_arrays or timeout_sec or terminate_after:
            raise NotImplementedError(_NOT_PORTED)
        gsort = None
        if sort is not None:
            gsort = self._global_sort_keys(sort)
            if gsort is None:
                raise NotImplementedError(
                    f"sort on {sort.field!r}: an f64 sort key needs the exact host "
                    "sort, which is not ported yet (ROADMAP item 8)"
                )
        fast = self._fast_text_search(node, top_hits, gsort)
        if fast is None:
            fast = self._fast_filtered_text(node, top_hits, gsort)
        if fast is None:
            raise NotImplementedError(_NOT_PORTED)
        return fast

    def fast_query_spec(self, node: qp.QueryNode):
        """Compile a query node to a fast-path QuerySpec, or None if the
        shape needs the general evaluator."""
        from nrtsearch_tpu_torch.analysis import get_analyzer
        from nrtsearch_tpu_torch.core.packed_view import QuerySpec

        if isinstance(node, qp.MatchQueryNode):
            if node.minimum_number_should_match > 1 or node.fuzzy_max_edits:
                return None
            fd = self.field_defs.get(node.field)
            if fd is None or not fd.is_text or not fd.search:
                return None
            if node.analyzer is not None:
                try:
                    terms = get_analyzer(node.analyzer).terms(node.query)
                except KeyError:
                    return None
            else:
                terms = fd.query_terms(node.query)
            require_all = node.operator == "MUST"
        elif isinstance(node, qp.TermQueryNode) and node.text is not None:
            fd = self.field_defs.get(node.field)
            if fd is None or not fd.is_text or not fd.search:
                return None
            terms = [fd.normalize_value(node.text)]
            require_all = True
        else:
            return None
        if not terms or len(terms) > 32:
            return None
        return QuerySpec(
            field=node.field, terms=tuple(terms), require_all=require_all,
            boost=float(node.boost),
        )

    def release_device_caches(self) -> None:
        """Drop this snapshot's device caches (packed views with their
        dense head rows and global columns, global sort keys); they rebuild
        lazily if a search lands here later."""
        self._packed_views.clear()
        self._gsort_cache.clear()

    def packed_view(self, field: str):
        """The packed multi-segment view for one field, cached on this
        immutable snapshot."""
        from nrtsearch_tpu_torch.core.packed_view import PackedFieldView

        if field not in self._packed_views:
            self._packed_views[field] = PackedFieldView(self, field)
        return self._packed_views[field]

    def fast_search_reduce(self, spec, top_hits: int, reduce_plan):
        """Search + flat reductions in one merge-path dispatch.

        ``reduce_plan``: list of {"kind": "ordinal"|"sum"|"min"|"max"|
        "count", "field": name-or-None}. Facet counts and stats accumulate
        over the dispatch's own match stream. Returns (TopDocs, [per-entry
        result]); ordinal results are {term: count} dicts keyed by the packed
        view's global ordinal dictionary."""
        view = self.packed_view(spec.field)
        cols, kinds, labels = [], [], []
        for rp in reduce_plan:
            kind = rp["kind"]
            if kind == "count":
                # a placeholder column the reducer skips
                cols.append((torch.zeros(1, dtype=torch.float32,
                                         device=self.segments[0].device), None))
                kinds.append(("count",))
                labels.append(None)
                continue
            col = view.global_column(rp["field"])
            if kind == "ordinal":
                if col["ord_terms"] is None:
                    raise ValueError(
                        f"field {rp['field']!r} is not an ORDINAL doc-value field"
                    )
                kinds.append(("ordinal", len(col["ord_terms"]) or 1))
            else:
                kinds.append((kind,))
            cols.append((col["values"], col["present"]))
            labels.append(col["ord_terms"])
        results, reds = view.search_batch(
            [spec], top_hits, reduce_cols=tuple(cols), reduce_kinds=tuple(kinds),
        )
        td = self._fast_result_to_topdocs(spec, results[0], top_hits)
        out = []
        for kind, lab, r in zip(kinds, labels, reds[0]):
            if kind[0] == "ordinal":
                out.append({t: int(c) for t, c in zip(lab, np.asarray(r)) if c})
            else:
                out.append(int(r) if kind[0] == "count" else float(r))
        return td, out

    def _fast_result_to_topdocs(self, spec, res, top_hits: int) -> TopDocs:
        hits: list[Hit] = []
        for s, d in zip(res.scores, res.docs):
            if s == -np.inf:
                break
            seg_idx = int(np.searchsorted(self.bases, d, side="right")) - 1
            local = int(d) - int(self.bases[seg_idx])
            if spec.sort is not None:
                hits.append(Hit(seg_idx, local, int(d), 0.0, sort_key=float(s)))
            else:
                hits.append(Hit(seg_idx, local, int(d), float(s)))
        td = TopDocs(hits[:top_hits], res.total_hits)
        if res.pruned:
            # top-k is exact but the hit count is a lower bound (Lucene
            # reports the same relation under WAND)
            td.relation = "GREATER_THAN_OR_EQUAL_TO"
        return td

    def warm(self, fields: Sequence[str]) -> None:
        """Eagerly build packed views, and the dense-head rows when the
        fused path is active (CUDA default, or NRT_FAST_PATH in {dense,
        fused}), so the first query after a refresh does not pay them."""
        path = os.environ.get("NRT_FAST_PATH", "")
        for f in fields:
            if self.field_defs.get(f) is not None and any(
                f in seg.fields for seg in self.segments
            ):
                view = self.packed_view(f)
                if view.index is not None and (
                    path in ("dense", "fused") or (not path and on_cuda(view.index.doc_ids))
                ):
                    view._dense_state()

    # -- sorts -----------------------------------------------------------------

    def _sort_keys(self, seg: Segment, sort: SortSpec) -> Optional[torch.Tensor]:
        """One segment's f32 [capacity] sort keys, missing values at
        -1e38 (or +1e38 with ``missing_last``); None for an f64 column,
        which needs the exact host sort."""
        dv = seg.doc_values.get(sort.field)
        # missing sentinel beyond any stored f32 doc value: missing_last
        # places missing at the end of the NATURAL (ascending) order
        miss = float(np.float32(1e38 if sort.missing_last else -1e38))
        if dv is None:
            return torch.full((seg.capacity,), miss, dtype=torch.float32, device=seg.device)
        if dv.kind != DocValueKind.ORDINAL and dv.values.dtype == torch.float64:
            return None
        return torch.where(dv.present, dv.values.to(torch.float32), miss)

    def _global_sort_keys(self, sort: SortSpec):
        """(keys f32 [max_doc] over global ords, ascending), or None when a
        segment needs the exact-f64 host sort. Cached per (field,
        direction, missing) on this immutable snapshot: specs that share a
        sort share its key object, so they group into one dispatch. A
        multi-component sort raises before the cache is read: it shares its
        first component's key (the reference's cache returns that
        component's keys for it, ROADMAP §3)."""
        if sort.is_multi:
            raise NotImplementedError(
                "multi-component, docid and score sorts are not ported yet "
                "(ROADMAP item 8)"
            )
        fd = self.field_defs.get(sort.field)
        if fd is not None and fd.type.value in ("VIRTUAL", "RUNTIME"):
            raise NotImplementedError(
                f"sort on the {fd.type.value} field {sort.field!r} is not ported yet "
                "(ROADMAP item 8)"
            )
        key = (sort.field, sort.reverse, sort.missing_last)
        if key in self._gsort_cache:
            return self._gsort_cache[key]
        parts = []
        for seg in self.segments:
            keys = self._sort_keys(seg, sort)
            if keys is None:
                parts = None
                break
            parts.append(keys[: seg.num_docs])
        out = None
        if parts is not None:
            g = parts[0] if len(parts) == 1 else torch.cat(parts)
            out = (g, not sort.reverse)
        self._gsort_cache[key] = out
        return out

    # -- fast paths ----------------------------------------------------------

    def _fast_text_search(self, node: qp.QueryNode, top_hits: int, gsort=None):
        """Plain text queries: every segment in one dispatch over the packed
        view, field-sorted when ``gsort`` = (keys, ascending) is given.
        None when the shape isn't eligible."""
        spec = self.fast_query_spec(node)
        if spec is None:
            return None
        if gsort is not None:
            spec = replace(spec, sort=gsort)
        return self.fast_search_batch([spec], top_hits)[0]

    def compile_batchable(self, node: qp.QueryNode, sort=None):
        """QuerySpec for the batchable fast paths, or None: plain text
        queries, decomposed filtered boolean trees, and field-sorted
        variants of both."""
        gsort = self._global_sort_keys(sort) if sort is not None else None
        if sort is not None and gsort is None:
            return None
        spec = self.fast_query_spec(node)
        if spec is not None:
            return spec if gsort is None else replace(spec, sort=gsort)
        return self._compile_filtered_spec(node, gsort)

    def _fast_filtered_text(self, node: qp.QueryNode, top_hits: int, gsort=None):
        spec = self._compile_filtered_spec(node, gsort)
        if spec is None:
            return None
        return self.fast_search_batch([spec], top_hits)[0]

    def _compile_filtered_spec(self, node: qp.QueryNode, gsort=None):
        """Decomposed boolean pushdown: a tree of ONE scored MUST text clause
        plus any mix of FILTER / MUST_NOT clauses and scored non-text MUST
        clauses whose scores are columnar (``_columnar_scorable``) becomes
        one spec: the non-text clauses' AND-mask filters the text clause's
        postings inside the dispatch, and their summed per-doc scores enter
        as an additive column. SHOULD clauses beside filters are not
        eligible: filter-only matches would score 0, which a score > 0
        dispatch cannot represent."""
        from nrtsearch_tpu_torch.query import compiled as qc

        if not isinstance(node, qp.BooleanQueryNode) or node.minimum_number_should_match:
            return None
        scored_text, scored_columnar, others = [], [], []
        for cl in node.clauses:
            if cl.occur == qp.Occur.MUST:
                if self.fast_query_spec(cl.node) is not None:
                    scored_text.append(cl.node)
                elif _columnar_scorable(cl.node, self.field_defs):
                    scored_columnar.append(cl.node)
                else:
                    return None
            elif cl.occur in (qp.Occur.FILTER, qp.Occur.MUST_NOT):
                others.append(cl)
            else:
                return None  # SHOULD alongside filters: general path
        if len(scored_text) != 1 or not (others or scored_columnar):
            return None
        spec = self.fast_query_spec(scored_text[0])
        if spec is None or not self.segments:
            return None
        mask_clauses = tuple(others) + tuple(
            qp.BooleanClause(node=n, occur=qp.Occur.MUST) for n in scored_columnar
        )
        filter_node = qp.BooleanQueryNode(clauses=mask_clauses)
        mparts, sparts = [], []
        for seg in self.segments:
            ctx = EvalContext(seg, self.field_defs, self.stats)
            cq = qc.CompiledQuery(filter_node, ctx, qc.live_root_mask(seg))
            if scored_columnar:
                sc, match = cq.arrays()
                mparts.append(match[: seg.num_docs])
                sparts.append(sc[: seg.num_docs])
            else:
                mparts.append(cq.match()[: seg.num_docs])
        gfilter = mparts[0] if len(mparts) == 1 else torch.cat(mparts)
        additive = None
        if sparts:
            additive = (sparts[0] if len(sparts) == 1 else torch.cat(sparts)) \
                * float(np.float32(node.boost))
        return replace(
            spec, boost=spec.boost * float(node.boost), filter=gfilter,
            additive=additive, sort=gsort,
        )

    def fast_search_batch(self, specs, top_hits: int) -> list[TopDocs]:
        """Batched fast path: N queries against one field, one dispatch per
        path and column group."""
        view = self.packed_view(specs[0].field)
        return [
            self._fast_result_to_topdocs(spec, res, top_hits)
            for spec, res in zip(specs, view.search_batch(specs, top_hits))
        ]


def _columnar_scorable(node: qp.QueryNode, field_defs) -> bool:
    """True when ``node`` scores from columnar doc values or masks alone, so
    a decomposed boolean tree can push it down as (AND-mask + additive
    score) beside the text clause."""
    if isinstance(node, (
        qp.RangeQueryNode, qp.ExistsQueryNode,
        qp.MatchAllNode, qp.GeoBoundingBoxNode, qp.GeoRadiusNode,
        qp.GeoPolygonNode, qp.PolygonContainsNode,
    )):
        return True
    if isinstance(node, (qp.TermQueryNode, qp.TermInSetNode)):
        # constant-score columnar when matched via doc values; a searchable
        # text field would take the postings path instead
        fd = field_defs.get(node.field)
        return fd is not None and not (fd.is_text and fd.search)
    if isinstance(node, qp.ConstantScoreNode):
        return True  # constant score; its inner node is mask-only
    if isinstance(node, qp.BooleanQueryNode):
        if node.minimum_number_should_match:
            return False
        return all(_columnar_scorable(cl.node, field_defs) for cl in node.clauses)
    return False

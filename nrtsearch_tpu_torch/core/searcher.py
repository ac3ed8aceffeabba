"""Searcher: an immutable snapshot over a list of segments (counterpart:
nrtsearch_tpu/core/searcher.py).

The fast paths come first, as in the reference: a match or term query on
one text field becomes a ``QuerySpec`` and runs through the packed field
view (the fused dense path on CUDA, the exact merge path on the CPU); a
boolean tree of one scored text clause plus filter, must-not and columnar
scored clauses decomposes into a filter mask and an additive score column
on the same spec (``_compile_filtered_spec``); a single-field sort ranks
matched docs by a doc-value key (``_global_sort_keys``); a timeout on such
a spec cuts the view into docid chunks with a deadline check between
chunk dispatches (``PackedFieldView.search_timeout``).

Everything else takes the general evaluator, segment by segment: the
compiled program (query/compiled.py, ``NRT_COMPILED_EVAL``, on by default)
or the eager evaluator (query/eval.py), then a per-segment top-k by score
or sort key, or the exact host sort for f64 keys and multi-component,
docid and score sorts, and a merge of the segments' hits on the host.
Timeouts and ``terminate_after`` cut at segment granularity there, and
``terminate_after`` also within a segment. ``knn_search_batch`` runs exact
kNN of a batch of query vectors (ops/knn.py), ``knn_search`` a batch of
one. ``dist_shards`` above 1 (the server's
virtualShards) serves plain text batches over a (shard, data) grid of
``device.search_devices()`` (parallel/distributed.py) when there are two
or more of them, and on the local path otherwise, as the reference does.

A multi-component sort never reads the single-sort key cache: the
reference's cache keys a sort by its first component only
(nrtsearch_tpu/core/searcher.py:520), so after a single sort on a field a
multi-component sort that starts with it ranks by that field alone there.
The port ranks by every component.

A snapshot is shared by the server's threads (the gRPC pool, the batcher's
workers, the runtime's warm thread): its packed-view cache is built under a
lock, so one view per field exists however many threads ask at once.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, replace
from typing import Any, Optional, Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.query import plan as qp
from nrtsearch_tpu_torch.schema.fields import DocValueKind, FieldDef
from nrtsearch_tpu_torch.core.segment import Segment
from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.ops import knn as knn_ops
from nrtsearch_tpu_torch.ops.topk import masked_top_k, masked_top_k_by_key
from nrtsearch_tpu_torch.query import compiled as qc
from nrtsearch_tpu_torch.query import eval as qeval
from nrtsearch_tpu_torch.query.eval import CollectionStats, EvalContext
from nrtsearch_tpu_torch.tracing import span


def _compiled_eval_enabled() -> bool:
    """The general evaluator runs the compiled program per (query,
    segment) by default (query/compiled.py); NRT_COMPILED_EVAL=0 takes the
    eager evaluator instead (the reference's switch)."""
    return os.environ.get("NRT_COMPILED_EVAL", "1") != "0"


def _host(*tensors) -> list[np.ndarray]:
    """Tensors (or arrays) as numpy arrays on the host."""
    return [t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in tensors]


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
    """Sort specification: one or more components, primary first.
    Single-component sorts ride the fast paths or a device top-k by key;
    multi-component, docid and score sorts take the exact host
    lexicographic sort (reference: SortParser, SortParser.java:39)."""

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


def sort_compare_key(sort: SortSpec, raw_values) -> tuple:
    """ASCENDING-comparable key tuple from a hit's raw per-component sort
    values (the reference's, searcher.py:91): each component is
    sign-flipped by its effective direction (reverse XOR natural-descending,
    the latter only for "score"). The searchAfter cursor compares by it."""
    out = []
    for comp, v in zip(sort.components, raw_values):
        eff_rev = bool(comp.reverse) != (comp.field == "score")
        out.append(-v if eff_rev else v)
    return tuple(out)


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
        self._views_lock = threading.Lock()
        self._gsort_cache: dict = {}
        self._dist_cache: dict = {}   # (field, dist_shards) -> DistributedBM25
        # _dist_lock guards the count and the cache and is held only briefly;
        # _dist_build_lock serializes the slow builds (host repartition,
        # dense rows) so that a live count change never waits on one
        self._dist_lock = threading.Lock()
        self._dist_build_lock = threading.Lock()
        self._dist_shards = 1

    @property
    def dist_shards(self) -> int:
        """liveSettings.virtualShards, set by IndexRuntime."""
        return self._dist_shards

    @dist_shards.setter
    def dist_shards(self, n: int) -> None:
        """A new shard count drops the meshes built for another one, so a
        live change never keeps the old mesh beside the new."""
        with self._dist_lock:
            self._dist_shards = int(n)
            for key in [key for key in self._dist_cache if key[1] != self._dist_shards]:
                del self._dist_cache[key]

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
        arrays_score_free: bool = False,
        timeout_check_every: int = 0,
    ):
        """Recall + top-k over all segments (the reference's
        searcher.py:130-281).

        ``extra_filter`` is AND-ed in without contributing score. With
        ``return_arrays`` also returns the per-segment (scores, match)
        tensors, for collectors and facets over the full match set
        (``arrays_score_free``: the caller reads no scores, so a fast-path
        answer comes with match masks only). ``timeout_sec`` and
        ``terminate_after`` bound work at segment granularity, and a
        fast-path spec with a timeout is cut into docid chunks
        (``timeout_check_every`` docs each); cut results are a lower bound
        (relation GREATER_THAN_OR_EQUAL_TO)."""
        if not self.segments:
            return (TopDocs([], 0), []) if return_arrays else TopDocs([], 0)
        if extra_filter is None and not return_arrays and timeout_sec and not terminate_after:
            # the timeout inside the fast path: docid-ascending chunk
            # dispatches with a deadline check between chunks
            spec = self.compile_batchable(node, sort)
            if spec is not None:
                res, timed_out = self.packed_view(spec.field).search_timeout(
                    spec, top_hits, timeout_sec, check_every=timeout_check_every,
                )
                td = self._fast_result_to_topdocs(spec, res, top_hits)
                td.hit_timeout = timed_out
                if timed_out:
                    td.relation = "GREATER_THAN_OR_EQUAL_TO"
                return td
        if (
            extra_filter is None
            and (not return_arrays or arrays_score_free)
            and not timeout_sec
            and not terminate_after
        ):
            gsort = self._global_sort_keys(sort) if sort is not None else None
            if sort is None or gsort is not None:
                fast = self._fast_text_search(node, top_hits, gsort)
                if fast is None:
                    fast = self._fast_filtered_text(node, top_hits, gsort)
                if fast is not None:
                    if return_arrays:
                        # score-free arrays: the match masks come from the
                        # compiled match program, no dense scores
                        return fast, [(None, m) for m in self.match_masks(node)]
                    return fast
        t_start = time.time()
        hit_timeout = False
        terminated_early = False
        per_segment: list[tuple] = []
        arrays = []
        total = 0
        compiled = _compiled_eval_enabled()
        for idx, seg in enumerate(self.segments):
            if timeout_sec and idx > 0 and (time.time() - t_start) > timeout_sec:
                hit_timeout = True
                break
            if terminate_after and total >= terminate_after:
                terminated_early = True
                break
            k = min(top_hits, seg.capacity)
            rem = (terminate_after - total) if terminate_after else 0
            if compiled:
                s, ids, seg_total, arr = self._compiled_segment_topk(
                    seg, node, extra_filter, sort, k, return_arrays, budget=rem, seg_idx=idx,
                )
            else:
                s, ids, seg_total, arr = self._eager_segment_topk(
                    seg, node, extra_filter, sort, k, return_arrays, budget=rem, seg_idx=idx,
                )
            if return_arrays:
                arrays.append(arr)
            per_segment.append((s, ids, idx, min(seg_total, k)))
            total += seg_total
            if rem and seg_total >= rem:
                terminated_early = True
                break
        td = self._merge_top(per_segment, top_hits, sort, total)
        td.hit_timeout = hit_timeout
        td.terminated_early = terminated_early
        if hit_timeout or terminated_early:
            td.relation = "GREATER_THAN_OR_EQUAL_TO"
        return (td, arrays) if return_arrays else td

    def _eager_segment_topk(self, seg: Segment, node, extra_filter, sort, k: int,
                            return_arrays: bool, budget: int = 0, seg_idx: int = 0):
        """Recall + top-k for one segment through the eager evaluator (the
        reference's NRT_COMPILED_EVAL=0 branch, searcher.py:227-274).
        Returns (scores [k], ids [k], seg_total, arrays entry or None) on
        the host."""
        ctx = EvalContext(seg, self.field_defs, self.stats)
        scores, match = qeval.eval_node(node, ctx)
        if extra_filter is not None:
            _, fmask = qeval.eval_node(extra_filter, ctx)
            match = match & fmask
        match = match & qc.live_root_mask(seg)
        if budget:
            # within-segment terminateAfter: only the first ``budget``
            # matches in docid order are collected
            match = qc.budget_mask(match, budget)
        arr = (scores, match) if return_arrays else None
        if sort is None:
            s, ids, th = masked_top_k(scores[None, :], match[None, :], k)
        else:
            keys = self._sort_keys(seg, sort, seg_idx)
            if keys is None:
                s, ids, seg_total = self._host_sorted_topk(seg_idx, match, sort, k,
                                                           scores=scores)
                return s, ids, seg_total, arr
            s, ids, th = masked_top_k_by_key(keys[None, :], match[None, :], k,
                                             ascending=not sort.reverse)
        s, ids, th = _host(s[0], ids[0], th[0])
        return s, ids, int(th), arr

    def _compiled_segment_topk(self, seg: Segment, node, extra_filter, sort, k: int,
                               return_arrays: bool, budget: int = 0, seg_idx: int = 0):
        """Recall + top-k for one segment through the compiled program
        (the reference's searcher.py:283-342). Returns (scores [k], ids
        [k], seg_total, arrays entry or None) on the host; ``budget`` is
        the within-segment terminateAfter limit."""
        ctx = EvalContext(seg, self.field_defs, self.stats)
        cq = qc.CompiledQuery(node, extra_filter, ctx, qc.live_root_mask(seg))
        arr = None
        if sort is None:
            if return_arrays and budget:
                sc, match = cq.arrays()
                match = qc.budget_mask(match, budget)
                arr = (sc, match)
                s, ids, th = masked_top_k(sc[None, :], match[None, :], k)
                s, ids, th = _host(s[0], ids[0], th[0])
                return s, ids, int(th), arr
            if return_arrays:
                sc, match, s, ids, th = cq.arrays_top_k(k)
                arr = (sc, match)
            else:
                s, ids, th = cq.top_k(k, budget=budget)
            s, ids, th = _host(s, ids, th)
            return s, ids, int(th), arr
        keys = self._sort_keys(seg, sort, seg_idx)
        if return_arrays or keys is None:
            sc, match = cq.arrays()
            if budget:
                match = qc.budget_mask(match, budget)
            arr = (sc, match)
            if keys is None:
                # exact f64 column or multi-component sort: host path
                s, ids, seg_total = self._host_sorted_topk(seg_idx, match, sort, k, scores=sc)
                return s, ids, seg_total, arr
            s, ids, th = masked_top_k_by_key(keys[None, :], match[None, :], k,
                                             ascending=not sort.reverse)
            s, ids, th = _host(s[0], ids[0], th[0])
            return s, ids, int(th), arr
        s, ids, th = cq.top_k_by_key(keys, k, ascending=not sort.reverse, budget=budget)
        s, ids, th = _host(s, ids, th)
        return s, ids, int(th), None

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
        # nested children need the root-filtered general path
        for seg in self.segments:
            parents = seg.parent_positions()
            if parents is not None and len(parents) != seg.num_docs:
                return None
        return QuerySpec(
            field=node.field, terms=tuple(terms), require_all=require_all,
            boost=float(node.boost),
        )

    def release_device_caches(self) -> None:
        """Drop this snapshot's device caches (packed views with their
        dense head rows and global columns, global sort keys, virtual-shard
        meshes); they rebuild
        lazily if a search lands here later."""
        self._packed_views.clear()
        self._gsort_cache.clear()
        with self._dist_lock:
            self._dist_cache.clear()

    def packed_view(self, field: str):
        """The packed multi-segment view for one field, cached on this
        immutable snapshot."""
        from nrtsearch_tpu_torch.core.packed_view import PackedFieldView

        view = self._packed_views.get(field)
        if view is None:
            with self._views_lock:
                view = self._packed_views.get(field)
                if view is None:
                    view = PackedFieldView(self, field)
                    self._packed_views[field] = view
        return view

    def count(self, node: qp.QueryNode) -> int:
        return sum(int(m.sum()) for m in self.match_masks(node))

    def match_masks(self, node: qp.QueryNode) -> list[Any]:
        """Per-segment live match masks (for facets and collectors over all
        hits, drill sideways, delete by query)."""
        compiled = _compiled_eval_enabled()
        out = []
        for seg in self.segments:
            ctx = EvalContext(seg, self.field_defs, self.stats)
            if compiled:
                out.append(qc.CompiledQuery(node, None, ctx, qc.live_root_mask(seg)).match())
                continue
            _, match = qeval.eval_node(node, ctx)
            out.append(match & qc.live_root_mask(seg))
        return out

    def knn_search(self, field: str, query_vector, k: int,
                   filter_node: Optional[qp.QueryNode] = None,
                   boost: float = 1.0) -> TopDocs:
        """Exact kNN of one query vector: the batch of one of
        ``knn_search_batch``, whose answers the reference's per-segment
        host merge gives."""
        q = np.asarray(query_vector, np.float32).reshape(1, -1)
        return self.knn_search_batch(field, q, k, filter_node=filter_node, boost=boost)[0]

    def knn_search_batch(self, field: str, queries, k: int,
                         filter_node: Optional[qp.QueryNode] = None,
                         boost: float = 1.0) -> list[TopDocs]:
        """Exact kNN of a batch of query vectors (f32 [B, dims]) over all
        segments (``ops/knn.py`` ``knn_search_batch``), the filter applied
        before the top-k (the FANOUT pre-filter strategy,
        search.proto:1720-1729). Per segment the mask present & live &
        filter (the filter through the eager evaluator, as the reference's),
        one product of the whole batch over the column's rows and a top k;
        the segments' candidates merge on the device; one read to the host
        brings back every query's hits and its total. The boost multiplies
        each score on the host (f64, as the reference's ``float(s) *
        boost``), and its sign orders the merge. Total hits is the filtered
        match count (NrtKnnFloatVectorQuery's). Spans: ``knn.plan`` (masks,
        upload, launches), ``knn.readback``, ``knn.results`` (``TopDocs``)."""
        fd = self.field_defs.get(field)
        if fd is None or not fd.vector_queryable:
            raise KeyError(f"field {field!r} is not a vector field")
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != fd.dims:
            raise ValueError(
                f"query vector has {q.shape[-1]} dims; field {field!r} has {fd.dims}"
            )
        with span("knn.plan"):
            cols, masks, bases, seg_of = [], [], [], []
            for idx, seg in enumerate(self.segments):
                vc = seg.vectors.get(field)
                if vc is None or vc.rows == 0:
                    continue
                mask = vc.present & seg.live
                if filter_node is not None:
                    _, fmask = qeval.eval_node(
                        filter_node, EvalContext(seg, self.field_defs, self.stats))
                    mask = mask & fmask
                cols.append(vc)
                masks.append(mask)
                bases.append(int(self.bases[idx]))
                seg_of.append(idx)
            if not cols:
                return [TopDocs([], 0) for _ in range(len(q))]
            rank = (boost > 0) - (boost < 0)
            out = knn_ops.knn_search_batch(cols, masks, bases, q, similarity=fd.similarity,
                                           k=k, rank=rank)
        with span("knn.readback"):
            scores, docs, totals = knn_ops.batch_to_host(*out)
        with span("knn.results"):
            col_bases = np.asarray(bases, np.int64)
            pos = np.searchsorted(col_bases, docs, side="right") - 1
            segs = np.asarray(seg_of, np.int64)[pos].tolist()
            locals_ = (docs - col_bases[pos]).tolist()
            boosted = (scores.astype(np.float64) * boost).tolist()
            valid = (scores != -np.inf).tolist()
            gids = docs.tolist()
            return [TopDocs([Hit(si, li, g, sc) for si, li, g, sc, ok in zip(
                segs[b], locals_[b], gids[b], boosted[b], valid[b]) if ok],
                int(totals[b])) for b in range(len(q))]

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
        fused path is the route (``packed_view.fast_path``), so the first
        query after a refresh does not pay them."""
        from nrtsearch_tpu_torch.core.packed_view import fast_path

        for f in fields:
            if self.field_defs.get(f) is not None and any(
                f in seg.fields for seg in self.segments
            ):
                view = self.packed_view(f)
                if view.index is not None and fast_path(on_cuda(view.index.doc_ids)) == "dense":
                    view._dense_state()

    # -- sorts -----------------------------------------------------------------

    def _sort_keys(self, seg: Segment, sort: SortSpec,
                   seg_idx: Optional[int] = None) -> Optional[torch.Tensor]:
        """One segment's f32 [capacity] sort keys, missing values at -1e38
        (or +1e38 with ``missing_last``); None for a multi-component sort
        or an f64 column, which take the exact host sort."""
        if sort.is_multi:
            return None
        fd = self.field_defs.get(sort.field)
        if fd is not None and fd.type.value in ("VIRTUAL", "RUNTIME"):
            from nrtsearch_tpu_torch.search.fetch import virtual_field_column

            if seg_idx is None:
                seg_idx = next(i for i, s in enumerate(self.segments) if s is seg)
            vals = virtual_field_column(self, seg_idx, fd)
            return torch.as_tensor(np.asarray(vals).astype(np.float32), device=seg.device)
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
        """(keys f32 [max_doc] over global ords, ascending), or None when the
        sort needs the exact host sort: a multi-component, docid or score
        sort, or a segment's f64 column. Cached per (field, direction,
        missing) on this immutable snapshot: specs that share a sort share
        its key object, so they group into one dispatch. A multi-component
        sort returns None before the cache is read, so it never gets its
        first component's keys (the reference's cache does, ROADMAP §3)."""
        if sort.is_multi:
            return None
        key = (sort.field, sort.reverse, sort.missing_last)
        if key in self._gsort_cache:
            return self._gsort_cache[key]
        parts = []
        for idx, seg in enumerate(self.segments):
            keys = self._sort_keys(seg, sort, idx)
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

    def _component_values(self, seg_idx: int, comp: SortComponent,
                          scores=None) -> tuple[np.ndarray, bool]:
        """Host f64 values [num_docs] of one sort component, missing values
        filled (+inf with missing_last, else -inf, before reverse); and
        whether the component's natural order is descending (only
        "score", SortParser.java:66-70)."""
        seg = self.segments[seg_idx]
        n = seg.num_docs
        if comp.field == "docid":
            return float(self.bases[seg_idx]) + np.arange(n, dtype=np.float64), False
        if comp.field == "score":
            if scores is None:
                raise ValueError("sort on 'score' requires scores for the match set")
            return _host(scores)[0][:n].astype(np.float64), True
        missing = np.inf if comp.missing_last else -np.inf
        fd = self.field_defs.get(comp.field)
        if fd is not None and fd.type.value in ("VIRTUAL", "RUNTIME"):
            from nrtsearch_tpu_torch.search.fetch import virtual_field_column

            vals = virtual_field_column(self, seg_idx, fd)[:n]
            return np.asarray(vals, np.float64), False
        dv = seg.doc_values.get(comp.field)
        if dv is None:
            return np.full(n, missing, np.float64), False
        vals = dv.host_values[:n].astype(np.float64)
        return np.where(dv.host_present[:n], vals, missing), False

    def _host_multisort_topk(self, seg_idx: int, match, sort: SortSpec, k: int, scores=None):
        """Exact lexicographic multi-component sort of one segment's match
        set on the host, ties by doc id ascending. Returns (raw [k, C] f64
        per-component values, ids [k] local, total)."""
        seg = self.segments[seg_idx]
        m = _host(match)[0][: seg.num_docs]
        ids = np.nonzero(m)[0]
        comps = sort.components
        comp_raw, comp_keys = [], []
        for comp in comps:
            vals, nat_desc = self._component_values(seg_idx, comp, scores)
            raw = vals[ids]
            eff_rev = bool(comp.reverse) != nat_desc
            comp_raw.append(raw)
            comp_keys.append(-raw if eff_rev else raw)
        # np.lexsort: the LAST key is primary; doc id is the final tie-break
        order = np.lexsort([ids] + comp_keys[::-1])[:k] if len(ids) else np.empty(0, np.int64)
        top = ids[order]
        raws = np.stack([r[order] for r in comp_raw], axis=1) if len(order) else (
            np.empty((0, len(comps))))
        pad = k - len(top)
        if pad > 0:
            top = np.concatenate([top, np.zeros(pad, np.int64)])
            raws = np.concatenate([raws, np.full((pad, len(comps)), -np.inf)], axis=0)
        return raws, top, int(m.sum())

    def _host_sorted_topk(self, seg_idx: int, match, sort: SortSpec, k: int, scores=None):
        """Exact host sort: a stable argsort of one f64 field, or the
        lexicographic path for multi-component, docid and score sorts.
        Returns (keys [k] f64 or [k, C] f64, ids [k], total)."""
        if sort.is_multi:
            return self._host_multisort_topk(seg_idx, match, sort, k, scores)
        seg = self.segments[seg_idx]
        dv = seg.doc_values[sort.field]
        m = _host(match)[0][: seg.num_docs]
        ids = np.nonzero(m)[0]
        miss = np.inf if sort.missing_last else -np.inf
        vals = np.where(dv.host_present[ids], dv.host_values[ids].astype(np.float64), miss)
        order = np.argsort(-vals if sort.reverse else vals, kind="stable")
        top = ids[order[:k]]
        keys = vals[order[:k]].astype(np.float64)
        pad = k - len(top)
        if pad > 0:
            top = np.concatenate([top, np.zeros(pad, np.int64)])
            keys = np.concatenate([keys, np.full(pad, -np.inf)])
        return keys, top, int(m.sum())

    def _merge_top(self, per_segment: list[tuple], top_hits: int,
                   sort: Optional[SortSpec], total: int) -> TopDocs:
        hits: list[Hit] = []
        multi = sort is not None and sort.is_multi
        for scores, ids, seg_idx, valid in per_segment:
            base = int(self.bases[seg_idx])
            for s, i in zip(scores[:valid], ids[:valid]):
                if sort is None:
                    hits.append(Hit(seg_idx, int(i), base + int(i), float(s)))
                elif multi:
                    hits.append(Hit(seg_idx, int(i), base + int(i), 0.0,
                                    sort_key=tuple(float(v) for v in np.atleast_1d(s))))
                else:
                    hits.append(Hit(seg_idx, int(i), base + int(i), 0.0, sort_key=float(s)))
        if sort is None:
            # score desc, then global ord asc (Lucene tie-break)
            hits.sort(key=lambda h: (-h.score, h.global_ord))
        elif multi:
            hits.sort(key=lambda h: (sort_compare_key(sort, h.sort_key), h.global_ord))
        else:
            sign = -1.0 if sort.reverse else 1.0
            hits.sort(key=lambda h: (sign * (h.sort_key or 0.0), h.global_ord))
        return TopDocs(hits[:top_hits], total)

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
        if not _compiled_eval_enabled():
            return None
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
            cq = qc.CompiledQuery(filter_node, None, ctx, qc.live_root_mask(seg))
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

    # -- virtual shards: the mesh-sharded serving path (reference: liveSettings
    # virtualShards, luceneserver.proto:1458 / MyIndexSearcher.slicesForShards)

    def _distributed_state(self, field: str):
        """The mesh-sharded postings of one field, built on first use and
        cached on this snapshot (the reference's searcher.py:665-687): the
        packed view re-partitioned round-robin over a (shard, data) grid of
        ``device.search_devices()``. The mesh is built outside
        ``_dist_lock`` and installed only if the shard count is still the
        one it was built for; otherwise it serves this call alone."""
        from nrtsearch_tpu_torch import device as _device
        from nrtsearch_tpu_torch.parallel.distributed import (
            DistributedBM25, make_search_mesh,
        )

        with self._dist_build_lock:
            with self._dist_lock:
                n = self._dist_shards
                dist = self._dist_cache.get((field, n))
            if dist is not None:
                return dist
            n_dev = len(_device.search_devices())
            shards = max(1, min(n, n_dev))
            data = max(1, n_dev // shards)
            mesh = make_search_mesh(shards * data, data_parallel=data)
            dist = DistributedBM25.from_searcher(self, field, mesh)
            with self._dist_lock:
                if self._dist_shards == n:
                    self._dist_cache[(field, n)] = dist
        return dist

    def _distributed_search_batch(self, specs, top_hits: int):
        """Plain OR text queries over the virtual-shard mesh, or None when
        the batch is not eligible (filters, sorts, additive columns and
        multi-term conjunctions stay local) or fewer than two search
        devices exist (the reference's searcher.py:689-767). The fused mesh
        serves when ``packed_view.fast_path`` routes to the fused path; else
        the merge mesh."""
        from nrtsearch_tpu_torch import device as _device
        from nrtsearch_tpu_torch.core.packed_view import FastResult, fast_path

        if int(self.dist_shards) <= 1 or len(_device.search_devices()) < 2:
            return None
        for spec in specs:
            if (spec.filter is not None or spec.additive is not None
                    or spec.sort is not None):
                return None
            if spec.require_all and len(set(spec.terms)) > 1:
                return None
        try:
            dist = self._distributed_state(specs[0].field)
        except ValueError:
            return None
        data = dist.mesh.shape["data"]
        B = len(specs)
        B_pad = -(-B // data) * data
        qs = [list(spec.terms) for spec in specs]
        qs += [[] for _ in range(B_pad - B)]

        def to_topdocs(scores, ids, hits):
            scores, gids, hits_n = _host(scores, ids, hits)
            return [self._fast_result_to_topdocs(
                spec, FastResult(scores[qi], gids[qi], int(hits_n[qi]), False), top_hits)
                for qi, spec in enumerate(specs)]

        view = self.packed_view(specs[0].field)
        if fast_path(view.index is not None and on_cuda(view.index.doc_ids)) == "dense":
            with self._dist_build_lock:
                if not dist.dense_attached:
                    dist.attach_dense()
            if dist.dense_rows is not None:
                tid_qs = [[dist.vocab[t] for t in q if t in dist.vocab] for q in qs]
                (W, row_idx, n_req, r_offs, r_lens, r_w, drun_len,
                 has_head, has_tail) = dist.compile_dense_queries(tid_qs)
                if has_head:
                    for qi, spec in enumerate(specs):
                        if spec.boost != 1.0:
                            W[qi] *= np.float32(spec.boost)
                            r_w[:, qi, :] *= np.float32(spec.boost)
                    return to_topdocs(*dist.search_dense(
                        W, row_idx, n_req, r_offs, r_lens, r_w, run_len=drun_len,
                        k=top_hits, has_head=has_head, has_tail=has_tail))

        offs, lens, w, n_terms, run_len = dist.compile_text_queries(qs)
        for qi, spec in enumerate(specs):
            if spec.boost != 1.0:
                w[:, qi, :] *= np.float32(spec.boost)
        return to_topdocs(*dist.search(offs, lens, w, n_terms, run_len=run_len,
                                       k=top_hits))

    def fast_search_batch(self, specs, top_hits: int) -> list[TopDocs]:
        """Batched fast path: N queries against one field, one dispatch per
        path and column group; with ``dist_shards`` above 1 and two or more
        search devices, plain text queries serve over the mesh."""
        dist = self._distributed_search_batch(specs, top_hits)
        if dist is not None:
            return dist
        view = self.packed_view(specs[0].field)
        found = view.search_batch(specs, top_hits)
        with span("results"):
            return [
                self._fast_result_to_topdocs(spec, res, top_hits)
                for spec, res in zip(specs, found)
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

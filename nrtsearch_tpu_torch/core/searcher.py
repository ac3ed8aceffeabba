"""Searcher: an immutable snapshot over a list of segments (counterpart:
nrtsearch_tpu/core/searcher.py).

This slice ports the fast text path: a match or term query on one text
field becomes a ``QuerySpec`` and runs through the packed field view (the
fused dense path on CUDA, the exact merge path on the CPU). Shapes the fast
path refuses (boolean trees, filters, sorts, timeouts, returned arrays, the
general evaluator) raise ``NotImplementedError`` naming ROADMAP item 8.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from nrtsearch_tpu_torch.query import plan as qp
from nrtsearch_tpu_torch.schema.fields import FieldDef
from nrtsearch_tpu_torch.core.segment import Segment
from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.query.eval import CollectionStats

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


@dataclass
class TopDocs:
    hits: list[Hit]
    total_hits: int
    relation: str = "EQUAL_TO"     # | GREATER_THAN_OR_EQUAL_TO
    hit_timeout: bool = False
    terminated_early: bool = False


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
        sort=None,
        extra_filter: Optional[qp.QueryNode] = None,
        return_arrays: bool = False,
        timeout_sec: float = 0.0,
        terminate_after: int = 0,
    ) -> TopDocs:
        """Recall + top-k over all segments through the fast text path."""
        if not self.segments:
            return TopDocs([], 0)
        if (sort is not None or extra_filter is not None or return_arrays
                or timeout_sec or terminate_after):
            raise NotImplementedError(_NOT_PORTED)
        fast = self._fast_text_search(node, top_hits)
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
        """Drop this snapshot's packed views (postings + dense head rows);
        they rebuild lazily if a search lands here later."""
        self._packed_views.clear()

    def packed_view(self, field: str):
        """The packed multi-segment view for one field, cached on this
        immutable snapshot."""
        from nrtsearch_tpu_torch.core.packed_view import PackedFieldView

        if field not in self._packed_views:
            self._packed_views[field] = PackedFieldView(self, field)
        return self._packed_views[field]

    def _fast_result_to_topdocs(self, res, top_hits: int) -> TopDocs:
        hits: list[Hit] = []
        for s, d in zip(res.scores, res.docs):
            if s == -np.inf:
                break
            seg_idx = int(np.searchsorted(self.bases, d, side="right")) - 1
            local = int(d) - int(self.bases[seg_idx])
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

    def _fast_text_search(self, node: qp.QueryNode, top_hits: int):
        """Scatter-free path for plain text queries: every segment in one
        dispatch over the packed view. None when the shape isn't eligible."""
        spec = self.fast_query_spec(node)
        if spec is None:
            return None
        return self.fast_search_batch([spec], top_hits)[0]

    def fast_search_batch(self, specs, top_hits: int) -> list[TopDocs]:
        """Batched fast path: N queries against one field in one dispatch."""
        view = self.packed_view(specs[0].field)
        return [
            self._fast_result_to_topdocs(res, top_hits)
            for res in view.search_batch(specs, top_hits)
        ]

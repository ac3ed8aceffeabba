"""Copy of ``nrtsearch_tpu/search/query_cache.py``, kept whole but for its
key: an entry is keyed by (segment id, device, node), where the reference
keys it by (segment id, node). A CPU copy and a CUDA copy of one commit
share their segment ids in one process (a parity check, a primary beside a
replica), and a mask cached for one device must not meet the other's
tensors. ``get`` and ``put`` take the segment's device.

Query cache: LRU of per-segment filter evaluation results.

Reference: NrtQueryCache (server/search/cache/NrtQueryCache.java:27) — an LRU
over per-segment filter bitsets with count/size metrics. Here the cached
value is the (scores, match) device-array pair for a (segment, plan-node)
key; segments are immutable so entries never go stale — a new searcher
snapshot simply stops referencing old segment ids.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional

from nrtsearch_tpu_torch.query import plan as qp


class QueryCache:
    def __init__(self, max_entries: int = 1024):
        self.max_entries = max_entries
        self._lru: OrderedDict[tuple, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def cacheable(node: qp.QueryNode) -> bool:
        """Only score-independent (filter-like) nodes are worth caching —
        mirrors Lucene's policy of caching filters, not scoring queries."""
        return isinstance(
            node,
            (
                qp.RangeQueryNode, qp.TermInSetNode, qp.ExistsQueryNode,
                qp.PrefixQueryNode, qp.WildcardQueryNode, qp.GeoBoundingBoxNode,
                qp.GeoRadiusNode, qp.ConstantScoreNode,
            ),
        )

    def get(self, seg_id: str, node: qp.QueryNode, device=None) -> Optional[Any]:
        key = (seg_id, str(device), node)
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                self.hits += 1
                return self._lru[key]
            self.misses += 1
            return None

    def put(self, seg_id: str, node: qp.QueryNode, value: Any, device=None) -> None:
        key = (seg_id, str(device), node)
        with self._lock:
            self._lru[key] = value
            self._lru.move_to_end(key)
            while len(self._lru) > self.max_entries:
                self._lru.popitem(last=False)


# process-wide default cache (configured size via NrtsearchConfig later)
DEFAULT_QUERY_CACHE = QueryCache()

"""Collection statistics (counterpart: nrtsearch_tpu/query/eval.py
``CollectionStats``). The general per-segment evaluator of that module is
not ported yet (ROADMAP item 8)."""

from __future__ import annotations

from typing import Sequence

from nrtsearch_tpu_torch.core.segment import Segment

# Lucene BM25Similarity defaults
BM25_K1 = 1.2
BM25_B = 0.75


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

"""IndexWriter: buffered document ingest and refresh (counterpart:
nrtsearch_tpu/core/writer.py).

Documents buffer in a host-side SegmentBuilder; ``refresh()`` flushes the
buffer into a new immutable segment on the writer's device and returns the
segment list (the caller makes a new Searcher over it). Segments are never
merged. Deletes, doc-value updates, merges and the upsert of an _ID that is
already indexed raise ``NotImplementedError`` (ROADMAP item 10).
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

import torch

from nrtsearch_tpu_torch.schema.fields import FieldDef, FieldType
from nrtsearch_tpu_torch.core.segment import Segment, SegmentBuilder
from nrtsearch_tpu_torch.device import resolve_device


class IndexWriter:
    def __init__(
        self,
        field_defs: dict[str, FieldDef],
        device: str | torch.device,
        max_buffer_docs: int = 100_000,
    ):
        self.field_defs = field_defs
        self.device = resolve_device(device)
        self.max_buffer_docs = max_buffer_docs
        self.segments: list[Segment] = []
        self._builder = SegmentBuilder(field_defs, self.device)
        self._ids: set[str] = set()
        self._lock = threading.RLock()
        self._seq = 0
        self.id_field = next(
            (n for n, f in field_defs.items() if f.type == FieldType.ID), None
        )

    # -- ingest ----------------------------------------------------------------

    def add_documents(self, docs: Sequence[dict[str, Any]]) -> int:
        """Add a chunk of parsed docs; returns the sequence number (gen)."""
        with self._lock:
            for doc in docs:
                if self.id_field and self.id_field in doc:
                    doc_id_val = doc[self.id_field]
                    if isinstance(doc_id_val, (list, tuple)):
                        doc_id_val = doc_id_val[0]
                    key = str(doc_id_val)
                    if key in self._ids:
                        raise NotImplementedError(
                            f"upsert of existing id {key!r}: updates are not "
                            "ported yet (ROADMAP item 10)"
                        )
                    self._builder.add_document(doc)
                    self._ids.add(key)
                else:
                    self._builder.add_document(doc)
            self._seq += 1
            if self._builder.num_docs >= self.max_buffer_docs:
                self._flush_buffer()
            return self._seq

    def delete_by_id(self, ids: Sequence[str]) -> int:
        raise NotImplementedError("deletes are not ported yet (ROADMAP item 10)")

    def update_doc_values(self, docs) -> int:
        raise NotImplementedError(
            "doc-value updates are not ported yet (ROADMAP item 10)"
        )

    # -- refresh -------------------------------------------------------------------

    def refresh(self) -> list[Segment]:
        """Flush the buffer; returns the new segment list."""
        with self._lock:
            self._flush_buffer()
            return list(self.segments)

    def _flush_buffer(self) -> None:
        if self._builder.num_docs == 0:
            return
        seg = self._builder.flush()
        self.segments.append(seg)
        self._builder = SegmentBuilder(self.field_defs, self.device)

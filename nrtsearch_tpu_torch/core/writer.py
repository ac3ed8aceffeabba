"""IndexWriter: buffered document ingest, deletes, doc-value updates,
refresh and merges (counterpart: nrtsearch_tpu/core/writer.py, whose
semantics this writer keeps).

- Documents buffer in a host-side SegmentBuilder; an _ID that is already
  indexed or buffered is an upsert: delete-then-add (Lucene
  updateDocuments).
- Deletes by _ID, by query (``delete_matches``: seg_id -> local ids) and
  all; they stay pending until ``refresh()``, which applies them as new
  live masks (``Segment.with_deletes``: same seg_id, next del_gen), then the
  pending doc-value updates (``Segment.with_doc_value_updates``: a new
  ``_dv`` seg_id), then the tiered merge policy (``segments_per_tier``,
  ``max_merged_docs``; ``core/merge.py`` re-packs a group on the host and
  drops its deleted docs).
- With an ``index_sort`` each flushed segment, and each merge, lays its
  docs out in the sort's doc-value order.

Every segment lives on the writer's device. Documents carry the field
types ``SegmentBuilder`` builds.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.core.merge import merge_segments
from nrtsearch_tpu_torch.core.segment import Segment, SegmentBuilder
from nrtsearch_tpu_torch.device import resolve_device
from nrtsearch_tpu_torch.schema.fields import FieldDef, FieldType


class IndexWriter:
    def __init__(
        self,
        field_defs: dict[str, FieldDef],
        device: str | torch.device,
        merge_factor: int = 10,
        max_buffer_docs: int = 100_000,
    ):
        self.field_defs = field_defs
        self.device = resolve_device(device)
        self.merge_factor = merge_factor
        # tiered merge policy knobs (live settings segmentsPerTier /
        # maxMergedSegmentMB; doc-count proxy for segment size)
        self.segments_per_tier = merge_factor
        self.max_merged_docs = 0  # 0 = unbounded
        # cumulative merge activity, scraped via IndexRuntime.stats()
        self.merge_stats = {"merges": 0, "merged_docs": 0, "merge_seconds": 0.0}
        # index sort: list of (field, reverse, missing_last); docs within each
        # flushed/merged segment are laid out in this doc-value order
        self.index_sort: list[tuple[str, bool, bool]] = []
        self.max_buffer_docs = max_buffer_docs
        self.segments: list[Segment] = []
        self._builder = SegmentBuilder(field_defs, self.device)
        self._buffer_deleted: set[int] = set()
        self._buffer_ids: dict[str, int] = {}
        self._pending_deletes: dict[str, set[int]] = {}  # seg_id -> local ids
        self._pending_dv_updates: dict[str, dict] = {}   # seg_id -> field -> {local: value}
        self._id_map: dict[str, tuple[str, int]] = {}    # id -> (seg_id, local)
        self._lock = threading.RLock()
        self._seq = 0
        self.id_field: Optional[str] = next(
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
                    self._delete_id(str(doc_id_val))
                    local = self._builder.add_document(doc)
                    self._buffer_ids[str(doc_id_val)] = local
                else:
                    self._builder.add_document(doc)
            self._seq += 1
            if self._builder.num_docs >= self.max_buffer_docs:
                self._flush_buffer()
            return self._seq

    # -- deletes -----------------------------------------------------------------

    def delete_by_id(self, ids: Sequence[str]) -> int:
        with self._lock:
            for i in ids:
                self._delete_id(str(i))
            self._seq += 1
            return self._seq

    def delete_matches(self, seg_matches: dict[str, np.ndarray]) -> int:
        """Apply delete-by-query results: seg_id -> local doc ids to delete."""
        with self._lock:
            for seg_id, locals_ in seg_matches.items():
                self._pending_deletes.setdefault(seg_id, set()).update(
                    int(x) for x in locals_
                )
            self._seq += 1
            return self._seq

    def update_doc_values(self, docs: Sequence[dict[str, Any]]) -> int:
        """Doc-values-only updates by id (IndexingRequestType.UPDATE_DOC_VALUES).

        Each doc carries the _ID field plus numeric doc-value fields to
        update. The target doc must be in a flushed segment (refresh first)."""
        if self.id_field is None:
            raise ValueError("doc-value updates require an _ID field")
        with self._lock:
            for doc in docs:
                id_value = doc.get(self.id_field)
                if isinstance(id_value, (list, tuple)):
                    id_value = id_value[0]
                id_value = str(id_value)
                if id_value in self._buffer_ids:
                    raise ValueError(
                        f"doc {id_value!r} is still buffered; refresh before "
                        "updating doc values"
                    )
                loc = self._id_map.get(id_value)
                if loc is None:
                    raise KeyError(f"no document with id {id_value!r}")
                seg_id, local = loc
                for fname, value in doc.items():
                    if fname == self.id_field:
                        continue
                    fd = self.field_defs.get(fname)
                    if fd is None:
                        raise KeyError(f"unregistered field: {fname!r}")
                    v = value[0] if isinstance(value, (list, tuple)) else value
                    self._pending_dv_updates.setdefault(seg_id, {}).setdefault(
                        fname, {}
                    )[local] = fd.parse_doc_value(v)
            self._seq += 1
            return self._seq

    def delete_all(self) -> int:
        with self._lock:
            self.segments = []
            self._builder = SegmentBuilder(self.field_defs, self.device)
            self._buffer_deleted = set()
            self._buffer_ids = {}
            self._pending_deletes = {}
            self._pending_dv_updates = {}
            self._id_map = {}
            self._seq += 1
            return self._seq

    def _delete_id(self, id_value: str) -> None:
        if id_value in self._buffer_ids:
            self._buffer_deleted.add(self._buffer_ids.pop(id_value))
        loc = self._id_map.pop(id_value, None)
        if loc is not None:
            seg_id, local = loc
            self._pending_deletes.setdefault(seg_id, set()).add(local)

    # -- refresh / merge ----------------------------------------------------------

    def refresh(self) -> list[Segment]:
        """Flush the buffer, apply deletes then doc-value updates, merge;
        returns the new segment list."""
        with self._lock:
            self._flush_buffer()
            self._apply_pending_deletes()
            self._apply_pending_dv_updates()
            self._maybe_merge()
            return list(self.segments)

    @property
    def buffered_docs(self) -> int:
        return self._builder.num_docs

    def _flush_buffer(self) -> None:
        if self._builder.num_docs == 0:
            return
        seg = self._builder.flush()
        assert seg is not None
        if self.index_sort and seg.num_docs > 1:
            # sort at flush time (Lucene sorts new segments at flush too):
            # a single-segment "merge" re-packs docs in index-sort order
            seg, remap = merge_segments([seg], self.field_defs, self.index_sort)
            m = next(iter(remap.values()))
            self._buffer_deleted = {int(m[d]) for d in self._buffer_deleted}
            self._buffer_ids = {k: int(m[v]) for k, v in self._buffer_ids.items()}
        if self._buffer_deleted:
            seg = seg.with_deletes(np.asarray(sorted(self._buffer_deleted)))
        for id_value, local in self._buffer_ids.items():
            self._id_map[id_value] = (seg.seg_id, local)
        self.segments.append(seg)
        self._builder = SegmentBuilder(self.field_defs, self.device)
        self._buffer_deleted = set()
        self._buffer_ids = {}

    def _apply_pending_deletes(self) -> None:
        if not self._pending_deletes:
            return
        new_segments = []
        for seg in self.segments:
            dels = self._pending_deletes.get(seg.seg_id)
            if dels:
                seg = seg.with_deletes(np.asarray(sorted(dels)))
            new_segments.append(seg)
        self.segments = new_segments
        self._pending_deletes = {}

    def _apply_pending_dv_updates(self) -> None:
        if not self._pending_dv_updates:
            return
        new_segments = []
        renamed: dict[str, str] = {}
        for seg in self.segments:
            upd = self._pending_dv_updates.get(seg.seg_id)
            if upd:
                new_seg = seg.with_doc_value_updates(upd)
                renamed[seg.seg_id] = new_seg.seg_id
                seg = new_seg
            new_segments.append(seg)
        self.segments = new_segments
        if renamed:
            for id_value, (seg_id, local) in list(self._id_map.items()):
                if seg_id in renamed:
                    self._id_map[id_value] = (renamed[seg_id], local)
        self._pending_dv_updates = {}

    def _maybe_merge(self) -> None:
        """Tiered merge policy, the reference's (writer.py:227-246): while
        the segment count exceeds segments_per_tier, merge the group of
        smallest segments (at most segments_per_tier of them, their live
        docs within max_merged_docs when that is set)."""
        while True:
            group = self._plan_tiered_merge()
            if group is None:
                return
            t0 = time.time()
            docs = sum(s.live_doc_count for s in group)
            self._merge_group(group)
            self.merge_stats["merges"] += 1
            self.merge_stats["merged_docs"] += docs
            self.merge_stats["merge_seconds"] += time.time() - t0

    def _plan_tiered_merge(self) -> Optional[list[Segment]]:
        if len(self.segments) <= max(self.segments_per_tier, 1):
            return None
        by_size = sorted(self.segments, key=lambda s: s.live_doc_count)
        group: list[Segment] = []
        total = 0
        for seg in by_size:
            if len(group) >= max(self.segments_per_tier, 2):
                break
            if (
                self.max_merged_docs
                and group
                and total + seg.live_doc_count > self.max_merged_docs
            ):
                break  # by_size is sorted: no later segment fits either
            group.append(seg)
            total += seg.live_doc_count
        return group if len(group) >= 2 else None

    def _merge_group(self, group: list[Segment]) -> None:
        merged, remap = merge_segments(group, self.field_defs, self.index_sort)
        merged_ids = {s.seg_id for s in group}
        for id_value, (seg_id, local) in list(self._id_map.items()):
            if seg_id in merged_ids:
                new_local = int(remap[seg_id][local])
                if new_local < 0:
                    del self._id_map[id_value]
                else:
                    self._id_map[id_value] = (merged.seg_id, new_local)
        self.segments = [
            s for s in self.segments if s.seg_id not in merged_ids
        ] + [merged]

    # -- replication / restore -----------------------------------------------------

    def install_segments(self, segments: list[Segment]) -> None:
        """Replace the segment set wholesale (replica point copy / restore)."""
        with self._lock:
            self.segments = list(segments)
            self._rebuild_id_map()

    def _rebuild_id_map(self) -> None:
        """id -> (seg_id, local) over the installed segments' live docs."""
        self._id_map = {}
        if not self.id_field:
            return
        for seg in self.segments:
            dv = seg.doc_values.get(self.id_field)
            if dv is None or dv.ord_terms is None:
                continue
            n = seg.num_docs
            local = np.nonzero(seg.host_live[:n] & dv.host_present[:n])[0]
            ords = dv.host_values[:n][local].tolist()
            self._id_map.update(
                (dv.ord_terms[o], (seg.seg_id, l)) for o, l in zip(ords, local.tolist())
            )

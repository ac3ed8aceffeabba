"""Segment merging: N immutable segments -> one compacted segment
(counterpart: nrtsearch_tpu/core/merge.py).

Merging is a host re-pack, as in the reference: each segment's postings,
doc values and stored rows are read back to the host, deleted docs are
compacted out, doc ids remapped, term dictionaries unioned in first-seen
order, and the port's ``SegmentBuilder`` packs a fresh segment onto the
device the segments live on. The merged segment is the one the reference
builds from the same segments: the same term ids, postings, quantized
lengths (re-quantized, which leaves them unchanged), doc values and rows.

With an index sort the merged docs are laid out in its doc-value order,
doc id for doc id as the reference lays them out; the writer also sorts
each flushed segment this way. Vector columns are carried by index: one
host copy of each segment's matrix (dequantized, as the reference's
``host_float``), its live rows scattered to their new ids, then packed in
the field's format (an int8 column re-quantizes with the merged matrix's
scale, as in the reference). Suggest entries raise ``NotImplementedError``
(ROADMAP item 10): the port's builder makes none.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from nrtsearch_tpu_torch.core.segment import Segment, SegmentBuilder, new_seg_id
from nrtsearch_tpu_torch.schema.fields import DocValueKind, FieldDef


def merge_segments(
    segments: Sequence[Segment],
    field_defs: dict[str, FieldDef],
    index_sort: Optional[Sequence[tuple[str, bool, bool]]] = None,
) -> tuple[Segment, dict[str, np.ndarray]]:
    """Merge segments, dropping deleted docs.

    Returns (merged_segment, remap) where ``remap[seg_id][old_local] -> new
    local id or -1`` for deleted docs.

    ``index_sort``: optional list of (field, reverse, missing_last); the
    merged segment's docs follow this doc-value order. Segments holding
    nested child docs are never sorted (blocks must stay contiguous)."""
    for seg in segments:
        if seg.suggest:
            raise NotImplementedError(
                "merging suggest entries is not ported yet (ROADMAP item 10)"
            )
    remap: dict[str, np.ndarray] = {}
    new_local = 0
    for seg in segments:
        m = np.full(seg.num_docs, -1, dtype=np.int64)
        live_ids = np.nonzero(seg.host_live)[0]
        m[live_ids] = np.arange(new_local, new_local + len(live_ids))
        new_local += len(live_ids)
        remap[seg.seg_id] = m

    if index_sort and not any(_has_nested_children(s) for s in segments):
        _apply_index_sort(segments, remap, new_local, index_sort)

    builder = SegmentBuilder(field_defs, segments[0].device)
    builder.num_docs = new_local
    for seg in segments:
        m = remap[seg.seg_id]
        for fname, tfi in seg.fields.items():
            post = builder._postings.setdefault(fname, {})
            lens = builder._doc_lens.setdefault(fname, [])
            doc_ids = tfi.doc_ids[: tfi.postings_len].cpu().numpy()
            freqs = tfi.freqs[: tfi.postings_len].cpu().numpy()
            new_ids = m[doc_ids]
            inv_terms = [None] * len(tfi.terms)
            for term, tid in tfi.terms.items():
                inv_terms[tid] = term
            for tid, term in enumerate(inv_terms):
                off, ln = int(tfi.offsets[tid]), int(tfi.lengths[tid])
                nd = new_ids[off : off + ln]
                keep = nd >= 0
                plist = post.setdefault(term, [])
                plist.extend(zip(nd[keep].tolist(), freqs[off : off + ln][keep].tolist()))
            seg_lens = tfi.doc_lens[: seg.num_docs].cpu().numpy()
            while len(lens) < new_local:
                lens.append(0)
            live = m >= 0
            for new, ln in zip(m[live].tolist(), seg_lens[live].tolist()):
                lens[new] = int(ln)
        for fname, dv in seg.doc_values.items():
            out = builder._dv.setdefault(fname, [])
            if dv.mv_offsets is not None:
                for old in range(seg.num_docs):
                    new = m[old]
                    if new < 0:
                        continue
                    for v in dv.mv_values[dv.mv_offsets[old] : dv.mv_offsets[old + 1]]:
                        val = dv.ord_terms[int(v)] if dv.ord_terms else v.item()
                        out.append((int(new), val))
            else:
                for old in range(seg.num_docs):
                    new = m[old]
                    if new < 0 or not dv.host_present[old]:
                        continue
                    if dv.kind == DocValueKind.ORDINAL:
                        out.append((int(new), dv.ord_terms[int(dv.host_values[old])]))
                    elif dv.kind == DocValueKind.LAT_LON:
                        lat, lon = dv.host_values[old]
                        out.append((int(new), (float(lat), float(lon))))
                    else:
                        out.append((int(new), dv.host_values[old].item()))
        for fname, vc in seg.vectors.items():
            keep = np.nonzero((m >= 0) & vc.host_present()[: seg.num_docs])[0]
            builder._vectors.setdefault(fname, []).append(
                (m[keep], vc.host_float()[keep]))
        for old in range(seg.num_docs):
            new = m[old]
            if new >= 0:
                while len(builder._stored) <= new:
                    builder._stored.append({})
                builder._stored[int(new)] = seg.stored[old]

    while len(builder._stored) < new_local:
        builder._stored.append({})

    # order postings within each term by new doc id (merge may interleave)
    for post in builder._postings.values():
        for term in post:
            post[term].sort(key=lambda p: p[0])

    merged = builder.flush(seg_id=new_seg_id("_m"))
    assert merged is not None
    return merged, remap


def _has_nested_children(seg: Segment) -> bool:
    parents = seg.parent_positions()
    return parents is not None and len(parents) != seg.num_docs


def _apply_index_sort(
    segments: Sequence[Segment],
    remap: dict[str, np.ndarray],
    total: int,
    index_sort: Sequence[tuple[str, bool, bool]],
) -> None:
    """Rewrite ``remap`` in place so new local ids follow the index sort.

    Multi-key sort is a chain of stable single-key passes (last key first);
    each pass orders by value with the key's reverse flag, then moves docs
    missing the value to the front/back per missing_last, so missing
    placement is direction-independent (SortField missing-value semantics)."""
    # preliminary id -> (segment, old local)
    origin: list[tuple[Segment, int]] = [None] * total  # type: ignore[list-item]
    for seg in segments:
        m = remap[seg.seg_id]
        for old in np.nonzero(m >= 0)[0]:
            origin[int(m[old])] = (seg, int(old))

    order = list(range(total))
    for field, reverse, missing_last in reversed(list(index_sort)):
        keys: list = [None] * total
        present = np.zeros(total, dtype=bool)
        for i, (seg, old) in enumerate(origin):
            dv = seg.doc_values.get(field)
            if dv is None or not dv.host_present[old]:
                continue
            if dv.kind == DocValueKind.ORDINAL:
                # per-segment ordinals are not comparable across segments
                keys[i] = dv.ord_terms[int(dv.host_values[old])]
            else:
                keys[i] = dv.host_values[old].item()
        present[[i for i in range(total) if keys[i] is not None]] = True
        fallback = "" if any(isinstance(k, str) for k in keys if k is not None) else 0.0
        order.sort(
            key=lambda i: keys[i] if keys[i] is not None else fallback,
            reverse=reverse,
        )
        order.sort(key=lambda i: (0 if present[i] else (1 if missing_last else -1)))
    inv = np.empty(total, dtype=np.int64)
    inv[np.asarray(order, dtype=np.int64)] = np.arange(total)
    for seg in segments:
        m = remap[seg.seg_id]
        live = m >= 0
        m[live] = inv[m[live]]

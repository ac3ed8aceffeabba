"""Segment merging: N immutable segments -> one compacted segment
(counterpart: nrtsearch_tpu/core/merge.py).

Merging is a host re-pack, as in the reference: each segment's postings
with their positions, doc values, suggest entries and stored rows are read
back to the host, deleted docs are compacted out, doc ids remapped, term
dictionaries unioned in first-seen order, and the port's ``SegmentBuilder``
packs a fresh segment onto the device the segments live on. The merged
segment is the one the reference builds from the same segments: the same
term ids, postings, positions, quantized lengths (re-quantized, which
leaves them unchanged), doc values and rows. The postings move as arrays
(one sort of all entries by term and new doc id, one gather of the
positions), where the reference moves one entry at a time.

With an index sort the merged docs are laid out in its doc-value order,
doc id for doc id as the reference lays them out; the writer also sorts
each flushed segment this way. Vector columns are carried by index: one
host copy of each segment's matrix (dequantized, as the reference's
``host_float``), its live rows scattered to their new ids, then packed in
the field's format (an int8 column re-quantizes with the merged matrix's
scale, as in the reference). A segment that kept no positions merges as
one whose entries have none, as in the reference. A segment with no
``_nested_path`` column (one made from arrays by ``convert``) merges as
one whose docs are all roots, so a merge with builder-made segments keeps
every doc a top-level hit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from nrtsearch_tpu_torch.core.segment import (
    NESTED_PATH_FIELD, ROOT_PATH, Segment, SegmentBuilder, new_seg_id,
)
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
    for fname in dict.fromkeys(f for seg in segments for f in seg.fields):
        _merge_text_field(builder, fname, [s for s in segments if fname in s.fields],
                          remap, new_local)
    for seg in segments:
        m = remap[seg.seg_id]
        if NESTED_PATH_FIELD not in seg.doc_values:
            # a segment made from arrays carries no nesting info: its docs
            # are roots, as the builder would have marked them
            builder._dv.setdefault(NESTED_PATH_FIELD, []).extend(
                (int(n), ROOT_PATH) for n in m[m >= 0])
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
                    elif dv.kind == DocValueKind.POLYGON:
                        # geojson strings ride doc-indexed in ord_terms
                        out.append((int(new), dv.ord_terms[old]))
                    else:
                        out.append((int(new), dv.host_values[old].item()))
        for fname, vc in seg.vectors.items():
            keep = np.nonzero((m >= 0) & vc.host_present()[: seg.num_docs])[0]
            builder._vectors.setdefault(fname, []).append(
                (m[keep], vc.host_float()[keep]))
        for fname, entries in seg.suggest.items():
            out = builder._suggest.setdefault(fname, [])
            for doc, text, weight, ctxs in entries:
                nd = m[int(doc)]
                if nd >= 0:
                    out.append((int(nd), text, weight, list(ctxs)))
        for old in range(seg.num_docs):
            new = m[old]
            if new >= 0:
                while len(builder._stored) <= new:
                    builder._stored.append({})
                builder._stored[int(new)] = seg.stored[old]

    while len(builder._stored) < new_local:
        builder._stored.append({})

    merged = builder.flush(seg_id=new_seg_id("_m"))
    assert merged is not None
    return merged, remap


def _ragged(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The concatenated index ranges [starts[i], starts[i] + lens[i])."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    ends = np.cumsum(lens)
    shift = np.repeat(np.asarray(starts, np.int64) - (ends - lens), lens)
    return shift + np.arange(total, dtype=np.int64)


def _merge_text_field(builder: SegmentBuilder, fname: str, segments: Sequence[Segment],
                      remap: dict[str, np.ndarray], total_docs: int) -> None:
    """One text field's merged postings, as the reference's entry-by-entry
    loop builds them: terms in first-seen order (segment by segment, term
    id by term id, a term entering with its first live entry), each term's
    entries by new doc id, each entry's positions as they were."""
    term_ids: dict[str, int] = {}
    parts = []   # per segment: (global term id, new doc, freq, positions, lens)
    for seg in segments:
        tfi = seg.fields[fname]
        m = remap[seg.seg_id]
        n_terms = len(tfi.terms)
        inv_terms = [None] * n_terms
        for term, tid in tfi.terms.items():
            inv_terms[tid] = term
        entries = _ragged(tfi.offsets, tfi.lengths)          # term-id order
        entry_tid = np.repeat(np.arange(n_terms), tfi.lengths)
        docs = tfi.host_doc_ids()[entries]
        new_docs = m[docs]
        keep = new_docs >= 0
        live_per_term = np.bincount(entry_tid[keep], minlength=n_terms)
        gid = np.empty(n_terms, np.int64)
        for tid in range(n_terms):
            if live_per_term[tid]:
                gid[tid] = term_ids.setdefault(inv_terms[tid], len(term_ids))
        entries, entry_tid, new_docs = entries[keep], entry_tid[keep], new_docs[keep]
        freqs = tfi.freqs[: tfi.postings_len].cpu().numpy()[entries]
        if tfi.positions is not None and tfi.position_offsets is not None:
            starts = tfi.position_offsets[entries]
            plens = tfi.position_offsets[entries + 1] - starts
            pos = tfi.positions[_ragged(starts, plens)]
        else:
            plens = np.zeros(len(entries), np.int64)
            pos = np.empty(0, np.int32)
        parts.append((gid[entry_tid], new_docs, freqs, pos, plens))
    lens = [0] * total_docs
    for seg in segments:
        m = remap[seg.seg_id]
        seg_lens = seg.fields[fname].doc_lens[: seg.num_docs].cpu().numpy()
        live = m >= 0
        for new, ln in zip(m[live].tolist(), seg_lens[live].tolist()):
            lens[new] = int(ln)
    gids = np.concatenate([p[0] for p in parts])
    new_docs = np.concatenate([p[1] for p in parts])
    order = np.lexsort((new_docs, gids))
    plens = np.concatenate([p[4] for p in parts])
    pos_starts = np.zeros(len(plens), np.int64)
    np.cumsum(plens[:-1], out=pos_starts[1:])
    offsets = np.zeros(len(order) + 1, np.int64)
    np.cumsum(plens[order], out=offsets[1:])
    positions = np.concatenate([p[3] for p in parts]).astype(np.int32)
    builder.set_text_arrays(
        fname, list(term_ids),
        np.bincount(gids, minlength=len(term_ids)).astype(np.int32),
        new_docs[order], np.concatenate([p[2] for p in parts])[order],
        positions[_ragged(pos_starts[order], plens[order])], offsets, lens,
    )


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

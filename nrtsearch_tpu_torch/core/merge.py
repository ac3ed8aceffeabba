"""Segment merging: N immutable segments -> one compacted segment
(counterpart: nrtsearch_tpu/core/merge.py).

Merging is a host re-pack, as in the reference: each segment's postings,
doc values and stored rows are read back to the host, deleted docs are
compacted out, doc ids remapped, term dictionaries unioned in first-seen
order, and the port's ``SegmentBuilder`` packs a fresh segment onto the
device the segments live on. The merged segment is the one the reference
builds from the same segments: the same term ids, postings, quantized
lengths (re-quantized, which leaves them unchanged), doc values and rows.

Index sorts, vector columns and suggest entries raise
``NotImplementedError`` (ROADMAP items 10 and 12): the port's builder makes
none of them.
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
    local id or -1`` for deleted docs."""
    if index_sort:
        raise NotImplementedError("index sorts are not ported yet (ROADMAP item 10)")
    for seg in segments:
        if seg.vectors:
            raise NotImplementedError(
                "merging vector columns is not ported yet (ROADMAP item 12)"
            )
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

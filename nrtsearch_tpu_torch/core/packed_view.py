"""Packed multi-segment field view: one dispatch for any segment count
(counterpart: nrtsearch_tpu/core/packed_view.py).

Every segment's postings for one field are concatenated into one flat device
array with doc ids rebased to GLOBAL ords, so runs from different segments
are just more sorted runs in the same merge, and one dispatch scores the
whole index for a whole query batch.

Path choice mirrors the reference, and ``fast_path`` alone makes it from
``NRT_FAST_PATH``: by default the fused dense path (``dense_search_batch``)
serves when the index tensors live on CUDA (the reference serves it on its
accelerator) and the exact merge path (``PrunedIndex.search``) on the CPU.
Specs the fused path refuses go to the merge path, exactly as in the
reference. ``NRT_FAST_PATH=bucket`` sends plain text batches to the
bucket-local path (``bucket_search_batch``, ops/bucket_retrieval.py) and
what it refuses to the merge path; its scores are 15-bit quantized and it
refuses specs with columns, as the reference does.

A spec may carry device columns indexed by global doc ord: a ``filter``
mask, an ``additive`` score column and a ``sort`` (keys, ascending).
Specs are grouped by the identity of those objects, one dispatch per group.
Flat reductions (facet counts, stats) ride the merge path only
(``search_batch(..., reduce_cols, reduce_kinds)``), over columns laid out
by ``global_column``. A spec with a timeout runs on the merge path in
docid chunks, with a deadline check between chunk dispatches
(``search_timeout``).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.ops.bm25 import lucene_idf
from nrtsearch_tpu_torch.ops.bucket_retrieval import (
    MIN_TILE, QMAX, bucket_search_topk, decode_topk,
)
from nrtsearch_tpu_torch.ops.merge_scoring import _pow2
from nrtsearch_tpu_torch.tracing import span

# tail slack of the packed postings: a run gather near the end never clamps
GATHER_TILE = 8192
# batches the fused dense path refused, by reason (one per refused
# ``dense_search_batch`` call): no postings, no head term, a conjunction
# with a tail term, a conjunction whose head term spilled to the tail, more
# tail runs than the kernel's fixed R
FUSED_REFUSALS = {"empty": 0, "no_head": 0, "and_tail": 0, "spill_and": 0, "tail_runs": 0}


@dataclass(frozen=True)
class QuerySpec:
    """One fast-path text query: analyzed terms against one field.

    ``filter`` is an optional device bool [max_doc] mask (global ords):
    docs failing it match nothing. ``additive`` is an optional device f32
    [max_doc] per-doc score added to matched docs before the top-k (the
    columnar score of a decomposed boolean tree's non-text MUST clauses).
    ``sort`` is an optional (keys f32 [max_doc], ascending): matched docs
    rank by the key instead of the score."""

    field: str
    terms: tuple[str, ...]
    require_all: bool = False
    boost: float = 1.0
    filter: Optional[torch.Tensor] = dc_field(default=None, compare=False, hash=False)
    additive: Optional[torch.Tensor] = dc_field(default=None, compare=False, hash=False)
    sort: Optional[tuple] = dc_field(default=None, compare=False, hash=False)


@dataclass
class FastResult:
    scores: np.ndarray   # [k] f32, -inf padded
    docs: np.ndarray     # [k] global ords
    total_hits: int
    pruned: bool         # total_hits is a lower bound


def fast_path(on_device: bool) -> str:
    """The batched text route: ``NRT_FAST_PATH`` (``fused`` is another
    name of ``dense``), or unset, ``dense`` when the index lives on the
    device and ``merge`` on the CPU. ``dense`` and ``bucket`` name the
    fused and bucket paths; any other value serves as ``merge``."""
    path = os.environ.get("NRT_FAST_PATH", "") or ("dense" if on_device else "merge")
    return "dense" if path == "fused" else path


def _empty(k: int) -> FastResult:
    return FastResult(np.full(k, -np.inf, np.float32), np.zeros(k, np.int64), 0, False)


class PackedFieldView:
    """All live segments' postings for one field, packed for fused search."""

    # H rows x D docs: at most 1024 rows, and at most this many bytes of
    # bf16 rows and their residual rows per field view
    _DENSE_MAX_ROWS = 1024
    _DENSE_BYTES_BUDGET = 2048 << 20
    # the fused path's fixed shapes: at most _DENSE_U head rows a dispatch
    # (32 when the batch needs no more), head terms past them spilling to
    # the tail, and _DENSE_R tail runs a query of ``dense_run_len`` each
    _DENSE_U = 128
    _DENSE_R = 8

    @staticmethod
    def dense_run_len(tail_max_df: int) -> int:
        """The fused path's tail run length on a snapshot: its largest
        tail df as a power of two, within [4096, 65536]."""
        return _pow2(min(max(4096, tail_max_df), 65536))

    def __init__(self, searcher, field: str):
        from nrtsearch_tpu_torch.core.maxscore import PrunedIndex

        self.field = field
        fd = searcher.field_defs[field]
        self.k1 = float(fd.sim_k1)
        self.b = float(fd.sim_b)
        self.avgdl = float(searcher.stats.avgdl(field))
        self.doc_count = int(searcher.stats.doc_count(field))
        self.stats = searcher.stats
        self.max_doc = int(searcher.max_doc)
        self._searcher = searcher
        self._columns: dict[str, dict] = {}
        self._dense_build_lock = threading.Lock()
        self._dense_st = None
        # specs served per path over this view's lifetime (reporting)
        self.path_counts = {"fused": 0, "bucket": 0, "merge": 0}

        run_off_parts, run_len_parts = [], []
        # (segment_idx, tfi, run_index_base) for term lookups
        self.seg_entries: list[tuple[int, object, int]] = []
        parts: list[tuple[object, int]] = []   # (segment, global base)
        cursor = 0
        run_base = 0
        for idx, seg in enumerate(searcher.segments):
            tfi = seg.fields.get(field)
            if tfi is None or tfi.postings_len == 0:
                continue
            base = int(searcher.bases[idx])
            parts.append((seg, base))
            run_off_parts.append(np.asarray(tfi.offsets, np.int64) + cursor)
            run_len_parts.append(np.asarray(tfi.lengths, np.int32))
            self.seg_entries.append((idx, tfi, run_base))
            run_base += len(tfi.offsets)
            cursor += tfi.postings_len
        self.total_len = cursor
        if cursor == 0:
            self.index = None
            return
        dev_ids, dev_imps = _device_packed(self, parts, cursor, 2 * GATHER_TILE)
        self.index = PrunedIndex(
            dev_ids, dev_imps, np.concatenate(run_off_parts),
            np.concatenate(run_len_parts), self.max_doc,
        )

    # -- term plumbing ---------------------------------------------------------

    def term_entries(
        self, terms: Sequence[str], boost: float = 1.0
    ) -> list[tuple[str, float, list[int]]]:
        """Per term: (term, idf*boost weight, [run_index, ...])."""
        out = []
        for term in terms:
            df = self.stats.doc_freq(self.field, term)
            w = lucene_idf(self.doc_count, df) * boost if df else 0.0
            runs = []
            if w:
                for _, tfi, run_base in self.seg_entries:
                    tid = tfi.terms.get(term)
                    if tid is not None and tfi.lengths[tid]:
                        runs.append(run_base + tid)
            out.append((term, w, runs))
        return out

    # -- bucket-local path (opt-in) ---------------------------------------------

    _BUCKET_MAX_SLOTS = 16
    _BUCKET_DOCS = 16384

    def _bucket_state(self):
        """Per-run bucket split offsets for the bucket-local kernels: one
        bisection over every (run, bucket boundary) pair on the device
        (``PrunedIndex.split_rows``). Cached per view."""
        st = getattr(self, "_bucket_st", None)
        if st is not None:
            return st
        bits = self._BUCKET_DOCS.bit_length() - 1
        m = max(1, _pow2(self.max_doc) // self._BUCKET_DOCS)
        offs = self.index.run_offsets
        lens = self.index.run_lengths
        bounds = np.zeros((len(offs), m + 1), np.int32)
        if m > 1 and len(offs):
            boundaries = np.arange(1, m, dtype=np.int64) * self._BUCKET_DOCS
            bounds[:, 1:-1] = self.index.split_rows(offs, lens, boundaries)[:, 1:-1]
        bounds[:, -1] = lens
        st = {"bounds": bounds, "bits": bits, "m": m, "ub": self.index.run_ub}
        self._bucket_st = st
        return st

    def bucket_plan(self, specs: Sequence[QuerySpec]):
        """Host planning of one batch for the bucket path, line for line the
        reference's (packed_view.py:192-260) except that the quantization
        scale bounds every query term. Returns None when a spec needs
        another path (filter, additive or sort columns, more runs than the
        slot budget, or a batch that mixes AND and OR), else a dict: per-query ``live`` flags, the [B, T]
        ``term_offs`` / ``weights``, [B, T, m+1] ``bounds``, ``n_terms``,
        ``scales``, ``tile``, ``bits``, ``require_all``. ``live`` is None
        when every spec is a dead conjunction."""
        if self.total_len == 0:
            return None
        st = self._bucket_state()
        m = st["m"]
        B = len(specs)
        run_lengths = self.index.run_lengths
        per_q: list = []
        for spec in specs:
            if spec.filter is not None or spec.additive is not None or spec.sort is not None:
                return None
            entries = self.term_entries(spec.terms, spec.boost)
            if spec.require_all and any(not runs for _, _, runs in entries):
                per_q.append(None)   # dead: a required term matches nothing
                continue
            slots = [(r, w) for _, w, runs in entries if w
                     for r in runs if run_lengths[r]]
            if len(slots) > self._BUCKET_MAX_SLOTS:
                return None
            n_distinct = len(spec.terms) if spec.require_all else 1
            per_q.append((slots, spec.require_all, n_distinct))
        if all(q is None for q in per_q):
            return {"live": None}
        req_all = any(q is not None and q[1] for q in per_q)
        if req_all and not all(q is None or q[1] for q in per_q):
            return None   # mixed AND/OR batch: one require_all flag per launch

        T = max(1, max(len(q[0]) for q in per_q if q is not None))
        term_offs = np.zeros((B, T), np.int32)
        runs = np.full((B, T), -1, np.int64)
        weights = np.zeros((B, T), np.float32)
        n_terms = np.ones(B, np.int32)
        scales = np.ones(B, np.float32)
        run_offsets = self.index.run_offsets
        for qi, q in enumerate(per_q):
            if q is None:
                continue
            slots, _ra, n_distinct = q
            # slot order: heaviest run first
            slots = sorted(slots, key=lambda s: -int(run_lengths[s[0]]))
            # quantization scale from per-weight bounds, as the reference
            # computes it (nrtsearch_tpu/core/packed_view.py:243-247). Its
            # fault, kept on purpose (ROADMAP §3): a repeated term, or two
            # terms of equal idf, share one bound, so their sums can pass
            # QMAX and clip, and the clipped docs rank by doc id
            by_w: dict[float, float] = {}
            for r, w in slots:
                by_w[w] = max(by_w.get(w, 0.0), float(st["ub"][r]))
            smax = sum(w * ub for w, ub in by_w.items())
            scale = QMAX / smax if smax > 0 else 1.0
            scales[qi] = scale
            n_terms[qi] = n_distinct
            for ti, (r, w) in enumerate(slots):
                term_offs[qi, ti] = int(run_offsets[r])
                runs[qi, ti] = r
                weights[qi, ti] = w * scale
        bounds = np.where((runs >= 0)[..., None], st["bounds"][np.maximum(runs, 0)], 0)
        bounds = bounds.astype(np.int32)
        lens = bounds[:, :, 1:] - bounds[:, :, :-1]
        tile = _pow2(int(lens.sum(axis=1).max()), MIN_TILE)
        return {
            "live": [q is not None for q in per_q], "term_offs": term_offs,
            "bounds": bounds, "weights": weights, "n_terms": n_terms,
            "scales": scales, "tile": tile, "bits": st["bits"],
            "require_all": req_all,
        }

    def bucket_search_batch(self, specs: Sequence[QuerySpec], k: int):
        """Plain text queries on the bucket-local path
        (ops/bucket_retrieval.py): per (query, bucket) gather + pack, per-doc
        integer sums and mask, lowest-doc top-k over int32 rank keys. Scores
        are 15-bit quantized on the query's largest possible score; docs and
        hit counts are exact over the quantized scores. Returns None when
        the batch needs the merge path (``bucket_plan``)."""
        plan = self.bucket_plan(specs)
        if plan is None:
            return None
        if plan["live"] is None:
            return [_empty(k) for _ in specs]
        dev = self.index.device

        def t(x):
            return torch.as_tensor(x, device=dev)

        tk, td, hits = bucket_search_topk(
            self.index.doc_ids, self.index.impacts, t(plan["term_offs"]),
            t(plan["bounds"]), t(plan["weights"]), t(plan["n_terms"]),
            tile=plan["tile"], bucket_bits=plan["bits"], k=k,
            require_all=plan["require_all"],
        )
        scores, docs = decode_topk(tk.cpu().numpy(), td.cpu().numpy(), plan["scales"])
        hits = hits.cpu().numpy()
        return [
            FastResult(scores[qi], docs[qi].astype(np.int64), int(hits[qi]), False)
            if live else _empty(k)
            for qi, live in enumerate(plan["live"])
        ]

    # -- dense-head + merge-tail fused path ---------------------------------------

    def _dense_state(self):
        """Lazily build the dense-head state over this view's packed
        postings: head terms (df >= min_df) become bf16 [Hp, D] impact rows
        (plus Dekker residual rows) built ON DEVICE with one flat scatter
        from the resident postings. Cached per immutable searcher snapshot.
        Returns None when no term reaches min_df."""
        if self._dense_st is not None:
            return self._dense_st if self._dense_st != "none" else None
        with self._dense_build_lock:
            return self._dense_state_locked()

    def _dense_state_locked(self):
        st = self._dense_st
        if st is not None:
            return st if st != "none" else None
        dev = self.index.device
        D = -(-self.max_doc // 128) * 128
        min_df = max(256, self.max_doc // 512)
        # bf16 rows and their Dekker residual rows
        bytes_per_row = 4 * D
        max_rows = min(
            self._DENSE_MAX_ROWS, self._DENSE_BYTES_BUDGET // bytes_per_row
        )
        # per-TERM total df across segments
        df: dict[str, int] = {}
        for _, tfi, _rb in self.seg_entries:
            for term, tid in tfi.terms.items():
                ln = int(tfi.lengths[tid])
                if ln:
                    df[term] = df.get(term, 0) + ln
        head = sorted(
            (t for t, n in df.items() if n >= min_df),
            key=lambda t: (-df[t], t),
        )[:max_rows]
        if not head or max_rows <= 0:
            self._dense_st = "none"
            return None
        head_pos = {t: i for i, t in enumerate(head)}
        Hp = max(8, -(-len(head) // 8) * 8)
        # flat scatter indices: for every head (term, segment-run), the
        # positions of its postings in the packed device arrays
        gidx_parts, row_parts = [], []
        run_offs = self.index.run_offsets
        run_lens = self.index.run_lengths
        for _, tfi, rb in self.seg_entries:
            for term, row in head_pos.items():
                tid = tfi.terms.get(term)
                if tid is None or not tfi.lengths[tid]:
                    continue
                off, ln = int(run_offs[rb + tid]), int(run_lens[rb + tid])
                gidx_parts.append(np.arange(off, off + ln, dtype=np.int64))
                row_parts.append(np.full(ln, row, np.int64))
        gidx = torch.as_tensor(np.concatenate(gidx_parts), device=dev)
        rowid = torch.as_tensor(np.concatenate(row_parts), device=dev)
        ids = self.index.doc_ids[gidx].long()
        imps = self.index.impacts[gidx]
        hi = imps.to(torch.bfloat16)
        rows = torch.zeros((Hp, D), dtype=torch.bfloat16, device=dev)
        rows[rowid, ids] = hi
        # Dekker residual: bf16(imp - f32(hi))
        lo = (imps - hi.float()).to(torch.bfloat16)
        rows_lo = torch.zeros((Hp, D), dtype=torch.bfloat16, device=dev)
        rows_lo[rowid, ids] = lo
        del gidx, rowid, ids, imps, hi, lo
        row_max = rows.amax(dim=1).float()
        # the largest tail (non-head) df sizes the fixed serving run_len
        tail_max_df = max((n for t, n in df.items() if t not in head_pos), default=0)
        st = {
            "rows": rows, "rows_lo": rows_lo, "row_max": row_max,
            "head_pos": head_pos, "D": D, "tail_max_df": int(tail_max_df),
        }
        self._dense_st = st
        return st

    def dense_search_batch(self, specs: Sequence[QuerySpec], k: int):
        """Text queries on the fused dense path (ops/dense_fused.py): compact
        head rows, tail runs through the bitonic merge in exact f32, window
        or full combine. Filters, additive columns and sorts ride the same
        dispatch: specs are grouped by the identity of their column objects
        (and the AND/OR mode), one dispatch per group, each group's columns
        padded to D. Returns None when a spec needs the merge path (a
        conjunction with a tail term, more than R tail runs), as the
        reference does; each refusal is counted in FUSED_REFUSALS."""
        from nrtsearch_tpu_torch.ops.dense_fused import dense_fused_topk
        from nrtsearch_tpu_torch.ops.dense_head import decode_packed2

        if self.total_len == 0:
            return _refused("empty")
        st = self._dense_state()
        if st is None:
            return _refused("no_head")
        dev = self.index.device
        head_pos = st["head_pos"]
        D = st["D"]
        B = len(specs)
        run_offs = self.index.run_offsets
        run_lens = self.index.run_lengths

        # one fused dispatch per (filter, additive, sort) object set and
        # AND/OR mode (a static flag of the kernel)
        groups: dict[tuple, list[int]] = {}
        parsed = []
        for qi, spec in enumerate(specs):
            entries = self.term_entries(spec.terms, spec.boost)
            live = [(t, w, runs) for t, w, runs in entries if w and runs]
            dead = spec.require_all and any(not runs for _, _, runs in entries)
            distinct = len({t for t, _, _ in live})
            is_and = bool(spec.require_all and distinct > 1 and not dead)
            if is_and and any(t not in head_pos for t, _, _ in live):
                return _refused("and_tail")   # conjunction with a tail term: merge path
            f, a, srt = spec.filter, spec.additive, spec.sort
            key = (
                id(f) if f is not None else None,
                id(a) if a is not None else None,
                (id(srt[0]), bool(srt[1])) if srt is not None else None,
                is_and,
            )
            parsed.append((qi, spec, live, dead, distinct))
            groups.setdefault(key, []).append(qi)

        def pad_col(x):
            n = x.shape[0]
            return x if n == D else F.pad(x, (0, D - n))

        out: list = [_empty(k)] * B
        u_cap = self._DENSE_U
        for (*_cols, is_and), idxs in groups.items():
            items = [parsed[i] for i in idxs]
            live_items = [it for it in items if not it[3]]
            if not live_items:
                continue
            Bg = len(live_items)
            used: dict[int, int] = {}
            per_q: list[list[tuple[int, float]]] = []
            rows_tail: list[list[tuple[int, int, float]]] = []
            n_req = np.ones(Bg, np.int32)
            any_tail = False
            spill_and = False
            for gi, (qi, spec, live, _dead, distinct) in enumerate(live_items):
                merged: dict[str, float] = {}
                ent_by_term: dict[str, list] = {}
                for term, w, runs in live:
                    merged[term] = merged.get(term, 0.0) + w
                    ent_by_term[term] = runs
                slots: list[tuple[int, float]] = []
                row: list[tuple[int, int, float]] = []
                for term, w in merged.items():
                    r = head_pos.get(term)
                    if r is not None and (r in used or len(used) < u_cap):
                        if r not in used:
                            used[r] = len(used)
                        slots.append((used[r], w))
                    else:
                        if r is not None and is_and:
                            # a spilled term breaks the all-head conjunction
                            spill_and = True
                        for run in ent_by_term[term]:
                            ln = int(run_lens[run])
                            if ln:
                                row.append((int(run_offs[run]), ln, w))
                                any_tail = True
                per_q.append(slots)
                rows_tail.append(row)
                if is_and:
                    n_req[gi] = distinct
            if spill_and:
                return _refused("spill_and")  # merge path serves the conjunction exactly
            has_head = bool(used)
            U = 32 if len(used) <= 32 else u_cap
            W = np.zeros((Bg, U), np.float32)
            row_idx = np.zeros(U, np.int32)
            for r, slot in used.items():
                row_idx[slot] = r
            for gi, slots in enumerate(per_q):
                for slot, w in slots:
                    W[gi, slot] += w
            if any_tail:
                run_len = self.dense_run_len(st["tail_max_df"])
                R_fix = self._DENSE_R
                t_offs = np.zeros((Bg, R_fix), np.int32)
                t_lens = np.zeros((Bg, R_fix), np.int32)
                t_w = np.zeros((Bg, R_fix), np.float32)
                for gi, row in enumerate(rows_tail):
                    ri = 0
                    for off, ln, w in row:
                        for start in range(0, ln, run_len):
                            if ri >= R_fix:
                                return _refused("tail_runs")  # merge path
                            t_offs[gi, ri] = off + start
                            t_lens[gi, ri] = min(run_len, ln - start)
                            t_w[gi, ri] = w
                            ri += 1
            else:
                t_offs = np.zeros((Bg, 1), np.int32)
                t_lens = np.zeros((Bg, 1), np.int32)
                t_w = np.zeros((Bg, 1), np.float32)
                run_len = 0

            def t(x):
                return torch.as_tensor(x, device=dev)

            spec0 = live_items[0][1]
            filt = None if spec0.filter is None else pad_col(spec0.filter)
            additive = None if spec0.additive is None else pad_col(spec0.additive)
            sort_keys, sort_ascending = None, True
            if spec0.sort is not None:
                sort_keys = pad_col(spec0.sort[0]).to(torch.float32)
                sort_ascending = bool(spec0.sort[1])
            packed = dense_fused_topk(
                st["rows"], st["row_max"], self.index.doc_ids, self.index.impacts,
                t(W), t(row_idx), t(n_req), t(t_offs), t(t_lens), t(t_w),
                filt, additive, sort_keys, st["rows_lo"], k=k, has_head=has_head,
                has_tail=any_tail, run_len=run_len, require_all=is_and,
                sort_ascending=sort_ascending,
            )
            scores, docs, hits, exact = decode_packed2(packed, k)
            for gi, (qi, *_rest) in enumerate(live_items):
                out[qi] = FastResult(
                    scores[gi], docs[gi].astype(np.int64), int(hits[gi]),
                    not bool(exact[gi]),
                )
        return out

    # -- fused batched search -----------------------------------------------------

    # -- global doc-value columns (flat reductions) ------------------------------

    def global_column(self, field: str) -> dict:
        """Doc-value column laid out by GLOBAL doc ord, for flat reductions
        over the merge path's match stream: ``values`` (int32 global
        ordinals, -1 where absent, or f32 for numeric columns, f64 ones
        included, as the reference casts them), ``present`` and, for
        ORDINAL columns, ``ord_terms``: the sorted union of the segments'
        dictionaries. Cached per packed view."""
        cached = self._columns.get(field)
        if cached is not None:
            return cached
        searcher = self._searcher
        ord_union: set[str] = set()
        is_ordinal = False
        for seg in searcher.segments:
            dv = seg.doc_values.get(field)
            if dv is not None and dv.ord_terms is not None:
                is_ordinal = True
                ord_union.update(dv.ord_terms)
        ord_terms = sorted(ord_union)
        gidx = {t: i for i, t in enumerate(ord_terms)}
        vals = np.zeros(self.max_doc, np.float64)
        present = np.zeros(self.max_doc, bool)
        for idx, seg in enumerate(searcher.segments):
            dv = seg.doc_values.get(field)
            if dv is None:
                continue
            base = int(searcher.bases[idx])
            n = seg.num_docs
            hp = np.asarray(dv.host_present[:n], bool)
            if is_ordinal:
                remap = np.array([gidx[t] for t in (dv.ord_terms or [])], np.int64)
                hv = np.asarray(dv.host_values[:n]).astype(np.int64)
                if len(remap):
                    v = np.where(hp, remap[np.clip(hv, 0, len(remap) - 1)], -1)
                else:
                    v = np.full(n, -1, np.int64)
            else:
                v = np.asarray(dv.host_values[:n]).astype(np.float64)
            vals[base : base + n] = np.where(hp, v, vals[base : base + n])
            present[base : base + n] = hp
        dev = self.index.device if self.index is not None else searcher.segments[0].device
        out = {
            "values": torch.as_tensor(vals.astype(np.int32 if is_ordinal else np.float32),
                                      device=dev),
            "present": torch.as_tensor(present, device=dev),
            "ord_terms": ord_terms if is_ordinal else None,
        }
        self._columns[field] = out
        return out

    # -- doc-space chunked search (a timeout inside the fast path) -------------------

    def search_timeout(self, spec: QuerySpec, k: int, timeout_sec: float, chunks: int = 8,
                       check_every: int = 0):
        """One spec as docid-ascending chunk dispatches on the merge path,
        with a deadline check between chunks (``PrunedIndex.
        search_chunked``; the reference's packed_view.py:599-641). Returns
        (FastResult, timed_out). ``check_every`` (timeoutCheckEvery, docs
        between deadline checks) sets the chunk size: about that many docs
        per chunk, 1 to 64 chunks."""
        if check_every > 0:
            want = -(-int(self.index.max_doc) // max(int(check_every), 1))
            chunks = max(1, min(64, want))
        if self.total_len == 0:
            return _empty(k), False
        entries = self.term_entries(spec.terms, spec.boost)
        if spec.require_all and any(not runs for _, _, runs in entries):
            return _empty(k), False
        q = {
            "entries": [(w, runs) for _, w, runs in entries if w and runs],
            "require_all": spec.require_all,
            "n_terms": len(spec.terms) if spec.require_all else 1,
            "filter": spec.filter,
            "additive": spec.additive,
            "sort": spec.sort,
        }
        if not q["entries"]:
            return _empty(k), False
        s, d, total, timed_out = self.index.search_chunked(
            q, k, deadline=time.time() + timeout_sec,
            chunks=min(chunks, max(1, int(self.index.max_doc))),
        )
        return FastResult(s, d, total, False), timed_out

    # -- batched search ------------------------------------------------------------

    def search_batch(
        self, specs: Sequence[QuerySpec], k: int, reduce_cols=(), reduce_kinds=(),
    ):
        """Batched search over all segments in one dispatch per path (and
        column group).

        ``fast_path`` picks the path: with ``NRT_FAST_PATH`` unset, the
        fused dense path when the index lives on CUDA and the merge path on
        the CPU. The bucket path is opt-in (``NRT_FAST_PATH=bucket``), as in
        the reference. What the fused or bucket path refuses goes to the
        merge path. With
        ``reduce_kinds`` the batch takes the merge path and returns
        (results, per-spec reductions)."""
        from nrtsearch_tpu_torch.core.maxscore import _zero_reductions

        path = fast_path(self.index is not None and on_cuda(self.index.doc_ids))
        if path == "dense" and not reduce_kinds:
            with span("fused"):
                res = self.dense_search_batch(specs, k)
            if res is not None:
                self.path_counts["fused"] += len(specs)
                return res
        if path == "bucket" and not reduce_kinds:
            res = self.bucket_search_batch(specs, k)
            if res is not None:
                self.path_counts["bucket"] += len(specs)
                return res
        B = len(specs)
        out = [_empty(k)] * B
        reds = [_zero_reductions(reduce_kinds)] * B
        queries = []
        dead = [False] * B
        with span("plan.terms"):
            for qi, spec in enumerate(specs):
                entries = self.term_entries(spec.terms, spec.boost)
                if spec.require_all and any(not runs for _, _, runs in entries):
                    dead[qi] = True   # a required term matches nothing
                    queries.append({"entries": [], "require_all": True, "n_terms": 1})
                    continue
                queries.append({
                    "entries": [(w, runs) for _, w, runs in entries if w and runs],
                    "require_all": spec.require_all,
                    "n_terms": len(spec.terms) if spec.require_all else 1,
                    "filter": spec.filter,
                    "additive": spec.additive,
                    "sort": spec.sort,
                })
        # never dispatch empty queries: a zero-run row is wasted width (and
        # faulted the reference's TPU merge kernel)
        live_idx = [
            qi for qi in range(B) if not dead[qi] and queries[qi]["entries"]
        ]
        if live_idx:
            self.path_counts["merge"] += len(live_idx)
            sub = [queries[qi] for qi in live_idx]
            if reduce_kinds:
                results, reds_sub = self.index.search(
                    sub, k, reduce_cols=reduce_cols, reduce_kinds=reduce_kinds)
            else:
                results = self.index.search(sub, k)
            for si, qi in enumerate(live_idx):
                s, d, total = results[si]
                out[qi] = FastResult(s, d, total, False)
                if reduce_kinds:
                    reds[qi] = reds_sub[si]
        return (out, reds) if reduce_kinds else out


def _refused(reason: str) -> None:
    """A refusal of the fused path, counted in FUSED_REFUSALS."""
    FUSED_REFUSALS[reason] += 1
    return None


def _device_packed(view: PackedFieldView, parts, total_len: int, pad_slack: int):
    """Global (doc_ids, impacts) device tensors from segment device buffers.

    Single segment at base 0: doc_ids is the segment's own buffer (no copy,
    provided it carries the gather slack). Otherwise: rebase + per-segment
    impacts + one device concatenate."""
    from nrtsearch_tpu_torch.ops.bm25 import precompute_impacts

    field = view.field
    p_pad = _pow2(total_len + pad_slack)

    def seg_impacts(seg):
        tfi = seg.fields[field]
        return precompute_impacts(
            tfi.doc_ids, tfi.freqs, tfi.doc_lens, seg.live,
            view.k1, view.b, view.avgdl,
        )

    if len(parts) == 1 and parts[0][1] == 0:
        seg = parts[0][0]
        tfi = seg.fields[field]
        if int(tfi.doc_ids.shape[0]) >= total_len + pad_slack:
            return tfi.doc_ids, seg_impacts(seg)

    dev = parts[0][0].device
    id_parts, imp_parts = [], []
    for seg, base in parts:
        tfi = seg.fields[field]
        ln = tfi.postings_len
        id_parts.append(tfi.doc_ids[:ln] + base)
        imp_parts.append(seg_impacts(seg)[:ln])
    pad = p_pad - total_len
    id_parts.append(torch.zeros(pad, dtype=torch.int32, device=dev))
    imp_parts.append(torch.zeros(pad, dtype=torch.float32, device=dev))
    return torch.cat(id_parts), torch.cat(imp_parts)


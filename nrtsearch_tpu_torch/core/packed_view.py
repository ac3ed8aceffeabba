"""Packed multi-segment field view: one dispatch for any segment count
(counterpart: nrtsearch_tpu/core/packed_view.py).

Every segment's postings for one field are concatenated into one flat device
array with doc ids rebased to GLOBAL ords, so runs from different segments
are just more sorted runs in the same merge, and one dispatch scores the
whole index for a whole query batch.

Path choice mirrors the reference: ``NRT_FAST_PATH`` picks it; by default
the fused dense path (``dense_search_batch``) serves when the index tensors
live on CUDA (the reference serves it on its accelerator) and the exact
merge path (``PrunedIndex.search``) on the CPU. Specs the fused path refuses
go to the merge path, exactly as in the reference. ``NRT_FAST_PATH=bucket``
(or ``NRT_BUCKET=1``) sends plain text batches to the bucket-local path
(``bucket_search_batch``, ops/bucket_retrieval.py) after the fused attempt
and before the merge path, as the reference routes it; its scores are
15-bit quantized. Flat reductions are not ported yet.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.ops.bm25 import lucene_idf
from nrtsearch_tpu_torch.ops.bucket_retrieval import (
    MIN_TILE, QMAX, bucket_search_topk, decode_topk,
)
from nrtsearch_tpu_torch.ops.merge_scoring import _pow2

# tail slack of the packed postings: a run gather near the end never clamps
GATHER_TILE = 8192


@dataclass(frozen=True)
class QuerySpec:
    """One fast-path text query: analyzed terms against one field. (The
    reference's filter / additive / sort columns come with the filtered and
    sorted fused variants, ROADMAP item 8.)"""

    field: str
    terms: tuple[str, ...]
    require_all: bool = False
    boost: float = 1.0


@dataclass
class FastResult:
    scores: np.ndarray   # [k] f32, -inf padded
    docs: np.ndarray     # [k] global ords
    total_hits: int
    pruned: bool         # total_hits is a lower bound


def _empty(k: int) -> FastResult:
    return FastResult(np.full(k, -np.inf, np.float32), np.zeros(k, np.int64), 0, False)


class PackedFieldView:
    """All live segments' postings for one field, packed for fused search."""

    # H rows x D docs: at most 1024 rows, and at most this many bytes of
    # bf16 rows (+ residual rows) per field view
    _DENSE_MAX_ROWS = 1024
    _DENSE_BYTES_BUDGET = 2048 << 20

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
        another path (more runs than the slot budget, or a batch that mixes
        AND and OR), else a dict: per-query ``live`` flags, the [B, T]
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
            # filter / additive / sort specs refuse here once QuerySpec
            # carries those columns (ROADMAP item 8)
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
        residual = os.environ.get("NRT_DENSE_RESIDUAL", "1") != "0"
        bytes_per_row = (4 if residual else 2) * D
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
        rows_lo = None
        if residual:
            # Dekker residual: bf16(imp - f32(hi))
            lo = (imps - hi.float()).to(torch.bfloat16)
            rows_lo = torch.zeros((Hp, D), dtype=torch.bfloat16, device=dev)
            rows_lo[rowid, ids] = lo
        del gidx, rowid, ids, imps, hi
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
        or full combine. Returns None when a spec needs the merge path (a
        conjunction with a tail term, more than R tail runs), as the
        reference does."""
        from nrtsearch_tpu_torch.ops.dense_fused import dense_fused_topk
        from nrtsearch_tpu_torch.ops.dense_head import decode_packed2

        if self.total_len == 0:
            return None
        st = self._dense_state()
        if st is None:
            return None
        dev = self.index.device
        head_pos = st["head_pos"]
        B = len(specs)
        run_offs = self.index.run_offsets
        run_lens = self.index.run_lengths

        # one fused dispatch per AND/OR mode (a static flag of the kernel)
        groups: dict[bool, list[int]] = {}
        parsed = []
        for qi, spec in enumerate(specs):
            entries = self.term_entries(spec.terms, spec.boost)
            live = [(t, w, runs) for t, w, runs in entries if w and runs]
            dead = spec.require_all and any(not runs for _, _, runs in entries)
            distinct = len({t for t, _, _ in live})
            is_and = bool(spec.require_all and distinct > 1 and not dead)
            if is_and and any(t not in head_pos for t, _, _ in live):
                return None   # conjunction with a tail term: merge path
            parsed.append((qi, spec, live, dead, distinct))
            groups.setdefault(is_and, []).append(qi)

        out: list = [_empty(k)] * B
        # shape discipline: U from a 2-value menu with head->tail spill, one
        # fixed tail shape (run_len, R) per snapshot
        u_cap = int(os.environ.get("NRT_DENSE_U", "128"))
        for is_and, idxs in groups.items():
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
                return None  # merge path serves the conjunction exactly
            has_head = bool(used)
            lo = min(32, u_cap)
            U = lo if len(used) <= lo else u_cap
            W = np.zeros((Bg, U), np.float32)
            row_idx = np.zeros(U, np.int32)
            for r, slot in used.items():
                row_idx[slot] = r
            for gi, slots in enumerate(per_q):
                for slot, w in slots:
                    W[gi, slot] += w
            if any_tail:
                run_len = int(os.environ.get("NRT_DENSE_RL", 0)) or _pow2(
                    min(max(4096, st["tail_max_df"]), 65536)
                )
                R_fix = int(os.environ.get("NRT_DENSE_R", "8"))
                t_offs = np.zeros((Bg, R_fix), np.int32)
                t_lens = np.zeros((Bg, R_fix), np.int32)
                t_w = np.zeros((Bg, R_fix), np.float32)
                for gi, row in enumerate(rows_tail):
                    ri = 0
                    for off, ln, w in row:
                        for start in range(0, ln, run_len):
                            if ri >= R_fix:
                                return None  # merge path
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

            packed = dense_fused_topk(
                st["rows"], st["row_max"], self.index.doc_ids, self.index.impacts,
                t(W), t(row_idx), t(n_req), t(t_offs), t(t_lens), t(t_w),
                rows_lo=st["rows_lo"], k=k, has_head=has_head, has_tail=any_tail,
                run_len=run_len, require_all=is_and,
            )
            scores, docs, hits, exact = decode_packed2(packed, k)
            for gi, (qi, *_rest) in enumerate(live_items):
                out[qi] = FastResult(
                    scores[gi], docs[gi].astype(np.int64), int(hits[gi]),
                    not bool(exact[gi]),
                )
        return out

    # -- fused batched search -----------------------------------------------------

    def search_batch(
        self, specs: Sequence[QuerySpec], k: int, prune: Optional[bool] = None,
    ) -> list[FastResult]:
        """Batched search over all segments in one dispatch per path.

        ``NRT_FAST_PATH`` picks the path; unset, the fused dense path when
        the index lives on CUDA and the merge path on the CPU. The bucket
        path is opt-in (``NRT_FAST_PATH=bucket`` or ``NRT_BUCKET=1``), as in
        the reference; what it refuses goes to the merge path. ``prune=None``
        reads NRT_MAXSCORE (default off; pruning is not ported)."""
        path = os.environ.get("NRT_FAST_PATH", "")
        if not path:
            on_dev = self.index is not None and on_cuda(self.index.doc_ids)
            path = "dense" if on_dev else "merge"
        if prune is None:
            prune = os.environ.get("NRT_MAXSCORE", "0") == "1"
        if path in ("dense", "fused"):
            res = self.dense_search_batch(specs, k)
            if res is not None:
                self.path_counts["fused"] += len(specs)
                return res
        if path == "bucket" or os.environ.get("NRT_BUCKET", "0") == "1":
            res = self.bucket_search_batch(specs, k)
            if res is not None:
                self.path_counts["bucket"] += len(specs)
                return res
        B = len(specs)
        if self.total_len == 0:
            return [_empty(k)] * B
        queries = []
        dead = [False] * B
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
            })
        # never dispatch empty queries: a zero-run row is wasted width (and
        # faulted the reference's TPU merge kernel)
        live_idx = [
            qi for qi in range(B) if not dead[qi] and queries[qi]["entries"]
        ]
        out = [_empty(k)] * B
        if not live_idx:
            return out
        self.path_counts["merge"] += len(live_idx)
        results = self.index.search([queries[qi] for qi in live_idx], k, prune=prune)
        for si, qi in enumerate(live_idx):
            s, d, total, count_exact = results[si]
            out[qi] = FastResult(s, d, total, not count_exact)
        return out


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


"""Device-resident packed postings and the batched full merge search over
them (counterpart: nrtsearch_tpu/core/maxscore.py ``PrunedIndex``).

Every query's postings runs go through one batched ``merge_score_topk``
dispatch per column group (ops/merge_scoring.py), on its accelerator branch
when the postings live on CUDA (``use_pallas``, as the reference sets it on
its TPU). The reference's MaxScore pruning is not carried: on an H100 it
was slower than this full merge at batch 1 and at batch 32 alike.

``run_ub``, the per-run impact upper bounds, sets the bucket path's
quantization scale; ``split_rows`` serves that path's per-run bucket bounds
(``PackedFieldView._bucket_state``) and the docid chunks of
``search_chunked``, the timeout search.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.ops.merge_scoring import _pow2, merge_score_topk, plan_run_lists
from nrtsearch_tpu_torch.tracing import span

# impacts block size for per-run upper bounds
_UB_BLOCK = 512


def run_upper_bounds(
    impacts: torch.Tensor,     # f32 [P_pad] device, live-folded impacts
    run_offsets: np.ndarray,   # int64 [NR]
    run_lengths: np.ndarray,   # int32 [NR]
) -> np.ndarray:
    """Per-run max-impact UPPER bounds from device block maxima: one device
    reduce ([P] -> [P/512]) and one host pull; edge blocks shared with
    neighbouring runs only raise a bound. Clipped at 1 (impacts are < 1)."""
    P = int(impacts.shape[0])
    nb = P // _UB_BLOCK
    if nb == 0:
        return np.ones(len(run_offsets), np.float32)
    bm_t = impacts[: nb * _UB_BLOCK].reshape(nb, _UB_BLOCK).amax(dim=1)
    if nb * _UB_BLOCK < P:
        bm_t = torch.cat([bm_t, impacts[nb * _UB_BLOCK :].amax()[None]])
    bm = bm_t.cpu().numpy()
    offs = np.asarray(run_offsets, np.int64)
    lens = np.asarray(run_lengths, np.int64)
    ub = np.zeros(len(offs), np.float32)
    nz = lens > 0
    if not nz.any():
        return ub
    b0 = offs[nz] // _UB_BLOCK
    b1 = (offs[nz] + lens[nz] - 1) // _UB_BLOCK
    order = np.argsort(b0, kind="stable")
    seg = np.maximum.reduceat(bm, b0[order]) if len(b0) else np.empty(0)
    vals = np.empty(len(b0), np.float32)
    vals[order] = seg
    # reduceat segment [b0_i, b0_{i+1}) can miss the shared edge block b1_i
    vals = np.maximum(vals, bm[np.minimum(b1, len(bm) - 1)])
    ub[nz] = np.minimum(vals, 1.0)
    return ub


class PrunedIndex:
    """Device-resident packed postings (doc-sorted per run, global ords)
    plus per-run impact upper bounds, and the batched merge search.

    Queries are dicts: ``entries`` [(weight, [run_idx, ...])] per term,
    ``require_all`` bool, ``n_terms`` int, and optionally ``filter`` /
    ``additive`` (device [max_doc] columns) and ``sort`` ((keys, ascending)).
    One dispatch serves each group of queries that share the same column
    objects (``_group_by_arrays``)."""

    def __init__(
        self,
        device_ids: torch.Tensor,      # i32 [P_pad] device postings doc ids
        device_impacts: torch.Tensor,  # f32 [P_pad] device live-folded impacts
        run_offsets: np.ndarray,       # int64 [NR]
        run_lengths: np.ndarray,       # int32 [NR]
        max_doc: int,
    ):
        self.max_doc = max_doc
        self.run_offsets = np.asarray(run_offsets, np.int64)
        self.run_lengths = np.asarray(run_lengths, np.int32)
        self.doc_ids = device_ids
        self.impacts = device_impacts
        self.run_ub = run_upper_bounds(
            device_impacts, self.run_offsets, self.run_lengths
        )
        # merge_score_topk's accelerator branch (the reference: _on_tpu())
        self.use_pallas = on_cuda(device_ids)

    @property
    def device(self) -> torch.device:
        return self.doc_ids.device

    def split_rows(self, offsets, lengths, boundaries) -> np.ndarray:
        """Per-run doc-boundary split offsets by bisection on the device.

        ``offsets`` / ``lengths``: the runs (the reference takes a list of
        (offset, length, weight) tuples and ignores the weight);
        ``boundaries``: ascending doc ids [C-1]. Returns int32 [R, C+1]
        run-relative split points ([:, 0] = 0, [:, -1] = length): chunk c of
        run r is [splits[r, c], splits[r, c+1]). Postings are doc-sorted per
        run, so 32 vectorized bisection steps over [R, C-1] gathers find
        every run's first posting at or past each boundary; one host pull."""
        lens_np = np.asarray(lengths, np.int64)
        R, C1 = len(lens_np), len(boundaries)
        out = np.zeros((R, C1 + 2), np.int32)
        if R == 0:
            return out
        dev = self.device
        offs = torch.as_tensor(np.asarray(offsets, np.int64), device=dev)[:, None]
        lens = torch.as_tensor(lens_np, device=dev)[:, None]
        bounds = torch.as_tensor(np.asarray(boundaries, np.int64), device=dev)[None, :]
        lo = torch.zeros((R, C1), dtype=torch.int64, device=dev)
        hi = lens.expand(R, C1).clone()
        last = torch.clamp(lens - 1, min=0)
        for _ in range(32):
            mid = (lo + hi) >> 1
            v = self.doc_ids[offs + torch.minimum(mid, last)]
            go_right = (v < bounds) & (mid < hi)
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right, hi, mid)
        out[:, 1:-1] = lo.cpu().numpy()
        out[:, -1] = lens_np
        return out

    def _dispatch(self, rows, n_terms, k: int, require_all: bool,
                  filter_mask=None, additive=None, sort=None,
                  reduce_cols=(), reduce_kinds=()):
        """One merge_score_topk dispatch over planned run tables (the
        reference's maxscore.py:258-300, without its ``force`` shape pin:
        eager torch has no compiled shapes to keep). Returns
        (out, (run_len, R)): ``out`` is (scores, docs, hits), then the
        reductions when ``reduce_kinds`` is given, as host arrays."""
        with span("plan.runs"):
            offs, lens, weights, run_len = plan_run_lists(
                rows, max_run=int(self.doc_ids.shape[0])
            )
            width = run_len * offs.shape[1]
            k_eff = min(k, max(self.max_doc, 1), width)
            dev = self.device
            tables = [torch.as_tensor(x, device=dev) for x in (
                offs, lens, weights, np.asarray(n_terms, np.int32))]
        out = merge_score_topk(
            self.doc_ids, self.impacts, *tables,
            run_len=run_len, k=k_eff, require_all_terms=require_all,
            use_pallas=self.use_pallas, filter_mask=filter_mask, additive=additive,
            sort_keys=None if sort is None else sort[0],
            sort_ascending=True if sort is None else bool(sort[1]),
            reduce_cols=reduce_cols, reduce_kinds=reduce_kinds,
        )
        shape = (run_len, offs.shape[1])
        with span("readback"):
            host = [t.cpu().numpy() for t in out[:3]]
            if reduce_kinds:
                host.append([r.cpu().numpy() for r in out[3]])
        return tuple(host), shape

    def search_chunked(self, query: dict, k: int, deadline: float, chunks: int = 8):
        """One query over doc-space chunks with a deadline check between
        chunk dispatches (the reference's maxscore.py:341-401; the
        reference checks its cutoff per collect, SearchCutoffWrapper.java:41,
        and one dispatch cannot be preempted). Each chunk is one
        ``_dispatch`` of the query's runs cut at the chunk's doc bounds
        (``split_rows``): on CUDA a chunk whose merged width reaches
        ``ALT_MIN_WIDTH`` runs the merge kernels. On timeout the collected
        prefix is exact over the docs visited and the count is a lower
        bound. Returns (scores [k], docs [k], hits, timed_out)."""
        rows = [
            (int(self.run_offsets[r]), int(self.run_lengths[r]), w)
            for w, runs in query["entries"]
            for r in runs
            if self.run_lengths[r]
        ]
        if not rows:
            return np.full(k, -np.inf, np.float32), np.zeros(k, np.int64), 0, False
        chunk_docs = -(-self.max_doc // max(chunks, 1))
        boundaries = np.arange(1, chunks, dtype=np.int64) * chunk_docs
        splits = self.split_rows([o for o, _, _ in rows], [n for _, n, _ in rows], boundaries)
        srt = query.get("sort")
        req = bool(query.get("require_all"))
        n_terms = query.get("n_terms", 1)

        best: list[tuple] = []   # (score, doc) accumulated across chunks
        total = 0
        timed_out = False
        for c in range(chunks):
            rows_c = [
                (off + int(splits[r, c]), int(splits[r, c + 1]) - int(splits[r, c]), w)
                for r, (off, _ln, w) in enumerate(rows)
            ]
            if not any(ln for _, ln, _ in rows_c):
                continue
            (s, d, h), _shape = self._dispatch(
                self._pad_rows([rows_c]), [n_terms], k, req,
                filter_mask=query.get("filter"), additive=query.get("additive"), sort=srt,
            )
            total += int(h[0])
            for sc, doc in zip(s[0], d[0]):
                if sc > -np.inf:
                    best.append((float(sc), int(doc)))
            if time.time() > deadline and c + 1 < chunks:
                timed_out = True
                break
        ascending = srt is not None and bool(srt[1])
        best.sort(key=lambda t: (t[0], t[1]) if ascending else (-t[0], t[1]))
        out_s = np.full(k, -np.inf, np.float32)
        out_d = np.zeros(k, np.int64)
        for i, (sc, doc) in enumerate(best[:k]):
            out_s[i], out_d[i] = sc, doc
        return out_s, out_d, total, timed_out

    def search(
        self,
        queries: Sequence[dict],
        k: int,
        shape_log: Optional[dict] = None,
        reduce_cols=(),
        reduce_kinds=(),
    ):
        """Batched full search (the reference's maxscore.py:403-459, its
        full path). Returns per query (scores [k] f32 -inf padded,
        docs [k] int64, total_hits); with ``reduce_kinds`` also the
        per-query reductions, as (results, reductions). ``shape_log``
        collects the largest (run_len, R) of the dispatches under "full".
        The reference's ``force_*`` shape pins are left out: eager torch
        compiles no shapes."""
        B = len(queries)
        results: list = [None] * B
        reductions: dict[int, list] = {}
        live: list[int] = []
        for i, q in enumerate(queries):
            if q["entries"]:
                live.append(i)
                continue
            results[i] = (np.full(k, -np.inf, np.float32), np.zeros(k, np.int64), 0)
            if reduce_kinds:
                reductions[i] = _zero_reductions(reduce_kinds)
        if live:
            self._run_full(queries, live, k, results, shape_log,
                           reduce_cols, reduce_kinds, reductions)
        if reduce_kinds:
            return results, [reductions[i] for i in range(B)]
        return results

    # -- full path -------------------------------------------------------------------

    @staticmethod
    def _pad_rows(rows: list) -> list:
        """Pad the batch to a power of two with empty rows (they add no
        postings work), as the reference does to bound its compiled
        shapes."""
        b = _pow2(max(len(rows), 1))
        return rows + [[] for _ in range(b - len(rows))]

    def _run_full(self, queries, idxs, k, results, shape_log=None,
                  reduce_cols=(), reduce_kinds=(), reductions_out=None):
        for (fmask, addv), gidx in _group_by_arrays([queries[i] for i in idxs], idxs):
            with span("plan.runs"):
                srt = queries[gidx[0]].get("sort")
                rows = self._pad_rows([
                    [
                        (int(self.run_offsets[r]), int(self.run_lengths[r]), w)
                        for w, runs in queries[i]["entries"]
                        for r in runs
                        if self.run_lengths[r]
                    ]
                    for i in gidx
                ])
                n_terms = [queries[i]["n_terms"] for i in gidx]
                n_terms = n_terms + [1] * (len(rows) - len(n_terms))
                req = any(queries[i].get("require_all") for i in gidx)
            out, shape = self._dispatch(rows, n_terms, k, req, filter_mask=fmask,
                                        additive=addv, sort=srt,
                                        reduce_cols=reduce_cols, reduce_kinds=reduce_kinds)
            _log_shape(shape_log, "full", shape)
            s2, d2, h2 = out[:3]
            with span("results"):
                for row_i, i in enumerate(gidx):
                    if reduce_kinds:
                        reductions_out[i] = [np.asarray(r[row_i]) for r in out[3]]
                    kk = s2[row_i].shape[0]
                    out_s = np.full(k, -np.inf, np.float32)
                    out_d = np.zeros(k, np.int64)
                    out_s[: min(k, kk)] = s2[row_i][:k]
                    out_d[: min(k, kk)] = d2[row_i][:k].astype(np.int64)
                    results[i] = (out_s, out_d, int(h2[row_i]))


def _zero_reductions(reduce_kinds) -> list:
    """The reductions of a query that matches nothing."""
    out = []
    for kind in reduce_kinds:
        if kind[0] == "ordinal":
            out.append(np.zeros(int(kind[1]), np.int32))
        elif kind[0] == "count":
            out.append(np.int32(0))
        elif kind[0] == "sum":
            out.append(np.float32(0.0))
        elif kind[0] == "min":
            out.append(np.float32(np.inf))
        else:
            out.append(np.float32(-np.inf))
    return out


def _log_shape(shape_log, key, shape):
    """Keep the largest (run_len, R) of each dispatch kind."""
    if shape_log is not None:
        prev = shape_log.get(key, (0, 0))
        shape_log[key] = (max(prev[0], shape[0]), max(prev[1], shape[1]))


def _group_by_arrays(queries, idxs):
    """Group query indices by (filter, additive, sort) object identity, so
    that one dispatch shares one [D] column set (per-query [B, D] columns
    would not fit device memory). Returns [((filter, additive), [i, ...])]."""
    groups: dict = {}
    for q, i in zip(queries, idxs):
        f, a, srt = q.get("filter"), q.get("additive"), q.get("sort")
        key = (id(f) if f is not None else None,
               id(a) if a is not None else None,
               (id(srt[0]), bool(srt[1])) if srt is not None else None)
        groups.setdefault(key, ((f, a), []))[1].append(i)
    return list(groups.values())

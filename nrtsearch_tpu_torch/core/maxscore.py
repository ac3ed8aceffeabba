"""Device-resident packed postings and the batched MaxScore-or-full merge
search over them (counterpart: nrtsearch_tpu/core/maxscore.py
``PrunedIndex``).

The exact merge path: every query's postings runs go through one batched
``merge_score_topk`` dispatch (ops/merge_scoring.py), on its accelerator
branch when the postings live on CUDA (``use_pallas``, as the reference sets
it on its TPU).

MaxScore pruning (``search(..., prune=True)``, the reference's
maxscore.py:1-46) spends no work on postings that provably cannot reach the
top k:

1. **Theta dispatch**: merge only the query's rarest terms (within
   ``THETA_BUDGET`` postings). Its k-th real score is a lower bound
   ``theta`` of the true k-th score: each of its scores is a partial sum of
   a real doc's score. Filters and additive columns ride it as they ride
   the full dispatch.
2. **Split** (host): with per-term upper bounds ub_t = w_t * max impact, the
   non-essential set N is the longest ascending-ub prefix with
   ``sum_N ub + max(additive) < SPLIT_FRAC * theta`` (strict). A doc that
   matches only N terms scores below theta.
3. **Essential dispatch** over the essential runs only, to a window of the
   top M candidates; it also counts the docs whose essential score reaches
   ``tau = theta - sum_N ub`` (less a 1e-5 relative slack).
4. **Probe and finish** (``probe_finish``, torch ops on the index's
   device): each candidate's non-essential mass by binary search over the
   doc-sorted runs, then the top k with ties to the lower doc id.
5. **Certify or escalate**: when the tau count fits the window, the window
   holds every possible top-k doc; otherwise the query takes the full
   dispatch.

Pruned hit counts are lower bounds (``exact`` False, reported as
GREATER_THAN_OR_EQUAL_TO); flat reductions always take the full path, and
pruning engages only above ``PRUNE_MIN_WIDTH`` postings, so small indexes
keep exact counts. ``split_rows`` serves the bucket path's per-run bucket
bounds (``PackedFieldView._bucket_state``) and the docid chunks of
``search_chunked``, the timeout search.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.ops.merge_scoring import _pow2, merge_score_topk, plan_run_lists
from nrtsearch_tpu_torch.ops.topk import topk_lowest_index

# pruning engages only when a query's total postings width exceeds this
# (below it the full dispatch is already cheap and counts stay exact)
PRUNE_MIN_WIDTH = 1 << 16
# theta dispatch postings budget: rarest terms whose cumulative df fits
THETA_BUDGET = 1 << 16
# candidate window: M = pow2(max(WINDOW_K_MULT * k, WINDOW_MIN))
WINDOW_MIN = 512
WINDOW_K_MULT = 4
# non-essential mass must stay below this fraction of theta (a smaller
# fraction keeps tau high, so the window certificate passes more often)
SPLIT_FRAC = 0.5
_I32_MAX = 2**31 - 1
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


def probe_finish(
    post_docs: torch.Tensor,     # i32 [P_pad] doc-sorted postings (flat, global ords)
    post_impacts: torch.Tensor,  # f32 [P_pad]
    cand_docs: torch.Tensor,     # i32 [B, M] window docs (garbage where score == -inf)
    cand_scores: torch.Tensor,   # f32 [B, M] essential scores (-inf padded)
    probe_offs: torch.Tensor,    # i32 [B, TN] non-essential run starts (0: unused)
    probe_lens: torch.Tensor,    # i32 [B, TN] run lengths (0: unused)
    probe_w: torch.Tensor,       # f32 [B, TN] idf * boost (0: unused)
    *,
    k: int,
    steps: int,                  # binary-search rounds (>= ceil(log2(max len)))
):
    """Each window candidate's non-essential mass, then the top k (the
    reference's jitted ``_probe_finish_impl``, maxscore.py:135-196, as torch
    ops on the index's device, no host read).

    ``steps`` rounds of one binary search over [B, TN, M] at once find each
    candidate's posting in each non-essential run; the found ``w * impact``
    sum over TN in run order (t = 0 first), and add to the essential score.
    Candidates are sorted by doc id first, so the lowest-index top-k breaks
    ties by doc ascending. Returns (scores [B, k], docs [B, k], k-th score
    [B])."""
    valid = cand_scores > float("-inf")
    docs = torch.where(valid, cand_docs, torch.full((), _I32_MAX, dtype=torch.int32,
                                                    device=cand_docs.device))
    offs = probe_offs.to(torch.int64)[:, :, None]                 # [B, TN, 1]
    lens = probe_lens.to(torch.int64)[:, :, None]
    last = torch.clamp(lens - 1, min=0)
    want = docs[:, None, :]                                       # [B, 1, M]
    B, TN = probe_offs.shape
    M = docs.shape[1]
    lo = torch.zeros((B, TN, M), dtype=torch.int64, device=docs.device)
    hi = torch.clamp(lens, min=0).expand(B, TN, M).clone()
    for _ in range(steps):
        mid = (lo + hi) // 2
        v = post_docs[offs + torch.minimum(mid, last)]
        go_hi = v < want
        lo = torch.where(go_hi, mid + 1, lo)
        hi = torch.where(go_hi, hi, mid)
    at = offs + torch.minimum(lo, last)
    w = probe_w[:, :, None]
    found = (lo < lens) & (post_docs[at] == want) & (w != 0.0)
    mass = torch.where(found, w * post_impacts[at], 0.0)          # [B, TN, M]
    probed = mass[:, 0]
    for t in range(1, TN):
        probed = probed + mass[:, t]
    final = torch.where(valid, cand_scores + probed, float("-inf"))
    order = torch.sort(docs, dim=1, stable=True).indices
    docs_s = torch.gather(docs, 1, order)
    final_s = torch.gather(final, 1, order)
    top_s, pos = topk_lowest_index(final_s, k)
    top_d = torch.gather(docs_s, 1, pos)
    return top_s, top_d, top_s[:, k - 1]


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
        self._steps = max(int(np.ceil(np.log2(max(self.run_lengths.max(initial=1), 2)))) + 1, 1)

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

    # -- helpers ---------------------------------------------------------------

    def _term_stats(self, entries):
        """Per term: (weight, [runs], df, ub)."""
        out = []
        for w, runs in entries:
            df = int(sum(int(self.run_lengths[r]) for r in runs))
            ub = w * float(max((self.run_ub[r] for r in runs), default=0.0))
            out.append((w, runs, df, ub))
        return out

    def _dispatch(self, rows, n_terms, k: int, require_all: bool,
                  filter_mask=None, additive=None, sort=None,
                  device_out: bool = False, count_threshold=None,
                  reduce_cols=(), reduce_kinds=()):
        """One merge_score_topk dispatch over planned run tables (the
        reference's maxscore.py:258-300, without its ``force`` shape pin:
        eager torch has no compiled shapes to keep). Returns
        (out, (run_len, R)): ``out`` is (scores, docs, hits), then the
        counts at or above ``count_threshold`` [B] when it is given, or the
        reductions; host arrays, or the device tensors with
        ``device_out``."""
        offs, lens, weights, run_len = plan_run_lists(
            rows, max_run=int(self.doc_ids.shape[0])
        )
        width = run_len * offs.shape[1]
        k_eff = min(k, max(self.max_doc, 1), width)
        dev = self.device
        out = merge_score_topk(
            self.doc_ids, self.impacts,
            torch.as_tensor(offs, device=dev), torch.as_tensor(lens, device=dev),
            torch.as_tensor(weights, device=dev),
            torch.as_tensor(np.asarray(n_terms, np.int32), device=dev),
            run_len=run_len, k=k_eff, require_all_terms=require_all,
            use_pallas=self.use_pallas, filter_mask=filter_mask, additive=additive,
            sort_keys=None if sort is None else sort[0],
            sort_ascending=True if sort is None else bool(sort[1]),
            count_threshold=(
                None if count_threshold is None
                else torch.as_tensor(np.asarray(count_threshold, np.float32), device=dev)
            ),
            reduce_cols=reduce_cols, reduce_kinds=reduce_kinds,
        )
        shape = (run_len, offs.shape[1])
        if device_out:
            return out, shape
        host = [t.cpu().numpy() for t in out[:3]]
        if reduce_kinds:
            host.append([r.cpu().numpy() for r in out[3]])
        elif count_threshold is not None:
            host.append(out[3].cpu().numpy())
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
        prune: bool = True,
        reduce_cols=(),
        reduce_kinds=(),
    ):
        """Batched MaxScore-or-full search (the reference's
        maxscore.py:403-459). Returns per query (scores [k] f32 -inf
        padded, docs [k] int64, total_hits, exact): ``exact`` False means
        the hits are a lower bound. With ``reduce_kinds`` (which always take
        the full path) also the per-query reductions, as (results,
        reductions). ``shape_log`` collects the largest (run_len, R) of
        each dispatch kind ("theta", "essential", "full"). The reference's
        ``force_*`` shape pins are left out: eager torch compiles no
        shapes."""
        B = len(queries)
        results: list = [None] * B
        reductions: dict[int, list] = {}
        if reduce_kinds:
            # flat reductions read the full unique-match stream, which a
            # pruned dispatch does not see
            prune = False
        full_idx: list[int] = []
        pruned: list[dict] = []
        for i, q in enumerate(queries):
            if not q["entries"]:
                results[i] = (
                    np.full(k, -np.inf, np.float32), np.zeros(k, np.int64), 0, True,
                )
                if reduce_kinds:
                    reductions[i] = _zero_reductions(reduce_kinds)
                continue
            plan = self._plan_theta(q, k) if prune else None
            if plan is None:
                full_idx.append(i)
            else:
                plan["i"] = i
                pruned.append(plan)
        if pruned:
            self._run_pruned(queries, pruned, k, results, full_idx, shape_log)
        if full_idx:
            self._run_full(queries, full_idx, k, results, shape_log,
                           reduce_cols, reduce_kinds, reductions)
        if reduce_kinds:
            return results, [reductions[i] for i in range(B)]
        return results

    # -- pruned path ---------------------------------------------------------------

    def _plan_theta(self, q: dict, k: int) -> Optional[dict]:
        """Eligibility and the theta dispatch's terms for one query (the
        reference's maxscore.py:461-481)."""
        if q.get("require_all") or q.get("sort") is not None:
            return None
        stats = self._term_stats(q["entries"])
        stats = [st for st in stats if st[2] > 0 and st[0] != 0.0]
        if len(stats) < 2:
            return None
        total_width = sum(df for _, _, df, _ in stats)
        if total_width < PRUNE_MIN_WIDTH or k > 1024:
            return None
        # theta terms: highest ub (rarest) first, within the postings budget
        by_ub = sorted(stats, key=lambda st: -st[3])
        theta_terms, used = [], 0
        for st in by_ub:
            if used + st[2] <= THETA_BUDGET:
                theta_terms.append(st)
                used += st[2]
        if not theta_terms:
            return None
        return {"stats": stats, "theta_terms": theta_terms}

    def _rows_for(self, terms) -> list[tuple[int, int, float]]:
        return [
            (int(self.run_offsets[r]), int(self.run_lengths[r]), w)
            for w, runs, _df, _ub in terms
            for r in runs
            if self.run_lengths[r]
        ]

    def _run_pruned(self, queries, pruned, k, results, full_idx, shape_log):
        """Theta dispatch, split, essential dispatch, probe and certificate
        per column group (the reference's maxscore.py:500-603). A query
        whose split prunes nothing or whose window overflows joins
        ``full_idx``."""
        M = _pow2(max(WINDOW_K_MULT * k, WINDOW_MIN))
        groups = _group_by_arrays([queries[p["i"]] for p in pruned],
                                  list(range(len(pruned))))
        dev = self.device
        for (fmask, addv), pidx in groups:
            plans = [pruned[j] for j in pidx]
            # the additive column's max bounds the columnar mass that a doc
            # matching no essential term can carry. It is taken per group,
            # launched before the theta dispatch and read after its host
            # read: the reference caches it per id(column)
            # (maxscore.py:233-247), and a freed request column's id can be
            # reused by the next request's column
            add_max = None if addv is None else addv.amax()
            # theta dispatch (tiny)
            rows_t = self._pad_rows([self._rows_for(p["theta_terms"]) for p in plans])
            (s_t, _d_t, _h_t), shape = self._dispatch(
                rows_t, [1] * len(rows_t), k, False,
                filter_mask=fmask, additive=addv,
            )
            _log_shape(shape_log, "theta", shape)
            max_add = 0.0 if add_max is None else max(float(add_max), 0.0)

            # split, and the essential dispatch's rows and probe tables
            ess_rows, probe_tables, run_idx, taus = [], [], [], []
            for row_i, p in enumerate(plans):
                # theta is the k-th real score; with fewer than k slots
                # there is no k-th lower bound
                theta = float(s_t[row_i][k - 1]) if s_t.shape[1] >= k else -np.inf
                split = self._split(p["stats"], theta, max_add)
                if split is None:
                    full_idx.append(p["i"])
                    continue
                ess, non_ess, sum_ub = split
                p["sum_ub"] = sum_ub
                ess_rows.append(self._rows_for(ess))
                probe_tables.append(self._rows_for(non_ess))
                # docs below tau in essential score cannot reach theta even
                # with every non-essential bound; the relative slack absorbs
                # f32 summation-order noise (it counts a hair more)
                tau = theta - sum_ub
                taus.append(tau - 1e-5 * max(1.0, abs(tau)))
                run_idx.append(row_i)
            if not ess_rows:
                continue
            live_plans = [plans[j] for j in run_idx]
            ess_rows = self._pad_rows(ess_rows)
            taus = taus + [np.inf] * (len(ess_rows) - len(taus))

            # essential dispatch, its output left on the device; it also
            # counts the docs at or above tau
            (s_e, d_e, h_e, n_above), shape = self._dispatch(
                ess_rows, [1] * len(ess_rows), M, False,
                filter_mask=fmask, additive=addv,
                device_out=True, count_threshold=np.asarray(taus, np.float32),
            )
            _log_shape(shape_log, "essential", shape)
            m_eff = int(s_e.shape[1])

            # probe and finish; the probe tables' width is a power of two
            TN = _pow2(max((len(t) for t in probe_tables), default=1) or 1)
            po = np.zeros((len(ess_rows), TN), np.int32)
            pl = np.zeros((len(ess_rows), TN), np.int32)
            pw = np.zeros((len(ess_rows), TN), np.float32)
            for bi, table in enumerate(probe_tables):
                for ti, (o, ln, w) in enumerate(table):
                    po[bi, ti], pl[bi, ti], pw[bi, ti] = o, ln, w
            kk = min(k, m_eff)
            top_s, top_d, _kth = probe_finish(
                self.doc_ids, self.impacts, d_e, s_e,
                torch.as_tensor(po, device=dev), torch.as_tensor(pl, device=dev),
                torch.as_tensor(pw, device=dev), k=kk, steps=self._steps,
            )
            # the one host read of the pruned path
            host = torch.cat([top_s.view(torch.int32), top_d.to(torch.int32),
                              n_above[:, None].to(torch.int32),
                              h_e[:, None].to(torch.int32)], dim=1).cpu().numpy()
            top_s_h = host[:, :kk].view(np.float32)
            top_d_h = host[:, kk:2 * kk]
            n_above_h, h_e_h = host[:, 2 * kk], host[:, 2 * kk + 1]

            # certify or escalate
            for bi, p in enumerate(live_plans):
                if int(n_above_h[bi]) > m_eff:
                    # more tau-reaching docs than the window holds
                    full_idx.append(p["i"])
                    continue
                out_s = np.full(k, -np.inf, np.float32)
                out_d = np.zeros(k, np.int64)
                out_s[:kk] = top_s_h[bi][:k]
                out_d[:kk] = top_d_h[bi][:k].astype(np.int64)
                out_d[out_s == -np.inf] = 0
                # hits: essential matches only, a lower bound of the union
                results[p["i"]] = (out_s, out_d, int(h_e_h[bi]), False)

    @staticmethod
    def _split(stats, theta: float, max_add: float):
        """MaxScore split (the reference's maxscore.py:605-628). Returns
        (essential, non_essential, sum_ub), or None when nothing can be
        pruned."""
        if not (theta > 0.0) or not np.isfinite(theta):
            return None
        by_ub = sorted(stats, key=lambda st: st[3])  # ascending ub
        budget = SPLIT_FRAC * theta - max_add
        non_ess, cum = [], 0.0
        for st in by_ub:
            if cum + st[3] < budget:
                non_ess.append(st)
                cum += st[3]
            else:
                break
        if not non_ess:
            return None
        ess = [st for st in stats if not any(st is n for n in non_ess)]
        if not ess:
            # keep the highest-ub term essential: the window must exist
            ess = [non_ess.pop()]
            cum = sum(st[3] for st in non_ess)
        return ess, non_ess, cum

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
            for row_i, i in enumerate(gidx):
                if reduce_kinds:
                    reductions_out[i] = [np.asarray(r[row_i]) for r in out[3]]
                kk = s2[row_i].shape[0]
                out_s = np.full(k, -np.inf, np.float32)
                out_d = np.zeros(k, np.int64)
                out_s[: min(k, kk)] = s2[row_i][:k]
                out_d[: min(k, kk)] = d2[row_i][:k].astype(np.int64)
                results[i] = (out_s, out_d, int(h2[row_i]), True)


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

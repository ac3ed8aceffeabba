"""Device-resident packed postings and the full-width merge search over them
(counterpart: nrtsearch_tpu/core/maxscore.py ``PrunedIndex``).

The exact merge path: every query's postings runs go through one batched
``merge_score_topk`` dispatch (ops/merge_scoring.py), on its accelerator
branch when the postings live on CUDA (``use_pallas``, as the reference sets
it on its TPU). MaxScore pruning
(``prune=True``: the theta dispatch, the term split, the probe and the
window certificate) is not ported; the reference's serving default
(NRT_MAXSCORE=0) never asks for it. ``split_rows`` serves the bucket path's
per-run bucket bounds (``PackedFieldView._bucket_state``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from nrtsearch_tpu_torch.device import on_cuda
from nrtsearch_tpu_torch.ops.merge_scoring import _pow2, merge_score_topk, plan_run_lists

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
    ``require_all`` bool and ``n_terms`` int. One dispatch serves the batch:
    the reference groups queries by their filter/additive/sort arrays, which
    ported specs do not carry yet (ROADMAP item 8)."""

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

    def _dispatch(self, rows, n_terms, k: int, require_all: bool):
        """One merge_score_topk dispatch over planned run tables; returns
        host (scores, docs, hits)."""
        offs, lens, weights, run_len = plan_run_lists(
            rows, max_run=int(self.doc_ids.shape[0])
        )
        width = run_len * offs.shape[1]
        k_eff = min(k, max(self.max_doc, 1), width)
        dev = self.device
        s, d, h = merge_score_topk(
            self.doc_ids, self.impacts,
            torch.as_tensor(offs, device=dev), torch.as_tensor(lens, device=dev),
            torch.as_tensor(weights, device=dev),
            torch.as_tensor(np.asarray(n_terms, np.int32), device=dev),
            run_len=run_len, k=k_eff, require_all_terms=require_all,
            use_pallas=self.use_pallas,
        )
        return s.cpu().numpy(), d.cpu().numpy(), h.cpu().numpy()

    def search(
        self, queries: Sequence[dict], k: int, prune: bool = False,
    ) -> list[tuple[np.ndarray, np.ndarray, int, bool]]:
        """Batched full-width search. Returns per query (scores [k] f32 -inf
        padded, docs [k] int64, total_hits, exact)."""
        if prune:
            raise NotImplementedError(
                "MaxScore pruning is not ported yet (ROADMAP item 14)"
            )
        B = len(queries)
        results: list = [None] * B
        full_idx: list[int] = []
        for i, q in enumerate(queries):
            if not q["entries"]:
                results[i] = (
                    np.full(k, -np.inf, np.float32), np.zeros(k, np.int64), 0, True,
                )
            else:
                full_idx.append(i)
        if full_idx:
            self._run_full(queries, full_idx, k, results)
        return results

    @staticmethod
    def _pad_rows(rows: list) -> list:
        """Pad the batch to a power of two with empty rows (they add no
        postings work), as the reference does to bound its compiled
        shapes."""
        b = _pow2(max(len(rows), 1))
        return rows + [[] for _ in range(b - len(rows))]

    def _run_full(self, queries, idxs, k, results):
        rows = self._pad_rows([
            [
                (int(self.run_offsets[r]), int(self.run_lengths[r]), w)
                for w, runs in queries[i]["entries"]
                for r in runs
                if self.run_lengths[r]
            ]
            for i in idxs
        ])
        n_terms = [queries[i]["n_terms"] for i in idxs]
        n_terms = n_terms + [1] * (len(rows) - len(n_terms))
        req = any(queries[i].get("require_all") for i in idxs)
        s2, d2, h2 = self._dispatch(rows, n_terms, k, req)
        for row_i, i in enumerate(idxs):
            kk = s2[row_i].shape[0]
            out_s = np.full(k, -np.inf, np.float32)
            out_d = np.zeros(k, np.int64)
            out_s[: min(k, kk)] = s2[row_i][:k]
            out_d[: min(k, kk)] = d2[row_i][:k].astype(np.int64)
            results[i] = (out_s, out_d, int(h2[row_i]), True)

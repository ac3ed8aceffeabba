"""The check that decides ``correct``: the program's answers against the
reference's, query by query.

For a sample of the answers the window produced (drawn from the seed),
the reference scores every doc of each query (``reference.Reference``) and
the check reads four numbers:

- ``score_gap`` (mode ``relative``): the widest relative gap between the
  program's score at a rank and the reference's score at that rank, or
  between the program's score of a doc and the reference's score of that
  doc; mode ``quanta`` reads the same gaps in quanta of the query's
  quantization per distinct query term (``quanta_gap``);
- ``hits_wrong``: queries whose total hit count differs from the reference's;
- ``short_lists``: queries that return another number of hits than
  min(k, total hits);
- ``order_faults``: adjacent pairs out of (score descending, doc id
  ascending) order, repeated docs, and docs returned that the query does
  not match.

Near-ties may swap docs without a fault: both gaps stay within the limit
when each doc's score is right and the list is sorted.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import Reference

BLOCK = 32   # queries the reference scores at once


def sample_positions(n_batches: int, batch: int, count: int, seed: int) -> list[tuple[int, int]]:
    """``count`` (batch, query) positions of the window's answers, drawn
    without replacement from ``seed``'s sample stream; all when fewer."""
    from portbench.generate import sub_seed

    total = n_batches * batch
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    flat = np.arange(total) if count >= total else np.sort(rng.choice(total, count, replace=False))
    return [(int(i // batch), int(i % batch)) for i in flat]


def order_faults(scores: np.ndarray, docs: np.ndarray, n: int) -> int:
    s, d = scores[:n].astype(np.float64), docs[:n]
    bad = int(np.count_nonzero((s[1:] > s[:-1]) | ((s[1:] == s[:-1]) & (d[1:] <= d[:-1]))))
    return bad + (n - len(np.unique(d)))


def check(ref: Reference, queries: np.ndarray, prog: tuple, k: int, mode: str) -> dict:
    """Numbers of the check over ``queries`` (int64 [S, T] term ids) and the
    program's answers ``prog`` = (scores [S, k], docs [S, k], hits [S])."""
    p_scores, p_docs, p_hits = prog
    gap_name = "score_gap" if mode == "relative" else "quanta_gap"
    out = {gap_name: 0.0, "hits_wrong": 0, "short_lists": 0, "order_faults": 0}
    N = ref.num_docs
    for lo in range(0, len(queries), BLOCK):
        qs = queries[lo:lo + BLOCK]
        dense, matched = ref.dense(qs)
        r_scores, _r_docs, r_hits = ref.topk(dense, matched, k)
        ps, pd = p_scores[lo:lo + BLOCK], p_docs[lo:lo + BLOCK]
        valid = np.isfinite(ps)
        n_valid = valid.sum(axis=1)
        # the reference's score of each doc the program returned
        safe = np.where(valid & (pd >= 0) & (pd < N), pd, 0)
        rows = torch.arange(len(qs), device=dense.device)[:, None]
        idx = torch.as_tensor(safe, device=dense.device)
        doc_ref = dense[rows, idx].to(torch.float64).cpu().numpy()
        doc_hit = matched[rows, idx].cpu().numpy()
        for j, q in enumerate(qs):
            n = int(n_valid[j])
            out["hits_wrong"] += int(p_hits[lo + j] != r_hits[j])
            out["short_lists"] += int(n != min(k, int(r_hits[j])) or not valid[j, :n].all())
            d = pd[j, :n]
            out["order_faults"] += order_faults(ps[j], pd[j], n) + int(
                np.count_nonzero((d < 0) | (d >= N) | ~doc_hit[j, :n]))
            m = min(n, int(np.isfinite(r_scores[j]).sum()))
            if m == 0:
                continue
            p = ps[j, :m].astype(np.float64)
            if mode == "relative":
                scale_r, scale_d = np.abs(r_scores[j, :m]), np.abs(doc_ref[j, :m])
            else:
                unit = ref.quantum(q) * max(1, len(np.unique(q[ref.df[q] > 0])))
                scale_r = scale_d = np.full(m, unit)
            hit = doc_hit[j, :m]   # an unmatched doc is an order fault, above
            gaps = np.concatenate([np.abs(p - r_scores[j, :m]) / scale_r,
                                   np.abs(p - doc_ref[j, :m])[hit] / scale_d[hit]])
            out[gap_name] = max(out[gap_name], float(gaps.max()))
        del dense, matched
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[name] <= limits[name] for name in numbers)


def lines(numbers: dict, limits: dict) -> list[str]:
    """One line per number compared: name, number, limit."""
    return [f"check {name} {numbers[name]!r} limit {limits[name]!r}" for name in numbers]
